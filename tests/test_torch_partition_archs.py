"""The dry run's plans of the recurrent, encoder-decoder and vision archs,
and of mamba2 with a model axis of 4, held to the reference's own
partition: its GSPMD lowering of the same SMOKE cells on ``Auto`` mesh
axes (``tests/partition_oracle.py``, one subprocess on 8 fake host
devices for every cell of this file, batch 16 x 64 tokens, the inputs its
``input_specs`` makes: whisper's audio frames, qwen2-vl's patch
embeddings), as ``tests/test_torch_partition.py`` holds qwen3-14b and
mamba2-780m, with its helpers:

* recurrentgemma-9b (RG-LRU and local attention, one KV head),
  whisper-medium (encoder-decoder) and qwen2-vl-72b (a patch projection),
  prefill and train on (8, 1), (4, 2) and (2, 4), decode on (4, 2);
  mamba2-780m prefill and train on (2, 4), decode on (4, 2);
* the port's collectives over the step within 0.5-2x of the reference's,
  in elements (the reference's counted per loop trip);
* on every cell with a model axis, the port's all-reduces over it and
  over its parts (qwen2-vl's KV gradients over each pair of chips that
  holds a KV head) operand for operand the reference's but for the
  differences ``model_axis_differences`` names;
* on every cell with a model axis, the FLOPs of the port's batched
  products (attention's, the SSD's) per chip equal the reference's (not
  mamba2's train step);
* the reference's step takes the inputs the port's dry run gives its own;
* mamba2's SSD runs on each chip's heads and state: its step's FLOPs
  per chip on (2, 4) an eighth of the one-chip step's.
"""
import json

import pytest

from repro_torch.configs.shapes import input_specs
from repro_torch.launch import dryrun
from repro_torch.models import ssm
from test_torch_partition import (SHAPE_OF, _oracle, _plan, _short, _size, _spec, assert_model_axis_all_reduces,
                                  batched_product_flops)

ARCHS = ("recurrentgemma-9b", "whisper-medium", "qwen2-vl-72b")
MESHES = ((8, 1), (4, 2), (2, 4))
CELLS = [(a, m, mesh) for a in ARCHS for m in ("prefill", "train") for mesh in MESHES] + \
    [(a, "decode", (4, 2)) for a in ARCHS] + \
    [("mamba2-780m", m, (2, 4)) for m in ("prefill", "train")] + [("mamba2-780m", "decode", (4, 2))]
MODEL_AXIS_CELLS = [c for c in CELLS if c[2][1] > 1]


def _id(cell):
    return f"{cell[0]}-{cell[1]}-{cell[2][0]}x{cell[2][1]}"


@pytest.fixture(scope="module")
def oracle():
    """The reference's lowering of every cell of this file (one subprocess)."""
    out = _oracle([_spec(c) for c in CELLS])
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    return {(r["arch"], r["mode"], tuple(r["mesh"])): r for r in rows}


@pytest.fixture(scope="module")
def plans():
    return {cell: _plan(*cell) for cell in CELLS}


@pytest.mark.parametrize("cell", CELLS, ids=_id)
def test_collective_elements_within_twice_the_reference(oracle, plans, cell):
    """The port's collectives over the step within 0.5-2x of the
    reference's on ``Auto`` mesh axes, in elements, the reference's each
    counted as often as the loops around it run."""
    ref = oracle[cell]
    port = plans[cell]["collective_elements_by_kind"]
    ratio = sum(port.values()) / sum(ref["elements_per_trip"].values())
    assert 0.5 <= ratio <= 2.0, (ratio, port, ref["elements_per_trip"])
    assert set(ref["elements_per_trip"]) <= set(port) == set(dryrun.COLLECTIVE_KINDS)


@pytest.mark.parametrize("cell", MODEL_AXIS_CELLS, ids=_id)
def test_model_axis_all_reduces_as_the_reference_lowers_them(oracle, cell):
    """The port's all-reduces over the model axis and over its parts,
    operand for operand over the step, are the reference's but for the
    differences ``model_axis_differences`` names: on qwen2-vl's train
    step on (2, 4), each layer's ``dk`` and ``dv`` (rows, tokens, 1, hd)
    over the pair of chips that holds its KV head in each microbatch, as
    GSPMD splits 2 KV heads over a model axis of 4 and the query groups
    within each pair (``attention._head_groups``)."""
    assert_model_axis_all_reduces(oracle[cell], cell)


@pytest.mark.parametrize("cell", [c for c in MODEL_AXIS_CELLS if (c[0], c[1]) != ("mamba2-780m", "train")],
                         ids=_id)
def test_batched_products_flops_as_the_reference_lowers_them(oracle, cell):
    """The FLOPs per chip of the port's batched products (attention's
    scores and their product with v, forward, the remat's recompute and
    backward; the SSD's chunk products; in decode the scores against the
    cache and the SSD's readout of each row's state) over the step equal
    those of the reference's dots with batch dims (``batched_dot_flops``):
    each chip runs the heads GSPMD gives it, and decode's ``wo`` is one
    plain product (``common.mm``), no batched one over a copy of the
    weight for each row.  Not mamba2's train step, whose reference scan
    also transposes the last chunk's unread state update
    (``model_axis_differences``)."""
    assert batched_product_flops(cell) == oracle[cell]["batched_dot_flops"]


@pytest.mark.parametrize("arch", ARCHS + ("mamba2-780m",))
def test_reference_lowers_the_inputs_the_port_plans(oracle, arch):
    """The reference's step is lowered on the inputs its own dry run makes
    (``_token_specs``), the port's dry run's by name and shape: whisper's
    audio frames and qwen2-vl's patch embeddings besides the tokens and
    labels."""
    cfg, b, s = _size((arch,))
    with pytest.MonkeyPatch.context() as mp:
        _short(mp, s)
        for mode in ("prefill", "train"):
            port = input_specs(cfg, SHAPE_OF[mode], b)["batch"]
            mesh = (2, 4) if arch == "mamba2-780m" else (4, 2)
            assert oracle[(arch, mode, mesh)]["inputs"] == {k: list(v.shape) for k, v in port.items()}
    extra = {"whisper-medium": "audio_embed", "qwen2-vl-72b": "patch_embeds"}.get(arch)
    assert (extra in port) == (extra is not None)


@pytest.mark.parametrize("mode", ["prefill", "train"])
def test_ssd_runs_on_each_chips_heads_and_state(monkeypatch, mode):
    """mamba2 on (2, 4): with the SSD on each chip's block of the heads and
    the state (``ssm._ssd_local``) the step's FLOPs per chip are an eighth
    of the one-chip step's, every product split; with the SSD whole on each
    chip of the model axis (``ssm._heads_axis`` returning None, the
    form before) they are more (1.49x in prefill, 1.36x in train)."""
    one = _plan("mamba2-780m", mode, (1, 1))["flops_per_chip"]
    local = _plan("mamba2-780m", mode, (2, 4))["flops_per_chip"]
    monkeypatch.setattr(ssm, "_heads_axis", lambda *a: None)
    whole = _plan("mamba2-780m", mode, (2, 4))["flops_per_chip"]
    assert local * 8 == one and whole > local, (one, local, whole)
