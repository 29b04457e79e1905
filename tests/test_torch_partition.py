"""The dry run's partitioned step (``repro_torch.launch.dryrun``): the step
run on DTensors over a mesh on a fake process group, and what rank 0's
local ops and collectives add up to.

* against the reference's GSPMD lowering of the same SMOKE cells on
  ``Auto`` mesh axes, where its sharding constraints act
  (``tests/partition_oracle.py`` in a subprocess on 8 fake host devices,
  batch 16 x 64 tokens; qwen3-14b and mamba2-780m, prefill and train):
  no collective on a (1, 1) mesh in either package; the port's
  collectives over the step within 0.5-2x of the reference's, in
  elements, the reference's counted per loop trip (its host lowering is
  float32 where the port's traffic is bf16, and it scans microbatches and
  layers), on the (8, 1) and (4, 2) meshes and, for qwen3-14b, on (2, 4)
  and (1, 8), whose model axis does not divide the KV heads, and for
  qwen3-14b widened to d_model 1024 at 32 x 256 (prefill and train on
  (8, 1) and (4, 2), decode on (8, 1) and (4, 2)) and at d_model 1280
  with 10 heads on (2, 4), whose model axis divides ``wo`` 's rows but
  not the heads; on every cell with a model axis, the port's all-reduces
  over it operand for operand the reference's but for the differences
  ``model_axis_differences`` names (the logsumexp, the qk-norm gammas'
  grouping, the embedding's gradient and lookup, decode's scores, the
  two remainders of mamba2's train step, and in
  ``tests/test_torch_partition_archs.py`` 's cells the patch projection);
  on the u1280 train cell ``wo`` runs on its row shard as the reference
  lowers it (on the default ``Explicit`` axes, lowered for
  this cell only, every product runs whole), its FLOPs per chip a
  quarter of the gathered form's, and one all-reduce per column-parallel
  product's input gradient, as the reference's; on (8, 1) the port's
  collectives are the ZeRO-3 traffic of the param tree counted by hand,
  and their ratio of elements to the reference's is pinned; the oracle's
  trip counting on a scan of known length; the reference lowers no MoE
  cell (mixtral-8x7b), which the port plans;
* exact counts: the collectives and FLOPs of one batch-sharded input
  times one FSDP-sharded weight, forward and backward, worked out by hand,
  as a plain product and through ``common.mm``, which gathers the weight,
  and of a column-parallel product whose input gradient ``summed_grad``
  all-reduces once; every count at two and three layer groups extended
  to five equal to the count of the five-group step; the local FLOPs of a pure data-parallel
  cell times its chips equal to the one-chip count; the temporaries on
  ``meta`` equal to the same tracker's over real CPU tensors, plain and as
  DTensors over sharded meshes (``chip_smoke.py`` phase 10c holds the
  sharded plan to the card's allocator);
* the process group is gone after every ``plan_cell``, a failing one too;
* the model code's DTensor forms: the identity on plain tensors, and the
  decode cache's block-by-block write equal to ``index_copy_`` on every
  rank's block.
"""
import collections
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers the "fake" backend)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.dist.sharding import (NamedSharding, P, default_rules, fake_device_mesh, placements, spec_for,
                                      to_dtensor)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, common, init_params
from repro_torch.models.attention import _write_slot_
from repro_torch.train import optimizer
from test_torch_launch import _args, _deeper

ROOT = Path(__file__).resolve().parents[1]
B, S = 16, 64
SHAPE_OF = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
ORACLE_ARCHS = ("qwen3-14b", "mamba2-780m")
ORACLE_MESHES = ((1, 1), (8, 1), (4, 2))
#: meshes whose model axis does not divide qwen3's SMOKE heads (4 query, 2 KV)
UNEVEN_MESHES = ((2, 4), (1, 8))
ORACLE_CELLS = [(a, m, mesh) for a in ORACLE_ARCHS for m in ("prefill", "train") for mesh in ORACLE_MESHES] + \
    [("qwen3-14b", m, mesh) for m in ("prefill", "train") for mesh in UNEVEN_MESHES]
#: qwen3-14b's SMOKE config widened to d_model 1024 (``ModelConfig.scaled``)
#: at batch 32 x 256 tokens (decode: 32 at context 256), where a product
#: split over the contraction shows: a cell ``(arch, mode, mesh, "d1024")``
WIDE = {"d_model": 1024, "head_dim": 256, "d_ff": 4096}
WIDE_B, WIDE_S = 32, 256
WIDE_CELLS = [("qwen3-14b", m, mesh, "d1024") for m, mesh in (
    ("prefill", (8, 1)), ("prefill", (4, 2)), ("train", (4, 2)), ("train", (8, 1)), ("decode", (8, 1)),
    ("decode", (4, 2)))]
#: qwen3-14b's SMOKE config at d_model 1280 with 10 query heads and 2 KV
#: heads, which a model axis of 4 does not divide while it divides
#: ``wo`` 's H·hd = 1280 rows, as Qwen3-14B's 40 heads on 16 chips (5,120
#: rows), at 32 x 256: a cell ``(arch, mode, mesh, "u1280")``
UNEVEN_WIDE = {"d_model": 1280, "n_heads": 10, "n_kv_heads": 2, "head_dim": 128, "d_ff": 4096}
UNEVEN_WIDE_CELLS = [("qwen3-14b", m, (2, 4), "u1280") for m in ("prefill", "train")]
#: the uneven train cell, whose ``wo`` dot the tests read
WO_CELL = ("qwen3-14b", "train", (2, 4), "u1280")
#: qwen3-14b's SMOKE config with 20 query heads over 5 KV heads, on (1, 8):
#: phi3-medium-14b's 10 KV heads on a model axis of 16, which neither
#: divides the other, at SMOKE width (a cell ``(arch, mode, mesh, "k5")``)
KV5 = {"n_heads": 20, "n_kv_heads": 5}
KV5_CELLS = [("qwen3-14b", m, (1, 8), "k5") for m in ("prefill", "train")]
#: every cell the oracle lowers on ``Auto`` mesh axes, the yardstick
CELLS = ORACLE_CELLS + WIDE_CELLS + UNEVEN_WIDE_CELLS + KV5_CELLS
#: the one cell the oracle also lowers on the default ``Explicit`` axes
#: (a key ``cell + ("explicit",)``): the replicated step, whose ``wo`` dot
#: runs whole
EXPLICIT_CELLS = [WO_CELL]
#: each width's ``ModelConfig.scaled`` overrides, batch and tokens
WIDTHS = {"d1024": (WIDE, WIDE_B, WIDE_S), "u1280": (UNEVEN_WIDE, WIDE_B, WIDE_S), "k5": (KV5, B, S)}


def _short(monkeypatch_ctx, seq: int = S) -> None:
    """Every shape at ``seq`` tokens (the SMOKE cells' length)."""
    for name, spec in list(SHAPES.items()):
        monkeypatch_ctx.setitem(SHAPES, name, ShapeSpec(spec.name, seq, spec.global_batch, spec.mode))


def _warm_count(step, args, again):
    """The step counted after one uncounted run with the same shapes: the
    first run fills the model's per-device caches (RoPE's frequencies), a
    few bytes that later runs do not make."""
    with torch.no_grad(), implicit_replication():
        step(*args)
    return dryrun.count_step(dryrun.StepCount(), *again())[0]


def _size(cell):
    """A cell's SMOKE config (widened for a ``"d1024"`` or ``"u1280"``
    cell), batch and tokens."""
    cfg = get_config(cell[0], smoke=True)
    if len(cell) > 3:
        scaled, b, s = WIDTHS[cell[3]]
        return cfg.scaled(**scaled), b, s
    return cfg, B, S


def _plan(arch, mode, mesh_shape, *width, **kw):
    cfg, b, s = _size((arch, mode, mesh_shape, *width))
    mesh = make_mesh(mesh_shape, ("data", "model"), device="meta")
    with pytest.MonkeyPatch.context() as mp:
        _short(mp, s)
        return dryrun.plan_cell(cfg, SHAPE_OF[mode], mesh, batch_override=b, **kw)


def _spec(cell, axes="auto"):
    """A cell as ``tests/partition_oracle.py`` takes it, on ``axes``."""
    scaled, b, s = WIDTHS[cell[3]] if len(cell) > 3 else ({}, B, S)
    return [cell[0], cell[1], list(cell[2]), b, s, scaled, axes]


def _oracle_run(args):
    """``tests/partition_oracle.py`` with ``args``, in a subprocess."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, str(ROOT / "tests" / "partition_oracle.py"), *args],
                          env=env, capture_output=True, text=True, timeout=900)


def _oracle(specs):
    """The reference's partitioned program of ``specs`` (one subprocess)."""
    return _oracle_run([json.dumps(specs)])


@pytest.fixture(scope="module")
def oracle():
    """The reference's collectives (per loop trip too), temporaries, FLOPs,
    all-reduce operands and ``wo`` dots per cell, on ``Auto`` mesh axes
    (``EXPLICIT_CELLS`` also on ``Explicit`` ones)."""
    out = _oracle([_spec(c) for c in CELLS] + [_spec(c, "explicit") for c in EXPLICIT_CELLS])
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    width = {json.dumps(v[0], sort_keys=True): k for k, v in WIDTHS.items()}
    return {(r["arch"], r["mode"], tuple(r["mesh"])) + ((width[json.dumps(r["scaled"], sort_keys=True)],)
                                                        if r["scaled"] else ()) +
            (("explicit",) if r["axes"] == "explicit" else ()): r for r in rows}


@pytest.fixture(scope="module")
def plans():
    return {cell: _plan(*cell) for cell in CELLS}


# ---------------------------------------------------------------------------
# against the reference's partitioned program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ORACLE_ARCHS for m in ("prefill", "train")])
def test_one_chip_has_no_collectives(oracle, plans, arch, mode):
    for coll in (oracle[(arch, mode, (1, 1))]["collectives"], plans[(arch, mode, (1, 1))]["collectives"]):
        assert coll["total_per_chip_bytes"] == 0 and not any(coll["counts"].values())


#: pure data-parallel cells whose collectives are the hand-counted ZeRO-3
#: traffic (``zero3_bytes``): the port / reference ratio of the
#: collectives' elements over the step, as measured
ZERO3 = {("qwen3-14b", "train", (8, 1)): 1.00, ("mamba2-780m", "train", (8, 1)): 1.00,
         ("mamba2-780m", "prefill", (8, 1)): 1.00, ("qwen3-14b", "train", (8, 1), "d1024"): 1.04}
#: the cells held to 2x (every cell off one chip), with the ids they had
#: before the (1, 8) and ZeRO-3 cells joined them
_OFF_ONE_CHIP = [c for c in ORACLE_CELLS if c[2] not in ((1, 1), (1, 8))]
BANDED = [pytest.param(c, id=f"{c[0]}-{c[1]}-mesh{i}") for i, c in enumerate(_OFF_ONE_CHIP)] + \
    [pytest.param(c, id=f"{c[0]}-{c[1]}-1x8") for c in ORACLE_CELLS if c[2] == (1, 8)] + \
    [pytest.param(c, id=f"{c[0]}-{c[1]}-{c[2][0]}x{c[2][1]}-{c[3]}") for c in WIDE_CELLS + UNEVEN_WIDE_CELLS + KV5_CELLS]


@pytest.mark.parametrize("cell", BANDED)
def test_collective_bytes_within_twice_the_reference(oracle, plans, cell):
    """The port's collectives over the step within 0.5-2x of the
    reference's on ``Auto`` mesh axes (where its sharding constraints act
    and GSPMD partitions each product), in elements: the reference's each
    counted as often as the loops around it run (``elements_per_trip``;
    its bytes are float32 on the host, the port's bf16 where the step's
    are), the port's over every layer and microbatch."""
    ref = oracle[cell]
    port = plans[cell]["collective_elements_by_kind"]
    ratio = sum(port.values()) / sum(ref["elements_per_trip"].values())
    assert 0.5 <= ratio <= 2.0, (ratio, port, ref["elements_per_trip"])
    assert set(ref["elements_per_trip"]) <= set(port) == set(dryrun.COLLECTIVE_KINDS)
    coll = plans[cell]["collectives"]
    assert coll["total_per_chip_bytes"] == sum(coll["bytes_by_kind"].values())
    assert ref["collectives_per_trip"]["total_per_chip_bytes"] >= ref["collectives"]["total_per_chip_bytes"]


#: the reference's dtype names of the port's collective operands
DTYPE_NAME = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int32: "s32"}
DTYPE_BYTES = {"bf16": 2, "f32": 4, "s32": 4}


def zero3_bytes(cfg, mode: str, n: int, batch: int, seq: int):
    """The bytes one chip sends in ``cfg`` 's prefill or train step (one
    microbatch) on a pure data-parallel ``(n, 1)`` mesh, worked out from
    ``init_params`` ' shapes and the rule table (FSDP: each dim on
    ``"embed"`` split over ``data``), by kind and the operand's dtype:

    * every weight ``common.mm`` multiplies (two dims, one on ``"embed"``)
      has its FSDP block all-gathered before each product: once in
      prefill; in train twice for the stacked layers' (the forward, and
      the remat's recompute in the backward) and once for ``lm_head``; its
      gradient is reduce-scattered whole onto the blocks, once;
    * each rmsnorm gamma (``("embed",)``) is gathered in float32 at each
      use (train: the forward, the recompute, the backward's product; the
      final norm, outside the remat, twice); its gradient reduce-scattered;
    * the embedding lookup gathers the token ids (int32, each chip's rows)
      once and looks up the global batch's rows in its D columns; an
      all-to-all (an all-gather on a CPU mesh) takes them back to the
      batch's rows, a block of the rows' activations; the backward's
      all-to-all takes the gradient back to the columns, where it is added
      into the table's block with no collective more;
    * each param replicated over ``data`` has its gradient all-reduced
      whole; the loss's token count and each data-sharded leaf's share of
      the global gradient norm are float32 scalars, all-reduced."""
    mesh = make_mesh((n, 1), ("data", "model"), device="meta")
    rules = default_rules(mesh)
    params, axes = init_params(None, cfg, device="meta")
    train = mode == "train"
    rows = batch // n
    assert not train or batch // (n * 4) <= 1  # one microbatch
    out = collections.Counter()
    sharded = 0

    def add(kind, dtype, nbytes):
        out[(kind, DTYPE_NAME[dtype])] += nbytes

    def walk(name, t, ax):
        nonlocal sharded
        if isinstance(t, dict):
            for k in t:
                walk(k, t[k], ax[k])
            return
        stacked = ax[0] == "layers"
        per = ax[1:] if stacked else ax
        on_data = "data" in spec_for(ax, t.shape, rules, mesh)
        whole = t.numel() * t.element_size()
        sharded += on_data
        if name == "embed":
            add("all-gather", torch.int32, rows * seq * 4)
            add("all-gather", t.dtype, (1 + train) * rows * seq * cfg.d_model * t.element_size())
        elif len(per) == 2 and "embed" in per and on_data:
            add("all-gather", t.dtype, (1 + (train and stacked)) * whole // n)
            if train:
                add("reduce-scatter", t.dtype, whole)
        elif per == ("embed",) and on_data:
            add("all-gather", torch.float32, ((2 + stacked) if train else 1) * t.numel() // n * 4)
            if train:
                add("reduce-scatter", t.dtype, whole)
        elif not on_data:
            if train:
                add("all-reduce", t.dtype, whole)
        else:
            raise ValueError(f"no count for {name} {ax}")

    walk(None, params, axes)
    if train:
        add("all-reduce", torch.float32, 4 * (sharded + 1))
    return out


def _by_kind(by_dtype):
    kinds = dict.fromkeys(dryrun.COLLECTIVE_KINDS, 0.0)
    for (kind, _), b in by_dtype.items():
        kinds[kind] += b
    return kinds


class ByDtype(dryrun.StepCount):
    """``StepCount`` with each collective's bytes also under its kind and
    its operand's dtype (``"kind:dtype"`` counts)."""

    def start(self, args):
        super().start(args)
        self.c.update({f"{k}:{d}": 0 for k in dryrun.COLLECTIVE_KINDS for d in DTYPE_BYTES})

    def _local_op(self, func, args, kwargs):
        kind = dryrun.collective_kind(func)
        if kind is not None:
            self.c[f"{kind}:{DTYPE_NAME[dryrun._local(args[0]).dtype]}"] += dryrun._nbytes(args[0])
        return super()._local_op(func, args, kwargs)


def _count_by_dtype(cell):
    """The cell's whole step counted by ``ByDtype``: {(kind, dtype): bytes}."""
    cfg, b, s = _size(cell)
    mesh = make_mesh(cell[2], ("data", "model"), device="meta")
    with pytest.MonkeyPatch.context() as mp, fake_device_mesh(mesh) as dm:
        _short(mp, s)
        counts, _ = dryrun.count_step(ByDtype(), *dryrun.cell_step(cfg, SHAPE_OF[cell[1]], mesh, dm,
                                                                  batch_override=b))
    return {tuple(k.split(":")): v for k, v in counts.items() if ":" in k and v}


DATA_PARALLEL_CELLS = [c for c in ORACLE_CELLS if c[2] == (8, 1)] + \
    [c for c in WIDE_CELLS if c[2] == (8, 1) and c[1] != "decode"]


@pytest.mark.parametrize("cell", DATA_PARALLEL_CELLS, ids=lambda c: "-".join(map(str, c[:2] + c[3:])))
def test_data_parallel_collectives_counted_by_hand(plans, cell):
    """On a pure data-parallel mesh the step's collectives are the ZeRO-3
    traffic of its param tree, to the byte (``zero3_bytes``): no product is
    split over an FSDP-sharded contraction."""
    cfg, b, s = _size(cell)
    want = _by_kind(zero3_bytes(cfg, cell[1], cell[2][0], b, s))
    assert plans[cell]["collectives"]["bytes_by_kind"] == want


@pytest.mark.parametrize("cell", list(ZERO3), ids=lambda c: "-".join(map(str, c[:2] + c[3:])))
def test_zero3_where_the_reference_gathers_and_all_reduces_in_float32(oracle, plans, cell):
    """On a pure data-parallel mesh: the port's collectives are the hand
    count by kind and dtype (bf16 weights gathered and their gradients
    reduce-scattered whole); every collective of the reference's host
    lowering is float32 or int32 (XLA on the host gathers the bf16 weights
    and all-reduces the gradients whole as float32, in each layer's trip
    of its scan); and the ratio of the collectives' elements over the
    step (each collective's bytes over its dtype's size, on both sides;
    the reference's counted per loop trip) keeps its measured value."""
    cfg, b, s = _size(cell)
    want = zero3_bytes(cfg, cell[1], cell[2][0], b, s)
    assert _count_by_dtype(cell) == {k: v for k, v in want.items() if v}
    assert plans[cell]["collectives"]["bytes_by_kind"] == _by_kind(want)
    elements = sum(v / DTYPE_BYTES[d] for (_, d), v in want.items())
    assert elements == sum(plans[cell]["collective_elements_by_kind"].values())
    ref = oracle[cell]
    ref_by_dtype = ref["collectives_by_dtype_per_trip"]
    assert {d for by in ref_by_dtype.values() for d in by} <= {"f32", "s32"}
    for kind, by in ref_by_dtype.items():
        assert sum(by.values()) == pytest.approx(ref["collectives_per_trip"]["bytes_by_kind"][kind], rel=1e-12)
    ref_elements = sum(ref["elements_per_trip"].values())
    assert ref_elements == pytest.approx(sum(v / DTYPE_BYTES[d] for by in ref_by_dtype.values()
                                             for d, v in by.items()), rel=1e-12)
    assert round(elements / ref_elements, 2) == ZERO3[cell], elements / ref_elements


@pytest.mark.parametrize("mesh", [(1, 1), (8, 1), (4, 2)])
def test_reference_cannot_lower_the_moe_cells(mesh):
    """The reference's sort dispatch (``repro/models/moe.py`` 's
    ``dispatch_seq``) calls ``jnp.repeat`` without the output sharding that
    jax asks for under a mesh, so GSPMD lowers no MoE cell and mixtral has
    no oracle; the port plans the same cell."""
    out = _oracle([_spec(("mixtral-8x7b", "prefill", mesh), "explicit")])
    assert out.returncode != 0 and "jnp.repeat" in out.stderr and "dispatch_seq" in out.stderr
    plan = _plan("mixtral-8x7b", "prefill", mesh)
    assert plan["status"] == "ok" and plan["flops_per_chip"] > 0
    assert (plan["collectives"]["total_per_chip_bytes"] > 0) == (mesh != (1, 1))


def test_plan_reports_every_field(plans):
    for cell, plan in plans.items():
        mem = plan["memory_analysis"]
        assert plan["status"] == "ok"
        assert plan["flops_per_chip"] > 0 and plan["bytes_accessed_per_chip"] > 0, cell
        assert mem["temp_bytes"] > 0 and mem["argument_bytes"] > 0, cell
        assert set(plan["notes"]) >= {"flops_per_chip", "bytes_accessed_per_chip", "temp_bytes",
                                       "collectives"}


# ---------------------------------------------------------------------------
# exact counts
# ---------------------------------------------------------------------------


def test_fsdp_product_forward_and_backward_by_hand():
    """``(x @ w).sum()`` and its backward on an (8, 1) mesh, x (64, 32)
    batch-sharded, w (32, 48) FSDP-sharded on its rows, bf16.  Forward: w
    is gathered (each chip sends its 4 x 48 block) and y = x w is rank 0's
    8 rows.  Backward: dy is the sum's replicated ones, so dx = dy w^T
    takes w's column block of w^T with no collective (dx sharded on its
    columns), and dw = x^T dy contracts over the sharded batch: partial
    sums, reduce-scattered onto w's rows (the whole 32 x 48 operand, the
    gradient sync).  Each of the three products is an eighth of the
    whole."""
    mesh = make_mesh((8, 1), ("data", "model"), device="meta")
    x = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    w = torch.empty(32, 48, dtype=torch.bfloat16, device="meta")

    def step(x, w):
        w.requires_grad_(True)
        x.requires_grad_(True)
        with torch.enable_grad():
            (x @ w).sum().backward()
        return w.grad.redistribute(w.device_mesh, w.placements)

    with fake_device_mesh(mesh) as dm:
        args = (to_dtensor(NamedSharding(mesh, P("data")), x, dm),
                to_dtensor(NamedSharding(mesh, P("data")), w, dm))
        counts, grad = dryrun.count_step(dryrun.StepCount(), step, args)
        assert grad.placements == (Shard(0), Replicate()) and grad.to_local().shape == (4, 48)
        assert args[0].grad.placements == (Shard(1), Replicate())
    assert counts["all-gather_count"] == 1 and counts["all-gather_bytes"] == 4 * 48 * 2
    assert counts["reduce-scatter_count"] == 1 and counts["reduce-scatter_bytes"] == 32 * 48 * 2
    assert counts["all-reduce_count"] == counts["all-to-all_count"] == counts["collective-permute_count"] == 0
    assert counts["flops"] == 3 * 2 * 64 * 32 * 48 // 8  # y = x w, dx = dy w^T, dw = x^T dy


def test_gathered_weight_product_forward_and_backward_by_hand():
    """``common.mm(x, w).square().sum()`` and its backward on the same mesh
    and operands as above, the loss's gradient batch-sharded as a model's
    is: ``mm`` gathers w's FSDP blocks first (each chip sends its 4 x 48
    block), autograd saves the gathered w, so dx = dy w^T runs on rank 0's
    8 batch rows with no collective and stays batch-sharded (the plain
    product above shards dx on its columns instead, the seed of a split
    over the contraction); dw = x^T dy contracts over the sharded batch
    and is reduce-scattered once onto w's rows at the gather's backward
    (the whole 32 x 48 operand)."""
    mesh = make_mesh((8, 1), ("data", "model"), device="meta")
    x = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    w = torch.empty(32, 48, dtype=torch.bfloat16, device="meta")

    def step(x, w):
        w.requires_grad_(True)
        x.requires_grad_(True)
        with torch.enable_grad():
            common.mm(x, w).square().sum().backward()
        return w.grad

    with fake_device_mesh(mesh) as dm:
        args = (to_dtensor(NamedSharding(mesh, P("data")), x, dm),
                to_dtensor(NamedSharding(mesh, P("data")), w, dm))
        counts, grad = dryrun.count_step(dryrun.StepCount(), step, args)
        assert grad.placements == (Shard(0), Replicate()) and grad.to_local().shape == (4, 48)
        assert args[0].grad.placements == (Shard(0), Replicate()) and args[0].grad.to_local().shape == (8, 32)
    assert counts["all-gather_count"] == 1 and counts["all-gather_bytes"] == 4 * 48 * 2
    assert counts["reduce-scatter_count"] == 1 and counts["reduce-scatter_bytes"] == 32 * 48 * 2
    assert counts["all-reduce_count"] == counts["all-to-all_count"] == counts["collective-permute_count"] == 0
    assert counts["flops"] == 3 * 2 * 64 * 32 * 48 // 8  # y = x w, dx = dy w^T, dw = x^T dy


def test_column_parallel_input_gradient_completed_by_hand():
    """``common.mm(common.summed_grad(x), w).square().sum()`` and its
    backward on a (1, 2) mesh, x (4, 8, 32) replicated over ``model``, w
    (32, 48) sharded on its columns, bf16.  Forward: no collective, each
    chip its 24 columns of y.  Backward: dx = dy w^T contracts over the
    sharded columns, a partial sum that ``summed_grad`` all-reduces once,
    x's whole B·S·D = 4·8·32 elements, summed in float32 (4 bytes each, as
    the reference's lowering sums them), to ``Replicate`` over ``model``
    (without the form dx stays ``Partial``); dw = x^T dy lands on w's
    shard with no collective.  Each of the three products is half the
    whole."""
    mesh = make_mesh((1, 2), ("data", "model"), device="meta")
    x = torch.empty(4, 8, 32, dtype=torch.bfloat16, device="meta")
    w = torch.empty(32, 48, dtype=torch.bfloat16, device="meta")

    def forward(x, w):
        return common.mm(common.summed_grad(x), w)

    def step(x, w, form=common.summed_grad):
        w.requires_grad_(True)
        x.requires_grad_(True)
        with torch.enable_grad():
            common.mm(form(x), w).square().sum().backward()
        return x.grad

    with fake_device_mesh(mesh) as dm:
        def args():
            return (to_dtensor(NamedSharding(mesh, P()), x, dm),
                    to_dtensor(NamedSharding(mesh, P(None, "model")), w, dm))

        fwd, y = dryrun.count_step(dryrun.StepCount(), forward, args())
        assert y.placements == (Replicate(), Shard(2)) and y.to_local().shape == (4, 8, 24)
        counts, dx = dryrun.count_step(dryrun.StepCount(), step, args())
        assert dx.placements == (Replicate(), Replicate()) and dx.to_local().shape == (4, 8, 32)
        _, partial = dryrun.count_step(dryrun.StepCount(), lambda x, w: step(x, w, lambda t: t), args())
        assert partial.placements == (Replicate(), Partial())
    assert not any(v for k, v in fwd.items() if k.endswith("_count"))
    assert counts["all-reduce_count"] == 1 and counts["all-reduce_bytes"] == 4 * 8 * 32 * 4
    assert counts["all-reduce_elements"] == 4 * 8 * 32 and dx.dtype == torch.bfloat16
    assert sum(counts[f"{k}_count"] for k in dryrun.COLLECTIVE_KINDS) == 1
    assert counts["flops"] == 3 * 2 * 4 * 8 * 32 * 48 // 2  # y = x w, dx = dy w^T, dw = x^T dy


def _shape(hlo: str):
    """``"f32[1024,320]"`` -> (1024, 320)."""
    return tuple(int(d) for d in hlo[hlo.index("[") + 1:-1].split(","))


class _ForwardProducts(dryrun.StepCount):
    """``StepCount`` that also keeps the local operand shapes of every
    ``mm`` of the forward (no autograd node running: not the backward nor
    the remat's recompute)."""

    def start(self, args):
        super().start(args)
        self.products = set()

    def _local_op(self, func, args, kwargs):
        if func is torch.ops.aten.mm.default and torch._C._current_autograd_node() is None:
            self.products.add(tuple(tuple(dryrun._local(a).shape) for a in args[:2]))
        return super()._local_op(func, args, kwargs)


def test_wo_runs_on_its_row_shard_as_the_reference_lowers_it(oracle):
    """The uneven-heads train cell (10 heads, a model axis of 4 that
    divides ``wo`` 's 1,280 rows).  The reference's lowering on ``Auto``
    mesh axes, where its sharding constraints act, runs ``wo`` 's forward
    dot on a row shard, [1024, 320] x [320, 1280], and all-reduces the
    partial sums; on the oracle's default ``Explicit`` axes its
    ``constrain_batch`` is a no-op and every product, ``wo`` 's too, runs
    whole on the gathered weight over the whole microbatch.  The port's
    forward multiplies the same blocks (each chip its 320 rows of ``wo``,
    ``common.row_block``), and ``wo`` 's FLOPs per chip over the step (the
    forward, the remat's recompute, dx and dw in each layer and
    microbatch) are a quarter of those with its rows gathered, counted
    by ``StepCount``."""
    (auto,) = oracle[WO_CELL]["wo_dots"]
    (explicit,) = oracle[WO_CELL + ("explicit",)]["wo_dots"]
    cfg, b, s = _size(WO_CELL)
    rows_block, hd_rows, d = cfg.n_heads * cfg.hd // 4, cfg.n_heads * cfg.hd, cfg.d_model
    assert _shape(auto[2]) == (rows_block, d) and _shape(auto[1])[1] == rows_block
    assert _shape(explicit[2]) == (hd_rows, d)
    assert oracle[WO_CELL]["collectives"]["bytes_by_kind"]["all-reduce"] > 0
    mesh = make_mesh(WO_CELL[2], ("data", "model"), device="meta")

    def count(out_proj=None):
        with pytest.MonkeyPatch.context() as mp, fake_device_mesh(mesh) as dm:
            _short(mp, s)
            if out_proj is not None:
                mp.setattr(attention, "_out_proj", out_proj)
            counter = _ForwardProducts()
            step, args = dryrun.cell_step(cfg, SHAPE_OF["train"], mesh, dm, batch_override=b)
            counts, _ = dryrun.count_step(counter, step, args)
            return counts["flops"], counter.products

    flops, products = count()
    assert (_shape(auto[1]), _shape(auto[2])) in products
    assert not any(rhs == (hd_rows, d) for _, rhs in products)
    gathered_flops, _ = count(lambda out, wo: common.mm(attention._merge_heads(out), common.gathered(wo, 0)))
    microbatches = b // (WO_CELL[2][0] * 4)
    rows = b // microbatches // WO_CELL[2][0] * s
    wo_whole = 4 * 2 * rows * hd_rows * d * cfg.n_layers * microbatches
    assert gathered_flops - flops == wo_whole * 3 // 4


class _AllReducesByAxis(dryrun.StepCount):
    """``StepCount`` that also counts each all-reduce's operand under the
    mesh axis of its group, or ``"model[n]"`` for a group of ``n`` chips of
    the model axis (attention's head groups, ``common.split_axis``, named as
    ``tests/partition_oracle.py`` names the reference's), and its elements
    (``"all-reduce:<axis>:<n>"``, for the sizes ``n`` given; any other
    under ``"...:other"``), and the elements of all of them
    (``"all-reduce:elements"``)."""

    def __init__(self, dm, sizes):
        self.groups = {dm.get_group(i).group_name: a for i, a in enumerate(dm.mesh_dim_names)}
        m = dm.size(dm.mesh_dim_names.index("model"))
        self.axes = [*dm.mesh_dim_names, *(f"model[{d}]" for d in range(2, m) if m % d == 0)]
        self.sizes = sizes
        super().__init__()

    def start(self, args):
        super().start(args)
        self.c.update({f"all-reduce:{a}:{n}": 0 for a in self.axes for n in [*self.sizes, "other"]})
        self.c["all-reduce:elements"] = 0

    def _local_op(self, func, args, kwargs):
        if dryrun.collective_kind(func) == "all-reduce":
            n = dryrun._local(args[0]).numel()
            axis = self.groups.get(args[2]) or f"model[{dist.distributed_c10d._resolve_process_group(args[2]).size()}]"
            self.c[f"all-reduce:{axis}:{n if n in self.sizes else 'other'}"] += 1
            self.c["all-reduce:elements"] += n
        return super()._local_op(func, args, kwargs)


def _model_axes(axis: str) -> bool:
    """The model axis or a part of it (``"model[2]"``)."""
    return axis == "model" or axis.startswith("model[")


def port_model_axis_all_reduces(cell, keys):
    """The port's all-reduces over the model axis and its parts over the
    cell's whole step: ``{(axes, elements): count}`` for the ``keys``
    given, and the count of any other."""
    cfg, b, s = _size(cell)
    mesh = make_mesh(cell[2], ("data", "model"), device="meta")
    with pytest.MonkeyPatch.context() as mp, fake_device_mesh(mesh) as dm:
        _short(mp, s)
        counter = _AllReducesByAxis(dm, sorted({n for _, n in keys}))
        counts, _ = dryrun.count_step(counter, *dryrun.cell_step(cfg, SHAPE_OF[cell[1]], mesh, dm,
                                                                 batch_override=b))
    port = collections.Counter({(a, n): counts[f"all-reduce:{a}:{n}"] for a, n in keys
                                if counts[f"all-reduce:{a}:{n}"]})
    other = sum(counts[f"all-reduce:{a}:other"] for a in counter.axes if _model_axes(a))
    return port, other + sum(counts[f"all-reduce:{a}:{n}"] for a in counter.axes for n in counter.sizes
                             if _model_axes(a) and (a, n) not in keys)


def assert_model_axis_all_reduces(ref, cell):
    """The port's all-reduces over the model axis and its parts, operand
    for operand over the step, are those of the reference's lowering
    ``ref`` (``all_reduce_operands``, each counted as often as the loops
    around it run) but for the differences ``model_axis_differences``
    names."""
    want = collections.Counter({(axes, int(n)): c for axes, by in ref["all_reduce_operands"].items()
                                if _model_axes(axes) for n, c in by.items()})
    differences = model_axis_differences(cell)
    port_only = sum((p for p, _ in differences.values()), collections.Counter())
    ref_only = sum((r for _, r in differences.values()), collections.Counter())
    port, other = port_model_axis_all_reduces(cell, set(want) | set(port_only))
    assert other == 0
    assert not port_only - port and not ref_only - want, differences
    assert port - port_only == want - ref_only, (port, want, differences)


def test_column_parallel_input_gradients_all_reduced_as_the_reference_lowers_them(oracle):
    """The uneven-heads train cell, lowered by the reference on ``Auto``
    mesh axes (where its sharding constraints act).  Its backward
    all-reduces each column-parallel product's input gradient as an
    operand of its own: q's, k's and v's (their dots contract over each
    chip's 320, 64 and 64 columns) in one combined all-reduce, gate's and
    up's (1,024 each) in another, not one sum where the residual fans
    out; ``common.summed_grad`` sits at each product's input so.  Over the
    step (each operand counted as often as the loops around it run), the
    port's model-axis all-reduces are the reference's operand for operand
    (the residual's (4, 256, 1280) microbatch block 68 times: in each
    layer and microbatch ``wo`` 's and ``w_down`` 's forward sums, the
    remat's ``wo`` sum again and the five input gradients, and
    ``lm_head`` 's input gradient in each microbatch; four of
    (4, 256, 1), nine scalars) but for the cross-entropy's logsumexp over
    the model-sharded vocab: the reference all-reduces its max and its sum,
    (4, 256) each per microbatch, where the port gathers the float32
    logits' blocks; and for the embedding's lookup, whose masked rows
    (each microbatch's 8 rows on each chip's 640 columns, the residual
    block's size here) the port all-reduces over the model axis and the
    reference over pairs of its chips.  All axes together the port's
    all-reduce elements are 0.70 of the reference's: on the data axis the
    reference all-reduces the weights' float32 gradients, which the port
    reduce-scatters onto their FSDP blocks."""
    ref = oracle[WO_CELL]
    cfg, b, s = _size(WO_CELL)
    data, model = WO_CELL[2]
    q, kv, f = cfg.n_heads * cfg.hd // model, cfg.n_kv_heads * cfg.hd // model, cfg.d_ff // model
    grads = sorted(sorted(w) for axes, back, w in ref["dot_all_reduces"] if axes == "model" and back and len(w) > 1)
    assert grads == [sorted([q, kv, kv]), [f, f]]
    want = {int(n): c for n, c in ref["all_reduce_operands"]["model"].items()}
    mesh = make_mesh(WO_CELL[2], ("data", "model"), device="meta")
    with pytest.MonkeyPatch.context() as mp, fake_device_mesh(mesh) as dm:
        _short(mp, s)
        counter = _AllReducesByAxis(dm, list(want))
        counts, _ = dryrun.count_step(counter, *dryrun.cell_step(cfg, SHAPE_OF["train"], mesh, dm,
                                                                 batch_override=b))
    port = {n: counts[f"all-reduce:model:{n}"] for n in want if counts[f"all-reduce:model:{n}"]}
    assert counts["all-reduce:model:other"] == 0
    microbatches = b // (data * 4)
    rows = b // microbatches // data
    # the embedding's lookup (the microbatch's rows on each chip's D / data
    # columns) is the residual block's size here
    assert rows * s * cfg.d_model == b // microbatches * s * (cfg.d_model // data)
    assert port[rows * s * cfg.d_model] == (3 + 5) * cfg.n_layers * microbatches + 2 * microbatches
    logsumexp = collections.Counter({rows * s: 2 * microbatches})
    lookup = collections.Counter({rows * s * cfg.d_model: microbatches})
    assert collections.Counter(port) + logsumexp == collections.Counter(want) + lookup
    ref_elements = sum(int(n) * c for by in ref["all_reduce_operands"].values() for n, c in by.items())
    assert round(counts["all-reduce:elements"] / ref_elements, 2) == 0.70, counts["all-reduce:elements"] / ref_elements


#: cells with a model axis, whose all-reduces over it are held operand for
#: operand to the reference's
MODEL_AXIS_CELLS = [c for c in CELLS if c[2][1] > 1]
#: the cells on which the reference's partitioner moves the embedding's
#: lookup over the model axis by another op than an all-reduce of the
#: whole axis (an all-gather of the activations at d_model 1024, an
#: all-reduce over pairs of the model axis's chips at 1280)
LOOKUP_BY_OTHER_OPS = [("qwen3-14b", "prefill", (4, 2), "d1024"), ("qwen3-14b", "prefill", (2, 4), "u1280"),
                       ("qwen3-14b", "train", (2, 4), "u1280")]
#: of those, the cells whose lookup the reference all-reduces over pairs
LOOKUP_OVER_PAIRS = [c for c in LOOKUP_BY_OTHER_OPS if c[3] == "u1280"]
#: the cells on which the reference's partitioner splits the patch
#: projection's contraction over the model axis: qwen2-vl's train step on
#: (2, 4) only (not on (4, 2), nor in prefill)
PATCH_PROJ_SPLIT = [("qwen2-vl-72b", "train", (2, 4))]


def _attention_caches(cfg, s):
    """Each decode cache of ``cfg`` 's attention layers: ``(slots, layers)``
    of the self-attention caches (a ring of the window) and, for an
    encoder-decoder, of the cross-attention caches."""
    if cfg.kind == "encdec":
        return [(s, cfg.n_layers), (cfg.enc_seq, cfg.n_layers)]
    n_groups, tail = divmod(cfg.n_layers, len(cfg.block_pattern))
    layers = n_groups * cfg.block_pattern.count("a") + cfg.block_pattern[:tail].count("a")
    slots = min([s] + [w for w in (cfg.sliding_window, cfg.attn_chunk) if w])
    return [(slots, layers)] if layers else []


def _split_norms(cfg, mode, model, rows, s, mb):
    """The reference's all-reduces of the qk-norms over parts of the model
    axis (``{(axes, elements): count}``): it normalizes q and k on the
    projections' column blocks, ``w`` = n·hd / model columns of the n heads
    on each chip.  Where ``w`` splits a head over ``hd / w`` chips, it
    all-reduces the mean of squares over them, (rows, tokens), at each use
    (prefill: once a layer; train: the forward, the remat's recompute and
    the backward, in each layer and microbatch), and in train the gamma's
    gradient, ``w`` partial sums over the model / (hd / w) chips that hold
    the same columns of other heads, in each layer and microbatch, and one
    scalar of the global norm over the head's chips; where ``w`` neither
    divides nor is divided by ``hd`` (10 query heads' 1,280 columns on 4
    chips), the gamma's (hd,) gradient in each layer and microbatch over
    the gcd(n, model) chips of distinct heads."""
    def axes(n):
        return "model" if n == model else f"model[{n}]"

    out = collections.Counter()
    hd, L = cfg.hd, cfg.n_layers
    for n in (cfg.n_heads, cfg.n_kv_heads) if cfg.qk_norm else ():
        w, rem = divmod(n * hd, model)
        if rem or w % hd == 0:
            continue
        if hd % w == 0:
            split = hd // w
            out[(axes(split), rows * s)] += L * (3 * mb if mode == "train" else 1)
            if mode == "train":
                out[(axes(model // split), w)] += L * mb
                out[(axes(split), 1)] += 1
        elif mode == "train" and math.gcd(n, model) > 1:
            out[(axes(math.gcd(n, model)), hd)] += L * mb
    return out


def model_axis_differences(cell):
    """What sets the port's all-reduces over the model axis and its parts
    apart from the reference's, by name: ``{name: (port only, reference
    only)}``, each ``{(axes, elements): count}`` over the step.

    * ``logsumexp`` (train): the reference all-reduces the loss's max and
      sum over the model-sharded vocabulary, (rows, tokens) each per
      microbatch; the port gathers the float32 logits' blocks;
    * ``qk-norm gammas`` (train, where the model axis divides the query or
      the KV heads): the reference all-reduces each layer's (hd,)
      gradient in its scan's trip, the port the stacked leaf's (L·hd,)
      once per microbatch: the same elements;
    * ``qk-norm over a split head`` (:func:`_split_norms`): the reference
      normalizes q and k on the projections' column blocks, where the
      port gathers the heads whole first (``common.split_last``);
    * ``embedding gradient`` (train on (4, 2)): the reference all-reduces
      the table's gradient over the model axis, its whole vocabulary on
      each chip's D / data columns, once per microbatch; the port adds
      each chip's ids into its own vocabulary block (``common.embed_rows``);
    * ``embedding lookup`` (``LOOKUP_BY_OTHER_OPS``): the port all-reduces
      the masked lookup of the microbatch's rows over the model axis, the
      reference moves it by another op (``LOOKUP_OVER_PAIRS``: an
      all-reduce over pairs of the axis's chips);
    * ``decode scores`` (decode, each attention layer whose cache the
      decode state's rule splits on its head dim, the widest): the port
      all-reduces the scores' partial sums, (rows, H, 1, slots), where the
      reference reshards q and the cache by all-to-all (a cache split on
      its slots runs the softmax on them in both, its max and sum
      all-reduced);
    * ``patch projection`` (``PATCH_PROJ_SPLIT``): the reference splits the
      patch projection's contraction over the model axis and all-reduces
      its (rows, patches, D) output per microbatch, on that mesh only; the
      port runs it on the gathered weight, as the reference does on (4, 2)
      and in prefill;
    * ``unread last state`` (mamba2 train, the SSD on its model shards):
      the reference's scan transposes its body in every trip, so it
      all-reduces ``B`` 's gradient from the last chunk's state update,
      (rows, chunk, N) per layer and microbatch, whose state no chunk
      reads (zeros); the port's autograd runs no backward for it;
    * ``head params' norm`` (the same cells): the reference keeps the
      gradients of ``A_log``, ``dt_bias`` and ``D_skip`` on each chip's
      heads and all-reduces their squares' sums in the global norm, three
      scalars a step; the port gathers them over the model axis (an
      all-gather) where they are made."""
    cfg, b, s = _size(cell)
    arch, mode, (data, model) = cell[:3]
    mb = max(1, b // (data * 4)) if mode == "train" else 1
    rows = b // mb // data
    out = {}
    if mode == "train":
        out["logsumexp"] = ({}, {rows * s: 2 * mb})
        norms = cfg.qk_norm * ((cfg.n_heads % model == 0) + (cfg.n_kv_heads % model == 0))
        if norms:
            out["qk-norm gammas"] = ({cfg.n_layers * cfg.hd: norms * mb}, {cfg.hd: norms * cfg.n_layers * mb})
        if cell[2] == (4, 2):
            out["embedding gradient"] = ({}, {cfg.vocab_padded * cfg.d_model // data: mb})
    if mode != "decode":
        split = _split_norms(cfg, mode, model, rows, s, mb)
        if split:
            out["qk-norm over a split head"] = ({}, split)
    if cell in LOOKUP_BY_OTHER_OPS:
        lookup = b // mb * s * cfg.d_model // data
        out["embedding lookup"] = ({lookup: mb}, {("model[2]", lookup): mb} if cell in LOOKUP_OVER_PAIRS else {})
    if mode == "decode":
        scores = collections.Counter()
        for slots, layers in _attention_caches(cfg, s):
            # the decode state's rule: the widest of (slots, K, hd) that the
            # model axis divides, the last of equals
            if max((d, i) for i, d in enumerate((slots, cfg.n_kv_heads, cfg.hd)) if d % model == 0)[1] == 2:
                scores[rows * cfg.n_heads * slots] += layers
        if scores:
            out["decode scores"] = (scores, {})
    if cell in PATCH_PROJ_SPLIT:
        out["patch projection"] = ({}, {rows * cfg.n_patches * cfg.d_model: mb})
    if cfg.kind == "ssm" and mode == "train" and model > 1 and cfg.ssm_heads % model == 0 == cfg.ssm_state % model:
        out["unread last state"] = ({}, {rows * cfg.ssm_chunk * cfg.ssm_state: cfg.n_layers * mb})
        out["head params' norm"] = ({}, {1: 3})
    # a bare size is over the whole model axis
    return {k: tuple(collections.Counter({(n if isinstance(n, tuple) else ("model", n)): c for n, c in side.items()})
                     for side in v) for k, v in out.items()}


@pytest.mark.parametrize("cell", MODEL_AXIS_CELLS, ids=lambda c: "-".join(map(str, c[:2] + c[3:])) +
                         f"-{c[2][0]}x{c[2][1]}")
def test_model_axis_all_reduces_as_the_reference_lowers_them(oracle, cell):
    """On every cell with a model axis: the port's all-reduces over it and
    over its parts (attention's KV gradients over each KV head's chips,
    ``model[2]`` where 2 KV heads lie on 4 chips), operand for operand
    over the step (``{(axes, elements): count}``, each layer and
    microbatch counted), are the reference's on ``Auto`` mesh axes
    (``all_reduce_operands``, each counted as often as the loops around it
    run) but for the differences ``model_axis_differences`` names."""
    assert_model_axis_all_reduces(oracle[cell], cell)


class _BatchedProducts(dryrun.StepCount):
    """``StepCount`` that also adds the FLOPs of the batched products
    (``bmm``: attention's, the SSD's chunks') under ``"bmm_flops"``."""

    def start(self, args):
        super().start(args)
        self.c["bmm_flops"] = 0

    def _local_op(self, func, args, kwargs):
        before = self.c["flops"]
        out = super()._local_op(func, args, kwargs)
        if func is torch.ops.aten.bmm.default:
            self.c["bmm_flops"] += self.c["flops"] - before
        return out


def batched_product_flops(cell) -> int:
    """The FLOPs per chip of the port's batched products over the cell's
    whole step."""
    cfg, b, s = _size(cell)
    mesh = make_mesh(cell[2], ("data", "model"), device="meta")
    with pytest.MonkeyPatch.context() as mp, fake_device_mesh(mesh) as dm:
        _short(mp, s)
        counts, _ = dryrun.count_step(_BatchedProducts(), *dryrun.cell_step(cfg, SHAPE_OF[cell[1]], mesh, dm,
                                                                          batch_override=b))
    return counts["bmm_flops"]


#: each (2, 4), (4, 2) and (1, 8) cell of qwen3 at every width, and how
#: many chips run each of attention's scores in the reference's partition:
#: one where the model axis divides the KV heads or each KV head's chips
#: divide its query heads; both chips of the pair that holds a KV head of
#: the u1280 cells (5 query heads on 2 chips: GSPMD neither pads them nor
#: splits the head dim, each chip runs the group); the 2 chips that split
#: a query head's head dim on (1, 8) (2 KV heads and 4 query heads on 8
#: chips: the scores whole on each, their product with v on half of hd);
#: every chip of (1, 8) for the phi3-like 5 KV heads (GSPMD runs them
#: whole on each chip); one for the d1024 decode cells' scores against
#: the cache, on (8, 1) and (4, 2)
SCORES_CHIPS = {c: 1 for c in CELLS if c[0] == "qwen3-14b" and c[1] != "decode" and c[2] in ((2, 4), (4, 2))} | {
    c: 1 for c in WIDE_CELLS if c[1] == "decode"} | {
    ("qwen3-14b", m, (2, 4), "u1280"): 2 for m in ("prefill", "train")} | {
    ("qwen3-14b", m, (1, 8)): 2 for m in ("prefill", "train")} | {c: 8 for c in KV5_CELLS}


@pytest.mark.parametrize("cell", list(SCORES_CHIPS), ids=lambda c: "-".join(map(str, c[:2] + c[3:])) +
                         f"-{c[2][0]}x{c[2][1]}")
def test_attention_runs_each_chips_share_of_the_heads(oracle, cell):
    """Attention's FLOPs per chip (its batched products: the scores and
    their product with v, forward, the remat's recompute and backward)
    equal the reference's (``batched_dot_flops``), and with each chip's
    share of the heads (``attention._head_groups``) they are the one-chip
    step's over the chips (``SCORES_CHIPS``: times the chips that run the
    same scores), also where the model axis divides the heads, which no
    all-reduce shows; the 5 KV heads on 8 chips run whole on each chip, as
    the reference runs them.  In decode they are the scores against the
    cache and their product with it, ``wo`` one plain product
    (:func:`test_decode_out_projection_is_one_plain_product`)."""
    port = batched_product_flops(cell)
    assert port == oracle[cell]["batched_dot_flops"]
    one = batched_product_flops(cell[:2] + ((1, 1),) + cell[3:])
    chips = cell[2][0] * cell[2][1]
    if (cell[2], cell[3:]) == ((1, 8), ()):
        # the scores' products on 2 chips, their product with v split too
        assert one < port * chips < 2 * one
    else:
        assert port * chips == SCORES_CHIPS[cell] * one


class _OpsSeen(TorchDispatchMode):
    """The ops that reach the dispatch modes (on DTensors: before DTensor
    runs them as local ops)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("cell", [c for c in WIDE_CELLS if c[1] == "decode"] +
                         [("qwen3-14b", "decode", (1, 1), "d1024")],
                         ids=lambda c: f"{c[2][0]}x{c[2][1]}")
def test_decode_out_projection_is_one_plain_product(monkeypatch, cell):
    """In the partitioned decode step each attention layer's output
    projection (``attention._out_proj``) is one ``mm`` on each chip's rows
    of the merged heads, as the reference lowers ``wo`` in decode: no
    ``bmm`` and no ``expand`` of ``wo`` over the batch rows.  The merged
    heads (B, 1, H·hd) keep the size-1 dim's stride of the (B, H, 1, hd)
    scores, so ``torch.matmul`` would not fold them (``common.mm`` folds
    them itself)."""
    seen = []
    out_proj = attention._out_proj

    def traced(out, wo):
        with _OpsSeen() as mode:
            y = out_proj(out, wo)
        seen.append((type(out), collections.Counter(f._overloadpacket for f in mode.ops)))
        return y

    monkeypatch.setattr(attention, "_out_proj", traced)
    batched_product_flops(cell)
    assert seen
    for kind, ops in seen:
        assert kind is DTensor and ops[torch.ops.aten.mm] == 1, (kind, ops)
        assert not ops[torch.ops.aten.bmm] and not ops[torch.ops.aten.expand], ops


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x7b", "recurrentgemma-9b"])
def test_counts_extended_over_depth_equal_the_whole_step(arch, mode):
    """Every count ``step_counts`` makes at two and three layer groups,
    extended to five groups (and a tail), equals the count of the
    five-group step itself, on a (4, 2) mesh: the collectives, the local
    FLOPs, the bytes accessed and the peak of the temporaries."""
    cfg = _deeper(get_config(arch, smoke=True))
    mesh = make_mesh((4, 2), ("data", "model"), device="meta")
    with pytest.MonkeyPatch.context() as mp:
        _short(mp)
        with fake_device_mesh(mesh) as dm:
            def build(c):
                return dryrun.cell_step(c, SHAPE_OF[mode], mesh, dm, batch_override=B, grad_accum=2)

            _warm_count(*build(cfg), lambda: build(cfg))
            extended, _ = dryrun.step_counts(cfg, build)
            whole, _ = dryrun.count_step(dryrun.StepCount(), *build(cfg))
    assert extended == whole
    assert whole["flops"] > 0 and whole["temp_bytes"] > 0 and whole["all-gather_count"] > 0


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_data_parallel_flops_split_evenly(mode):
    """On a pure data-parallel (8, 1) mesh with a divisible batch every
    product is split by the batch: 8 chips' local FLOPs are the one chip's."""
    one = _plan("qwen3-14b", mode, (1, 1))
    eight = _plan("qwen3-14b", mode, (8, 1))
    assert eight["flops_per_chip"] * 8 == one["flops_per_chip"] > 0
    assert eight["useful_flops_ratio"] == one["useful_flops_ratio"]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "mamba2-780m", "whisper-medium"])
def test_temporaries_on_meta_equal_real_cpu_tensors(arch, mode):
    """The storage tracker over the plain step on ``meta`` and over the
    same step on real CPU tensors: the same peak, FLOPs and bytes."""
    cfg = get_config(arch, smoke=True)
    counts = []
    for device in ("meta", "cpu"):
        gen = None if device == "meta" else torch.Generator().manual_seed(0)
        counts.append(_warm_count(*_args(cfg, mode, device, gen), lambda: _args(cfg, mode, device, gen)))
    assert counts[0] == counts[1]
    assert counts[0]["temp_bytes"] > 0 and counts[0]["bytes_accessed"] > 0


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_sharded_temporaries_on_meta_equal_real_cpu_tensors(mode, mesh):
    """The cell's step on DTensors over a sharded mesh, counted on ``meta``
    blocks as the plan counts it and on real CPU blocks (zeros, rank 0's
    collectives hallucinated by the fake group): the same peak of the
    temporaries, collectives and FLOPs.  The bytes accessed differ by the
    index arithmetic and scalars DTensor makes on the host, which a step on
    ``meta`` (or CUDA) leaves out by their device and one on the CPU
    cannot: within 0.1%."""
    assert_sharded_meta_equals_cpu("qwen3-14b", mode, mesh)


@pytest.mark.parametrize("mesh", [(2, 4), (1, 8)])
def test_head_groups_temporaries_on_meta_equal_real_cpu_tensors(mesh):
    """The same on meshes whose model axis does not divide qwen3's 2 KV
    heads (``attention._head_groups``: each KV head on a pair of the
    axis's chips; on 4 chips of 8, each chip one query head and half of
    v's head dim), the train step: its forward, the remat's recompute and
    the backward, whose KV gradients are summed over parts of the axis."""
    assert_sharded_meta_equals_cpu("qwen3-14b", "train", mesh)


def assert_sharded_meta_equals_cpu(arch, mode, mesh):
    """The body of the test above for ``arch`` 's SMOKE config."""
    cfg = get_config(arch, smoke=True)
    m = make_mesh(mesh, ("data", "model"), device="meta")
    counts = []
    with pytest.MonkeyPatch.context() as mp, fake_device_mesh(m) as dm:
        _short(mp)
        for device in ("meta", "cpu"):
            def build():
                return dryrun.cell_step(cfg, SHAPE_OF[mode], m, dm, batch_override=B, device=device)

            counts.append(_warm_count(*build(), build))
    meta, cpu = ({k: v for k, v in c.items() if k != "bytes_accessed"} for c in counts)
    assert meta == cpu and meta["temp_bytes"] > 0
    assert sum(meta[f"{k}_count"] for k in dryrun.COLLECTIVE_KINDS) > 0
    host = counts[1]["bytes_accessed"] - counts[0]["bytes_accessed"]
    assert abs(host) <= 1e-3 * counts[0]["bytes_accessed"], host


def test_cell_step_puts_zero_blocks_on_the_mesh_device_type():
    """Real blocks are zeros of rank 0's shard shapes, on the mesh's device
    type only: DTensor would move a block of another type to it."""
    cfg = get_config("qwen3-14b", smoke=True)
    mesh = make_mesh((2, 1), ("data", "model"), device="meta")
    with pytest.MonkeyPatch.context() as mp, fake_device_mesh(mesh) as dm:
        _short(mp)
        with pytest.raises(ValueError, match="cuda over a cpu mesh"):
            dryrun.cell_step(cfg, "prefill_32k", mesh, dm, batch_override=B, device="cuda")
        _, (params, batch) = dryrun.cell_step(cfg, "prefill_32k", mesh, dm, batch_override=B, device="cpu")
    tokens = batch["tokens"].to_local()
    assert tokens.device.type == "cpu" and tokens.shape == (B // 2, S) and not tokens.any()
    assert all(p.to_local().device.type == "cpu" and not p.to_local().any() for p in params.values()
               if isinstance(p, torch.Tensor))


def test_temp_bytes_follow_storages_not_views():
    """A view makes no storage, an in-place update none either, and a
    storage counts until its last view dies."""
    def step(x):
        y = x * 2  # 4 KiB
        v = y[:8]  # a view of y
        y.mul_(3)  # in place
        del y
        z = v + 1  # y still alive through v: peak 8 KiB
        return z.sum()

    x = torch.empty(32, 32, device="meta")
    counts, _ = dryrun.count_step(dryrun.StepCount(), step, (x,))
    assert counts["temp_bytes"] == 32 * 32 * 4 + 8 * 32 * 4 + 4
    assert counts["bytes_accessed"] == 3 * 4096 + 4096 + 2 * 1024 + 1024 + 4


def test_plan_cell_leaves_no_process_group(monkeypatch):
    assert not dist.is_initialized()
    plan = _plan("qwen3-14b", "decode", (2, 2))
    assert plan["status"] == "ok" and not dist.is_initialized()

    def boom(cfg, build):
        build(cfg)
        assert dist.is_initialized()
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "step_counts", boom)
    with pytest.raises(RuntimeError, match="boom"):
        _plan("qwen3-14b", "prefill", (2, 2))
    assert not dist.is_initialized()


def test_plan_takes_the_microbatch_count():
    default = _plan("qwen3-14b", "train", (1, 1))
    two = _plan("qwen3-14b", "train", (1, 1), grad_accum=2)
    assert default["scan_info"]["grad_accum"] == max(1, B // 4) and two["scan_info"]["grad_accum"] == 2
    assert two["flops_per_chip"] == default["flops_per_chip"]
    assert two["memory_analysis"]["temp_bytes"] > default["memory_analysis"]["temp_bytes"]


def test_oracle_counts_collectives_per_loop_trip():
    """``tests/partition_oracle.py`` 's trip counting, on a ``jax.lax.scan``
    of 5 trips that all-reduces its (96,) float32 carry over 8 fake host
    devices in its body: once per body the all-reduce's 384 bytes, per
    trip 5 times as many, in 4-byte elements; with six arrays all-reduced
    (one all-reduce of a tuple, which ``parse_collectives`` skips) per trip
    six times that."""
    out = _oracle_run(["--scan-psum", "5"])
    assert out.returncode == 0, out.stderr[-4000:]
    one, six = json.loads(out.stdout.splitlines()[-1])
    once = one["collectives"]["bytes_by_kind"]["all-reduce"]
    assert once == 96 * 4 and one["collectives"]["counts"]["all-reduce"] == 1
    assert six["collectives"]["total_per_chip_bytes"] == 0
    for r, parts in ((one, 1), (six, 6)):
        trips = r["collectives_per_trip"]
        assert trips["bytes_by_kind"]["all-reduce"] == trips["total_per_chip_bytes"] == 5 * parts * once
        assert trips["counts"]["all-reduce"] == 5
        assert r["collectives_by_dtype_per_trip"] == {"all-reduce": {"f32": 5 * parts * once}}
        assert r["elements_per_trip"] == {"all-reduce": 5 * parts * once / 4}


def test_collective_kinds():
    ops = torch.ops._c10d_functional
    assert dryrun.collective_kind(ops.all_gather_into_tensor.default) == "all-gather"
    assert dryrun.collective_kind(ops.reduce_scatter_tensor.default) == "reduce-scatter"
    assert dryrun.collective_kind(ops.all_reduce.default) == "all-reduce"
    assert dryrun.collective_kind(ops.all_to_all_single.default) == "all-to-all"
    assert dryrun.collective_kind(torch.ops._dtensor.shard_dim_alltoall.default) == "all-to-all"
    assert dryrun.collective_kind(ops.wait_tensor.default) is None
    assert dryrun.collective_kind(torch.ops.aten.mm.default) is None
    with pytest.raises(NotImplementedError, match="broadcast"):
        dryrun.collective_kind(ops.broadcast.default)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


def test_placements_follow_the_spec_in_mesh_order():
    mesh = make_mesh((2, 4, 2), ("pod", "data", "model"), device="meta")
    names = mesh.axis_names
    assert placements(NamedSharding(mesh, P(("pod", "data"), "model")), names) == [Shard(0), Shard(0), Shard(1)]
    assert placements(NamedSharding(mesh, P(None, "data")), names) == [Replicate(), Shard(1), Replicate()]
    assert placements(NamedSharding(mesh, P()), names) == [Replicate()] * 3
    with pytest.raises(ValueError, match="axis order"):
        placements(NamedSharding(mesh, P(("data", "pod"))), names)


def test_to_dtensor_holds_rank_zeros_block():
    mesh = make_mesh((2, 4, 2), ("pod", "data", "model"), device="meta")
    x = torch.arange(16 * 6, dtype=torch.float32).reshape(16, 6)
    sh = NamedSharding(mesh, P(("pod", "data"), "model"))
    with fake_device_mesh(make_mesh((2, 4, 2), ("pod", "data", "model"), device="cpu")) as dm:
        d = to_dtensor(sh, x, dm)
        assert d.shape == x.shape and d.placements == (Shard(0), Shard(0), Shard(1))
        assert torch.equal(d.to_local(), x[:2, :3])
        m = to_dtensor(sh, x.to("meta"), dm)
        assert m.to_local().device.type == "meta" and m.to_local().shape == (2, 3)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the model code's DTensor forms
# ---------------------------------------------------------------------------


def test_dtensor_forms_are_the_identity_on_plain_tensors():
    x = torch.randn(4, 6, 8)
    for f in (common.constrain_batch, common.summed, common.summed_grad, common.gathered, common.fsdp_gathered):
        assert f(x) is x
    assert common.whole_grad(x, 1) is x
    w = torch.randn(8, 5)
    assert common.row_block(x, w) is x
    assert torch.equal(common.mm(x, w), x @ w)
    assert torch.equal(common.split_last(x, 2, 4), x.reshape(4, 6, 2, 4))
    t = torch.randn(3 * optimizer.CHUNK // 2 + 5)
    chunks = optimizer._chunks(t)
    flat = t.view(-1)
    assert [c.data_ptr() for c in chunks] == [flat[i:].data_ptr() for i in range(0, t.numel(), optimizer.CHUNK)]
    assert torch.equal(torch.cat(chunks), t)


def test_constrain_batch_and_summed_on_dtensors():
    mesh = make_mesh((4, 2), ("data", "model"), device="meta")
    with fake_device_mesh(mesh) as dm, implicit_replication():
        x = DTensor.from_local(torch.empty(16, 8, 8, device="meta"), dm, [Replicate(), Shard(2)],
                               run_check=False, shape=(16, 8, 16), stride=(128, 16, 1))
        c = common.constrain_batch(x)
        assert c.placements == (Shard(0), Replicate()) and c.to_local().shape == (4, 8, 16)
        odd = DTensor.from_local(torch.empty(2, 8, device="meta"), dm, [Replicate(), Replicate()],
                                 run_check=False, shape=(2, 8), stride=(8, 1))
        assert common.constrain_batch(odd) is odd  # 2 rows do not split over 4
        part = DTensor.from_local(torch.empty(4, 8, device="meta"), dm, [Shard(0), Partial()],
                                  run_check=False, shape=(16, 8), stride=(8, 1))
        assert common.summed(part).placements == (Shard(0), Replicate())
        heads = DTensor.from_local(torch.empty(16, 10, device="meta"), dm, [Replicate(), Shard(1)],
                                   run_check=False, shape=(16, 20), stride=(20, 1))
        assert common.split_last(heads, 5, 4).placements == (Replicate(), Replicate())
        assert common.split_last(heads, 10, 2).placements == (Replicate(), Shard(1))
        merged = DTensor.from_local(torch.empty(4, 8, 20, device="meta"), dm, [Shard(0), Replicate()],
                                    run_check=False, shape=(16, 8, 20), stride=(160, 20, 1))
        wo = DTensor.from_local(torch.empty(10, 3, device="meta"), dm, [Shard(1), Shard(0)],
                                run_check=False, shape=(20, 12), stride=(12, 1))
        block = common.row_block(merged, wo)  # wo's rows on model: a slice; its data shard left to mm
        assert block.placements == (Shard(0), Shard(2)) and block.to_local().shape == (4, 8, 10)
        assert common.row_block(block, wo) is block
        w_in = DTensor.from_local(torch.empty(5, 6, device="meta"), dm, [Shard(0), Shard(1)],
                                  run_check=False, shape=(20, 12), stride=(12, 1))
        assert common.row_block(merged, w_in) is merged  # rows sharded on data only


def test_gathered_replicates_the_axes_of_a_dim():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="meta")
    with fake_device_mesh(mesh) as dm:
        x = to_dtensor(NamedSharding(mesh, P(("pod", "data"), "model")), torch.empty(8, 6, device="meta"), dm)
        assert common.gathered(x, 0).placements == (Replicate(), Replicate(), Shard(1))
        assert common.gathered(x, -1).placements == (Shard(0), Shard(0), Replicate())
        assert common.gathered(x).placements == (Replicate(),) * 3
        one = common.gathered(x, -1)
        assert common.gathered(one, 1) is one


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("slot", [3, 12])
def test_write_slot_on_each_ranks_block(rank, slot):
    """The decode cache sharded over its slot dim on 2 ranks: each rank's
    block after the block-by-block write is that block of ``index_copy_`` 's
    result on the whole cache."""
    gen = torch.Generator().manual_seed(slot)
    cache = torch.randn(2, 16, 3, 4, generator=gen)
    new = torch.randn(2, 1, 3, 4, generator=gen)
    idx = torch.tensor([slot])
    want = cache.clone().index_copy_(1, idx, new)
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank, world_size=2)
    try:
        dm = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
        block = cache[:, 8 * rank: 8 * rank + 8].clone()
        d = DTensor.from_local(block, dm, [Shard(1)], run_check=False, shape=cache.shape, stride=cache.stride())
        with implicit_replication():
            _write_slot_(d, DTensor.from_local(idx, dm, [Replicate()], run_check=False),
                         DTensor.from_local(new, dm, [Replicate()], run_check=False))
        assert torch.equal(block, want[:, 8 * rank: 8 * rank + 8])
    finally:
        dist.destroy_process_group()


def test_stacked_leaf_chunks_split_unsharded_rows(monkeypatch):
    """An optimizer leaf sharded over the mesh is not flattened: one view,
    or whole rows of its unsharded leading (layer) dim when its block is
    larger than ``CHUNK``; writes through the views reach the leaf."""
    monkeypatch.setattr(optimizer, "CHUNK", 16)
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    with fake_device_mesh(mesh) as dm:
        t = to_dtensor(NamedSharding(mesh, P(None, "data", "model")), torch.empty(6, 8, 4, device="meta"), dm)
        chunks = optimizer._chunks(t)
        assert [c.shape[0] for c in chunks] == [2, 2, 2] and all(c.placements == t.placements for c in chunks)
        for leaf in (torch.empty(8, 4, device="meta"), torch.empty(64, 4, device="meta")):
            d = to_dtensor(NamedSharding(mesh, P("data")), leaf, dm)
            (c,) = optimizer._chunks(d)  # a small block, or dim 0 sharded: one view
            assert c is d
    x = torch.zeros(6, 8, 4)
    with fake_device_mesh(make_mesh((2, 2), ("data", "model"), device="cpu")) as dm:
        d = to_dtensor(NamedSharding(mesh, P(None, "data", "model")), x, dm)
        for i, c in enumerate(optimizer._chunks(d)):
            c.add_(i + 1)
        assert torch.equal(d.to_local()[:, 0, 0], torch.tensor([1.0, 1, 2, 2, 3, 3]))
