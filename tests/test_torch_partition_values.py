"""The partitioned step computes what the plain step computes.

The dry run (``repro_torch.launch.dryrun``) runs each cell's step on
DTensors over a fake process group, whose collectives move nothing; here
the same step runs on four real gloo ranks of this CPU
(``torch.multiprocessing.spawn``, a ``file://`` rendezvous under the test's
own ``tmp_path``), for qwen3-14b's SMOKE config on the (2, 2), (4, 1) and
(1, 4) meshes, with 6 query heads over 2 KV heads on (1, 4), whose
model axis divides neither (``wo`` 's 96 rows it does; each pair of chips
runs its KV head's whole group), for the other archs' SMOKE configs
(``F32_CELLS``: mamba2-780m, its SSD on each chip's heads and state,
prefill and train on (2, 2) and (1, 4); recurrentgemma-9b and
whisper-medium train on (2, 2)), and for attention's head groups
(``HEAD_CELLS``: qwen2-vl-72b's train step on (1, 4), its 2 KV heads each
on a pair of chips and the query heads split within it; 2 query heads
over one KV head on (1, 4), each chip one query head and half the head
dim): its params drawn from a seed (the inputs besides the tokens and
labels drawn with numpy too), placed with ``distribute_tensor`` by the dry
run's own shardings, its batch drawn with numpy.  Each output, gathered
whole, is held to the same step on plain tensors with the same microbatch
count: the prefill step's last-position logits; the train step's loss,
gradient norm and first moments (one AdamW step from zeros makes each
``m`` (1 - b1) times the clipped gradient, so ``m`` holds the gradients as
each chip's shard of them was synced).  The bound is twice the plain
step's own gap between bf16 and float32 params (the same draws, the
config's ``param_dtype`` float32), as the gradient bounds of
``tests/test_torch_trainstep.py`` are twice a measured gap; the bf16
partial sums over a mesh axis are summed in float32, as the reference's
lowering sums them.  The other archs' cells, the uneven heads and the
head groups also run with float32 params, held to the plain float32 step
within ``F32_BOUND``: the partitioned step is the plain step's arithmetic
in another order.  All 28 runs are in one spawn of four ranks.
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, input_specs
from repro_torch.dist.sharding import NamedSharding, _map, default_rules, placements
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_params
from repro_torch.train.trainstep import init_train_state

ARCH = "qwen3-14b"
MESHES = ((2, 2), (4, 1), (1, 4))
MODES = ("prefill", "train")
#: qwen3's SMOKE config with heads the model axis does not divide: 6 query
#: heads over 2 KV heads on (1, 4), so that ``wo`` runs on its row shard
#: (``common.row_block``) where the heads do not split
UNEVEN = {"n_heads": 6, "n_kv_heads": 2}
UNEVEN_MESH = (1, 4)
#: qwen3's SMOKE config with 2 query heads over one KV head: on (1, 4) each
#: chip runs one query head against half the head dim of v
HD_SPLIT = {"n_heads": 2, "n_kv_heads": 1}
#: a variant's ``ModelConfig.scaled`` overrides of qwen3's SMOKE config
VARIANTS = {"uneven": UNEVEN, "hd-split": HD_SPLIT}
#: the other archs' cells, (mesh, mode, arch): mamba2's SSD on each chip's
#: heads and state, recurrentgemma's RG-LRU and one-KV-head attention,
#: whisper's encoder-decoder; each run with float32 params too
ARCH_CELLS = [(m, mode, "mamba2-780m") for m in ((2, 2), (1, 4)) for mode in MODES] + \
    [((2, 2), "train", "recurrentgemma-9b"), ((2, 2), "train", "whisper-medium")]
#: attention's head groups on (1, 4): qwen2-vl's 2 KV heads each on a pair
#: of chips, the KV's gradients summed over the pair; one KV head and 2
#: query heads, each chip one query head and half of v's head dim
HEAD_CELLS = [((1, 4), "train", "qwen2-vl-72b")] + [((1, 4), mode, "hd-split") for mode in MODES]
#: every cell also run with float32 params
F32_CELLS = ARCH_CELLS + [(UNEVEN_MESH, mode, "uneven") for mode in MODES] + HEAD_CELLS
#: each arch's (or variant's) bound on its plain step's bf16-vs-float32
#: gap, about twice its largest measured (mamba2 0.049 in train, 0.016 in
#: prefill; recurrentgemma 0.025; whisper 0.013; the hd-split variant's
#: train step 0.0186 on torch 2.13 and 0.0201 on 2.11), as qwen3's 2e-2
#: is (qwen2-vl 0.010)
GAP_BELOW = {"mamba2-780m": 0.1, "recurrentgemma-9b": 0.05, "whisper-medium": 0.03, "hd-split": 0.04}
#: every cell run in bf16: (mesh, mode) at the SMOKE config, (mesh, mode,
#: "uneven") with UNEVEN, ARCH_CELLS and HEAD_CELLS
CELLS = [(m, mode) for m in MESHES for mode in MODES] + [(UNEVEN_MESH, mode, "uneven") for mode in MODES] + \
    ARCH_CELLS + HEAD_CELLS
#: the float32 partitioned step's largest error relative to the plain
#: float32 step's largest output: sums taken in another order (3.3e-6
#: measured on the four gloo ranks)
F32_BOUND = 1e-5
SHAPE_OF = {"train": "train_4k", "prefill": "prefill_32k"}
B, S = 16, 64
WORLD = 4
SEED = 0


@contextlib.contextmanager
def _short():
    """Every shape at ``S`` tokens."""
    saved = dict(SHAPES)
    SHAPES.update({n: ShapeSpec(v.name, S, v.global_batch, v.mode) for n, v in saved.items()})
    try:
        yield
    finally:
        SHAPES.update(saved)


def _cell(mode, mesh_shape, param_dtype=torch.bfloat16, grad_accum=None, variant=None):
    """The cell's step as the dry run builds it (its microbatch count
    too, unless ``grad_accum`` is given), its real arguments on the CPU
    and their shardings (``variant`` ``"uneven"``: at the UNEVEN heads;
    else an arch's name: its SMOKE config, and its inputs besides the
    tokens and labels drawn as float32 normals)."""
    arch = ARCH if variant is None or variant in VARIANTS else variant
    cfg = get_config(arch, smoke=True).scaled(param_dtype=param_dtype, **VARIANTS.get(variant, {}))
    mesh = make_mesh(mesh_shape, ("data", "model"), device="meta")
    rules = default_rules(mesh, expert_sharding=cfg.expert_sharding)
    with _short():
        step, _, shardings, _, grad_accum = dryrun._cell_parts(cfg, SHAPE_OF[mode], mesh, rules, B, grad_accum)
    params, _ = init_params(torch.Generator().manual_seed(SEED), cfg.scaled(param_dtype=torch.bfloat16),
                            device="cpu")
    params = _map(lambda t: t.to(param_dtype) if t.is_floating_point() and t.dtype == torch.bfloat16 else t,
                  params, lambda t: isinstance(t, torch.Tensor))  # float32: the bf16 draws, widened
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)) for k in ("tokens", "labels")}
    with _short():
        specs = input_specs(cfg, SHAPE_OF[mode], B)["batch"]
    batch.update({k: torch.from_numpy(rng.standard_normal(v.shape, dtype=np.float32)).to(v.dtype)
                  for k, v in specs.items() if k not in batch})
    args = (params, batch) if mode == "prefill" else (init_train_state(params), batch)
    return step, args, shardings, grad_accum


def _outputs(mode, out):
    """The outputs held to the plain step's, whole, in float32."""
    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach().float()

    if mode == "prefill":
        return {"logits": whole(out)}
    state, metrics = out
    res = {"loss": whole(metrics["loss"]), "grad_norm": whole(metrics["grad_norm"])}
    leaves = []
    _map(leaves.append, state.opt.m, lambda t: isinstance(t, torch.Tensor))
    res.update({f"m{i}": whole(t) for i, t in enumerate(leaves)})
    return res


def _worker(rank, init_file, out_dir):
    """One gloo rank: every cell's step on DTensors; rank 0 saves the
    gathered outputs."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=WORLD)
    try:
        results, meshes = {}, {}
        for cell, dt in [(c, torch.bfloat16) for c in CELLS] + [(c, torch.float32) for c in F32_CELLS]:
            mesh_shape, mode = cell[:2]
            if mesh_shape not in meshes:
                meshes[mesh_shape] = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
            dm = meshes[mesh_shape]
            step, args, shardings, _ = _cell(mode, mesh_shape, dt, variant=cell[2] if len(cell) > 2 else None)
            args = _map(lambda sh, x: distribute_tensor(x, dm, placements(sh, dm.mesh_dim_names)),
                        shardings, lambda s: isinstance(s, NamedSharding), args)
            with torch.no_grad(), implicit_replication():
                results[cell if dt == torch.bfloat16 else cell + ("f32",)] = _outputs(mode, step(*args))
        if rank == 0:
            torch.save(results, f"{out_dir}/partitioned.pt")
    finally:
        dist.destroy_process_group()


def _partitioned(tmp) -> dict:
    """Every cell's outputs from the four gloo ranks (rendezvous in ``tmp``)."""
    mp.spawn(_worker, args=(f"{tmp}/rendezvous", str(tmp)), nprocs=WORLD, join=True)
    return torch.load(f"{tmp}/partitioned.pt")


@pytest.fixture(scope="module")
def partitioned(tmp_path_factory):
    return _partitioned(tmp_path_factory.mktemp("gloo"))


@pytest.fixture(scope="module")
def plain():
    return _plain()


def _plain() -> dict:
    """The plain step's outputs in bf16 and float32 for each cell, with
    the mesh's microbatch count (one run for each count and config)."""
    runs, out = {}, {}
    for cell in CELLS + [c for c in F32_CELLS if c not in CELLS]:
        mesh_shape, mode, variant = *cell[:2], (cell[2] if len(cell) > 2 else None)
        ga = _cell(mode, mesh_shape, variant=variant)[3]
        if (mode, ga, variant) not in runs:
            runs[(mode, ga, variant)] = []
            for dt in (torch.bfloat16, torch.float32):
                step, args, _, _ = _cell(mode, (1, 1), dt, ga, variant)
                with torch.no_grad():
                    runs[(mode, ga, variant)].append(_outputs(mode, step(*args)))
        out[cell] = runs[(mode, ga, variant)]
    return out


def _gap(bf16, f32) -> float:
    """The plain step's bf16-against-float32 gap: the largest over its
    outputs of max|Δ| / max|bf16|."""
    return max(float((bf16[k] - f32[k]).abs().max() / bf16[k].abs().max()) for k in bf16)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_partitioned_step_matches_plain_step(partitioned, plain, mesh, mode):
    """Each output within twice the plain step's relative gap times its own
    max|bf16|, as ``GRAD_ATOL_REL_BY_ARCH`` bounds each gradient leaf:
    the worst output's gap (the first moments', ~1.2e-2; the logits',
    7.9e-3) sets the bound of all, since a scalar's own gap (the loss's,
    1.0e-5 of it) is one sample of the rounding, not its size."""
    _assert_within_twice_the_gap(partitioned[(mesh, mode)], *plain[(mesh, mode)])


@pytest.mark.parametrize("mode", MODES)
def test_uneven_heads_partitioned_step_matches_plain_step(partitioned, plain, mode):
    """The UNEVEN heads on (1, 4): the partitioned step, with ``wo`` on its
    row shard and each column-parallel product's input gradient
    all-reduced where it is made, within the same bound."""
    cell = (UNEVEN_MESH, mode, "uneven")
    _assert_within_twice_the_gap(partitioned[cell], *plain[cell])


@pytest.mark.parametrize("cell", ARCH_CELLS, ids=lambda c: f"{c[2]}-{c[1]}-{c[0][0]}x{c[0][1]}")
def test_other_archs_partitioned_step_matches_plain_step(partitioned, plain, cell):
    """mamba2 with its SSD on each chip's heads and state (its chunks'
    scores and the gated norm's mean all-reduced over the model axis; its
    train step on (1, 4) too, since the bf16 partial sums are summed in
    float32), recurrentgemma with its query heads split over the model
    axis around one KV head, and whisper's encoder-decoder: each
    partitioned step within the same bound of its plain step."""
    _assert_within_twice_the_gap(partitioned[cell], *plain[cell], GAP_BELOW[cell[2]])


@pytest.mark.parametrize("cell", HEAD_CELLS, ids=lambda c: f"{c[2]}-{c[1]}-{c[0][0]}x{c[0][1]}")
def test_head_groups_partitioned_step_matches_plain_step(partitioned, plain, cell):
    """Attention on each chip's share of the heads where the model axis
    does not divide the KV heads (``attention._head_groups``): qwen2-vl's
    KV heads each on a pair of chips with the query heads split within
    the pair, one KV head's 2 query heads over 4 chips with v's head dim
    split in two; within the same bound of the plain step."""
    _assert_within_twice_the_gap(partitioned[cell], *plain[cell], GAP_BELOW.get(cell[2], 2e-2))


@pytest.mark.parametrize("cell", F32_CELLS, ids=lambda c: f"{c[2]}-{c[1]}-{c[0][0]}x{c[0][1]}")
def test_other_archs_float32_partitioned_step_matches_plain_step(partitioned, plain, cell):
    """The other archs' cells, the uneven heads and the head groups with
    float32 params: each output of the partitioned step within
    ``F32_BOUND`` times the plain float32 step's largest, the partitioned
    step the plain step's arithmetic in another order (the SSD's scores
    summed over the state's blocks, the row-parallel products' partial
    sums, the KV's gradients summed over each head's chips)."""
    got, want = partitioned[cell + ("f32",)], plain[cell][1]
    assert set(got) == set(want)
    for k in got:
        ref = float(want[k].abs().max())
        assert torch.isfinite(got[k]).all() and ref > 0, k
        assert float((got[k] - want[k]).abs().max()) <= F32_BOUND * ref, k


def _assert_within_twice_the_gap(got, bf16, f32, gap_below=2e-2):
    assert set(got) == set(bf16) == set(f32)
    gap = _gap(bf16, f32)
    assert 1e-3 < gap < gap_below, gap
    for k in got:
        ref = float(bf16[k].abs().max())
        err = float((got[k] - bf16[k]).abs().max())
        assert torch.isfinite(got[k]).all() and ref > 0, k
        assert err <= 2 * gap * ref, (k, err / ref, gap)


if __name__ == "__main__":
    # each bf16 cell's worst output error as a share of its bound, twice
    # the plain step's bf16-vs-float32 gap (1.0 at the bound):
    # PYTHONPATH=src python tests/test_torch_partition_values.py
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        got = _partitioned(tmp)
    want = _plain()
    for cell in CELLS:
        bf16, f32 = want[cell]
        share = max(float((got[cell][k] - bf16[k]).abs().max() / bf16[k].abs().max()) for k in bf16)
        print(cell, f"gap {_gap(bf16, f32):.4g}", f"error / bound {share / (2 * _gap(bf16, f32)):.3f}")
