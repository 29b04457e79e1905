"""The dry run's partitioned step for the MoE archs, which the reference
cannot lower under a mesh (``test_reference_cannot_lower_the_moe_cells``),
and the model code's DTensor forms that torch 2.11 needs to plan every
cell of the sweep:

* mixtral-8x7b and llama4-scout-17b-a16e SMOKE on (2, 1), (1, 2) and
  (2, 2): the temporaries, collectives and FLOPs on ``meta`` equal to the
  same step's on real CPU blocks, and no more strided shardings
  (``_StridedShard``, what torch 2.11 refuses) than qwen3-14b's step;
* one MoE block's collectives, forward and backward, worked out by hand;
* each form that a refusal on torch 2.11 called for, pinned on 2.13 by
  the placement it sets, and the identity on plain tensors (the
  embedding's lookup and its backward on local blocks too).

The helpers are ``test_torch_partition.py`` 's; this file holds no oracle
subprocess, so it can run on a worker of its own.
"""
import pytest
import torch
import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers the "fake" backend)
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config
from repro_torch.dist.sharding import NamedSharding, P, default_rules, fake_device_mesh, to_dtensor, \
    to_dtensors, tree_shardings
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import common, rglru, ssm
from repro_torch.models.attention import _merge_heads
from repro_torch.models.moe import init_moe, moe
from test_torch_partition import B, SHAPE_OF, _AllReducesByAxis, _short, assert_sharded_meta_equals_cpu

MOE_ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e")
MESHES = ((2, 1), (1, 2), (2, 2))
MODES = ("train", "prefill", "decode")


class _DTensorOps(TorchDispatchMode):
    """Each op run on DTensors (its inputs' placements) and how many of its
    outputs are strided shardings."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.strided = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            ins = [t.placements for t in tree_leaves((args, kwargs)) if isinstance(t, DTensor)]
            self.ops.append((func, ins))
            self.strided += sum(isinstance(t, DTensor) and any(isinstance(p, _StridedShard) for p in t.placements)
                                for t in tree_leaves(out))
        return out


def _strided_outputs(arch, mode, mesh) -> int:
    """The strided shardings that ``arch`` 's SMOKE step makes on ``mesh``
    (forward and backward) on ``meta``."""
    cfg = get_config(arch, smoke=True)
    m = make_mesh(mesh, ("data", "model"), device="meta")
    with pytest.MonkeyPatch.context() as mp, fake_device_mesh(m) as dm:
        _short(mp)
        step, args = dryrun.cell_step(cfg, SHAPE_OF[mode], m, dm, batch_override=B)
        seen = _DTensorOps()
        with torch.no_grad(), implicit_replication(), seen:
            step(*args)
    return seen.strided


# ---------------------------------------------------------------------------
# the MoE cells' plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_sharded_temporaries_on_meta_equal_real_cpu_tensors(arch, mode, mesh):
    """``test_sharded_temporaries_on_meta_equal_real_cpu_tensors`` for the
    MoE archs: the same temporaries, collectives and FLOPs on ``meta`` and
    on real CPU blocks, the bytes accessed within 0.1%."""
    assert_sharded_meta_equals_cpu(arch, mode, mesh)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_moe_steps_make_no_more_strided_shardings_than_qwen3(mode, mesh):
    """On the (1, 2) mesh (no data axis to pin to) qwen3's step makes
    strided shardings in attention's head products (240 in train, 12 in
    prefill, 2 in decode on torch 2.13; in train 24 of them in the
    backward's head products once q, k and v's input gradients are
    completed at their products, ``common.summed_grad``), which torch 2.11
    plans; the MoE steps make no more.  The decode cache of mixtral's sliding window and
    Scout's chunks is 16 slots at SMOKE width, as wide as a head, so the
    cache shards its head dim over the model axis; its attention output
    was merged across that shard (4 + 2 more) until ``_merge_heads``
    gathered it."""
    qwen = _strided_outputs("qwen3-14b", mode, mesh)
    assert qwen == {(1, 2): {"train": 240, "prefill": 12, "decode": 2}}.get(mesh, {}).get(mode, 0)
    for arch in MOE_ARCHS:
        assert _strided_outputs(arch, mode, mesh) <= qwen, arch


def _moe_block_counts(mesh_shape, shared: bool):
    """One MoE block forward and backward (``out.float().sum()``) on
    ``meta`` DTensors under the config's own ``expert_sharding="tp"`` rule:
    B 2 x S 8 tokens, D 8, F 8, E 2 experts, top-1, capacity C 5, bf16."""
    cfg = get_config("llama4-scout-17b-a16e", smoke=True).scaled(
        d_model=8, d_ff=8, n_experts=2, top_k=1, shared_expert=shared)
    mesh = make_mesh(mesh_shape, ("data", "model"), device="meta")
    params, specs = init_moe(None, cfg, device="meta")
    shardings = tree_shardings(specs, params, mesh, default_rules(mesh, expert_sharding=cfg.expert_sharding))
    x = torch.empty(2, 8, 8, dtype=torch.bfloat16, device="meta")

    def step(p, x):
        for t in (*tree_leaves(p), x):
            t.requires_grad_(True)
        with torch.enable_grad():
            out, _ = moe(p, cfg, x)
            out.float().sum().backward()
        return out

    with fake_device_mesh(mesh) as dm:
        args = to_dtensors((params, x), (shardings, NamedSharding(mesh, P("data"))), dm)
        counts, _ = dryrun.count_step(dryrun.StepCount(), step, args)
    return {k: (counts[f"{k}_count"], counts[f"{k}_bytes"]) for k in dryrun.COLLECTIVE_KINDS
            if counts[f"{k}_count"]}


@pytest.mark.parametrize("mesh,shared", [((1, 2), False), ((1, 2), True), ((2, 1), False)])
def test_moe_block_collectives_by_hand(mesh, shared):
    """B·E·C·D = 2·2·5·8 = 160 slot rows of bf16, 320 B, summed in float32
    (640 B).

    (1, 2), tensor parallel inside the experts: the router and the tokens
    are replicated, ``w_gate`` / ``w_up`` (E, D, F) shard F and ``w_down``
    (E, F, D) its F over the model axis.  Forward: the up products need no
    collective, the down product sums over the sharded F (partial sums),
    completed by one all-reduce of the (E, B·C, D) expert output where it
    is made (``common.summed``: in float32, 640 B).  Backward: the
    gradient of the up products' input sums over F again, all-reduced
    where it is made (``common.summed_grad``, 640 B); every weight
    gradient keeps its weight's shard.  With the shared expert its down product all-reduces
    the (B·S, D) output once more, and each of its two up products' input
    gradient, partial sums over F, is all-reduced where it is made
    (``common.summed_grad``): (B·S, D) bf16 partial sums each, summed in
    float32 (``common.summed``; 3 x 2·8·8·4 = 3 x 512 B).

    (2, 1), FSDP: the tokens and each weight's D are sharded over the
    data axis.  Forward: the router's (4, 2) float32 block is gathered
    (32 B, ``common.mm``) and each expert weight's 2·4·8 bf16 block (3 x
    128 B, ``common.fsdp_gathered``), so every chip runs its own
    sequence's slots against whole weights; the stats sum over the batch:
    all-reduces of ``tokens_per_expert.sum()`` (twice, 4 B each), of
    ``f·pbar`` 's (E,) float32 factor (8 B) and of ``slots_filled.sum()``
    (4 B).  Backward: every weight's gradient, partial sums over the
    batch, is reduce-scattered back onto its D shard at its gather's
    backward: the router's whole (8, 2) float32 operand (64 B) and each
    expert weight's 2·8·8 bf16 one (3 x 256 B); the tokens' gradient uses
    the gathered router autograd saved."""
    want = {
        ((1, 2), False): {"all-reduce": (2, 2 * 640)},
        ((1, 2), True): {"all-reduce": (5, 2 * 640 + 3 * 512)},
        ((2, 1), False): {"all-gather": (4, 32 + 3 * 128), "all-reduce": (4, 4 + 4 + 8 + 4),
                          "reduce-scatter": (4, 64 + 3 * 256)},
    }[(mesh, shared)]
    assert _moe_block_counts(mesh, shared) == want


# ---------------------------------------------------------------------------
# the forms torch 2.11 needs (each pinned by the placement it sets)
# ---------------------------------------------------------------------------


def test_moe_gathers_run_on_local_blocks():
    """The MoE's dispatch and combine gathers (``common.batch_rows``) run
    on local blocks: on a batch split over ``pod`` and ``data`` (torch 2.11
    plans no index into it) and on a tensor-parallel mesh (where 2.11 fails
    on the combine's backward), no index, scatter or index_put meets a
    DTensor, forward or backward (the top-k sort's backward scatters over
    the expert dim, which 2.11 plans)."""
    cfg = get_config("mixtral-8x7b", smoke=True)
    for shape, names in (((2, 2, 2), ("pod", "data", "model")), ((1, 2), ("data", "model"))):
        mesh = make_mesh(shape, names, device="meta")
        params, specs = init_moe(None, cfg, device="meta")
        shardings = tree_shardings(specs, params, mesh, default_rules(mesh))
        x = torch.empty(8, 16, cfg.d_model, dtype=torch.bfloat16, device="meta")
        with fake_device_mesh(mesh) as dm:
            p, xd = to_dtensors((params, x), (shardings, NamedSharding(mesh, P(tuple(n for n in names
                                                                                  if n != "model")))), dm)
            for t in tree_leaves(p):
                t.requires_grad_(True)
            seen = _DTensorOps()
            with implicit_replication(), seen:
                out, _ = moe(p, cfg, xd)
                out.float().sum().backward()
        indexing = [f for f, _ in seen.ops if f._overloadpacket in (
            torch.ops.aten.index, torch.ops.aten.index_put, torch.ops.aten.index_put_, torch.ops.aten.scatter_,
            torch.ops.aten._index_put_impl_)]
        assert not indexing and seen.ops, (shape, indexing)


def test_batch_rows_runs_on_each_chips_rows():
    """``batch_rows`` on a batch split over ``pod`` and ``data``: rank 0's
    block of the result is ``fn`` of rank 0's rows, the output pinned like
    the inputs; the identity on plain tensors."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 5, 3, generator=gen)
    idx = torch.randint(0, 5, (8, 4), generator=gen)

    def fn(x, idx):
        return x[torch.arange(x.shape[0])[:, None], idx], idx + 1

    want = fn(x, idx)
    got = common.batch_rows(fn, x, idx)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    with fake_device_mesh(mesh) as dm:
        sh = NamedSharding(mesh, P(("pod", "data")))
        rows, nxt = common.batch_rows(fn, to_dtensor(sh, x, dm), to_dtensor(sh, idx, dm))
        for d, w in ((rows, want[0]), (nxt, want[1])):
            assert d.placements == (Shard(0), Shard(0), Replicate()) and d.shape == w.shape
            assert torch.equal(d.to_local(), w[:2])


@pytest.mark.parametrize("form", ["plain", "partial"])
def test_batch_rows_sums_bf16_partials_in_float32(form):
    """A bf16 ``Partial`` input to ``batch_rows`` (partial sums over the
    model axis of (1, 2)) is summed in float32 and cast back
    (``common._summed_to``): one all-reduce of its 4·6·8 elements at 4
    bytes, a bf16 result on the batch placements; on plain bf16 tensors
    ``batch_rows`` is ``fn`` itself, bit for bit."""
    def fn(x, idx):
        return x[torch.arange(x.shape[0])[:, None], idx]

    if form == "plain":
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(4, 6, 8, generator=gen).to(torch.bfloat16)
        idx = torch.randint(0, 6, (4, 3), generator=gen)
        got = common.batch_rows(fn, x, idx)
        assert type(got) is torch.Tensor and torch.equal(got, fn(x, idx))
        return
    mesh = make_mesh((1, 2), ("data", "model"), device="meta")
    x = torch.empty(4, 6, 8, dtype=torch.bfloat16, device="meta")
    idx = torch.zeros(4, 3, dtype=torch.int64, device="meta")
    with fake_device_mesh(mesh) as dm:
        args = (DTensor.from_local(x, dm, [Replicate(), Partial()], run_check=False),
                DTensor.from_local(idx, dm, [Replicate(), Replicate()], run_check=False))
        counts, out = dryrun.count_step(dryrun.StepCount(), lambda *a: common.batch_rows(fn, *a), args)
    assert (counts["all-reduce_count"], counts["all-reduce_bytes"]) == (1, 4 * 6 * 8 * 4)
    assert out.dtype == torch.bfloat16 and out.placements == (Replicate(), Replicate()) and out.shape == (4, 3, 8)


def test_embed_rows_looks_up_and_adds_on_local_blocks():
    """``common.embed_rows`` on plain tensors is the index ``table[tokens]``
    itself, its rows and its gradient (repeated ids summed) bitwise.  On
    DTensors, the table laid out as a model's (``("vocab", "embed")``:
    its columns over ``data``, its rows over ``model``) and the ids as a
    batch: neither the lookup nor its backward runs an index, a scatter or
    an ``index_put`` on a DTensor (torch 2.11 plans no ``index_put`` of the
    gradient with one microbatch on a data axis); the rows are laid out as
    the table's columns on the data axes (whole on ``pod``, where the
    table is replicated) and completed over ``model``, the gradient of the
    table takes the table's placements and block.  On a (1, 2) CPU mesh
    rank 0's rows before the sum over ``model`` are the plain rows whose
    ids fall in its half of the vocabulary (zeros elsewhere), and its
    block of the gradient is the plain gradient's first half."""
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(16, 8, generator=gen).to(torch.bfloat16)
    tokens = torch.randint(0, 16, (4, 8), generator=gen, dtype=torch.int32)
    grad = torch.randn(4, 8, 8, generator=gen).to(torch.bfloat16)
    grads = []
    for f in (common.embed_rows, lambda t, i: t[i]):
        t = table.clone().requires_grad_(True)
        rows = f(t, tokens)
        rows.backward(grad)
        grads.append((rows.detach(), t.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])

    for shape, names in (((4, 1), ("data", "model")), ((2, 2), ("data", "model")),
                         ((2, 2, 2), ("pod", "data", "model"))):
        mesh = make_mesh(shape, names, device="meta")
        batch = tuple(n for n in names if n != "model")
        with fake_device_mesh(mesh) as dm:
            t = to_dtensor(NamedSharding(mesh, P("model", "data")), table.to("meta"), dm).requires_grad_(True)
            ids = to_dtensor(NamedSharding(mesh, P(batch)), tokens.to("meta"), dm)
            seen = _DTensorOps()
            with implicit_replication(), seen:
                rows = common.embed_rows(t, ids)
                common.constrain_batch(rows).float().sum().backward()
            want = [Replicate() if n == "pod" else Shard(2) if n == "data" else Replicate() for n in names]
            assert rows.placements == tuple(want), (shape, rows.placements)
            assert t.grad.placements == t.placements and t.grad.to_local().shape == t.to_local().shape
        indexing = [f for f, _ in seen.ops if f._overloadpacket in (
            torch.ops.aten.index, torch.ops.aten.index_put, torch.ops.aten.index_put_, torch.ops.aten.scatter_,
            torch.ops.aten.scatter_add_, torch.ops.aten._index_put_impl_, torch.ops.aten.embedding)]
        assert seen.ops and not indexing, (shape, indexing)

    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    with fake_device_mesh(mesh) as dm:
        t = to_dtensor(NamedSharding(mesh, P("model", "data")), table, dm).requires_grad_(True)
        ids = to_dtensor(NamedSharding(mesh, P("data")), tokens, dm)
        with implicit_replication():
            partial = common._EmbedRows.apply(t, ids)
            partial.backward(to_dtensor(NamedSharding(mesh, P()), grad, dm))
        mine = (tokens < 8)[..., None]
        assert partial.placements == (Replicate(), Partial())
        assert torch.equal(partial.to_local(), torch.where(mine, table[tokens], 0))
        assert torch.equal(t.grad.to_local(), grads[1][1][:8])


def test_fsdp_gathered_replicates_the_data_axes():
    """An expert weight's data-axis shards are gathered before its product
    (each chip then runs its own rows against whole experts, where DTensor
    had split the product over the contraction and reduce-scattered
    partial sums of the global batch); its model-axis shard is kept.  The
    identity on plain tensors and on a data axis of size 1."""
    w = torch.empty(4, 8, 6)
    assert common.fsdp_gathered(w) is w
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device="meta")
    with fake_device_mesh(mesh) as dm:
        d = to_dtensor(NamedSharding(mesh, P(None, "data", "model")), w.to("meta"), dm)
        assert common.fsdp_gathered(d).placements == (Replicate(), Replicate(), Shard(2))
    mesh = make_mesh((1, 2), ("data", "model"), device="meta")
    with fake_device_mesh(mesh) as dm:
        d = to_dtensor(NamedSharding(mesh, P(None, "data", "model")), w.to("meta"), dm)
        assert common.fsdp_gathered(d) is d


def test_rglru_gates_complete_the_product_before_the_bias():
    """``_gates`` ' products sum their partial sums (``mm``) before the
    bias is added: torch 2.11 cannot redistribute the bias, sharded like
    the product's columns, to a partial sum.  On plain tensors it is the
    same arithmetic as ``x @ w + b``."""
    gen = torch.Generator().manual_seed(0)
    W = 8
    p = {k: torch.randn(W, W, generator=gen) for k in ("w_a", "w_x")}
    p |= {k: torch.randn(W, generator=gen) for k in ("b_a", "b_x", "lam")}
    x = torch.randn(2, 3, W, generator=gen)
    a, b = rglru._gates(p, x)
    r = common.sigmoid(x @ p["w_a"] + p["b_a"])
    i = common.sigmoid(x @ p["w_x"] + p["b_x"])
    a_want = torch.exp(-rglru._C * common.softplus(p["lam"]) * r)
    assert torch.equal(a, a_want)
    assert torch.equal(b, torch.sqrt(torch.clamp(1.0 - a_want * a_want, min=1e-12)) * (i * x))
    mesh = make_mesh((1, 2), ("data", "model"), device="meta")
    with fake_device_mesh(mesh) as dm:
        ff = NamedSharding(mesh, P("model"))
        pd = {"w_a": to_dtensor(ff, p["w_a"].to("meta"), dm), "w_x": to_dtensor(ff, p["w_x"].to("meta"), dm)}
        pd |= {k: to_dtensor(ff, p[k].to("meta"), dm) for k in ("b_a", "b_x", "lam")}
        xd = to_dtensor(NamedSharding(mesh, P(None, None, "model")), x.to("meta"), dm)
        seen = _DTensorOps()
        with implicit_replication(), seen:
            rglru._gates(pd, xd)
    adds = [ins for f, ins in seen.ops if f is torch.ops.aten.add.Tensor]
    assert adds and not any(p.is_partial() for ins in adds for pl in ins for p in pl)


def test_ssd_cumsum_backward_flips_local_blocks():
    """The SSD's ``cumsum`` on a DTensor: its backward (the gradient
    flipped, summed, flipped back, as autograd's own) runs on each chip's
    block, so no ``flip`` meets a DTensor (torch 2.11 has no strategy for
    it); rank 0's block of the gradient is the plain gradient's.  On
    plain tensors it is ``torch.cumsum``."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(4, 6, 3, generator=gen)
    g = torch.randn(4, 6, 3, generator=gen)
    assert torch.equal(ssm._cumsum(a, 1), torch.cumsum(a, 1))
    plain = a.clone().requires_grad_(True)
    torch.cumsum(plain, 1).backward(g)
    mesh = make_mesh((2, 1), ("data", "model"), device="cpu")
    with fake_device_mesh(mesh) as dm:
        sh = NamedSharding(mesh, P("data"))
        ad = to_dtensor(sh, a, dm).requires_grad_(True)
        seen = _DTensorOps()
        with implicit_replication(), seen:
            out = ssm._cumsum(ad, 1)
            out.backward(to_dtensor(sh, g, dm))
        assert torch.equal(out.to_local(), torch.cumsum(a, 1)[:2])
        assert ad.grad.placements == (Shard(0), Replicate()) and torch.equal(ad.grad.to_local(), plain.grad[:2])
    assert seen.ops and not any(f is torch.ops.aten.flip.default for f, _ in seen.ops)


def test_ssd_chunk_products_run_on_each_chips_heads_and_state(monkeypatch):
    """mamba2's SMOKE SSD block (4 heads of 32, a state of 16, chunks of 8),
    forward and backward on a (2, 2) mesh, 4 x 32 tokens: the chunk loop
    (``ssm._scan``) runs on each chip's 2 heads and 8 of the state's dims
    (``ssm._ssd_local``), with the state whole for the heads' state (16).
    Over the model axis, forward: each chunk's scores ``C Bᵀ``, (rows, Q,
    Q), and the gated norm's mean, (rows, S, 1), are all-reduced, and
    ``w_out`` 's partial sums; backward: each chunk's score gradient, the
    gradient of ``C`` gathered whole over the state, and of ``B`` but in
    the last chunk, whose state no chunk reads, (rows, Q, N), the norm's,
    and ``w_in`` 's input gradient.  On plain tensors ``ssd_forward`` is
    the chunk loop op for op: bitwise the loop written out."""
    cfg = get_config("mamba2-780m", smoke=True)
    H, P_, N, d_inner, _ = ssm._dims(cfg)
    Q, Bsz, S = cfg.ssm_chunk, 4, 32
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    params, specs = ssm.init_ssd(None, cfg, device="meta")
    shardings = tree_shardings(specs, params, mesh, default_rules(mesh))
    u = torch.empty(Bsz, S, cfg.d_model, dtype=torch.bfloat16, device="meta")
    seen = []
    scan = ssm._scan

    def spy(x, Bm, Cm, dt, a, Q, N=None, **hooks):
        seen.append((x.shape, Bm.shape, N))
        return scan(x, Bm, Cm, dt, a, Q, N, **hooks)

    def step(p, u):
        for t in (*tree_leaves(p), u):
            t.requires_grad_(True)
        with torch.enable_grad():
            ssm.ssd_forward(p, cfg, u).float().sum().backward()

    rows = Bsz // 2
    sizes = [rows * Q * Q, rows * Q * N, rows * S, rows * S * cfg.d_model]
    with fake_device_mesh(mesh) as dm, monkeypatch.context() as mp:
        mp.setattr(ssm, "_scan", spy)
        args = to_dtensors((params, u), (shardings, NamedSharding(mesh, P("data"))), dm)
        counter = _AllReducesByAxis(dm, sizes)
        counts, _ = dryrun.count_step(counter, step, args)
    assert seen == [((rows, S, H // 2, P_), (rows, S, N // 2), N)]
    nc = S // Q
    assert {n: counts[f"all-reduce:model:{n}"] for n in sizes} == {
        rows * Q * Q: 2 * nc, rows * Q * N: 2 * nc - 1, rows * S: 2, rows * S * cfg.d_model: 2}
    assert counts["all-reduce:model:other"] == 0

    gen = torch.Generator().manual_seed(0)
    c32 = cfg.scaled(param_dtype=torch.float32)
    p, _ = ssm.init_ssd(gen, c32, device="cpu")
    u = torch.randn(2, S, c32.d_model, generator=gen)
    assert ssm._heads_axis(u, H, N) is None
    z, xbc, dt_raw = ssm._split_proj(p, c32, u)
    xbc, _ = ssm._causal_conv(xbc, p["conv_w"])
    xh, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    x = xh.reshape(2, S, H, P_)
    dt = common.softplus(dt_raw + p["dt_bias"])
    a = dt * -torch.exp(p["A_log"])
    h = torch.zeros(2, H, P_, N)
    ys = []
    for c in range(nc):
        q = slice(c * Q, (c + 1) * Q)
        xq, Bq, Cq, dtq, aq = x[:, q], Bm[:, q], Cm[:, q], dt[:, q], a[:, q]
        cum = torch.cumsum(aq, 1)
        y_off = torch.einsum("bqn,bhpn,bqh->bqhp", Cq, h, torch.exp(cum))
        Lmat = torch.exp(ssm._segsum(aq.transpose(1, 2)))
        y_diag = torch.einsum("bqs,bhqs,bsh,bshp->bqhp", torch.einsum("bqn,bsn->bqs", Cq, Bq), Lmat, dtq, xq)
        decay_tail = torch.exp(cum[:, -1:, :] - cum)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + torch.einsum("bqn,bqh,bqhp->bhpn", Bq, dtq * decay_tail,
                                                                          xq)
        ys.append(y_off + y_diag)
    y = torch.stack(ys, dim=1).reshape(2, S, H, P_) + x * p["D_skip"][None, None, :, None]
    y = common.rmsnorm(y.reshape(2, S, d_inner) * common.silu(z), p["norm"], c32.norm_eps)
    assert torch.equal(ssm.ssd_forward(p, c32, u), y @ p["w_out"])


def test_merge_heads_gathers_a_sharded_head_dim():
    """With no data axis to pin to, an attention output whose head dim is
    sharded (a 16-slot decode cache shards hd, as wide as its slots) is
    gathered along it before the heads merge: the merged dim is whole,
    where DTensor made a strided sharding of it."""
    mesh = make_mesh((1, 2), ("data", "model"), device="meta")
    out = torch.empty(4, 1, 4, 16, device="meta")
    with fake_device_mesh(mesh) as dm:
        d = to_dtensor(NamedSharding(mesh, P(None, None, None, "model")), out, dm)
        merged = _merge_heads(d)
        assert merged.shape == (4, 1, 64) and merged.placements == (Replicate(), Replicate())
        heads = to_dtensor(NamedSharding(mesh, P(None, None, "model")), out, dm)
        assert _merge_heads(heads).placements == (Replicate(), Shard(2))
    x = torch.randn(4, 1, 4, 16)
    assert torch.equal(_merge_heads(x), x.reshape(4, 1, 64))


def test_rglru_interleave_writes_block_by_block():
    """The RG-LRU scan's interleave of a batch- and width-sharded DTensor
    writes each chip's block, placed as its input, where DTensor made the
    output buffer replicated and gathered the whole batch into it (920 GB
    of all-gathers per chip in recurrentgemma's multi-pod ``train_4k``);
    rank 0's block is the interleave of rank 0's blocks.  On plain tensors:
    a0 b0 a1 b1 ..."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(4, 5, 6, generator=gen)
    b = torch.randn(4, 4, 6, generator=gen)
    want = torch.empty(4, 9, 6)
    want[:, 0::2], want[:, 1::2] = a, b
    assert torch.equal(rglru._interleave(a, b, 1), want)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    with fake_device_mesh(mesh) as dm:
        sh = NamedSharding(mesh, P("data", None, "model"))
        seen = _DTensorOps()
        with seen:
            out = rglru._interleave(to_dtensor(sh, a, dm), to_dtensor(sh, b, dm), 1)
        assert out.placements == (Shard(0), Shard(2)) and out.shape == want.shape
        assert torch.equal(out.to_local(), want[:2, :, :3])
    assert not seen.ops  # no op ran on DTensors: no buffer to gather into
