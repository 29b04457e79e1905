"""Shared model building blocks: config, init, norms, RoPE (counterpart of
``repro.models.common``).

Models are plain nested dicts of tensors and pure functions, with the
reference's keys, so a reference params tree converts leaf for leaf
(``repro_torch.convert.params_from``).  ``ModelConfig`` keeps the
reference's fields; its ``param_dtype`` is a ``torch.dtype``.
``ModelConfig.n_params`` counts the elements of ``init_params_shapes``, the
transformer's params built on the ``meta`` device (shapes and dtypes, no
allocation, no draws).

Products follow ``jnp``'s type promotion (:func:`promoted`, :func:`mm`):
``torch.matmul`` and ``torch.einsum`` refuse mixed dtypes, where ``jnp``
computes a float32 operand against a bfloat16 one in float32.  The
activations are written as ``jax.nn`` composes them (``sigmoid`` as XLA
expands ``logistic``: ``1 / (1 + exp(-x))``), one rounding per operation in
the input's dtype, with scalar constants first rounded to that dtype as
``jnp`` does with weak types: in bfloat16 ``torch.nn.functional``'s fused
forms round once and differ from the reference in a third of the
elements.  RoPE's frequencies and the sinusoid scales are computed once
per device and cached, and the angles on the tensors' device, so a decode
step uploads nothing from the host.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

__all__ = [
    "ModelConfig",
    "ParamSpec",
    "batch_rows",
    "constrain_batch",
    "init_dense",
    "init_zeros",
    "param_device",
    "promoted",
    "fsdp_gathered",
    "gathered",
    "laid_out_as",
    "local_block",
    "model_block",
    "split_last",
    "whole_grad",
    "summed",
    "summed_grad",
    "axis_sum",
    "axis_gather",
    "split_axis",
    "row_block",
    "mm",
    "einsum",
    "even_heads",
    "embed_rows",
    "sigmoid",
    "silu",
    "gelu_tanh",
    "softplus",
    "rmsnorm",
    "apply_rope",
    "rope_freqs",
    "sinusoidal_rows",
    "init_params_shapes",
]

#: the mesh axes over which a weight's ``"embed"`` dim is FSDP-sharded
FSDP_AXES = ("pod", "data")


@dataclass(frozen=True)
class ModelConfig:
    """One config covers the whole assigned-architecture pool; unused fields
    are zero/None for a given family."""

    name: str
    kind: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # SWA / local-attention window
    attn_chunk: Optional[int] = None  # llama4-style chunked attention
    mlp_type: str = "swiglu"  # swiglu | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    shared_expert: bool = False
    expert_sharding: str = "tp"  # tp: TP inside experts | ep: experts over model axis
    moe_impl: str = "sort"  # sort: gather/scatter dispatch | einsum: GShard one-hot (baseline)
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4
    # --- hybrid (recurrentgemma): repeating block pattern ---
    block_pattern: Tuple[str, ...] = ("a",)  # 'a' attention | 'r' RG-LRU | 's' SSD
    rglru_width: int = 0  # recurrent branch width (0 -> d_model)
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 0  # precomputed frontend frames (stub)
    # --- VLM (qwen2-vl) ---
    n_patches: int = 0  # early-fusion patch embeddings (stub)
    # --- numerics ---
    norm_eps: float = 1e-6
    param_dtype: Any = torch.bfloat16
    vocab_pad_to: int = 256  # pad embedding tables for TP divisibility
    # --- notes for DESIGN/dry-run bookkeeping ---
    sub_quadratic: bool = False  # can run long_500k
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows: vocab padded for tensor-parallel divisibility
        (padded logits are masked out of the loss)."""
        if self.vocab_pad_to <= 1:
            return self.vocab
        return int(-(-self.vocab // self.vocab_pad_to) * self.vocab_pad_to)

    @property
    def n_params(self) -> int:
        """Total parameter count (for 6ND model-flops accounting), from the
        params tree built on the ``meta`` device."""
        return int(sum(t.numel() for t in _leaves(init_params_shapes(self))))

    def scaled(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# A parameter's logical axes (a parallel tree of axis tuples made at init).
ParamSpec = Tuple[str, ...]


def _batch_placements(x: DTensor):
    """The placements that pin ``x`` 's leading (batch) dim to the
    data-parallel mesh axes (``pod`` and ``data`` of size > 1) and replicate
    it on the rest, or None where there is no such axis or the batch does not
    divide their product."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    dp = [i for i, a in enumerate(names) if a in ("pod", "data") and mesh.size(i) > 1]
    if not dp or x.shape[0] % math.prod(mesh.size(i) for i in dp):
        return None
    return [Shard(0) if i in dp else Replicate() for i in range(mesh.ndim)]


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin the leading (batch) dim to the data-parallel mesh axes, as the
    reference's sharding constraint does under a mesh: a DTensor whose
    batch dim divides the product of its mesh's ``pod`` and ``data`` axes
    is redistributed to ``Shard(0)`` on those and replicated on the rest.
    The identity on a plain tensor, on a mesh without those axes (or with
    them of size 1) and on an indivisible batch (global_batch=1 decode).  Without it, the sharding
    DTensor propagates from the embedding gather may replicate the whole
    activation path (the reference measured ~16x per-chip compute and
    temporaries on train cells)."""
    if not isinstance(x, DTensor):
        return x
    pl = _batch_placements(x)
    return x if pl is None else x.redistribute(x.device_mesh, pl)


def batch_rows(fn, *ts: torch.Tensor):
    """``fn(*ts)`` for an ``fn`` whose output row ``b`` reads only row ``b``
    of each input (a gather or scatter within each sequence).  On DTensors
    it runs on the local blocks: every input pinned to the batch axes
    (:func:`constrain_batch`; replicated where the batch does not split)
    and each output a DTensor so placed.  Torch 2.11's DTensor plans no
    index into a batch sharded over two mesh axes, nor the backward of an
    index whose gradient is a partial sum, where each sequence's rows are
    on one chip all along.  A 16-bit partial sum is summed in float32
    (:func:`_summed_to`).  The identity, ``fn(*ts)``, on plain tensors."""
    first = next((t for t in ts if isinstance(t, DTensor)), None)
    if first is None:
        return fn(*ts)
    mesh = first.device_mesh
    pl = _batch_placements(first) or [Replicate()] * mesh.ndim
    local = [_summed_to(t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                                                             run_check=False), pl).to_local()
             for t in ts]
    out = fn(*local)

    def wrap(o):
        return DTensor.from_local(o, mesh, pl, run_check=False)

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def param_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where params drawn from ``gen`` live: the generator's device, or
    ``meta`` for ``None`` (shapes only)."""
    return torch.device("meta") if gen is None else gen.device


def init_zeros(gen: Optional[torch.Generator], shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=param_device(gen))


def init_dense(
    gen: Optional[torch.Generator],
    shape: Sequence[int],
    dtype: torch.dtype,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (default 1/sqrt(fan_in)),
    drawn in float32 from ``gen`` on the generator's device, then cast
    (with ``gen=None``: an empty ``meta`` tensor, no draw).  The draws are
    not the reference's (the JAX PRNG is not reproduced); the distribution
    is."""
    if gen is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    if scale is None:
        scale = 1.0 / np.sqrt(shape[0])
    # inverse CDF: u uniform on [Phi(-2), Phi(2)] -> sqrt(2)·erfinv(2u - 1)
    lo, hi = _norm_cdf(-2.0), _norm_cdf(2.0)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    t.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=gen)
    t.erfinv_().mul_(float(np.sqrt(2.0))).clamp_(-2.0, 2.0)
    return (t * scale).to(dtype)


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def promoted(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The operands cast to their promoted dtype, as ``jnp`` products do."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def fsdp_gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight's FSDP shards gathered before its product, as the
    reference's partitioner gathers them: a DTensor sharded on a ``pod`` or
    ``data`` mesh axis is redistributed to ``Replicate`` on those axes (its
    model-axis shards kept).  Left to DTensor, a product of batch-sharded
    rows with a weight sharded on the same axis may instead be split over
    the contraction: every chip then computes a slice of every row of the
    global batch, partial sums that are reduce-scattered at the full batch's
    size.  The identity on a plain tensor."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    names = mesh.mesh_dim_names or ()
    pl = [Replicate() if names[i] in FSDP_AXES and mesh.size(i) > 1 else p
          for i, p in enumerate(w.placements)]
    return w if pl == list(w.placements) else w.redistribute(mesh, pl)


def whole_grad(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` as it is; where its ``dim`` is whole on every chip, its
    gradient comes back whole along ``dim`` too (redistributed to ``x`` 's
    placements on its way back; no collective forward).  For a view whose
    backward splits ``dim``: attention's merge of the K groups' heads,
    whose gradient may come back sharded over the H heads (as ``wo`` 's
    rows are) over a model axis that does not divide K (2 groups on 4
    chips), which DTensor cannot split: :func:`summed_grad` where ``dim``
    is whole.  The identity on a plain tensor and where ``dim`` is
    sharded."""
    if isinstance(x, DTensor) and any(p.is_shard(dim % x.ndim) for p in x.placements):
        return x
    return summed_grad(x)


def _summed_to(x: DTensor, placements) -> DTensor:
    """``x`` redistributed to ``placements``, a partial sum of a 16-bit
    ``x`` summed in float32 and cast back, as the reference's lowering
    carries its collectives: each chip's bf16 partial sum is not rounded
    again before the sum (four chips' rounded bf16 partials miss the bf16
    step's own bound, mamba2's train step on (1, 4))."""
    if x.dtype in (torch.bfloat16, torch.float16) and any(p.is_partial() for p in x.placements):
        return x.float().redistribute(x.device_mesh, placements).to(x.dtype)
    return x.redistribute(x.device_mesh, placements)


def summed(x: torch.Tensor) -> torch.Tensor:
    """A product's partial sums completed where it is made: a DTensor with
    ``Partial`` placements (a contraction over a sharded dim) is
    all-reduced to ``Replicate`` on those mesh axes (in float32,
    :func:`_summed_to`), as the reference's partitioner reduces a dot's
    output.  Left partial, DTensor carries the sums into the residual
    stream and redistributes them again at every non-linear op that meets
    them.  The identity on a plain tensor."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return _summed_to(x, [Replicate() if p.is_partial() else p for p in x.placements])
    return x


class _SummedGrad(torch.autograd.Function):
    """:func:`summed_grad` on a DTensor: the identity forward; backward,
    the gradient redistributed to the input's placements (:func:`_summed_to`)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the gradient of a partial sum is whole, as DTensor's redistribute has it
        want = tuple(Replicate() if p.is_partial() else p for p in ctx.placements)
        if not isinstance(g, DTensor) or (g.device_mesh, g.placements) == (ctx.mesh, want):
            return g
        return _summed_to(g, want)


def summed_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is (no collective forward), its gradient completed where
    it is made: brought back to ``x`` 's own placements, so a ``Partial``
    sum over the model axis is all-reduced to ``Replicate`` there (in
    float32, :func:`_summed_to`).  :func:`summed` 's rule applied to the
    gradient, as the reference's partitioner reduces a dot's partial
    output backward as well as forward.  For the input of a
    column-parallel product (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``,
    ``lm_head``), replicated over the model axis, whose gradient the
    product returns as a partial sum: one all-reduce at the residual's
    width (B·S·D) per product, as the reference's lowering on ``Auto``
    mesh axes all-reduces each product's input gradient as its own operand
    (q, k and v's three in one combined all-reduce, gate and up's two in
    another; held by ``tests/test_torch_partition.py``).  Left partial,
    DTensor carries the sums through the norm and the residual into the
    next product's backward, which reduce-scatters them at that product's
    width.  The identity on a plain tensor."""
    return _SummedGrad.apply(x) if isinstance(x, DTensor) else x


def axis_sum(t: torch.Tensor, mesh, axis: int) -> torch.Tensor:
    """Each chip's partial sums ``t`` (a local tensor) summed over the mesh
    axis ``axis`` (an all-reduce on its group; 16-bit sums in float32,
    :func:`_summed_to`)."""
    partial = [Replicate()] * mesh.ndim
    partial[axis] = Partial()
    return _summed_to(DTensor.from_local(t, mesh, partial, run_check=False),
                      [Replicate()] * mesh.ndim).to_local()


def axis_gather(t: torch.Tensor, mesh, axis: int, dim: int) -> torch.Tensor:
    """Each chip's block ``t`` (a local tensor) gathered along ``dim`` over
    the mesh axis ``axis`` in the order of its chips (an all-gather on its
    group)."""
    pl = [Replicate()] * mesh.ndim
    pl[axis] = Shard(dim % t.ndim)
    return DTensor.from_local(t, mesh, pl, run_check=False).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()


def split_axis(mesh, axis: int, sizes: Sequence[int]):
    """A ``DeviceMesh`` over the same ranks as ``mesh`` with its axis
    ``axis`` split into sub-axes of ``sizes`` (the first major), named
    ``"<axis>.0"``, ``"<axis>.1"``, ...: its groups are parts of that axis
    (two KV heads over a model axis of 4 each on a pair of its chips),
    which no placement on ``mesh`` can name.  Made once per mesh and
    process group (every rank makes it at the same point of the step) and
    kept on the mesh: DTensor's cached shardings can hand back a mesh of
    an earlier group of the same shape, whose split is made anew."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    cache = mesh.__dict__.setdefault("_split_axes", {})
    key = (axis, tuple(sizes))
    hit = cache.get(key)
    if hit is None or hit[0] is not dist.group.WORLD:
        names = list(mesh.mesh_dim_names)
        shape = list(mesh.mesh.shape)
        hit = cache[key] = (dist.group.WORLD, DeviceMesh(
            mesh.device_type, mesh.mesh.reshape(*shape[:axis], *sizes, *shape[axis + 1:]),
            mesh_dim_names=(*names[:axis], *(f"{names[axis]}.{i}" for i in range(len(sizes))), *names[axis + 1:])))
    return hit[1]


def local_block(x: DTensor, dim: int, *others: DTensor):
    """For an update of ``x`` block by block along ``dim`` (DTensor has no
    in-place scatter at an index into a sharded dim): ``x`` 's local block,
    the global index of the block's first element along ``dim`` (this
    chip's coordinates on the mesh axes that shard it, the first major),
    and each of ``others`` laid out as ``x`` 's blocks but whole along
    ``dim``, as local tensors."""
    mesh, placements = x.device_mesh, x.placements
    d = dim % x.ndim
    block, first = x.to_local(), 0
    for i, p in enumerate(placements):
        if p.is_shard(d):
            if type(p) is not Shard:
                raise NotImplementedError(f"a strided sharding of dim {d}: {placements}")
            first = first * mesh.size(i) + mesh.get_local_rank(i)
    whole = [Replicate() if p.is_shard(d) else p for p in placements]
    return block, first * block.shape[d], [o.redistribute(mesh, whole).to_local() for o in others]


def gathered(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """A DTensor redistributed to ``Replicate`` on the mesh axes that shard
    ``dim`` (every axis when ``dim`` is None), for an op DTensor cannot run
    on a sharded ``dim``: an in-place scatter at a sharded index, an argmax
    over a sharded vocabulary, the embedding's lookup of every id.  The
    identity on a plain tensor and where nothing is gathered."""
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if (not p.is_replicate() if dim is None else p.is_shard(dim % x.ndim)) else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def even_heads(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` whose dim ``dim`` holds ``n`` heads: a DTensor sharded along it
    over mesh axes whose product does not divide ``n`` (40 heads over 16
    chips) is first gathered along it.  DTensor cannot split an uneven
    shard into heads, where the reference's partitioner pads it, and the
    strided sharding it makes of a gradient's heads instead sends every
    later op's planning to a graph search.  The identity on a plain
    tensor."""
    if isinstance(x, DTensor):
        d = dim % x.ndim
        if n % math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements) if p.is_shard(d)):
            x = gathered(x, d)
    return x


def laid_out_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` placed as ``like`` (a tensor of the same shape on the same
    mesh): where their placements differ, gathered whole first (the
    all-gathers of :func:`gathered`) and then sliced to ``like`` 's blocks
    (no collective), one path on every torch version, where DTensor's own
    redistribution between two shardings picks its path by version (the
    RG-LRU's decode state of the layers after the stacked groups, which
    the decode state's rule shards on the batch axes along its width).
    The identity on plain tensors and where the placements agree."""
    if not (isinstance(x, DTensor) and isinstance(like, DTensor)) or x.placements == like.placements:
        return x
    return gathered(x).redistribute(like.device_mesh, like.placements)


def row_block(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` for the product ``x @ w``, its last dim (the contraction)
    laid out as ``w`` 's rows on the tensor-parallel mesh axes: where ``w``
    's rows are sharded over such an axis and ``x`` is replicated on it,
    ``x`` takes its local block of the contraction (``Replicate`` ->
    ``Shard``: a slice, no collective), and :func:`mm` completes the
    partial sums.  So a row-parallel product (``wo``) runs on each chip's
    rows of the weight even where the heads do not divide the model axis,
    as the reference's partitioner slices the activation; its backward
    gathers the gradient's blocks.  The FSDP axes (:data:`FSDP_AXES`) are
    left to :func:`fsdp_gathered`.  The identity on plain tensors."""
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x
    names = x.device_mesh.mesh_dim_names or ()
    pl = [Shard(x.ndim - 1) if q.is_shard(0) and p.is_replicate() and names[i] not in FSDP_AXES else p
          for i, (p, q) in enumerate(zip(x.placements, w.placements))]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def model_block(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` sliced to each chip's block of its ``dim`` on the
    tensor-parallel mesh axes (those outside :data:`FSDP_AXES`, of size >
    1) where ``x`` is whole and the axis divides ``dim`` (``Replicate`` ->
    ``Shard``: a slice, no collective; its backward gathers the gradient's
    blocks), as the reference's partitioner slices a replicated activation
    to the heads a product runs on.  The identity on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    d = dim % x.ndim
    pl = [Shard(d) if p.is_replicate() and names[i] not in FSDP_AXES and mesh.size(i) > 1
          and x.shape[d] % mesh.size(i) == 0 else p for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``: the embedding's rows at the token ids, its
    gradient added into zeros like ``table`` at the ids, as autograd's own
    backward of the index.  On DTensors both run on local blocks
    (:class:`_EmbedRows`): the ids are gathered whole once, each chip
    looks them up in its block of the table (its columns of ``D`` on the
    FSDP axes, its rows of the vocabulary on the model axis, the rows
    outside it zeros: partial sums over that axis, completed there,
    :func:`summed`, as the reference's partitioner all-reduces its masked
    lookup), and its backward adds the gradient, its columns split as the
    table's, into that block.  Torch 2.11's DTensor plans no backward of
    the index with one microbatch on a data axis (``index_put`` on a
    sharded column).  The identity, ``table[tokens]``, on plain
    tensors."""
    if not isinstance(table, DTensor):
        return table[tokens]
    return summed(_EmbedRows.apply(table, tokens))


class _EmbedRows(torch.autograd.Function):
    """:func:`embed_rows` on a DTensor table: out of each chip's block, the
    rows ``(*tokens.shape, D)`` laid out on each mesh axis as the table's
    columns are (``Shard`` on the last dim where the table's ``D`` is
    sharded), ``Partial`` where its vocabulary is, replicated elsewhere."""

    @staticmethod
    def forward(ctx, table, tokens):
        block, first, _ = local_block(table, 0)
        ids = gathered(tokens).to_local() if isinstance(tokens, DTensor) else tokens
        mine = None
        if block.shape[0] != table.shape[0]:  # the vocabulary is sharded
            ids = ids - first
            mine = ((ids >= 0) & (ids < block.shape[0]))[..., None]
            ids = ids.clamp(0, block.shape[0] - 1)
        ctx.save_for_backward(ids, mine)
        ctx.table = (table.device_mesh, table.placements, table.shape, table.stride(), block.shape)
        rows = block[ids] if mine is None else torch.where(mine, block[ids], 0)
        pl = [Shard(rows.ndim - 1) if p.is_shard(1) else Partial() if p.is_shard(0) else Replicate()
              for p in table.placements]
        return DTensor.from_local(rows, table.device_mesh, pl, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        ids, mine = ctx.saved_tensors
        mesh, placements, shape, stride, block_shape = ctx.table
        g = grad.redistribute(mesh, [Shard(grad.ndim - 1) if p.is_shard(1) else Replicate()
                                     for p in placements]).to_local()
        if mine is not None:
            g = torch.where(mine, g, 0)
        block = g.new_zeros(block_shape).index_put_((ids,), g, accumulate=True)
        return DTensor.from_local(block, mesh, placements, run_check=False, shape=shape, stride=stride), None


def split_last(x: torch.Tensor, n: int, size: int) -> torch.Tensor:
    """``x`` (..., n * size) as (..., n, size), its ``n`` heads whole on
    every chip that holds any (:func:`even_heads`)."""
    x = even_heads(x, -1, n)
    return x.reshape(*x.shape[:-1], n, size)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype, the weight's FSDP shards gathered
    first (:func:`fsdp_gathered`), as the reference's partitioner gathers
    them: each chip multiplies its own batch rows by the whole contraction,
    autograd saves the gathered weight, so ``dx`` keeps the rows' batch
    shard, and the weight's gradient is reduce-scattered onto its shard
    once, at the gather's backward.  ``x`` is never gathered.  An ``x`` of
    more than two dims is folded to its rows first, one plain product as
    the reference's dot: ``torch.matmul`` folds it only where its strides
    chain, and a DTensor's merged decode heads (B, 1, H·hd) keep the size-1
    dim's stride of the (B, H, 1, hd) scores, so it would broadcast ``w``
    over the B rows into a batched product instead (B copies of ``w`` read,
    and held where DTensor shards the broadcast)."""
    x, w = promoted(x, fsdp_gathered(w))
    if x.ndim > 2 and w.ndim == 2:
        return summed(torch.matmul(x.reshape(-1, x.shape[-1]), w).view(*x.shape[:-1], w.shape[-1]))
    return summed(torch.matmul(x, w))


def einsum(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` in the promoted dtype."""
    return summed(torch.einsum(eq, *promoted(*ts)))


def _weak(c: float, dtype: torch.dtype) -> float:
    """A Python constant rounded to ``dtype``, as ``jnp`` casts a weakly
    typed scalar before the operation."""
    return float(torch.tensor(c, dtype=dtype))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``, as XLA expands ``logistic``."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` with its default tanh approximation, op for op."""
    c = _weak(float(np.sqrt(2 / np.pi)), x.dtype)
    cdf = _weak(0.5, x.dtype) * (1.0 + torch.tanh(c * (x + _weak(0.044715, x.dtype) * (x * (x * x)))))
    return x * cdf


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``jnp.logaddexp(x, 0)`` as jax writes it."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dim, in float32.  Where that dim is sharded
    (the SSD's gated norm over ``d_inner``), the mean's partial sums are
    completed at (B, S, 1), forward and backward (:func:`summed`,
    :func:`summed_grad`): left partial, the gradient is expanded to the
    full width first and reduce-scattered there."""
    dtype = x.dtype
    x = x.float()
    var = summed_grad(summed(torch.mean(x * x, dim=-1, keepdim=True)))
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(dtype)


@functools.lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float, device=torch.device("cpu")) -> torch.Tensor:
    """``1 / theta**(2i / head_dim)`` as float32 on ``device``: computed
    there in float64 and cast, as the reference casts its numpy table.
    One shared tensor per (head_dim, theta, device), so no call after the
    first computes or uploads it; do not write to it."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim
    return (1.0 / torch.pow(theta, exps)).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., S, H, hd); positions: (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sinusoid_scales(d_model: int, device: torch.device) -> torch.Tensor:
    """``10000**(2i / d_model)`` in float64 on ``device``, one shared tensor
    per (d_model, device)."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float64, device=device)
    return torch.pow(10_000.0, dim / d_model)


def sinusoidal_rows(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Rows ``positions`` of whisper's sinusoidal position table (sin in the
    even columns, cos in the odd), float32, computed in float64 on the
    positions' device (no table, no upload)."""
    pos = positions.to(torch.float64)[..., None]
    angle = pos / _sinusoid_scales(d_model, positions.device)
    out = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1)
    return out.reshape(*positions.shape, d_model).float()


def init_params_shapes(cfg: ModelConfig):
    """Shape-only params tree: ``init_params`` on the ``meta`` device."""
    from .transformer import init_params

    return init_params(None, cfg, device="meta")[0]
