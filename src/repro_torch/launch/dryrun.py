"""Dry run on ``meta`` (counterpart of ``repro.launch.dryrun``): for every
(architecture x input shape x mesh) cell, build the FSDP + tensor-parallel
shardings from ``dist.sharding``'s rule table over the production mesh's
256 or 512 logical devices, and report what one chip holds, computes,
accesses and communicates.

The reference lowers and compiles each cell with GSPMD on 512 fake host
devices and reads the partitioned program.  Here the partitioned program
is the real step (``make_train_step``, ``make_prefill_step`` or
``make_serve_step``) run on DTensors: a fake process group of the mesh's
size (``dist.sharding.fake_device_mesh``, this process rank 0), every
argument a DTensor whose local tensor is rank 0's ``meta`` block
(``dist.sharding.to_dtensors``), and every tensor the step makes itself
taken as replicated where it meets one (``implicit_replication``).
DTensor runs each op as local ops and collectives on rank 0's blocks, and
:class:`StepCount` counts those:

* ``memory_analysis.argument_bytes`` / ``output_bytes``: exact per chip,
  the sum over every argument (output) of its ``shard_shape`` 's bytes.
  The steps update their state in place and return it, so the outputs are
  the state plus the new metrics, token or logits (these replicated, the
  token batch-sharded, the logits ``("batch", "vocab")``).
* ``memory_analysis.temp_bytes``, ``flops_per_chip``,
  ``bytes_accessed_per_chip`` and ``collectives``: counted over the local
  ops (:data:`NOTES` says what each counts).  Every layer is counted,
  where XLA counted a scan body once: the step runs at one and at two
  layer groups per stack and the difference, which every group repeats
  with the same shapes, is extended to the full depth (a whole 40-layer
  32k prefill would take minutes on ``meta``).

:func:`argument_bytes` gives the per-chip argument bytes alone, without
running the step.  Results are cached per cell as JSON under
``results/dryrun_torch/``.  Importing this module changes nothing, and
the run sets no CUDA environment: it computes on ``meta`` only.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

from .._device import map_tensors
from ..configs import ARCH_IDS, get_config
from ..configs.shapes import SHAPES, applicable, input_specs
from ..dist.sharding import (
    NamedSharding,
    P,
    _axes_tuple,
    _is_sharding,
    _map,
    batch_sharding,
    default_rules,
    fake_device_mesh,
    spec_for,
    to_dtensors,
    tree_shardings,
)
from ..models import ModelConfig, init_params
from ..train.optimizer import AdamWState
from ..train.servestep import make_prefill_step, make_serve_step
from ..train.trainstep import TrainState, init_train_state, make_train_step
from .mesh import Mesh, make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

NOTES = {
    "flops_per_chip": "FLOPs of torch.utils.flop_counter's registry (the products) over rank 0's local "
                      "ops of the step run on DTensors, every layer counted",
    "bytes_accessed_per_chip": "the tensor inputs and outputs of every local op, summed, unfused (an op "
                               "that returns a view moves nothing): an upper bound on XLA's figure, "
                               "which is after fusion",
    "temp_bytes": "peak of the bytes of the local storages alive over the step (views and in-place "
                  "updates make none), and of the temporaries the softmax backward's and logsumexp's "
                  "kernels allocate inside themselves, less the arguments'",
    "collectives": "the collectives DTensor issues on rank 0, by the reference's kinds, each its input's "
                   "bytes (a local block for an all-gather, the whole operand otherwise; its elements "
                   "in collective_elements_by_kind), every layer's and microbatch's; DTensor on a CPU "
                   "mesh issues an all-to-all as an all-gather of the same input",
}


# ---------------------------------------------------------------------------
# what one chip does over a step
# ---------------------------------------------------------------------------


#: the reference's collective kinds (``parse_collectives``)
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
_COMM_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor")
#: ops of those namespaces that move no data
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd", "mesh_get_process_group")
_KIND_BY_NAME = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
                 ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                 ("send", "collective-permute"), ("recv", "collective-permute"),
                 ("p2p", "collective-permute"))


def collective_kind(func) -> Optional[str]:
    """The reference's kind of a torch collective op, None for any other op.
    An op of the collective namespaces that no kind covers raises, so no
    collective goes uncounted."""
    if func.namespace not in _COMM_NAMESPACES:
        return None
    name = func._schema.name.split("::")[1]
    if name in _NOT_COLLECTIVES:
        return None
    for part, kind in _KIND_BY_NAME:
        if part in name:
            return kind
    raise NotImplementedError(f"no collective kind for {func}")


def _tensors(tree):
    """The tensors of a tree of tuples, lists and dicts (an op's arguments,
    a step's state)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (rank 0's block); the tensor an async
    collective's result wraps (the wrapper holds no storage of its own); a
    plain tensor itself."""
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.elem if isinstance(t, AsyncCollectiveTensor) else t


def _nbytes(tree) -> int:
    """The bytes of a tree's tensors (a DTensor's local tensor's)."""
    return sum(t.numel() * t.element_size() for t in map(_local, _tensors(tree)))


def _tensor_key(x: torch.Tensor):
    if isinstance(x, DTensor):
        local = x._local_tensor
        if local.device.type != "meta" or not _plain_placements(x):
            raise TypeError("not on meta, or a placement with state")
        return (x.device_mesh, tuple(x.placements), tuple(x.shape), x.stride(), x.dtype,
                tuple(local.shape), local.stride())
    if x.device.type != "meta":
        raise TypeError("not on meta")
    return (tuple(x.shape), x.stride(), x.dtype)


def _first_tensor(args, kwargs):
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    return b
    return None


def _plain_placements(x: DTensor) -> bool:
    """No placement of ``x`` carries state of its own (DTensor's masked
    partial of a sharded gather holds the mask its reduction applies), so
    an op on it can be replayed."""
    return all(isinstance(p, Shard) or type(p) in (Replicate, Partial) for p in x.placements)


def _out_meta(t: torch.Tensor, base: Optional[torch.Tensor], key: int):
    """What rebuilds an op's output on ``meta``: its spec (a DTensor's),
    whether it is a view of ``base`` (the op's first tensor argument's
    local tensor), shape, stride, offset into ``base`` or into a storage
    of its own, that storage's elements (an output can be a view into a
    larger storage the op made, as a chunk of a gathered block is), dtype
    and memo key."""
    local = _local(t)
    spec = t._spec if isinstance(t, DTensor) else None
    st = local.untyped_storage()
    if base is not None and st._cdata == base.untyped_storage()._cdata:
        return (spec, True, tuple(local.shape), local.stride(),
                local.storage_offset() - base.storage_offset(), 0, local.dtype, key)
    return (spec, False, tuple(local.shape), local.stride(), local.storage_offset(),
            st.nbytes() // local.element_size(), local.dtype, key)


def _softmax_backward_temporaries(args, out) -> int:
    """The softmax backward's ``grad * output`` and a contiguous copy of
    each input that is not contiguous."""
    return _nbytes(out) + sum(_nbytes(t) for t in _tensors(args) if not t.is_contiguous())


#: ops whose kernel allocates temporaries inside itself, beside its output,
#: and their bytes from the op's arguments and output (measured op by op on
#: the card: the allocator's peak inside the op over what it returns).  The
#: tracker sees only what an op returns, so these add to the peak while
#: they run.
_KERNEL_TEMPORARIES = {
    torch.ops.aten._softmax_backward_data.default: _softmax_backward_temporaries,
    # ``self - max`` at the input's size, exponentiated in place and summed
    torch.ops.aten.logsumexp.default: lambda args, out: _nbytes(args[0]),
}

#: the op that wraps a collective's result for autograd (torch 2.13; 2.11
#: wraps it without an op): an alias on a real device, but a fresh tensor
#: on ``meta`` (its fake kernel), which the tracker would count twice
_WRAP_FOR_AUTOGRAD = getattr(torch.ops._c10d_functional, "_wrap_tensor_autograd", None)

_FAKE = torch._C._TorchDispatchModeKey.FAKE
_IN_PLACE = "in place"


class _Live:
    """The storages one run holds: bytes now, and the peak."""

    def __init__(self):
        self.nbytes: Dict[int, int] = {}
        self.now = self.peak = 0

    def free(self, key: int) -> None:
        self.now -= self.nbytes.pop(key)


#: the counts a run adds up (``StepCount.counts``)
COUNTS = ("flops", "bytes_accessed", "temp_bytes", *(f"{k}_bytes" for k in COLLECTIVE_KINDS),
          *(f"{k}_elements" for k in COLLECTIVE_KINDS), *(f"{k}_count" for k in COLLECTIVE_KINDS))


class StepCount(TorchDispatchMode):
    """What one chip does over a step, counted op by op on the local tensors
    (a DTensor op is left to DTensor, which runs it as local ops and
    collectives on rank 0's blocks, and those are counted):

    * ``flops``: an op in ``torch.utils.flop_counter.flop_registry`` adds
      its registered FLOPs (``FlopCounterMode`` 's count); any other op is
      decomposed where it has a decomposition and its parts counted;
    * ``bytes_accessed``: each op's tensor inputs and outputs (an op that
      returns a view or alias of its input moves nothing);
    * collectives by the reference's kinds (:func:`collective_kind`), each
      its input's bytes: a local block for an all-gather, the whole
      operand for a reduce-scatter, all-reduce or all-to-all;
    * ``temp_bytes``: the peak of the bytes of the storages alive over the
      run (views share their base's; an in-place update makes none), less
      the arguments'.  Storages are followed by weak references.  A
      kernel's own temporaries are invisible here, except those of
      :data:`_KERNEL_TEMPORARIES`.

    On ``meta`` inputs a functional op, or an in-place update that keeps
    its tensor's shape (a local op, or one on DTensors), is remembered by
    its inputs' shapes, strides, dtypes and placements, so a
    repeat (the flash path runs the same few dozen ops 2,048 times a layer
    at 32k) makes empty ``meta`` outputs and adds the counts the first run
    of it added, the peak it reached included, instead of running the op's
    meta function or DTensor's sharding propagation again.  The memo lasts
    as long as the mode; :meth:`start` begins a run."""

    def __init__(self):
        super().__init__()
        self._memo: Dict = {}
        self._ids: Dict = {}  # a tensor's full key -> its number
        self._kinds: Dict = {}
        self._pass = False
        self.start(())

    def start(self, args) -> None:
        """Zero the counts and take ``args`` ' storages as the arguments.  Only
        ops on the arguments' device type are the step's."""
        first = next(_tensors(args), None)
        self.device = "meta" if first is None else first.device.type
        self.c = dict.fromkeys(COUNTS, 0)
        self._live = _Live()
        self._track(args)
        self.argument_bytes = self._live.now

    def counts(self) -> Dict[str, int]:
        return {**self.c, "temp_bytes": self._live.peak - self.argument_bytes}

    def _track(self, tree) -> None:
        live = self._live
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            key = st._cdata
            if key not in live.nbytes:
                live.nbytes[key] = st.nbytes()
                live.now += live.nbytes[key]
                weakref.finalize(st, live.free, key)
        live.peak = max(live.peak, live.now)

    def _key_of(self, x):
        """A memo key of an op's argument.  A tensor's is a small number for
        its shape, strides, dtype and placements, kept on the tensor (and
        dropped when an op mutates it): the flash path meets the same few
        dozen in every block."""
        if isinstance(x, torch.Tensor):
            attrs = x.__dict__
            kept = attrs.get("_dryrun_key")
            if kept is not None and kept[0] is self._ids:
                return kept[1]
            full = _tensor_key(x)
            key = self._ids.setdefault(full, len(self._ids))
            attrs["_dryrun_key"] = (self._ids, key)
            return key
        if isinstance(x, (list, tuple)):
            return tuple([self._key_of(v) if isinstance(v, (torch.Tensor, list, tuple)) else v for v in x])
        return x

    def _rebuild(self, meta, base: Optional[torch.Tensor]):
        spec, view, shape, stride, offset, numel, dtype, key = meta
        if view:
            local = base.as_strided(shape, stride, base.storage_offset() + offset)
        else:
            local = torch.empty(numel, dtype=dtype, device="meta").as_strided(shape, stride, offset)
        out = local if spec is None else DTensor(local, spec, requires_grad=False)
        out.__dict__["_dryrun_key"] = (self._ids, key)
        return out

    def _replay(self, hit, base):
        deltas, transient, spec, metas = hit
        c = self.c
        for k, v in deltas.items():
            c[k] += v
        live = self._live
        live.peak = max(live.peak, live.now + transient)
        if spec is _IN_PLACE:
            return base
        base = None if base is None else _local(base)
        if spec is None:
            out = self._rebuild(metas[0], base)
            if not metas[0][1]:  # a view holds no storage of its own
                self._track((out,))
            return out
        out = tree_unflatten([self._rebuild(m, base) for m in metas], spec)
        self._track(out)
        return out

    def _kind(self, func) -> str:
        """``"pure"`` for a functional op, ``"self"`` for one that writes its
        first argument only and returns it (``add_``), ``"other"`` for any
        other mutation (``out=``, several outputs written)."""
        kind = self._kinds.get(func)
        if kind is None:
            schema = func._schema
            written = [a for a in schema.arguments if a.alias_info is not None and a.alias_info.is_write]
            if not written:
                kind = "pure"
            elif (written == schema.arguments[:1] and len(schema.returns) == 1
                  and schema.returns[0].alias_info is not None
                  and schema.returns[0].alias_info.before_set == written[0].alias_info.before_set):
                kind = "self"
            else:
                kind = "other"
            self._kinds[func] = kind
        return kind

    def _memo_key(self, func, kind, args, kwargs):
        if kind == "other":
            return None
        try:
            key = (func, self._key_of(args), self._key_of(tuple(sorted(kwargs.items()))) if kwargs else ())
            hash(key)
        except TypeError:  # a tensor off meta, or an unhashable argument
            return None
        return key

    def _remember(self, key, before, transient, args, kwargs, out) -> None:
        """Memoize an op whose every output is a fresh ``meta`` storage or a
        view of its first tensor argument in that argument's dtype (a
        ``_unsafe_view`` 's too, though its schema does not say so)."""
        if key is None:
            return
        leaves, spec = tree_flatten(out)
        if not all(isinstance(t, torch.Tensor) and t.device.type == "meta"
                   and (not isinstance(t, DTensor) or _plain_placements(t)) for t in leaves):
            return
        first = next(_tensors(args), None)
        base = None if first is None else _local(first)
        others = {_local(t).untyped_storage()._cdata for t in _tensors((args, kwargs)) if _local(t) is not base}
        metas = [_out_meta(t, base, self._key_of(t)) for t in leaves]
        if base is not None:
            others.discard(base.untyped_storage()._cdata)
        if any(_local(t).untyped_storage()._cdata in others for t in leaves) or any(
                view and dtype != base.dtype for _, view, _, _, _, _, dtype, _ in metas):
            return
        deltas = {k: v - before[k] for k, v in self.c.items() if v != before[k]}
        self._memo[key] = (deltas, transient, None if isinstance(out, torch.Tensor) else spec, metas)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        first = _first_tensor(args, kwargs)
        device = first.device.type if first is not None else torch.device(kwargs.get("device") or "cpu").type
        if device != self.device or torch._C._get_dispatch_mode(_FAKE) is not None:
            # not the step's: DTensor's own index arithmetic on the host, or
            # its sharding propagation on fake tensors
            return func(*args, **kwargs)
        on_dtensors = any(issubclass(t, DTensor) for t in types)
        if _WRAP_FOR_AUTOGRAD is not None and func is _WRAP_FOR_AUTOGRAD.default and device == "meta":
            return torch.ops.aten.alias.default(args[0])
        if on_dtensors and self._pass:  # the call below: DTensor runs it
            self._pass = False
            return NotImplemented
        kind = self._kind(func)
        key = self._memo_key(func, kind, args, kwargs)
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            return self._replay(hit, first)
        if key is not None and kind == "self":
            meta_before = _tensor_key(args[0])
        if not on_dtensors and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:  # its parts were counted
                return out
        live = self._live
        before, start, outer_peak = dict(self.c), live.now, live.peak
        live.peak = live.now
        if on_dtensors:
            self._pass = True
            with self:
                out = func(*args, **kwargs)
        else:
            out = self._local_op(func, args, kwargs)
        self._track(out)
        if not on_dtensors and func in _KERNEL_TEMPORARIES:
            live.peak = max(live.peak, live.now + _KERNEL_TEMPORARIES[func](args, out))
        transient = live.peak - start
        live.peak = max(live.peak, outer_peak)
        if kind == "self" and key is not None and _tensor_key(args[0]) == meta_before:
            # an in-place update that left its tensor's shape and placements
            # as they were: a repeat adds the counts and returns the tensor
            self._memo[key] = ({k: v - before[k] for k, v in self.c.items() if v != before[k]},
                               transient, _IN_PLACE, None)
        elif kind != "pure":  # a mutated tensor's kept memo key may be stale
            for t in _tensors((args, kwargs)):
                t.__dict__.pop("_dryrun_key", None)
        else:
            self._remember(key, before, transient, args, kwargs, out)
        return out

    def _local_op(self, func, args, kwargs):
        """Run one op on local tensors and count it."""
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.c["flops"] += count(*args, **kwargs, out_val=out)
        ins = (args, {k: v for k, v in kwargs.items() if k != "out"})
        inputs = {_local(t).untyped_storage()._cdata for t in _tensors(ins)}
        if func._schema.is_mutable or any(_local(t).untyped_storage()._cdata not in inputs
                                          for t in _tensors(out)):
            self.c["bytes_accessed"] += _nbytes(ins) + _nbytes(out)  # not a view
        kind = collective_kind(func)
        if kind is not None:
            self.c[f"{kind}_bytes"] += _nbytes(args[0])
            self.c[f"{kind}_elements"] += _local(args[0]).numel()
            self.c[f"{kind}_count"] += 1
        return out


def _stacks(cfg: ModelConfig):
    """(config field, groups, layers per group, tail layers) of each layer
    stack the step's count is extended over."""
    if cfg.kind == "encdec":
        return [("n_layers", cfg.n_layers, 1, 0), ("n_enc_layers", cfg.n_enc_layers, 1, 0)]
    pat = len(cfg.block_pattern)
    return [("n_layers", cfg.n_layers // pat, pat, cfg.n_layers % pat)]


def count_step(counter: StepCount, fn: Callable, args):
    """``fn(*args)`` counted by ``counter`` (a new run of it), with grad off
    outside what the step enables itself and every plain tensor the step
    makes taken as replicated where it meets a DTensor.  Returns (counts,
    output)."""
    counter.start(args)
    with torch.no_grad(), implicit_replication(), counter:
        out = fn(*args)
    return counter.counts(), out


def step_counts(cfg: ModelConfig, build: Callable):
    """:class:`StepCount` 's counts of ``fn(*args)`` for ``fn, args =
    build(cfg)`` at the config's full depth, and its outputs at the cut
    depth.  The step runs with two groups per layer stack (fewer where the
    stack has fewer) and, for each stack deeper than that, once more with
    three; every further group adds that difference to each count (the
    peak's too).  Two, not one: DTensor may place the first group's
    boundary differently from the groups between two others (an extra
    reduce-scatter of the residual's gradient in a one-group train step),
    and from the second group on every group repeats the same ops."""
    stacks = _stacks(cfg)
    counter = StepCount()

    def run(groups):
        cut = cfg.scaled(**{f: g * per + tail for (f, _, per, tail), g in zip(stacks, groups)})
        return count_step(counter, *build(cut))

    base_groups = [min(n, 2) for _, n, _, _ in stacks]
    base, out = run(base_groups)
    total = dict(base)
    for i, (_, n, _, _) in enumerate(stacks):
        if n > 2:
            more = list(base_groups)
            more[i] = 3
            again = run(more)[0]
            for k in total:
                total[k] += (n - 2) * (again[k] - base[k])
    return total, out


def collectives(counts: Dict[str, int]) -> Dict:
    """The reference's ``collectives`` record from :func:`step_counts` ' counts."""
    by_kind = {k: float(counts[f"{k}_bytes"]) for k in COLLECTIVE_KINDS}
    return {
        "bytes_by_kind": by_kind,
        "counts": {k: counts[f"{k}_count"] for k in COLLECTIVE_KINDS},
        "total_per_chip_bytes": sum(by_kind.values()),
    }


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def _decode_state_shardings(state_shapes, mesh, rules):
    """Shardings for DecodeState trees by positional heuristics:
    shard batch dim over DP axes and the largest head/channel dim over
    'model' when divisible; replicate otherwise."""
    batch_axes = rules["batch"]
    bsize = int(np.prod([mesh.shape[a] for a in (
        (batch_axes,) if isinstance(batch_axes, str) else batch_axes)]))
    msize = int(mesh.shape["model"])

    def one(leaf):
        shape = leaf.shape
        if len(shape) <= 1:
            return NamedSharding(mesh, P())
        # leading axis is the stacked layer axis; batch is axis 1
        entries = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % bsize == 0 and shape[1] > 1:
            entries[1] = batch_axes
        # shard the widest remaining dim over model
        rest = [(d, i) for i, d in enumerate(shape[2:], start=2)]
        for d, i in sorted(rest, reverse=True):
            if d % msize == 0:
                entries[i] = "model"
                break
        return NamedSharding(mesh, P(*entries))

    return map_tensors(one, state_shapes)


def per_chip_bytes(tree, shardings) -> int:
    """Bytes one chip holds of ``tree`` placed by ``shardings``."""
    total = 0

    def add(sh: NamedSharding, t: torch.Tensor):
        nonlocal total
        total += math.prod(sh.shard_shape(t.shape)) * t.element_size()

    _map(add, shardings, _is_sharding, tree)
    return total


def _cell_parts(cfg: ModelConfig, shape: str, mesh: Mesh, rules, batch_override,
                grad_accum: Optional[int] = None):
    """The step, its arguments on ``meta`` and their shardings (one tree
    each), the arguments and shardings by part, and the microbatch count
    (default: four sequences per DP shard, as the reference's)."""
    spec = SHAPES[shape]
    specs_in = input_specs(cfg, shape, batch_override)
    params, param_axes = init_params(None, cfg, device="meta")
    params_sh = tree_shardings(param_axes, params, mesh, rules)
    if spec.mode == "decode":
        token, state = specs_in["token"], specs_in["state"]
        parts = {
            "params": (params, params_sh),
            "inputs": (token, batch_sharding(mesh, rules, shape=token.shape)),
            "state": (state, _decode_state_shardings(state, mesh, rules)),
        }
        args = (params, token, state)
        return make_serve_step(cfg), args, tuple(v[1] for v in parts.values()), parts, 1
    batch = specs_in["batch"]
    batch_sh = {k: batch_sharding(mesh, rules, shape=v.shape) for k, v in batch.items()}
    if spec.mode == "prefill":
        parts = {"params": (params, params_sh), "inputs": (batch, batch_sh)}
        return make_prefill_step(cfg), (params, batch), (params_sh, batch_sh), parts, 1
    if grad_accum is None:
        dp = math.prod(mesh.shape[a] for a in _axes_tuple(rules["batch"]))
        grad_accum = max(1, batch["tokens"].shape[0] // (dp * 4))
    state = init_train_state(params)
    opt_sh = AdamWState(step=NamedSharding(mesh, P()), m=params_sh, v=params_sh, error_feedback=None)
    parts = {
        "params": (params, params_sh),
        "optimizer": (state.opt, opt_sh),
        "inputs": (batch, batch_sh),
    }
    return (make_train_step(cfg, grad_accum=grad_accum), (state, batch),
            (TrainState(params_sh, opt_sh), batch_sh), parts, grad_accum)


def cell_step(cfg: ModelConfig, shape: str, mesh: Mesh, device_mesh, *,
              batch_override: Optional[int] = None, grad_accum: Optional[int] = None,
              device="meta"):
    """The cell's step and its arguments as DTensors over ``device_mesh``
    (rank 0's blocks): empty on ``meta``, as the plan runs it, else zeros
    on ``device``, the cell's step run for real (a zero token id is one
    every table holds); ``device`` must then be of the mesh's device
    type."""
    dev = torch.device(device).type
    if dev not in ("meta", device_mesh.device_type):
        raise ValueError(f"blocks on {dev} over a {device_mesh.device_type} mesh")
    rules = default_rules(mesh, expert_sharding=cfg.expert_sharding)
    step, args, shardings = _cell_parts(cfg, shape, mesh, rules, batch_override, grad_accum)[:3]
    args = to_dtensors(args, shardings, device_mesh)
    if dev != "meta":
        args = map_tensors(lambda d: DTensor.from_local(
            torch.zeros(d.to_local().shape, dtype=d.dtype, device=device), d.device_mesh, d.placements,
            run_check=False, shape=d.shape, stride=d.stride()), args)
    return step, args


def _output_bytes(mode: str, out, parts, mesh, rules) -> int:
    """Per-chip bytes of the step's outputs at the full depth: the state it
    returns (its input, updated in place) plus what the cut run made."""
    if mode == "train":
        _, metrics = out
        state = sum(per_chip_bytes(*parts[k]) for k in ("params", "optimizer"))
        rep = NamedSharding(mesh, P())
        return state + per_chip_bytes(metrics, {k: rep for k in metrics})
    if mode == "decode":
        token, _ = out
        return per_chip_bytes(token, batch_sharding(mesh, rules, shape=token.shape)) + \
            per_chip_bytes(*parts["state"])
    logits = out
    return per_chip_bytes(logits, NamedSharding(mesh, spec_for(("batch", "vocab"), logits.shape,
                                                               rules, mesh)))


def model_flops(cfg: ModelConfig, mode: str, batch: int, seq_len: int, n_params: int) -> Dict:
    """6·N·T for training, 2·N·T for prefill and decode (one token per
    sequence), N the parameters active per token (``benchmarks/roofline.py``'s
    definition)."""
    active = n_params
    if cfg.n_experts > 0:
        expert = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
        active_expert = 3 * cfg.d_model * cfg.d_ff * cfg.top_k
        active = n_params - cfg.n_layers * (expert - active_expert)
    tokens = batch * (1 if mode == "decode" else seq_len)
    factor = 6.0 if mode == "train" else 2.0
    return {"model_flops": factor * active * tokens, "n_params": n_params, "n_active_params": active}


def argument_bytes(cfg: ModelConfig, shape: str, mesh: Mesh, *,
                   batch_override: Optional[int] = None) -> Dict[str, int]:
    """Per-chip bytes of the cell's arguments by part (``params``,
    ``optimizer``, ``inputs``, ``state``), without running the step: what
    ``plan_cell`` reports as ``argument_bytes_by_part``."""
    rules = default_rules(mesh, expert_sharding=cfg.expert_sharding)
    parts = _cell_parts(cfg, shape, mesh, rules, batch_override)[3]
    return {k: per_chip_bytes(*v) for k, v in parts.items()}


def plan_cell(cfg: ModelConfig, shape: str, mesh: Mesh, *, batch_override: Optional[int] = None,
              grad_accum: Optional[int] = None) -> Dict:
    """The plan of one cell on any ``Mesh`` (a small mesh, a depth cut):
    the step run on DTensors over ``mesh`` 's shape on a fake process
    group, and what one chip holds, computes, accesses and communicates
    in it, in the reference's keys where they mean the same thing.
    ``grad_accum`` sets a train cell's microbatch count (default: four
    sequences per DP shard)."""
    spec = SHAPES[shape]
    t0 = time.perf_counter()
    rules = default_rules(mesh, expert_sharding=cfg.expert_sharding)
    _, _, _, parts, grad_accum = _cell_parts(cfg, shape, mesh, rules, batch_override, grad_accum)
    by_part = {k: per_chip_bytes(*v) for k, v in parts.items()}

    with fake_device_mesh(mesh) as device_mesh:
        counts, out = step_counts(cfg, lambda c: cell_step(
            c, shape, mesh, device_mesh, batch_override=batch_override, grad_accum=grad_accum))
        out_bytes = _output_bytes(spec.mode, out, parts, mesh, rules)
        del out
    plan_s = time.perf_counter() - t0

    n_chips = mesh.size
    B = batch_override or spec.global_batch
    mf = model_flops(cfg, spec.mode, B, spec.seq_len, cfg.n_params)
    pat = len(cfg.block_pattern)
    return {
        "status": "ok",
        "n_chips": n_chips,
        "plan_seconds": round(plan_s, 3),
        "flops_per_chip": counts["flops"],
        "bytes_accessed_per_chip": counts["bytes_accessed"],
        **mf,
        "useful_flops_ratio": mf["model_flops"] / max(counts["flops"] * n_chips, 1.0),
        "memory_analysis": {
            "argument_bytes": sum(by_part.values()),
            "output_bytes": out_bytes,
            "temp_bytes": counts["temp_bytes"],
            "argument_bytes_by_part": by_part,
        },
        "collectives": collectives(counts),
        "collective_elements_by_kind": {k: counts[f"{k}_elements"] for k in COLLECTIVE_KINDS},
        "notes": NOTES,
        "scan_info": {
            "mode": spec.mode,
            "grad_accum": grad_accum,
            "layer_groups": cfg.n_layers if cfg.kind == "encdec" else cfg.n_layers // pat,
            "enc_layers": cfg.n_enc_layers,
            "tail_layers": cfg.n_layers % pat,
            "seq_len": spec.seq_len,
            "global_batch": B,
            "n_params": None,  # the reference's roofline fills it; see n_params above
        },
    }


def lower_cell(arch: str, shape: str, mesh_kind: str) -> Dict:
    """Plan one (arch, shape, mesh) cell on the production mesh's logical
    devices on ``meta``.  Returns the result dict."""
    cfg = get_config(arch)
    skip = applicable(cfg, shape)
    if skip:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind, "status": "skipped",
                "reason": skip}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="meta")
    result = {"arch": arch, "shape": shape, "mesh": mesh_kind, **plan_cell(cfg, shape, mesh)}
    print(json.dumps({k: v for k, v in result.items() if k not in ("memory_analysis", "notes")}))
    return result


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def cell_path(arch: str, shape: str, mesh_kind: str) -> Path:
    return RESULTS_DIR / f"{arch}__{shape}__{mesh_kind}.json"


def run_cell(arch: str, shape: str, mesh_kind: str, force: bool = False) -> Dict:
    path = cell_path(arch, shape, mesh_kind)
    if path.exists() and not force:
        return json.loads(path.read_text())
    try:
        result = lower_cell(arch, shape, mesh_kind)
    except Exception as e:  # the sweep records the cell's failure and goes on
        result = {
            "arch": arch, "shape": shape, "mesh": mesh_kind, "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
        print(f"FAILED {arch} x {shape} x {mesh_kind}: {e}")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=2, default=str))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS, default=None)
    ap.add_argument("--shape", choices=tuple(SHAPES), default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch is None) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or args.shape is None) else (args.shape,)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)

    summary = {"ok": 0, "skipped": 0, "error": 0}
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                r = run_cell(arch, shape, mesh_kind, force=args.force)
                summary[r["status"]] += 1
                print(f"[{summary}] {arch} x {shape} x {mesh_kind}: {r['status']}")
    print("DONE", json.dumps(summary), f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
