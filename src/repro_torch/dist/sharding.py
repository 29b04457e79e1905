"""Logical-axis -> mesh-axis sharding rules (MaxText-style), and placement
over a mesh of logical devices (counterpart of ``repro.dist.sharding``).

Every parameter in ``repro_torch.models`` carries a tuple of *logical* axis
names (``("embed", "ff")`` etc.); this module maps them onto mesh axes.
The rule table, :func:`spec_for`'s fallbacks and the tree walks are the
reference's.  ``P`` and ``NamedSharding`` stand in for
``jax.sharding.PartitionSpec`` and ``NamedSharding``: a spec entry is
``None`` (replicated), a mesh axis name, or a tuple of names (sharded
jointly over the product of their extents, the first name major); as in
jax 0.9 a one-name tuple is stored as the name and an empty one as
``None``.

``spec_for`` applies two safety fallbacks per dimension:
  * divisibility — a dim not divisible by its mesh-axis extent is
    replicated instead of unevenly sharded;
  * single use — a mesh axis may shard at most one dim of an array; later
    dims asking for an already-used axis are replicated.

:func:`device_put` is the counterpart of ``jax.device_put(tree,
shardings)``: each leaf becomes a :class:`ShardedTensor` holding one
contiguous copy of its block per mesh position, on that position's
``torch.device`` (any number of positions may name one card).  A view
would report its whole storage, so every block is a copy of its own and
:func:`bytes_per_device` reads each position's bytes from the storages.
:func:`gather` reassembles the global tensors.

:func:`fake_device_mesh` and :func:`to_dtensors` place a tree as PyTorch's
distributed tensors instead, for the dry run: a ``DeviceMesh`` over a fake
process group of ``mesh.size`` ranks (no communication, this process is
rank 0), each leaf a ``DTensor`` whose local tensor is rank 0's block.  An
op on such tensors runs rank 0's share of the work and issues the
collectives one chip would issue, which the dry run counts.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..launch.mesh import Mesh, as_mesh

__all__ = [
    "P",
    "NamedSharding",
    "ShardedTensor",
    "default_rules",
    "runtime_rules",
    "spec_for",
    "tree_shardings",
    "batch_sharding",
    "state_shardings",
    "device_put",
    "gather",
    "bytes_per_device",
    "fake_device_mesh",
    "placements",
    "to_dtensor",
    "to_dtensors",
]

#: a rule value: one mesh axis, several (sharded jointly), or replicate
Rule = Union[str, Tuple[str, ...], None]


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class P(tuple):
    """A partition spec: one entry per leading dim of an array (dims past
    the last entry are replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def _axes_tuple(rule: Rule) -> Tuple[str, ...]:
    if rule is None:
        return ()
    return (rule,) if isinstance(rule, str) else tuple(rule)


@dataclass(frozen=True)
class NamedSharding:
    """``spec`` over the named axes of ``mesh``."""

    mesh: Any
    spec: P

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The block of a ``shape`` array that one mesh position holds."""
        out = list(shape)
        for i, entry in enumerate(self.spec):
            n = math.prod(self.mesh.shape[a] for a in _axes_tuple(entry))
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split over {entry!r} ({n})")
            out[i] //= n
        return tuple(out)

    def block_index(self, coords: Dict[str, int], shape: Sequence[int]) -> Tuple[slice, ...]:
        """The slices of the block that the position at mesh ``coords`` (axis
        name -> index) holds."""
        block = self.shard_shape(shape)
        idx = []
        for i, entry in enumerate(self.spec):
            axes = _axes_tuple(entry)
            k = 0
            for a in axes:  # the first axis of a tuple entry is the major one
                k = k * self.mesh.shape[a] + coords[a]
            idx.append(slice(k * block[i], (k + 1) * block[i]))
        return tuple(idx)


def default_rules(mesh: Mesh, *, expert_sharding: str = "tp") -> Dict[Optional[str], Rule]:
    """FSDP + tensor-parallel rule table for ``mesh``.

    Batch and the embed (feature) axis shard over the data-parallel axes
    ('pod' spans the slow inter-pod links and carries only batch); vocab,
    ff and the fused head dims shard over 'model'.  ``expert_sharding``:
    'tp' keeps tensor parallelism inside each expert (experts replicated),
    'ep' puts the expert axis on 'model' (expert parallelism) — the
    divisibility/reuse fallbacks in :func:`spec_for` then replicate the ff
    dim automatically.
    """
    names = mesh.axis_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    model = "model" if "model" in names else None
    return {
        None: None,
        "batch": dp or None,
        "embed": "data" if "data" in names else None,  # FSDP weight shard
        "embed2": None,
        "vocab": model,
        "ff": model,
        "ff2": model,
        "heads_x_hd": model,
        "kv_x_hd": model,
        "experts": model if expert_sharding == "ep" else None,
        "layers": None,  # the stacked layer axis stays local
    }


def runtime_rules(mesh, *, axis: str = "boxes") -> Dict[Optional[str], Rule]:
    """Rule table for the distributed PIC runtimes' slot-major state: only
    the leading ``boxes`` (slot) axis shards, over the 1-D box mesh
    (``repro_torch.launch.make_box_mesh``'s tuple of devices reads as the
    ``("boxes",)`` mesh).  Falls back to replication when the mesh has no
    such axis, so the same code path runs on any mesh."""
    return {None: None, "boxes": axis if axis in as_mesh(mesh).axis_names else None}


def state_shardings(state, mesh, rules: Optional[Dict] = None):
    """NamedShardings for a slot-major runtime state tree.

    Every tensor leaf is treated as logical axes ``("boxes", None, ...)`` —
    dim 0 sharded over the box axis, the rest replicated — and routed
    through :func:`spec_for`, so the divisibility and single-use fallbacks
    apply exactly as for model parameters.
    """
    mesh = as_mesh(mesh)
    if rules is None:
        rules = runtime_rules(mesh)
    axes = _map(lambda t: ("boxes",) + (None,) * (max(1, t.dim()) - 1), state,
                lambda x: isinstance(x, torch.Tensor))
    return tree_shardings(axes, state, mesh, rules)


def spec_for(
    axes: Sequence[Optional[str]],
    shape: Sequence[int],
    rules: Dict[Optional[str], Rule],
    mesh,
) -> P:
    """PartitionSpec for an array with logical ``axes`` and ``shape``."""
    used: set = set()
    entries = []
    for name, dim in zip(axes, shape):
        rule = rules.get(name)
        mesh_axes = _axes_tuple(rule)
        if not mesh_axes:
            entries.append(None)
            continue
        extent = math.prod(mesh.shape[a] for a in mesh_axes)
        if any(a in used for a in mesh_axes) or extent <= 0 or dim % extent != 0:
            entries.append(None)  # replicate: not divisible, or axis taken
            continue
        used.update(mesh_axes)
        entries.append(rule if isinstance(rule, str) else tuple(mesh_axes))
    return P(*entries)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x
    )


def _map(fn: Callable, tree, is_leaf: Callable, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts, lists, tuples and
    NamedTuples; ``None`` stays ``None``) and the matching nodes of the
    trees in ``rest``."""
    if is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, is_leaf, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, is_leaf, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_shardings(axes_tree, shapes_tree, mesh, rules):
    """NamedShardings for a whole parameter tree.

    ``axes_tree`` holds logical-axis tuples (the ``specs`` returned by
    ``repro_torch.models.init_params``); ``shapes_tree`` the matching
    tensors (``meta`` ones will do).
    """
    return _map(
        lambda ax, leaf: NamedSharding(mesh, spec_for(ax, leaf.shape, rules, mesh)),
        axes_tree,
        _is_axes_leaf,
        shapes_tree,
    )


def batch_sharding(mesh, rules, *, shape: Optional[Sequence[int]] = None) -> NamedSharding:
    """Sharding for batch-leading arrays (tokens, labels, decode tokens):
    dim 0 over the data-parallel axes, everything else replicated, with the
    same divisibility fallback as :func:`spec_for` when ``shape`` is given
    (global_batch=1 decode must not be unevenly split)."""
    axes = _axes_tuple(rules.get("batch"))
    ndim = len(shape) if shape is not None else 2
    if not axes:
        return NamedSharding(mesh, P())
    extent = math.prod(mesh.shape[a] for a in axes)
    if shape is not None and (len(shape) == 0 or shape[0] % extent != 0):
        return NamedSharding(mesh, P())
    return NamedSharding(mesh, P(tuple(axes), *([None] * (ndim - 1))))


# ---------------------------------------------------------------------------
# placement over the logical devices
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardedTensor:
    """A global tensor of ``shape`` placed by ``sharding``: ``shards`` is a
    mesh-shaped object array holding each position's block, a contiguous
    tensor of its own on that position's device."""

    sharding: NamedSharding
    shape: torch.Size
    shards: np.ndarray


def _is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


def _positions(mesh):
    """(mesh index, axis name -> coordinate) of every position, row-major."""
    for pos in np.ndindex(*mesh.devices.shape):
        yield pos, dict(zip(mesh.axis_names, pos))


def _put(sharding: NamedSharding, x: torch.Tensor) -> ShardedTensor:
    mesh = sharding.mesh
    shards = np.empty(mesh.devices.shape, dtype=object)
    for pos, coords in _positions(mesh):
        block = x[sharding.block_index(coords, x.shape)]
        shards[pos] = block.to(device=mesh.devices[pos], copy=True,
                               memory_format=torch.contiguous_format)
    return ShardedTensor(sharding, x.shape, shards)


def device_put(tree, shardings):
    """Place every tensor leaf of ``tree`` by the matching ``NamedSharding``
    of ``shardings`` (a tree of the same structure; ``None`` where ``tree``
    has ``None``)."""
    return _map(_put, shardings, _is_sharding, tree)


def _gather(t: ShardedTensor, device) -> torch.Tensor:
    sh = t.sharding
    first = t.shards.flat[0]
    out = torch.empty(t.shape, dtype=first.dtype, device=first.device if device is None else device)
    used = {a for e in sh.spec for a in _axes_tuple(e)}
    for pos, coords in _positions(sh.mesh):
        if all(c == 0 for a, c in coords.items() if a not in used):  # one replica of each block
            out[sh.block_index(coords, t.shape)] = t.shards[pos]
    return out


def gather(tree, device=None):
    """The global tensors of a tree of ``ShardedTensor`` s, on ``device``
    (default: the first position's device)."""
    return _map(lambda t: _gather(t, device), tree, lambda x: isinstance(x, ShardedTensor))


def bytes_per_device(tree) -> np.ndarray:
    """Mesh-shaped array of the bytes each position holds over every
    ``ShardedTensor`` of ``tree``, read from the blocks' storages."""
    total = None

    def add(t: ShardedTensor):
        nonlocal total
        b = np.vectorize(lambda s: s.untyped_storage().nbytes(), otypes=[np.int64])(t.shards)
        total = b if total is None else total + b

    _map(add, tree, lambda x: isinstance(x, ShardedTensor))
    return total


# ---------------------------------------------------------------------------
# placement as DTensors over a fake process group
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_device_mesh(mesh: Mesh, device_type: str = "cpu"):
    """A ``DeviceMesh`` with ``mesh`` 's shape and axis names over a fake
    process group of ``mesh.size`` ranks, this process rank 0.  Its device
    type is ``"cpu"`` by default, whatever ``mesh`` 's devices, so the plan
    is the same on every host and makes no CUDA call (DTensor's sharding
    propagation on a ``"cuda"`` mesh needs a CUDA build; on ``"cpu"`` it
    replaces an all-to-all by an all-gather of the same input and a local
    chunk); ``"cuda"`` runs a step's blocks on the card (DTensor moves a
    block to its mesh's device type).  The group and its sub-groups are
    destroyed on exit, so ``torch.distributed.is_initialized()`` is False
    again."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield init_device_mesh(device_type, tuple(mesh.shape.values()), mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()


def placements(sharding: NamedSharding, axis_names: Sequence[str]):
    """The DTensor placements of ``sharding`` over a mesh with
    ``axis_names``: ``Shard(d)`` on every mesh axis that dim ``d`` 's entry
    names, ``Replicate()`` elsewhere and on an axis of size 1 (one block is
    the whole; DTensor refuses to reshape a dim sharded even one way).  A
    dim split jointly over several axes is sharded on each of them in the
    mesh's order, the first one major, as ``P(("pod", "data"))`` means (the
    rules name such axes in mesh order)."""
    out = [Replicate()] * len(axis_names)
    for d, entry in enumerate(sharding.spec):
        axes = _axes_tuple(entry)
        if list(axes) != sorted(axes, key=axis_names.index):
            raise ValueError(f"{entry!r} is not in the mesh's axis order {tuple(axis_names)}")
        for a in axes:
            if sharding.mesh.shape[a] > 1:
                out[axis_names.index(a)] = Shard(d)
    return out


def to_dtensor(sharding: NamedSharding, x: torch.Tensor, device_mesh) -> DTensor:
    """``x`` placed by ``sharding`` as a DTensor on ``device_mesh``: its
    local tensor is rank 0's block, an empty one on ``meta`` when ``x`` is
    on ``meta``, else a contiguous copy."""
    if x.device.type == "meta":
        local = torch.empty(sharding.shard_shape(x.shape), dtype=x.dtype, device="meta")
    else:
        coords = dict.fromkeys(sharding.mesh.axis_names, 0)
        local = x[sharding.block_index(coords, x.shape)].clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local, device_mesh, placements(sharding, device_mesh.mesh_dim_names),
                              run_check=False, shape=x.shape, stride=x.stride())


def to_dtensors(tree, shardings, device_mesh):
    """:func:`to_dtensor` over every tensor leaf of ``tree`` and the matching
    ``NamedSharding`` of ``shardings``."""
    return _map(lambda sh, x: to_dtensor(sh, x, device_mesh), shardings, _is_sharding, tree)
