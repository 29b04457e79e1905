"""Carry state from the reference package into the port's objects.

The functions take numpy arrays and plain Python values (anything with the
reference's attribute names; ``np.asarray`` is applied to every leaf), so
this module imports nothing of the reference.  The tests use it to hand a
reference ``ProblemSetup`` or field state to the port, and
:func:`particles_to_numpy` / :func:`fields_to_numpy` take the port's
tensors back to numpy for comparison.  :func:`slots_from` /
:func:`slots_to_numpy` do the same for slot-major stacks (the sharded
runtime's state): a stack's rows split into equal blocks, one per logical
device, and back.  :func:`params_from` / :func:`params_to_numpy` carry a
nested params dict (the MoE block's) into tensors and back, each leaf's
dtype kept; a bfloat16 leaf (an ``ml_dtypes`` array, recognised by its
dtype's name, so ``ml_dtypes`` need not be installed) crosses through its
uint16 bits.  :func:`decode_state_from` / :func:`decode_state_to_numpy`
carry an LM decode state (a reference ``DecodeState``: stacked KV caches,
SSD and RG-LRU states, the tail, the encoder output and the position)
into the port's ``DecodeState`` and back, so a mid-generation state can be
compared in both directions.  :func:`train_state_from` /
:func:`train_state_to_numpy` do the same for a training state (a reference
``TrainState``: params, and the optimizer's ``step``, ``m``, ``v`` and
optional ``error_feedback``), leaf for leaf.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from .models.attention import KVCache
from .models.rglru import RGLRUState
from .models.ssm import SSDState
from .models.transformer import DecodeState
from .pic.fields import Fields
from .pic.grid import Grid2D
from .pic.laser import LaserAntenna
from .pic.particles import Particles
from .pic.problem import ProblemSetup
from .train.optimizer import AdamWState
from .train.trainstep import TrainState

__all__ = [
    "grid_from",
    "laser_from",
    "particles_from",
    "fields_from",
    "problem_from",
    "particles_to_numpy",
    "fields_to_numpy",
    "slots_from",
    "slots_to_numpy",
    "params_from",
    "params_to_numpy",
    "decode_state_from",
    "decode_state_to_numpy",
    "train_state_from",
    "train_state_to_numpy",
]

_PARTICLE_LEAVES = ("z", "x", "ux", "uy", "uz", "w", "alive", "q", "m")
_FIELD_LEAVES = ("ex", "ey", "ez", "bx", "by", "bz")
_LASER_FIELDS = ("a0", "omega0", "waist", "duration", "t_peak", "z_pos", "x_center")


def grid_from(g) -> Grid2D:
    """A port ``Grid2D`` with the same geometry as ``g``."""
    return Grid2D(
        nz=int(g.nz), nx=int(g.nx), dz=float(g.dz), dx=float(g.dx),
        box_nz=int(g.box_nz), box_nx=int(g.box_nx), cfl=float(g.cfl),
    )


def laser_from(laser) -> LaserAntenna | None:
    if laser is None:
        return None
    return LaserAntenna(**{k: float(getattr(laser, k)) for k in _LASER_FIELDS})


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.bool_:
        return torch.from_numpy(arr.copy()).to(device)
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def particles_from(p, device) -> Particles:
    """Port ``Particles`` from an object with the reference's leaves."""
    return Particles(*(_tensor(getattr(p, k), device) for k in _PARTICLE_LEAVES))


def fields_from(f, device) -> Fields:
    """Port ``Fields`` from six components (an object with ex..bz, or a sequence)."""
    comps: Sequence = (
        [getattr(f, k) for k in _FIELD_LEAVES] if hasattr(f, "ex") else list(f)
    )
    return Fields(*(_tensor(c, device) for c in comps))


def problem_from(setup, device) -> ProblemSetup:
    """Port ``ProblemSetup`` from the reference's (grid, species, laser, name)."""
    return ProblemSetup(
        grid=grid_from(setup.grid),
        species=tuple(particles_from(p, device) for p in setup.species),
        laser=laser_from(setup.laser),
        name=str(setup.name),
    )


def particles_to_numpy(p: Particles) -> Dict[str, np.ndarray]:
    return {k: getattr(p, k).detach().cpu().numpy() for k in _PARTICLE_LEAVES}


def fields_to_numpy(f: Fields) -> Dict[str, np.ndarray]:
    return {k: getattr(f, k).detach().cpu().numpy() for k in _FIELD_LEAVES}


def slots_from(stack: Dict[str, object], devices: Sequence) -> List[Dict[str, torch.Tensor]]:
    """Split a slot-major stack (leaves with a leading slot axis, e.g. a
    species' ``(slots, cap)`` arrays) into equal row blocks, block ``d`` on
    ``devices[d]``."""
    leaves = {k: np.asarray(v) for k, v in stack.items()}
    n_slots = next(iter(leaves.values())).shape[0]
    if n_slots % len(devices):
        raise ValueError(f"{n_slots} slots do not split evenly over {len(devices)} devices")
    per = n_slots // len(devices)
    return [
        {k: _tensor(v[d * per : (d + 1) * per], dev) for k, v in leaves.items()}
        for d, dev in enumerate(devices)
    ]


def slots_to_numpy(per_device: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """The slot-major stack of :func:`slots_from`'s per-device blocks, in
    device order, as numpy arrays."""
    keys = per_device[0].keys()
    return {k: np.concatenate([b[k].detach().cpu().numpy() for b in per_device]) for k in keys}


def _param_tensor(a, device) -> torch.Tensor:
    """One params leaf as a tensor on ``device``, its dtype kept."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr).view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from(tree: Any, device) -> Any:
    """A nested dict of arrays (numpy, ``ml_dtypes`` bfloat16, or tensors)
    as the same dict of tensors on ``device``, each leaf's dtype kept."""
    if isinstance(tree, dict):
        return {k: params_from(v, device) for k, v in tree.items()}
    return _param_tensor(tree, device)


def params_to_numpy(tree: Any) -> Any:
    """The numpy counterpart of :func:`params_from`: bfloat16 leaves come
    back as float32 (exact), since numpy has no bfloat16 of its own."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _state_tree(tree: Any, leaf) -> Any:
    """``leaf`` over a decode-state tree: dicts of block states, whose
    ``"kv"``/``"ssd"``/``"rg"`` entries become the port's NamedTuples."""
    kinds = {"kv": KVCache, "ssd": SSDState, "rg": RGLRUState}
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {
            k: (kinds[k](*(leaf(getattr(v, f)) for f in kinds[k]._fields)) if k in kinds
                else _state_tree(v, leaf))
            for k, v in tree.items()
        }
    return leaf(tree)


def decode_state_from(state, device):
    """The port's ``DecodeState`` on ``device`` from one with the
    reference's fields (``caches``, ``tail``, ``enc_out``, ``position``;
    leaves numpy, ``ml_dtypes`` bfloat16 or tensors), each leaf's dtype
    kept."""
    return _decode_state(state, partial(_param_tensor, device=device))


def _decode_state(state, leaf):
    return DecodeState(
        caches=_state_tree(state.caches, leaf),
        tail=_state_tree(state.tail, leaf),
        enc_out=_state_tree(state.enc_out, leaf),
        position=leaf(state.position),
    )


def decode_state_to_numpy(state):
    """The port's ``DecodeState`` with numpy leaves (bfloat16 as float32,
    exact), the counterpart of :func:`decode_state_from`."""
    return _decode_state(state, params_to_numpy)


def _train_state(state, tree, leaf):
    opt = state.opt
    ef = opt.error_feedback
    return TrainState(
        params=tree(state.params),
        opt=AdamWState(step=leaf(opt.step), m=tree(opt.m), v=tree(opt.v),
                       error_feedback=None if ef is None else tree(ef)),
    )


def train_state_from(state, device) -> TrainState:
    """The port's ``TrainState`` on ``device`` from one with the reference's
    fields (``params``; ``opt.step``, ``opt.m``, ``opt.v``,
    ``opt.error_feedback`` or ``None``; leaves numpy, ``ml_dtypes``
    bfloat16 or tensors), each leaf's dtype kept."""
    return _train_state(state, partial(params_from, device=device),
                        partial(_param_tensor, device=device))


def train_state_to_numpy(state) -> TrainState:
    """The port's ``TrainState`` with numpy leaves (bfloat16 as float32,
    exact), the counterpart of :func:`train_state_from`."""
    return _train_state(state, params_to_numpy, params_to_numpy)
