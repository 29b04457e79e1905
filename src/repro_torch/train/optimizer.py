"""AdamW with global-norm clipping + int8 gradient compression (error
feedback) for slow-link gradient synchronization (counterpart of
``repro.train.optimizer``).

Params stay in their model dtype (bf16); first/second moments are float32;
the update is computed in float32 and cast back.  Compression quantizes
per leaf to int8 with a float32 scale and keeps the quantization residual
as error-feedback state, so compressed sync stays unbiased over time.

Unlike the reference's, :func:`adamw_update` works **in place**: it writes
the new params, moments and error feedback into the tensors it is given
and returns them (with compression on it also overwrites ``grads`` with
the decompressed gradients), so it consumes its inputs.  A functional
update would hold a second copy of params, ``m`` and ``v``.  Each leaf is
updated a chunk of at most ``CHUNK`` elements at a time, so the float32
temporaries of a 778M-element embedding stay a few hundred MB.

The arithmetic is the reference's, operation for operation and in its
order, one rounding each: no ``add_(..., alpha=)`` or ``addcmul_``, which
may fuse a multiply-add where the reference rounds twice, and every
division by a value the reference computes is by a device tensor
(``x / python_float`` on CUDA multiplies by the reciprocal).  Leaves are
visited in the reference's flatten order (dict keys sorted), which fixes
the order of the global norm's sum.  Nothing here reads a value back to
the host.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from .._device import map_tensors
from ..ckpt.checkpoint import _flatten

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "quantize_int8",
    "dequantize_int8",
    "compress_decompress",
]

#: elements per chunk of the in-place update (256 MiB per float32 temporary)
CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32 on the params' device
    m: Any
    v: Any
    error_feedback: Optional[Any] = None  # residuals when compression is on


def _leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves in the reference's flatten order."""
    return [leaf for _, leaf in _flatten(tree)]


def _chunks(t: torch.Tensor) -> List[torch.Tensor]:
    """Views of ``t``'s elements, ``CHUNK`` at a time (``t`` must be
    contiguous: writes to the views are writes to ``t``).  A DTensor that
    a mesh axis shards is not flattened (that would make every later op on
    the views pay for a strided sharding): it is one view, or, where its
    local block holds more than ``CHUNK`` elements and no axis shards its
    leading dim (a stacked layer axis), views of whole leading rows."""
    if isinstance(t, DTensor) and any(p.is_shard() for p in t.placements):
        local = t._local_tensor.numel()
        if local <= CHUNK or any(p.is_shard(0) for p in t.placements):
            return [t]
        rows = max(1, CHUNK // (local // t.shape[0]))
        return list(t.split(rows))
    flat = t.view(-1)
    return [flat[i : i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def adamw_init(params, *, compression: bool = False) -> AdamWState:
    zeros_f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device),
        m=map_tensors(zeros_f32, params),
        v=map_tensors(zeros_f32, params),
        error_feedback=map_tensors(zeros_f32, params) if compression else None,
    )


def _global_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum over leaves of sum(g.astype(f32) ** 2))``, the leaves'
    sums added in list order."""
    sums = [sum(c.float().square().sum() for c in _chunks(g)) for g in leaves]
    return torch.sqrt(sum(sums))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / max(gnorm, 1e-9))`` as a 0-d float32 tensor."""
    return torch.clamp(torch.full_like(gnorm, max_norm) / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    gnorm = _global_norm(_leaves(grads))
    scale = _clip_scale(gnorm, max_norm)
    return map_tensors(lambda g: g * scale.to(g.dtype), grads), gnorm


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------


def _int8_scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)


def _int8_round(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)`` in float32 (integer values)."""
    return torch.clamp(torch.round(x / scale), -127, 127)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = _int8_scale(x.abs().amax())
    return _int8_round(x, scale).to(torch.int8), scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _compress_(g: torch.Tensor, e: torch.Tensor) -> None:
    """One leaf's compressed link, in place: ``e`` becomes ``g + e`` in
    float32 (the reference's ``g32``), ``g`` its int8 round trip in
    ``g``'s dtype, and ``e`` the residual ``g32 - deq``."""
    e.add_(g)
    scale = _int8_scale(torch.stack([c.abs().amax() for c in _chunks(e)]).amax())
    for g_c, e_c in zip(_chunks(g), _chunks(e)):
        deq = _int8_round(e_c, scale).mul_(scale)
        g_c.copy_(deq)
        e_c.sub_(deq)


def compress_decompress(grads, error_feedback):
    """Simulate the compressed gradient link: returns (decompressed grads,
    new error feedback), new tensors (the inputs are left as they are).
    On a real multi-pod mesh the int8 payload is what crosses the pod axis
    (4x fewer bytes than f32)."""
    new_g = map_tensors(torch.clone, grads)
    new_e = map_tensors(torch.clone, error_feedback)
    for g, e in zip(_leaves(new_g), _leaves(new_e)):
        _compress_(g, e)
    return new_g, new_e


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _adamw_chunk_(p, g, m, v, clip, b1c, b2c, *, lr, b1, b2, eps, weight_decay) -> None:
    """One chunk's update, in place, as the reference's ``upd`` after the
    clip's ``g * scale.astype(g.dtype)``."""
    g32 = (g * clip.to(g.dtype)).float()
    t = g32 * (1 - b1)
    m.mul_(b1).add_(t)
    torch.mul(g32, 1 - b2, out=t).mul_(g32)
    v.mul_(b2).add_(t)
    del g32
    update = m / b1c
    torch.div(v, b2c, out=t).sqrt_().add_(eps)
    update.div_(t)
    p32 = p.float()
    torch.mul(p32, weight_decay, out=t)
    update.add_(t).mul_(lr)
    if p32 is p:
        p.sub_(update)
    else:
        p.copy_(torch.sub(p32, update, out=t))


def adamw_update(
    params,
    grads,
    state: AdamWState,
    *,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    compression: bool = False,
):
    """One optimizer step.  Returns (params, new_state, metrics), the
    params and the state's moments and error feedback updated in place
    (see the module docstring); ``grads`` may be in the params' dtype or
    in float32."""
    flat_g = _leaves(grads)
    if compression:
        if state.error_feedback is None:
            raise ValueError("optimizer state was not initialized with compression=True")
        for g, e in zip(flat_g, _leaves(state.error_feedback)):
            _compress_(g, e)

    gnorm = _global_norm(flat_g)
    clip = _clip_scale(gnorm, max_grad_norm)
    step = state.step + 1
    b1c = 1.0 - torch.pow(b1, step.float())
    b2c = 1.0 - torch.pow(b2, step.float())
    for p, g, m, v in zip(_leaves(params), flat_g, _leaves(state.m), _leaves(state.v)):
        for chunk in zip(_chunks(p), _chunks(g), _chunks(m), _chunks(v)):
            _adamw_chunk_(*chunk, clip, b1c, b2c, lr=lr, b1=b1, b2=b2, eps=eps,
                          weight_decay=weight_decay)
    new_state = state._replace(step=step)
    return params, new_state, {"grad_norm": gnorm}
