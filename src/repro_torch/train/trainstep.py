"""Train-step factory: remat + microbatched gradient accumulation + AdamW
(counterpart of ``repro.train.trainstep``).

``make_train_step(cfg, ...)`` returns a ``(state, batch) -> (state,
metrics)`` function.  torch autograd takes the place of ``jax.grad``; the
model checkpoints each layer group itself while autograd records
(``models/transformer.py``).  The global batch is split into
``grad_accum`` microbatches run one after another by a host loop (the
reference's ``lax.scan``), each one's gradients added into float32
accumulators as soon as its backward ends.  So, as in the reference, the
optimizer gets the gradients in the params' dtype when ``grad_accum ==
1`` and in float32 otherwise.

The step **consumes its input state**: the params and the optimizer's
moments and error feedback are updated in place
(``train.optimizer.adamw_update``) and returned in a new ``TrainState``
(clone a state before stepping from it if it is needed again).  The
params hold no autograd state between steps.  The step's parts run in
``torch.profiler.record_function`` spans, ``train_step/forward_backward``,
``train_step/accumulate`` and ``train_step/optimizer``, which a profiler
trace splits the step's device time by.  Nothing reads a value back to
the host: the metrics are 0-d tensors on the device.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
from torch.distributed.tensor import DTensor
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..ckpt.checkpoint import _unflatten
from ..models import ModelConfig, loss_fn
from .optimizer import AdamWState, _leaves, adamw_init, adamw_update

__all__ = ["TrainState", "init_train_state", "make_train_step"]


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_train_state(params, *, compression: bool = False) -> TrainState:
    return TrainState(params=params, opt=adamw_init(params, compression=compression))


def _grad_of(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient, taken off ``p`` (zeros where the loss did not reach
    it, as ``jax.grad`` gives).  A DTensor gradient is redistributed to its
    param's placements: its partial sums over the batch shards are reduced
    (all-reduced, or reduce-scattered onto a sharded param), the gradient
    sync of data parallelism."""
    g = torch.zeros_like(p) if p.grad is None else p.grad
    p.grad = None
    if isinstance(g, DTensor) and g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(
    cfg: ModelConfig,
    *,
    grad_accum: int = 1,
    lr: float = 3e-4,
    remat: bool = False,
    compression: bool = False,
):
    # As in the reference, per-layer remat happens inside the model;
    # remat=True also checkpoints the whole loss, for ablation.
    def loss(params, batch):
        if remat:
            return checkpoint(loss_fn, params, cfg, batch, use_reentrant=False,
                              preserve_rng_state=False)
        return loss_fn(params, cfg, batch)

    def microbatch(params, batch):
        """Loss and metrics of one microbatch; its gradients on the params."""
        with record_function("train_step/forward_backward"), torch.enable_grad():
            l, metrics = loss(params, batch)
            l.backward()
        return l.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            if grad_accum == 1:
                l, metrics = microbatch(params, batch)
                grads = [_grad_of(p) for p in leaves]
            else:
                B = batch["tokens"].shape[0]
                if B % grad_accum:
                    raise ValueError(f"batch {B} does not split into {grad_accum} microbatches")
                n = B // grad_accum
                grads = [torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
                         for p in leaves]
                l_sum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
                for i in range(grad_accum):
                    l, _ = microbatch(params, {k: v[i * n : (i + 1) * n] for k, v in batch.items()})
                    with record_function("train_step/accumulate"):
                        for acc, p in zip(grads, leaves):
                            acc.add_(_grad_of(p))
                    l_sum = l_sum + l
                with record_function("train_step/accumulate"):
                    denom = torch.full_like(l_sum, grad_accum)
                    for acc in grads:
                        acc.div_(denom)
                l = l_sum / denom
                metrics = {}
        finally:
            for p in leaves:
                p.requires_grad_(False)
                p.grad = None

        with record_function("train_step/optimizer"), torch.no_grad():
            grads_tree = _unflatten(params, grads)
            params, new_opt, opt_metrics = adamw_update(
                params, grads_tree, state.opt, lr=lr, compression=compression
            )
        out_metrics = {"loss": l, **opt_metrics}
        for k in ("ce_loss", "moe_aux_loss"):
            if k in metrics:
                out_metrics[k] = metrics[k]
        return TrainState(params=params, opt=new_opt), out_metrics

    return train_step
