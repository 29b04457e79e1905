"""Dry run on ``meta`` (counterpart of ``repro.launch.dryrun``): for every
(architecture x input shape x mesh) cell, build the FSDP + tensor-parallel
shardings from ``dist.sharding``'s rule table over the production mesh's
256 or 512 logical devices, and report what one chip holds and computes.

The reference lowers and compiles each cell with XLA on 512 fake host
devices.  PyTorch has no partitioner, so the plan here is computed from the
shardings and from running the real step (``make_train_step``,
``make_prefill_step`` or ``make_serve_step``) on ``meta`` tensors:

* ``memory_analysis.argument_bytes`` / ``output_bytes``: exact per chip,
  the sum over every argument (output) of its ``shard_shape`` 's bytes.
  The steps update their state in place and return it, so the outputs are
  the state plus the new metrics, token or logits (these replicated, the
  token batch-sharded, the logits ``("batch", "vocab")``).  ``temp_bytes``
  is null: no compiler plans the step's temporaries.
* ``flops_per_chip``: the matmul FLOPs that ``torch.utils.flop_counter``
  counts (its registry and rules, :class:`StepFlops`) over the step at the
  cell's global shapes, divided by the chip count, which assumes an even
  split.  Every layer is counted, where XLA counted a scan body once: the
  step runs at one and at two layer groups per stack and the difference,
  which every group repeats with the same shapes, is extended to the full
  depth (a whole 40-layer 32k prefill would take minutes on ``meta``).
* ``collectives``: null.  Without a partitioner there is no partitioned
  program to read them from.

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
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch
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
    spec_for,
    tree_shardings,
)
from ..models import ModelConfig, init_params
from ..train.optimizer import AdamWState
from ..train.servestep import make_prefill_step, make_serve_step
from ..train.trainstep import init_train_state, make_train_step
from .mesh import Mesh, make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

NOTES = {
    "flops_per_chip": "matmul FLOPs of torch.utils.flop_counter over the step on meta at the "
                      "cell's global shapes, every layer counted, divided by n_chips (an even split)",
    "temp_bytes": "not planned: no compiler schedules the step's temporaries",
    "collectives": "not counted: PyTorch has no partitioned program to read them from",
}


# ---------------------------------------------------------------------------
# FLOPs of a step
# ---------------------------------------------------------------------------


def _meta_key(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError("not on meta")
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    return x


class StepFlops(TorchDispatchMode):
    """``FlopCounterMode`` 's count in one dispatch mode: an op in
    ``torch.utils.flop_counter.flop_registry`` adds its registered FLOPs,
    any other op is decomposed where it has a decomposition and its parts
    counted.  On ``meta`` inputs a functional op's outputs (and FLOPs) are
    remembered by its inputs' shapes, strides and dtypes, so a repeat (the
    flash path runs the same few dozen ops 2,048 times a layer at 32k)
    makes empty ``meta`` tensors instead of running the op's Python meta
    function again."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self._memo: Dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        key = None
        if not schema.is_mutable and all(r.alias_info is None for r in schema.returns):
            try:
                key = (func, _meta_key(args), _meta_key(tuple(sorted(kwargs.items()))))
                hit = self._memo.get(key)
            except TypeError:  # a tensor off meta, or an unhashable argument
                key = hit = None
            if hit is not None:
                flops, spec, metas = hit
                self.flops += flops
                return tree_unflatten(
                    [torch.empty_strided(s, st, dtype=dt, device="meta") for s, st, dt in metas], spec
                )
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        before = self.flops
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if key is not None:
            leaves, spec = tree_flatten(out)
            if all(isinstance(t, torch.Tensor) and t.device.type == "meta" for t in leaves):
                self._memo[key] = (self.flops - before, spec,
                                   [(tuple(t.shape), t.stride(), t.dtype) for t in leaves])
        return out


def _stacks(cfg: ModelConfig):
    """(config field, groups, layers per group, tail layers) of each layer
    stack the step's count is extended over."""
    if cfg.kind == "encdec":
        return [("n_layers", cfg.n_layers, 1, 0), ("n_enc_layers", cfg.n_enc_layers, 1, 0)]
    pat = len(cfg.block_pattern)
    return [("n_layers", cfg.n_layers // pat, pat, cfg.n_layers % pat)]


def step_flops(cfg: ModelConfig, build: Callable):
    """Matmul FLOPs of ``fn(*args)`` for ``fn, args = build(cfg)``, and its
    outputs at the cut depth.  The step runs with one group per layer stack
    and, for each stack deeper than that, once more with two; every
    further group adds that difference."""
    stacks = _stacks(cfg)
    counter = StepFlops()

    def run(groups):
        cut = cfg.scaled(**{f: g * per + tail for (f, _, per, tail), g in zip(stacks, groups)})
        fn, args = build(cut)
        before = counter.flops
        with torch.no_grad(), counter:
            out = fn(*args)
        return counter.flops - before, out

    one = [min(n, 1) for _, n, _, _ in stacks]
    base, out = run(one)
    total = base
    for i, (_, n, _, _) in enumerate(stacks):
        if n > 1:
            two = list(one)
            two[i] = 2
            total += (n - 1) * (run(two)[0] - base)
    return total, out


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


def _cell_parts(cfg: ModelConfig, shape: str, mesh: Mesh, rules, batch_override):
    """The step, its arguments on ``meta`` and their shardings, by part."""
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
        return make_serve_step(cfg), (params, token, state), parts, 1
    batch = specs_in["batch"]
    batch_sh = {k: batch_sharding(mesh, rules, shape=v.shape) for k, v in batch.items()}
    if spec.mode == "prefill":
        parts = {"params": (params, params_sh), "inputs": (batch, batch_sh)}
        return make_prefill_step(cfg), (params, batch), parts, 1
    # microbatch = four sequences per DP shard, as the reference's
    dp = math.prod(mesh.shape[a] for a in _axes_tuple(rules["batch"]))
    grad_accum = max(1, batch["tokens"].shape[0] // (dp * 4))
    state = init_train_state(params)
    opt_sh = AdamWState(step=NamedSharding(mesh, P()), m=params_sh, v=params_sh, error_feedback=None)
    parts = {
        "params": (params, params_sh),
        "optimizer": (state.opt, opt_sh),
        "inputs": (batch, batch_sh),
    }
    return make_train_step(cfg, grad_accum=grad_accum), (state, batch), parts, grad_accum


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
    _, _, parts, _ = _cell_parts(cfg, shape, mesh, rules, batch_override)
    return {k: per_chip_bytes(*v) for k, v in parts.items()}


def plan_cell(cfg: ModelConfig, shape: str, mesh: Mesh, *, batch_override: Optional[int] = None) -> Dict:
    """The plan of one cell on any ``Mesh`` (a small mesh, a depth cut):
    per-chip argument and output bytes, FLOPs, model FLOPs and the scan
    info, in the reference's keys where they mean the same thing."""
    spec = SHAPES[shape]
    t0 = time.perf_counter()
    rules = default_rules(mesh, expert_sharding=cfg.expert_sharding)
    _, _, parts, grad_accum = _cell_parts(cfg, shape, mesh, rules, batch_override)
    by_part = {k: per_chip_bytes(*v) for k, v in parts.items()}
    flops, out = step_flops(cfg, lambda c: _cell_parts(c, shape, mesh, rules, batch_override)[:2])
    out_bytes = _output_bytes(spec.mode, out, parts, mesh, rules)
    plan_s = time.perf_counter() - t0

    n_chips = mesh.size
    B = batch_override or spec.global_batch
    mf = model_flops(cfg, spec.mode, B, spec.seq_len, cfg.n_params)
    pat = len(cfg.block_pattern)
    return {
        "status": "ok",
        "n_chips": n_chips,
        "plan_seconds": round(plan_s, 3),
        "flops_per_chip": flops / n_chips,
        **mf,
        "useful_flops_ratio": mf["model_flops"] / max(flops, 1.0),
        "memory_analysis": {
            "argument_bytes": sum(by_part.values()),
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "argument_bytes_by_part": by_part,
        },
        "collectives": None,
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
