#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

  1. build: compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
     with nvcc (sm_90a), prints the compiler's register/shared-memory/spill
     report and each kernel's persistent grid, and fails if a kernel spills;
  2. kernels: runs each kernel and its plain PyTorch version on the card on
     the same inputs, at the main path's shapes (900 boxes, 70x70 tiles,
     the capacity the Simulation picks) with the initial electrons binned
     (in the order they are made, cell by cell, and with each box's lanes
     shuffled), and on adversarial counts (all boxes empty, all particles
     in one box, every box at capacity, counts 1/255/256/257, particles on
     the box edges, counts at span boundaries, only the last box occupied,
     alternate boxes empty).  Counters must be bitwise equal, pushed state
     within rtol 2e-5 / atol 1e-6, J within 2e-5·max|J|; the in-place
     ``gather_push_move_`` must give the functional form's result bitwise
     and leave every lane past the last executed chunk bitwise unchanged;
     both kernels launched with spans of 1 and of cap/tile chunks must give
     the default span's results.  Times each kernel's launch alone (spans
     and outputs prepared before the window) and its plain version with
     CUDA events (median of 10 after a warm-up), the in-place push on
     copies made once, on both orders of the electrons.  The deposition
     kernel's momenta form, which the PIC step runs, is held on every case
     to the glue it replaced plus the values form (counters bitwise, J
     within 2e-5·max|J|), and on the main cases its launch alone and its
     entry are timed against that glue and the values form's entry;
  3. main path: ``Simulation.run`` of the laser-ion problem on the paper's
     1920² grid (64² boxes, mass ratio 1836, 16 particles per cell per
     species) for 20 steps (2 LB rounds), every interval under
     ``torch.cuda.set_sync_debug_mode("error")``; each kernel must launch
     steps x species times, every deposition in the momenta form, and the fetched work counters must equal
     ``box_work_counters`` of the fetched per-species counts; then one more
     interval under ``torch.profiler`` prints where the step's time goes,
     with each kernel's device time per launch;
  4. backends: ``engine_backend="cuda"`` against ``"torch"`` at 256² for 10
     steps: energies within rtol 1e-3, the same particle census and LB steps;
  5. sharded: the sharded runtime (``repro_torch.dist.ShardedRuntime``) with
     both kernels through ``particle_phase_slots``:
     a. the kernels against their plain versions at the slot path's shapes
        (the 1920² problem packed into 900 slots of 72x72 tiles) and on the
        reference's five slot geometries at 64² boxes: counters bitwise and
        equal to ``box_work_counters``, J within 2e-5·max|J|, pushed state
        within rtol 2e-5 / atol 1e-6; each launch alone timed beside its
        bound, and the persistent grid at 72² printed; the deposition's
        momenta form with a mask against the slot path's former glue plus
        the values form, and both timed;
     b. 20 steps of the 1920² problem on one logical device under
        sync-debug "error": one fetch per interval, each kernel launched
        steps x species x devices times, no drops, the alive-prefix
        invariant on the final state; ms/step, pushes/s, peak memory,
        ``comm_stats()``, ``migration_stats()`` and the LB events printed;
     c. the same problem on four logical devices of the one card, 10 steps,
        a forced adoption swapping 16 boxes between devices 0 and 1 (which
        must change ``comm_stats()``), 10 more steps: the same checks, and
        energies within rtol 1e-3 of run b step by step, the same census;
     d. at 256² (10 steps, no adoption on its own): sharded ``cuda`` vs
        ``torch`` on four devices, sharded ``torch`` vs the global
        ``Simulation``, ``comm="ring"`` vs ``"neighbor"``: energies within
        rtol 1e-3 and the same census;
     e. one profiled interval of run b;
  6. the async interval pipeline and checkpointed recovery:
     a. the 1920² problem on four logical devices, 30 steps under
        ``pipeline="sync"`` and under ``"async"``, in turns (sync, async,
        async, sync; ``lb_interval=10``,
        sync-debug "error" around every interval and every adoption): each
        kernel launched steps x species x devices times, three fetches (the
        async run with one round still pending before its flush), no drops,
        the alive prefix kept, the same census and energies within rtol
        1e-3; ms/step per interval, ``pipeline_stats()`` and ``lb_steps``
        printed, and one more interval of each pipeline profiled;
     b. ``RecoveryRunner`` over the async runtime on four logical devices,
        device 1 killed at interval 2, 40 steps: one restore from the step-20
        checkpoint onto three devices (900 boxes divide by 3), held against
        an uninterrupted three-device run (same census, energies within
        rtol 1e-3 over steps 21-40); checkpoint bytes, snapshot and write
        times, restore time and intervals lost printed.

  7. the activity-ledger strategy, the strong-scaling model, split-phase
     stepping, BoxRuntime and the sharded FDTD:
     a. ``Simulation`` at 1920² with ``cost_strategy="activity_ledger"``
        and ``"work_counter"`` (cuda kernels, LB every 10 on 8 virtual
        devices, 20 steps each, in turns ledger, counter, counter, ledger):
        ms/step of the intervals (each holds a measurement round) and their
        ratio, records per round, and the Pearson and Spearman correlation
        of the per-box ledger costs (CUDA-event device time) with the work
        counters of the same round; finite events, LB on round boundaries;
     b. ``predicted_max_speedup`` for the first step's efficiency at x=0.91
        and 1, and the ``VirtualCluster``-modelled speedup of LB over
        ``lb_enabled=False`` with its ``fraction_of_predicted`` (a model);
     c. ``ShardedRuntime(engine_backend="torch")`` on four logical devices
        at 1920², ``overlap=False`` and ``True`` on the same steps (as many
        as fit in about 20 s, at least 2, measured first): fields within 1e-5·max, the
        same census, ms/step of each; the ``interval_trace`` order check at
        256²; ``engine_backend="cuda"`` with ``overlap=True`` must raise;
     d. ``BoxRuntime`` on four logical devices: 2 steps at 1920² through an
        adoption (ms and host dispatches per step); at 256² against
        ``ShardedRuntime("torch")`` (fields within 1e-5·max, census exact)
        and ``RecoveryRunner`` with device 1 killed against an
        uninterrupted three-device run;
     e. the block-sharded FDTD on 2x2 logical devices at 1920², 50 field
        steps against the global step, within 1e-5·max.

  8. the MoE serving lane (no PIC kernel launches here; the counts must
     stay 0):
     a. the serve-toy config (D 32, 16 experts, top-2, float32 params made
        on the CPU and copied) through ``ExpertRuntime`` on the card and on
        the CPU, 30 steps of the same traffic: routing stats equal every
        step, outputs within 1e-5, the balancer's events and mappings
        equal; the ``einsum`` and ``sort`` dispatches on the card at the
        same bounds;
     b. Llama-4-Scout's MoE block at its full width (D 5120, F 8192, 16
        experts, top-1, shared expert, bf16, drawn on the card): the
        forward alone on a pre-drawn 8x1024 batch (CUDA-event median of
        10) against its fp32 operations bound; ``ExpertRuntime(n_devices=4,
        lb_interval=5, ema_alpha=0.5)`` sync and async for 20 steps (device
        1 at half capacity from step 10, which forces a rebalance) and the
        heuristic cost source for 10, every step under sync-debug "error":
        ms/step split into host traffic generation and the rest, tokens/s,
        adoptions with each permutation's device time, one host sync per
        interval, the counters exact per step (tokens sum to B·S·K, slots
        filled never above tokens), the last round's costs by expert id
        from both sources, peak memory, and the served function on a fixed
        batch unchanged across the adoptions within 1e-5·max|out|; then
        ``snapshot()`` and a restore onto 2 modelled devices, timed, to the
        same bound;
     c. Mixtral-8x7B's MoE block (D 4096, F 14336, 8 experts, top-2):
        ``sort`` against ``einsum`` on one 2x1024 batch, stats equal and
        outputs within 1e-5·max|out|.

  9. the LM serving path (no PIC kernel launches here; the counts must
     stay 0):
     a. every SMOKE config, float32 params made on the CPU from one
        generator and copied: ``forward_train`` and 4 ``decode_step``s on
        the card and on the CPU, logits within 1e-4·max|logits|, float32
        state leaves within 1e-4·max|leaf|, the bf16 KV caches within one
        bf16 rounding (2^-7·max|leaf|), MoE stats equal;
     b. Qwen3-14B at full width and depth (40 layers, 29.54 GB of bf16
        params drawn on the card, their count equal to ``n_params``):
        ``make_prefill_step`` on 4 x 2048 tokens (the ``_sdpa`` path) and
        on 1 x 8192 (the flash path), CUDA-event medians of 5 beside the
        bf16 operations bound, tokens/s and peak memory; the library row
        (layer 0's q/k/v through ``_sdpa``, ``_flash_sdpa`` and
        ``F.scaled_dot_product_attention``, off the path); ``make_serve_step``
        at batch 16 from a filled 4096-token context, 32 greedy steps under
        sync-debug "error" (ms/step on the host clock beside the byte
        bound, tokens/s, one profiled step's host launches and device busy
        share); decode vs forward on a 32-token prompt at full depth in
        bf16 (reported), and at full width with 2 layers of float32 params
        (bf16 KV caches reported; float32 caches held at 1e-3·max|logits|);
     c. mamba2-780m, recurrentgemma-9b (the window-2048 ring at context
        4096) and whisper-medium (1,500 audio frames, a 448-token prompt)
        at full width: one prefill timed beside its bound, 16 decode steps;
        for mamba2 and recurrentgemma decode vs forward at full depth
        against the bf16 bound (held for recurrentgemma; reported for
        mamba2, whose scan's and step's bf16 roundings drift apart over 48
        layers, in the reference too: ``tests/decode_gap_at_depth.py``) and
        at full width with float32 params and caches (held at
        1e-3·max|logits|).  Whisper has no decode-vs-forward check: the
        reference's decode applies RoPE in the decoder's self-attention and
        its forward does not, so the two compute different functions.

  10. the training path (no PIC kernel launches here; the counts must stay
      0):
     a. every SMOKE config, params made on the CPU from one generator and
        copied, a 4 x 16 ``SyntheticLMData`` batch, card vs CPU: with
        float32 params ``loss_fn`` (rtol 1e-5), its gradients (per leaf
        within 1e-4·|g| + the CPU tests' atol·max|g|), MoE stats equal,
        and one ``grad_accum=2`` step (loss rtol 1e-5, params within 2·lr);
        with bfloat16 params the same step's gaps reported, the
        embedding's gradient among them;
     b. Qwen3-14B at full width with 4 of its 40 layers (2,878,388,224
        bf16 params drawn on the card), ``SyntheticLMData(seed=0)`` 2 x
        4096 tokens as 2 microbatches, per-layer remat: 3 steps (the first
        under ``torch.profiler``: host launches, busy share, device time of
        the forward+backward, accumulation and optimizer spans), ms/step
        (host clock, median after the first), tokens/s, the share of the
        bf16 products bound, peak memory against the 16 B/param of static
        state; then one step with int8 compression;
     c. mamba2-780m at full width and depth, 2 steps at 1 x 2048;
     d. restart: yi-9b SMOKE, 5 steps with a checkpoint at step 3 through
        the port's ``CheckpointManager``, restored and replayed, losses
        within rtol 1e-6;
     e. 10b's cell planned by ``plan_cell`` on a (1, 2) mesh and, at
        batch 4, on (2, 1) and (2, 2) meshes, and run on the card on
        DTensors over a fake process group (rank 0's blocks;
        ``dryrun.cell_step``): the predicted peak
        ``argument_bytes + temp_bytes`` against
        ``torch.cuda.max_memory_allocated()`` less the memory before the
        arguments, within 10%.
     In 10b the bytes of the storages the state and a batch hold on the
     card are held against the dry run's ``argument_bytes`` of the cell
     on a 1x1 mesh (bf16 params, float32 m and v, the step, the batch),
     within 512 B per tensor; the growth of
     ``torch.cuda.memory_allocated()`` is printed beside them (it adds
     the caching allocator's rounding).  Before the first step the dry
     run's ``plan_cell`` of the same cell (2 microbatches of 1) predicts
     the step's peak as ``argument_bytes + temp_bytes``; after the steps
     it is held against ``torch.cuda.max_memory_allocated()`` less the
     memory before the state, within 10%.

  11. the launch layer (no PIC kernel launches here; the counts must stay
      0):
     a. Qwen3-14B's params at full width with 4 layers (bf16, drawn on the
        card) placed by ``dist.sharding`` 's rules over
        ``make_production_mesh()`` (16x16 logical devices on the one card)
        and over the multi-pod mesh (2x16x16): each logical device's bytes
        equal to ``argument_bytes`` ' per-chip param bytes on that mesh, and
        ``gather`` gives the params back bitwise; placement and gather
        times printed;
     b. ``lower_cell`` for Qwen3-14B at full depth on ``meta`` (the step
        run on DTensors over the mesh on a fake process group): train_4k,
        prefill_32k and decode_32k on the single-pod mesh, decode_32k on
        the multi-pod one: per-chip argument and temporary bytes against
        80 GiB, collectives by kind, ``flops_per_chip``,
        ``bytes_accessed_per_chip``, the model-FLOPs ratio and the
        planning time.  The whole phase must take at most 60 s.

``set_performance_flags()`` (``repro_torch.launch.cuda_env``) runs first,
before CUDA initializes; what it set and the CUDA variables in the
environment are printed.  The last lines
are the phase times, the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src/repro_torch`` beside this file, it exits 2
and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: CUDA variables read at CUDA init, printed as the run found them
CUDA_ENV_VARS = ("PYTORCH_CUDA_ALLOC_CONF", "CUDA_DEVICE_MAX_CONNECTIONS", "CUDA_LAUNCH_BLOCKING")

# H100 SXM data-sheet peaks (dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

# fp32 operations per executed lane, counted from the CUDA sources:
# four order-3 weight sets (2 shifts + 4 x (floor, frac, 3 offsets, 1 index,
# 4 splines x 11)) = 202; gather_push adds six 4x4 gathers (6 x 40) and the
# Boris push + move (~70); deposition adds three 4x4 scatters (3 x 36).
GATHER_PUSH_FLOPS_PER_LANE = 202 + 240 + 70
DEPOSITION_FLOPS_PER_LANE = 202 + 108


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # keep the card busy while the host enqueues, so the window holds
        # device work only, not the host's launch latency
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(case: str, n_boxes: int, cap: int, gen, binned=None):
    """Binned inputs (counts, sz, sx, ux, uy, uz) for one case."""
    import torch

    from repro_torch.kernels.common import HALO
    from repro_torch.kernels._tensors import SPAN_CHUNKS

    dev = "cuda"
    if case == "main":
        b = binned
        return b.counts, b.sz, b.sx, b.ux, b.uy, b.uz
    if case == "main-shuffled":
        # the same electrons with each box's live lanes in random order (the
        # order a long run drifts toward), padding lanes where they were
        b = binned
        n_run = int(b.counts.max())
        lane = torch.arange(n_run, device=dev)[None, :]
        key = torch.rand((n_boxes, n_run), generator=gen, device=dev)
        perm = torch.where(lane < b.counts[:, None], key, 2.0 + lane.float()).argsort(dim=1)
        out = []
        for a in (b.sz, b.sx, b.ux, b.uy, b.uz):
            shuffled = a.clone()
            shuffled[:, :n_run] = a[:, :n_run].gather(1, perm)
            out.append(shuffled)
        return (b.counts, *out)
    if case == "all-empty":
        counts = torch.zeros(n_boxes, dtype=torch.int32, device=dev)
    elif case == "all-in-one-box":
        counts = torch.zeros(n_boxes, dtype=torch.int32, device=dev)
        counts[0] = cap
    elif case == "at-capacity":
        counts = torch.full((n_boxes,), cap, dtype=torch.int32, device=dev)
    elif case == "tile-boundaries":
        counts = torch.tensor([1, 255, 256, 257], dtype=torch.int32, device=dev).repeat(
            (n_boxes + 3) // 4
        )[:n_boxes]
    elif case == "box-edges":
        counts = torch.randint(0, cap + 1, (n_boxes,), generator=gen, device=dev).to(torch.int32)
    elif case == "span-boundaries":
        span = SPAN_CHUNKS * 256
        counts = torch.tensor([span - 1, span, span + 1], dtype=torch.int32, device=dev).repeat(
            (n_boxes + 2) // 3
        )[:n_boxes].clamp(max=cap)
    elif case == "last-box-only":
        counts = torch.zeros(n_boxes, dtype=torch.int32, device=dev)
        counts[-1] = cap - 1
    elif case == "alternate-empty":
        counts = torch.randint(1, cap + 1, (n_boxes,), generator=gen, device=dev).to(torch.int32)
        counts[1::2] = 0
    else:
        raise ValueError(case)
    shape = (n_boxes, cap)
    box = 64.0
    if case == "box-edges":
        edge = torch.rand(shape, generator=gen, device=dev) * 2.0 - 1.0
        side = torch.randint(0, 4, shape, generator=gen, device=dev)
        along = torch.rand(shape, generator=gen, device=dev) * box
        sz = torch.where(side == 0, HALO + edge, torch.where(side == 1, HALO + box - edge, HALO + along))
        sx = torch.where(side == 2, HALO + edge, torch.where(side == 3, HALO + box - edge, HALO + along))
    else:
        sz = HALO + torch.rand(shape, generator=gen, device=dev) * box
        sx = HALO + torch.rand(shape, generator=gen, device=dev) * box
    lane = torch.arange(cap, device=dev)[None, :]
    live = lane < counts[:, None].long()
    executed = lane < ((counts[:, None].long() + 255) // 256) * 256
    pad = executed & ~live  # padding lanes of executed chunks sit at s=0
    sz = torch.where(pad, 0.0, sz).contiguous()
    sx = torch.where(pad, 0.0, sx).contiguous()
    ux, uy, uz = (torch.randn(shape, generator=gen, device=dev) * 0.3 for _ in range(3))
    return counts, sz, sx, ux, uy, uz


def check_deposition(case: str, kd, pd, errs: dict) -> None:
    """Deposition outputs ``kd`` against the plain version's ``pd``."""
    import torch

    if not torch.equal(kd[3], pd[3]):
        raise AssertionError(f"deposition counters differ ({case})")
    for name, k, p in zip(("jx", "jy", "jz"), kd[:3], pd[:3]):
        scale = max(float(p.abs().max()), 1e-30)
        err = float((k - p).abs().max())
        if err > 2e-5 * scale:
            raise AssertionError(f"deposition {name} differs ({case}): {err} > 2e-5*{scale}")
        errs["deposition"] = max(errs["deposition"], err)


def unfused_values(form: str, counts, u, w, q, live, volume: float):
    """The current values the PIC step's glue computed before the
    deposition kernel's momenta form: ``pic_substep_body``'s (binned,
    ``lane < count``) or ``particle_phase_slots``' (slot, the mask
    ``live``), over every lane."""
    import torch

    ux, uy, uz = u
    gamma = torch.sqrt(1.0 + ux**2 + uy**2 + uz**2)
    if form == "binned":
        slot_live = torch.arange(ux.shape[1], device=ux.device)[None, :] < counts[:, None]
        qw = q * w
        coef = torch.where(slot_live, qw, torch.zeros_like(qw)) / (gamma * volume)
    else:
        coef = torch.where(live, q * w * (1.0 / volume), 0.0) / gamma
    return [(coef * c).contiguous() for c in u]


def momenta_scales(form: str, volume: float) -> dict:
    """The momenta form's scales on each path."""
    return dict(scale=1.0, volume=volume) if form == "binned" else dict(scale=1.0 / volume, volume=1.0)


def check_fused(case: str, form: str, counts, sz, sx, u, w, q, live, volume: float, kw: dict,
                errs: dict) -> None:
    """The deposition kernel's momenta form against the glue it replaced
    plus the values form: counters bitwise, J within 2e-5·max|J|."""
    import torch

    from repro_torch.kernels.deposition import deposit_local_tiles, deposit_local_tiles_from_momenta

    fused = deposit_local_tiles_from_momenta(
        counts, sz, sx, *u, w, q=q, live=live, **momenta_scales(form, volume), **kw
    )
    unfused = deposit_local_tiles(counts, sz, sx, *unfused_values(form, counts, u, w, q, live, volume), **kw)
    torch.cuda.synchronize()
    check_deposition(f"{case}, {form} momenta form", fused, unfused, errs)


def kernel_phase(sim, record: dict) -> None:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.deposition import (
        deposit_local_tiles,
        deposit_local_tiles_from_momenta,
        deposit_local_tiles_plain,
        deposition_from_momenta_launcher,
        deposition_launcher,
    )
    from repro_torch.kernels.gather_push import (
        gather_push_launcher,
        gather_push_move,
        gather_push_move_,
        gather_push_move_plain,
    )

    grid, cap = sim.grid, sim.kernel_cap
    n_boxes = grid.n_boxes
    bzx = grid.box_nz + 6
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20210423)
    tiles = tuple(
        (torch.randn((n_boxes, bzx, bzx), generator=gen, device="cuda") * 0.5).contiguous()
        for _ in range(6)
    )
    e = sim.species[0]
    binned = ops.bin_particles(e, grid, cap)
    qm = e.q / e.m
    dt = grid.dt
    errs = {"gather_push": 0.0, "deposition": 0.0}
    cases = ("main", "main-shuffled", "all-empty", "all-in-one-box", "at-capacity",
             "tile-boundaries", "box-edges", "span-boundaries", "last-box-only",
             "alternate-empty")
    for case in cases:
        counts, sz, sx, ux, uy, uz = kernel_inputs(case, n_boxes, cap, gen, binned)
        arrays = (sz, sx, ux, uy, uz)
        args = (counts, *arrays, tiles)
        kw = dict(grid=grid, qm=qm, dt=dt)
        k_out = gather_push_move(*args, **kw)
        # the in-place form: the functional form's result bitwise, and every
        # lane past the box's last executed chunk untouched
        in_place = [a.clone() for a in arrays]
        k_cnt = gather_push_move_(counts, *in_place, tiles, **kw)
        torch.cuda.synchronize()
        exec_per_box = ((counts.long() + 255) // 256) * 256
        skipped = torch.arange(cap, device="cuda")[None, :] >= exec_per_box[:, None]
        if not torch.equal(k_cnt, k_out[5]):
            raise AssertionError(f"gather_push_move_ counters differ from the functional form ({case})")
        for name, a, f, old in zip(("sz", "sx", "ux", "uy", "uz"), in_place, k_out, arrays):
            if not torch.equal(a.view(torch.int32), f.view(torch.int32)):
                raise AssertionError(f"gather_push_move_ {name} differs from the functional form ({case})")
            if bool(((a.view(torch.int32) != old.view(torch.int32)) & skipped).any()):
                raise AssertionError(f"gather_push_move_ changed {name} past the executed chunks ({case})")
        del in_place, skipped, exec_per_box
        p_out = gather_push_move_plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(k_out[5], p_out[5]):
            raise AssertionError(f"gather_push counters differ ({case})")
        for name, k, p in zip(("sz", "sx", "ux", "uy", "uz"), k_out[:5], p_out[:5]):
            bad = (k - p).abs() > 1e-6 + 2e-5 * p.abs()
            if bool(bad.any()):
                raise AssertionError(f"gather_push {name} differs ({case}): {int(bad.sum())} lanes")
            errs["gather_push"] = max(errs["gather_push"], float((k - p).abs().max()))
        del p_out
        # deposit at the pushed state with the engine's current values
        gamma = torch.sqrt(1.0 + k_out[2] ** 2 + k_out[3] ** 2 + k_out[4] ** 2)
        v = [(u / gamma).contiguous() for u in k_out[2:5]]
        del gamma
        dep_args = (counts, k_out[0], k_out[1], *v)
        kd = deposit_local_tiles(*dep_args, grid=grid)
        pd = deposit_local_tiles_plain(*dep_args, grid=grid)
        torch.cuda.synchronize()
        check_deposition(case, kd, pd, errs)
        # the momenta form the PIC step runs, against the glue it replaced
        w = (0.5 + torch.rand(counts.shape + (cap,), generator=gen, device="cuda")).contiguous()
        volume = grid.dz * grid.dx
        check_fused(case, "binned", counts, k_out[0], k_out[1], k_out[2:5], w, e.q, None, volume,
                    dict(grid=grid), errs)
        spans_checked = ""
        if case in ("span-boundaries", "alternate-empty"):
            # the span size reaches the kernels as a launch argument: spans of
            # one chunk, and of a whole box, give the default span's results
            for g in (1, cap // 256):
                pushed = [a.clone() for a in arrays]
                launch, g_cnt = gather_push_launcher(counts, pushed, tiles, span_chunks=g, **kw)
                launch()
                torch.cuda.synchronize()
                if not (torch.equal(g_cnt, k_out[5]) and all(
                    torch.equal(a.view(torch.int32), f.view(torch.int32))
                    for a, f in zip(pushed, k_out[:5])
                )):
                    raise AssertionError(f"gather_push with spans of {g} chunks differs ({case})")
                del pushed
                launch, g_dep = deposition_launcher(*dep_args, grid=grid, span_chunks=g)
                launch()
                torch.cuda.synchronize()
                check_deposition(f"{case}, spans of {g} chunks", g_dep, pd, errs)
                del g_dep
            spans_checked = f", spans of 1 and {cap // 256} chunks ok"
        log(f"kernels: case {case:16s} ok  (boxes with particles: {int((counts > 0).sum())}){spans_checked}")
        if case in ("main", "main-shuffled"):
            exec_lanes = int((((counts.long() + 255) // 256) * 256).sum())
            occupied = int((counts > 0).sum())
            # each kernel's launch alone, its arguments prepared once; the
            # in-place push works on copies: its work depends only on the
            # counts, so repeated pushes of the same lanes time the same work
            scratch = [a.clone() for a in arrays]
            launch, _ = gather_push_launcher(counts, scratch, tiles, **kw)
            gp_ms = cuda_time_ms(launch)
            launch, _ = deposition_launcher(*dep_args, grid=grid)
            dp_ms = cuda_time_ms(launch)
            # the momenta form: its launch alone, its entry with the set-up,
            # and the glue it replaced with the values form's entry
            u_args = (counts, *k_out[:5], w)
            u_kw = dict(q=e.q, grid=grid, **momenta_scales("binned", volume))
            launch, _ = deposition_from_momenta_launcher(*u_args, **u_kw)
            fused_ms = cuda_time_ms(launch)
            fused_entry_ms = cuda_time_ms(lambda: deposit_local_tiles_from_momenta(*u_args, **u_kw))
            unfused_ms = cuda_time_ms(lambda: deposit_local_tiles(
                counts, k_out[0], k_out[1],
                *unfused_values("binned", counts, k_out[2:5], w, e.q, None, volume), grid=grid,
            ))
            log(
                f"kernels: {case} case, the momenta form: launch alone {fused_ms:.3f} ms (values form "
                f"{dp_ms:.3f}), entry with its set-up {fused_entry_ms:.3f} ms; the glue it replaced "
                f"plus deposit_local_tiles {unfused_ms:.3f} ms"
            )
            del scratch, launch, u_args
            if case == "main-shuffled":
                log(
                    f"kernels: main case, each box's lanes shuffled: gather_push_move_ {gp_ms:.3f} ms, "
                    f"deposition {dp_ms:.3f} ms"
                )
            else:
                gp_plain = cuda_time_ms(lambda: gather_push_move_plain(*args, **kw))
                dp_plain = cuda_time_ms(lambda: deposit_local_tiles_plain(*dep_args, grid=grid))
                lanes = n_boxes * cap
                tile_bytes = n_boxes * bzx * bzx * 4
                # in place: read and write 5 floats per executed lane, read
                # the six tiles of each occupied box, read counts, write counters
                gp_bound = bound_ms(
                    40 * exec_lanes + 24 * bzx * bzx * occupied + 2 * n_boxes * 4,
                    exec_lanes * GATHER_PUSH_FLOPS_PER_LANE,
                )
                # the functional form's bound (every padded lane in and out)
                gp_bound_functional = bound_ms(
                    2 * 5 * lanes * 4 + 6 * tile_bytes + 2 * n_boxes * 4 + 4,
                    exec_lanes * GATHER_PUSH_FLOPS_PER_LANE,
                )
                dp_bound = bound_ms(
                    5 * exec_lanes * 4 + 3 * tile_bytes + 2 * n_boxes * 4,
                    exec_lanes * DEPOSITION_FLOPS_PER_LANE,
                )
                record["gather_push"].update(ms=gp_ms, plain_ms=gp_plain, bound_ms=gp_bound[0], bound_by=gp_bound[1])
                record["deposition"].update(ms=dp_ms, plain_ms=dp_plain, bound_ms=dp_bound[0], bound_by=dp_bound[1])
                log(
                    f"kernels: main case executed lanes {exec_lanes} of {lanes}, {occupied} occupied boxes; "
                    f"gather_push_move_ {gp_ms:.3f} ms (plain {gp_plain:.3f}, bound {gp_bound[0]:.4f} by "
                    f"{gp_bound[1]}; the functional form's bound {gp_bound_functional[0]:.3f} by "
                    f"{gp_bound_functional[1]}); "
                    f"deposition {dp_ms:.3f} ms (plain {dp_plain:.3f}, bound {dp_bound[0]:.4f} by {dp_bound[1]})"
                )
        del args, arrays, dep_args, k_out, kd, pd, v, w, counts, sz, sx, ux, uy, uz
        if case == "main-shuffled":
            binned = None  # the binned electrons (~11 GB at full size)
        torch.cuda.empty_cache()
    record["gather_push"]["max_abs_err"] = errs["gather_push"]
    record["deposition"]["max_abs_err"] = errs["deposition"]


# ---------------------------------------------------------------------------
# phase 3 and 4: the main path through Simulation
# ---------------------------------------------------------------------------


def main_path(sim, n_species: int, record: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.deposition import deposit_local_tiles, deposit_local_tiles_from_momenta
    from repro_torch.kernels.gather_push import gather_push_move
    from repro_torch.pic.deposition import box_work_counters

    n_particles = sum(int(p.alive.sum()) for p in sim.species)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather_push_move.launches = 0
    deposit_local_tiles.launches = 0
    deposit_local_tiles_from_momenta.launches = 0
    steps = 0
    for rnd in range(2):
        t0 = time.perf_counter()
        sim.run(10)  # one interval under sync-debug "error", one fetch
        wall = time.perf_counter() - t0
        steps += 10
        h = sim.last_outputs
        expect = sum(
            box_work_counters(torch.from_numpy(h.species_counts[:, s]), sim.grid).numpy()
            for s in range(n_species)
        )
        if not np.array_equal(h.work, expect):
            raise AssertionError("fetched work counters differ from box_work_counters")
        if not (np.isfinite(h.field_energy).all() and np.isfinite(h.kinetic_energy).all()):
            raise AssertionError("non-finite energies")
        log(
            f"main: interval {rnd}: {wall * 1e3 / 10:.2f} ms/step, "
            f"{n_particles * 10 / wall:.4g} particle pushes/s, "
            f"field energy {h.field_energy[-1]:.6g}, kinetic {h.kinetic_energy[-1]:.6g}"
        )
    # every deposition of the step is the momenta form
    for fn in (gather_push_move, deposit_local_tiles, deposit_local_tiles_from_momenta):
        if fn.launches != steps * n_species:
            raise AssertionError(f"{fn.__name__} launched {fn.launches} times, want {steps * n_species}")
    record["gather_push"]["launches"] = gather_push_move.launches
    record["deposition"]["launches"] = deposit_local_tiles.launches
    log(
        f"main: lb_steps {sim.history['lb_steps']}, events "
        f"{[(e.step, e.adopted, round(e.current_efficiency, 4), round(e.proposed_efficiency, 4)) for e in sim.balancer.events]}, "
        f"dropped_total {sim.dropped_total}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )


def profile_interval(sim, top: int = 12) -> None:
    """Where one more interval's time goes: device time by kernel name from
    ``torch.profiler``, and the device's busy share of the wall time, which
    ends once every round is harvested and the card is idle.
    Informational; it checks nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    steps = 10
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(steps)
        getattr(sim, "flush", lambda: None)()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    queue_full_ms = 0.0
    for ev in prof.key_averages():
        # device-side records only: the aten ops that launched them carry
        # the same time again on the CPU side
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        if ev.key == "Command Buffer Full":  # a CUPTI marker, not a kernel
            queue_full_ms += ms
        elif ms > 0:
            rows.append((ms, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log("profile: the profiler recorded no device time")
        return
    log(
        f"profile: {steps} steps, wall {wall_ms:.1f} ms, kernels busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%, idle {100 * (1 - busy / wall_ms):.1f}%), "
        f"launch queue full {queue_full_ms:.1f} ms"
    )
    # the top rows, and the port's two kernels wherever they rank
    ours = ("gather_push_kernel", "deposition_kernel")
    for i, (ms, count, name) in enumerate(rows):
        if i < top or any(k in name for k in ours):
            log(f"profile: {ms / steps:9.3f} ms/step {100 * ms / busy:5.1f}%  x{count // steps:<4d} {name[:90]}")
        if any(k in name for k in ours):
            log(f"profile: {name[:40]} {ms / count:.3f} ms of device time per launch ({count} launches)")
    kernels_ms = sum(ms for ms, _, name in rows if any(k in name for k in ours))
    log(f"profile: the two PIC kernels {kernels_ms / steps:.3f} ms/step of device time")
    # the host's side: CUDA runtime calls by their own host time
    calls = sorted(
        ((ev.self_cpu_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()
         if ev.device_type == torch.autograd.DeviceType.CPU and ev.key.startswith("cuda")),
        reverse=True,
    )
    for ms, count, name in calls[:5]:
        log(f"profile: host {ms / steps:8.3f} ms/step in {count // steps} calls/step of {name}")


def backends_phase() -> None:
    import numpy as np

    from repro_torch.pic import SimConfig, Simulation, laser_ion_problem

    sims = {}
    for backend in ("cuda", "torch"):
        prob = laser_ion_problem(nz=256, nx=256, box_cells=32, ppc=16, device="cuda")
        sim = Simulation(prob, SimConfig(engine_backend=backend, strict_syncs=True))
        sim.run(10)
        sims[backend] = sim
    a, b = sims["cuda"], sims["torch"]
    for key in ("field_energy", "kinetic_energy"):
        np.testing.assert_allclose(a.history[key], b.history[key], rtol=1e-3, err_msg=key)
    census = [sum(int(p.alive.sum()) for p in s.species) for s in (a, b)]
    if census[0] != census[1]:
        raise AssertionError(f"particle census differs: {census}")
    if a.history["lb_steps"] != b.history["lb_steps"]:
        raise AssertionError(f"lb_steps differ: {a.history['lb_steps']} vs {b.history['lb_steps']}")
    # the cuda backend records counts before each push, torch after it
    shifted = np.abs(a.last_outputs.counts[1:] - b.last_outputs.counts[:-1]).sum(axis=1)
    log(
        f"backends: 256^2 cuda vs torch: census {census[0]}, lb_steps {a.history['lb_steps']}, "
        f"max rel energy diff "
        f"{max(abs(x / y - 1) for x, y in zip(a.history['field_energy'], b.history['field_energy']) if y):.3g}, "
        f"per-box count differences per step {shifted.tolist()}"
    )


# ---------------------------------------------------------------------------
# phase 5: the sharded runtime
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Inside: ``particle_phase_slots`` runs the kernels' plain PyTorch
    versions on the same (CUDA) tensors, for the comparisons."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.deposition import deposit_local_tiles_from_momenta_plain
    from repro_torch.kernels.gather_push import gather_push_move_plain

    def push_(counts, *arrays_and_tiles, **kw):
        *arrays, tiles = arrays_and_tiles
        *outs, cnt = gather_push_move_plain(counts, *arrays, tiles, **kw)
        for a, out in zip(arrays, outs):
            a.copy_(out)
        return cnt

    saved = (ops.gather_push_move_, ops.deposit_local_tiles_from_momenta)
    ops.gather_push_move_, ops.deposit_local_tiles_from_momenta = (
        push_, deposit_local_tiles_from_momenta_plain
    )
    try:
        yield
    finally:
        ops.gather_push_move_, ops.deposit_local_tiles_from_momenta = saved


def slot_case(case: str, grid, local, cap: int, gen, device):
    """The five slot geometries of the reference's kernel-backend tests
    (``tests/test_kernel_backends.py``), at 64² boxes: ``(tiles6, p,
    origins, counts)`` on ``device``."""
    import torch

    from repro_torch.pic.particles import Particles

    counts = {
        "all-empty": [0, 0, 0, 0],
        "all-in-one-box": [cap, 0, 0, 0],
        "at-capacity": [cap] * 4,
        "tile-boundaries": [1, 255, 256, 257],
        "box-edge-seam": [137, 256, 0, 490],
    }[case]
    S = grid.n_boxes
    coords = torch.as_tensor(grid.box_coords, device=device).float()
    lz_b, lx_b = grid.box_nz * grid.dz, grid.box_nx * grid.dx
    z0 = (coords[:, 0] * lz_b)[:, None]
    x0 = (coords[:, 1] * lx_b)[:, None]
    shape = (S, cap)
    if case == "box-edge-seam":
        edge = torch.rand(shape, generator=gen, device=device) * grid.dz
        side = torch.randint(0, 4, shape, generator=gen, device=device)
        along_z = z0 + torch.rand(shape, generator=gen, device=device) * lz_b
        along_x = x0 + torch.rand(shape, generator=gen, device=device) * lx_b
        z = torch.where(side == 0, z0 + edge, torch.where(side == 1, z0 + lz_b - edge, along_z))
        x = torch.where(side == 2, x0 + edge, torch.where(side == 3, x0 + lx_b - edge, along_x))
    else:
        z = z0 + (0.05 + 0.9 * torch.rand(shape, generator=gen, device=device)) * lz_b
        x = x0 + (0.05 + 0.9 * torch.rand(shape, generator=gen, device=device)) * lx_b
    z = torch.minimum(torch.maximum(z, z0), torch.nextafter(z0 + lz_b, z0))
    x = torch.minimum(torch.maximum(x, x0), torch.nextafter(x0 + lx_b, x0))
    counts_t = torch.tensor(counts, device=device)
    alive = torch.arange(cap, device=device)[None, :] < counts_t[:, None]
    u = torch.randn((3,) + shape, generator=gen, device=device) * 0.1
    p = Particles(
        z=z.contiguous(), x=x.contiguous(), ux=u[0].contiguous(), uy=u[1].contiguous(),
        uz=u[2].contiguous(),
        w=0.5 + torch.rand(shape, generator=gen, device=device),
        alive=alive,
        q=torch.full((), -1.0, device=device), m=torch.full((), 1.0, device=device),
    )
    halo = (local.nz - grid.box_nz) // 2
    origins = torch.stack(
        [(coords[:, 0] * grid.box_nz - halo) * grid.dz, (coords[:, 1] * grid.box_nx - halo) * grid.dx], 1
    )
    tiles6 = torch.randn((S, 6, local.nz, local.nx), generator=gen, device=device) * 0.01
    return tiles6, p, origins, counts_t


def check_slots(label: str, tiles6, species, origins, local, grid, errs: dict) -> None:
    """``particle_phase_slots`` with the kernels against itself with their
    plain versions: counters bitwise (and, for one species, bitwise equal to
    ``box_work_counters`` of the alive counts), J within 2e-5·max|J|,
    pushed state within rtol 2e-5 / atol 1e-6, the same alive lanes."""
    import torch

    from repro_torch.kernels.ops import particle_phase_slots
    from repro_torch.pic.deposition import box_work_counters

    k_sp, k_j, k_c, k_w = particle_phase_slots(tiles6, species, origins, local, domain_grid=grid)
    with plain_kernels():
        p_sp, p_j, p_c, p_w = particle_phase_slots(tiles6, species, origins, local, domain_grid=grid)
    torch.cuda.synchronize()
    if not torch.equal(k_w, p_w):
        raise AssertionError(f"sharded: slot counters differ from the plain versions' ({label})")
    if len(species) == 1:
        formula = box_work_counters(species[0].alive.sum(1), grid)
        if not torch.equal(k_w, formula):
            raise AssertionError(f"sharded: slot counters differ from box_work_counters ({label})")
    if not torch.equal(k_c, p_c):
        raise AssertionError(f"sharded: slot alive counts differ ({label})")
    scale = max(float(p_j.abs().max()), 1e-30)
    err = float((k_j - p_j).abs().max())
    if err > 2e-5 * scale:
        raise AssertionError(f"sharded: slot J differs ({label}): {err} > 2e-5*{scale}")
    errs["deposition"] = max(errs["deposition"], err)
    for k, p in zip(k_sp, p_sp):
        if not torch.equal(k.alive, p.alive):
            raise AssertionError(f"sharded: alive lanes differ ({label})")
        for name in ("z", "x", "ux", "uy", "uz"):
            a, b = getattr(k, name), getattr(p, name)
            if bool(((a - b).abs() > 1e-6 + 2e-5 * b.abs()).any()):
                raise AssertionError(f"sharded: pushed {name} differs ({label})")
            errs["gather_push"] = max(errs["gather_push"], float((a - b).abs().max()))


def slot_kernel_phase(rt, record: dict) -> None:
    """Phase 5a: both kernels through ``particle_phase_slots`` at the full
    width's slot shapes and on the five reference geometries; each kernel's
    launch alone at the slot shapes beside its bound."""
    import torch

    from repro_torch.kernels._build import persistent_blocks
    from repro_torch.kernels.deposition import (
        deposit_local_tiles,
        deposition_from_momenta_launcher,
        deposition_launcher,
    )
    from repro_torch.kernels.gather_push import gather_push_launcher
    from repro_torch.pic.grid import Grid2D
    from repro_torch.pic.particles import Particles

    local, grid = rt.local_grid, rt.grid
    bz, bx = local.nz, local.nx
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kernel, n_tiles in (("gather_push", 6), ("deposition", 3), ("deposition_from_momenta", 3)):
        blocks = persistent_blocks(kernel, bz, bx, torch.cuda.current_device())
        log(
            f"sharded: {kernel} persistent grid at {bz}x{bx} tiles: {blocks} blocks "
            f"({blocks / sms:g} per SM), {n_tiles * bz * bx * 4} B of shared memory per block"
        )
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20210424)
    errs = {"gather_push": 0.0, "deposition": 0.0}
    sp = rt._species[0][0]
    e = Particles(**sp, q=rt._dev[0]["q"][0], m=rt._dev[0]["m"][0])
    S, cap = e.z.shape
    tiles6 = torch.randn((S, 6, bz, bx), generator=gen, device="cuda") * 0.5
    origins = rt._dev[0]["origins"]
    check_slots("full width, electrons", tiles6, (e,), origins, local, grid, errs)
    log(f"sharded: kernels at the slot shapes ({S} slots, cap {cap}, {bz}x{bx} tiles) match their plain versions")

    # each launch alone, on the inputs particle_phase_slots gives the kernels
    counts = e.alive.sum(1).to(torch.int32)
    sz = ((e.z - origins[:, 0:1]) / local.dz).contiguous()
    sx = ((e.x - origins[:, 1:2]) / local.dx).contiguous()
    arrays = [sz, sx, e.ux.clone(), e.uy.clone(), e.uz.clone()]
    tiles = tuple(tiles6[:, i].contiguous() for i in range(6))
    kw = dict(grid=local, qm=e.q / e.m, dt=float(local.dt), tile_shape=(bz, bx))
    launch, _ = gather_push_launcher(counts, arrays, tiles, **kw)
    gp_ms = cuda_time_ms(launch)
    v = [(u * 0.01).contiguous() for u in arrays[2:]]
    launch, _ = deposition_launcher(
        counts, sz, sx, *v, grid=local, tile_shape=(bz, bx), cells_per_box=grid.cells_per_box
    )
    dp_ms = cuda_time_ms(launch)
    exec_lanes = int((((counts.long() + 255) // 256) * 256).sum())
    occupied = int((counts > 0).sum())
    gp_bound = bound_ms(
        40 * exec_lanes + 24 * bz * bx * occupied + 2 * S * 4,
        exec_lanes * GATHER_PUSH_FLOPS_PER_LANE,
    )
    dp_bound = bound_ms(
        5 * exec_lanes * 4 + 3 * S * bz * bx * 4 + 2 * S * 4,
        exec_lanes * DEPOSITION_FLOPS_PER_LANE,
    )
    log(
        f"sharded: slot shapes, {exec_lanes} executed lanes in {occupied} occupied slots: "
        f"gather_push_move_ {gp_ms:.3f} ms (bound {gp_bound[0]:.4f} by {gp_bound[1]}), "
        f"deposition {dp_ms:.3f} ms (bound {dp_bound[0]:.4f} by {dp_bound[1]})"
    )
    # the momenta form on the slot path: a mask that also leaves out some
    # alive lanes, as it leaves out leavers
    live = (e.alive & (torch.rand(e.alive.shape, generator=gen, device="cuda") > 0.01)).contiguous()
    w, volume = e.w.contiguous(), grid.dz * grid.dx
    dep_kw = dict(grid=local, tile_shape=(bz, bx), cells_per_box=grid.cells_per_box)
    check_fused("full width slots", "slot", counts, sz, sx, arrays[2:], w, e.q, live, volume, dep_kw, errs)
    launch, _ = deposition_from_momenta_launcher(
        counts, sz, sx, *arrays[2:], w, q=e.q, live=live, **momenta_scales("slot", volume), **dep_kw
    )
    fused_ms = cuda_time_ms(launch)
    unfused_ms = cuda_time_ms(lambda: deposit_local_tiles(
        counts, sz, sx, *unfused_values("slot", counts, arrays[2:], w, e.q, live, volume), **dep_kw
    ))
    log(
        f"sharded: slot shapes, the momenta form: launch alone {fused_ms:.3f} ms; the glue it "
        f"replaced plus deposit_local_tiles {unfused_ms:.3f} ms"
    )
    del arrays, tiles, v, sz, sx, launch, tiles6, e, live, w

    # the reference's five slot geometries, scaled to 64² boxes
    g4 = Grid2D(nz=2 * grid.box_nz, nx=2 * grid.box_nx, dz=grid.dz, dx=grid.dx,
                box_nz=grid.box_nz, box_nx=grid.box_nx)
    for case in ("all-empty", "all-in-one-box", "at-capacity", "tile-boundaries", "box-edge-seam"):
        t6, p, o, c = slot_case(case, g4, local, 512, gen, "cuda")
        check_slots(case, t6, (p,), o, local, g4, errs)
        log(f"sharded: slot case {case:16s} ok  (counts {c.tolist()})")
    record["gather_push"]["max_abs_err"] = max(record["gather_push"]["max_abs_err"], errs["gather_push"])
    record["deposition"]["max_abs_err"] = max(record["deposition"]["max_abs_err"], errs["deposition"])
    torch.cuda.empty_cache()


def alive_prefix_ok(rt) -> bool:
    """Every slot's alive particles sit in its leading lanes."""
    import torch

    for per_device in rt._species:
        for sp in per_device:
            alive = sp["alive"]
            lane = torch.arange(alive.shape[1], device=alive.device)[None, :]
            if not bool((alive == (lane < alive.sum(1, keepdim=True))).all()):
                return False
    return True


def sharded_run(rt, n_steps: int, label: str, record: dict):
    """Drive ``rt`` ``n_steps`` steps with the launch counts zeroed just
    before; check the launches, drops, fetches and alive-prefix invariant;
    returns ms per step of each interval."""
    import numpy as np
    import torch

    from repro_torch.kernels.deposition import deposit_local_tiles, deposit_local_tiles_from_momenta
    from repro_torch.kernels.gather_push import gather_push_move

    n_sp = len(rt._qm)
    syncs0 = rt.host_syncs
    gather_push_move.launches = 0
    deposit_local_tiles.launches = 0
    deposit_local_tiles_from_momenta.launches = 0
    ms = []
    for _ in range(n_steps // rt.lb_interval):
        torch.cuda.synchronize()
        host0 = rt.pipeline_stats()
        t0 = time.perf_counter()
        rt.run(rt.lb_interval)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / rt.lb_interval)
        host = {k: (rt.pipeline_stats()[k] - host0[k]) * 1e3 / rt.lb_interval
                for k in ("dispatch_s", "fetch_s", "balance_s")}
        peaks = rt.last_history["emig_demand"].max(axis=(0, 2)).tolist()
        log(
            f"sharded: {label} interval: {ms[-1]:.2f} ms/step (host: issuing {host['dispatch_s']:.2f}, "
            f"waiting for the fetch {host['fetch_s']:.2f}, LB turnaround {host['balance_s']:.2f} ms/step), "
            f"emig_demand peaks per species {peaks}"
        )
    want = n_steps * n_sp * rt.n_devices
    for fn in (gather_push_move, deposit_local_tiles, deposit_local_tiles_from_momenta):
        if fn.launches != want:
            raise AssertionError(f"sharded: {label}: {fn.__name__} launched {fn.launches} times, want {want}")
    record["gather_push"]["launches"] += gather_push_move.launches
    record["deposition"]["launches"] += deposit_local_tiles.launches
    if rt.host_syncs - syncs0 != n_steps // rt.lb_interval:
        raise AssertionError(f"sharded: {label}: {rt.host_syncs - syncs0} fetches for {n_steps} steps")
    if rt.dropped_total != 0:
        raise AssertionError(f"sharded: {label}: dropped_total {rt.dropped_total}")
    if not alive_prefix_ok(rt):
        raise AssertionError(f"sharded: {label}: the alive-prefix invariant is broken")
    h = rt.history
    if not (np.isfinite(h["field_energy"]).all() and np.isfinite(h["kinetic_energy"]).all()):
        raise AssertionError(f"sharded: {label}: non-finite energies")
    return ms


def full_width_problem():
    from repro_torch.pic import laser_ion_problem

    return laser_ion_problem(nz=1920, nx=1920, box_cells=64, ppc=16, mass_ratio=1836, device="cuda")


def sharded_phase(record: dict) -> None:
    import numpy as np
    import torch

    from repro_torch.dist import ShardedRuntime

    kw = dict(engine_backend="cuda", comm="neighbor", lb_interval=10, strict_syncs=True)
    # b. one logical device at full width (5a uses its packed slot stacks)
    t0 = time.perf_counter()
    rt = ShardedRuntime(full_width_problem(), 1, **kw)
    n_particles = rt.total_alive()
    log(
        f"sharded: setup {time.perf_counter() - t0:.1f} s; 1 logical device, {rt.grid.n_boxes} slots, "
        f"caps {rt._caps}, {n_particles} particles, mig caps {rt.migration_stats()['caps']}"
    )
    slot_kernel_phase(rt, record)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = sharded_run(rt, 20, "1 device", record)
    if rt.host_syncs != 2:
        raise AssertionError(f"sharded: host_syncs {rt.host_syncs}, want 2")
    log(
        f"sharded: 1 device: {ms[1]:.2f} ms/step in interval 1, "
        f"{n_particles * 1e3 / ms[1]:.4g} particle pushes/s, census {rt.total_alive()}, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    log(f"sharded: 1 device comm_stats {rt.comm_stats()}")
    log(f"sharded: 1 device migration_stats {rt.migration_stats()}")
    log(f"sharded: 1 device LB events {[(e.step, e.adopted) for e in rt.balancer.events]}")
    energies_b = {k: list(rt.history[k]) for k in ("field_energy", "kinetic_energy")}
    census_b = rt.total_alive()
    # e. one profiled interval of run b
    profile_interval(rt)
    del rt
    torch.cuda.empty_cache()

    # c. four logical devices on one card, a forced adoption half way
    rt = ShardedRuntime(full_width_problem(), 4, **kw)
    ms4 = sharded_run(rt, 10, "4 devices", record)
    before = rt.comm_stats()
    mapping = np.asarray(rt.balancer.mapping).copy()
    curve = rt._curve
    # the 8 boxes deepest inside device 0's and device 1's curve blocks
    swap = []
    for d in (0, 1):
        boxes = np.where(mapping == d)[0]
        boxes = boxes[np.argsort(curve[boxes])]
        mid = len(boxes) // 2
        swap.append(boxes[mid - 4 : mid + 4])
    mapping[swap[0]], mapping[swap[1]] = 1, 0
    rt.apply_mapping(mapping)
    after = rt.comm_stats()
    if after == before:
        raise AssertionError("sharded: the forced adoption left comm_stats unchanged")
    ms4 += sharded_run(rt, 10, "4 devices, after the adoption", record)
    for k, ref in energies_b.items():
        np.testing.assert_allclose(rt.history[k], ref, rtol=1e-3, err_msg=f"4 vs 1 device {k}")
    if rt.total_alive() != census_b:
        raise AssertionError(f"sharded: census {rt.total_alive()} on 4 devices, {census_b} on 1")
    log(
        f"sharded: 4 devices: {ms4} ms/step per interval, census {rt.total_alive()} (1 device: {census_b}), "
        f"hop_radius {rt.hop_radius()}, lb_steps {rt.history['lb_steps']}"
    )
    log(f"sharded: 4 devices comm_stats before the adoption {before}")
    log(f"sharded: 4 devices comm_stats after the adoption {after}")
    log(f"sharded: 4 devices migration_stats {rt.migration_stats()}")
    log("sharded: profile of one more interval on 4 devices:")
    profile_interval(rt)
    del rt
    torch.cuda.empty_cache()
    cross_checks()


# ---------------------------------------------------------------------------
# phase 6: the async interval pipeline and checkpointed recovery
# ---------------------------------------------------------------------------


def launch_counters():
    from repro_torch.kernels.deposition import deposit_local_tiles, deposit_local_tiles_from_momenta
    from repro_torch.kernels.gather_push import gather_push_move

    return {
        "gather_push": gather_push_move,
        "deposition": deposit_local_tiles,
        "deposition_from_momenta": deposit_local_tiles_from_momenta,
    }


def read_launches(record: dict, want: int, label: str) -> None:
    """Check that each kernel launched ``want`` times since its count was
    zeroed (every deposition of a step is the momenta form), and add the
    launches to the JSON record."""
    for key, fn in launch_counters().items():
        if fn.launches != want:
            raise AssertionError(f"{label}: {fn.__name__} launched {fn.launches} times, want {want}")
        if key in record:
            record[key]["launches"] += fn.launches


def async_phase(record: dict, smi: str) -> None:
    """Phase 6a: sync against async on four logical devices at 1920², run
    in turns (sync, async, async, sync) so both see the same card state."""
    import numpy as np
    import torch

    from repro_torch.dist import ShardedRuntime

    kw = dict(engine_backend="cuda", comm="neighbor", lb_interval=10, strict_syncs=True)
    n_steps, runs, totals = 30, {}, {"sync": [], "async": []}
    for pipeline in ("sync", "async", "async", "sync"):
        rt = ShardedRuntime(full_width_problem(), 4, pipeline=pipeline, **kw)
        n_sp = len(rt._qm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in launch_counters().values():
            fn.launches = 0
        wall = []
        t_start = time.perf_counter()
        for _ in range(n_steps // rt.lb_interval):
            t0 = time.perf_counter()
            rt.run(rt.lb_interval)
            wall.append((time.perf_counter() - t0) * 1e3 / rt.lb_interval)
        in_flight = rt.pipeline_stats()
        rt.flush()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t_start) * 1e3 / n_steps
        read_launches(record, n_steps * n_sp * rt.n_devices, f"async: {pipeline}")
        stats = rt.pipeline_stats()
        want_pending = 0 if pipeline == "sync" else 1
        if in_flight["pending"] != want_pending or in_flight["harvests"] != 3 - want_pending:
            raise AssertionError(f"async: {pipeline}: before the flush {in_flight}")
        if stats["harvests"] != 3 or rt.host_syncs != 3 or stats["pending"] != 0:
            raise AssertionError(f"async: {pipeline}: {stats}, host_syncs {rt.host_syncs}")
        if rt.dropped_total != 0 or not alive_prefix_ok(rt):
            raise AssertionError(f"async: {pipeline}: drops {rt.dropped_total} or a broken alive prefix")
        runs.setdefault(pipeline, dict(
            history={k: list(rt.history[k]) for k in ("field_energy", "kinetic_energy")},
            census=rt.total_alive(),
        ))
        totals[pipeline].append(total)
        log(
            f"async: {pipeline} on 4 devices ({smi}): {[round(m, 2) for m in wall]} ms/step per "
            f"interval on the host clock, {total:.2f} ms/step for the {n_steps} steps to the last "
            f"flush and synchronize; lb_steps {rt.history['lb_steps']}, census {rt.total_alive()}, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
        )
        log(f"async: {pipeline} pipeline_stats {stats}")
        if len(totals[pipeline]) == 1:
            log(f"async: profile of one more interval under {pipeline}:")
            profile_interval(rt, top=6)
        del rt
        torch.cuda.empty_cache()
    for k, ref in runs["sync"]["history"].items():
        np.testing.assert_allclose(runs["async"]["history"][k], ref, rtol=1e-3, err_msg=f"async vs sync {k}")
    if runs["async"]["census"] != runs["sync"]["census"]:
        raise AssertionError(f"async: census {runs['async']['census']} vs sync {runs['sync']['census']}")
    rel = max(abs(a / b - 1) for a, b in zip(runs["async"]["history"]["field_energy"],
                                             runs["sync"]["history"]["field_energy"]) if b)
    log(f"async: async vs sync: same census, max rel field energy diff {rel:.3g}; ms/step in turns "
        f"sync {totals['sync'][0]:.2f}, async {totals['async'][0]:.2f}, async {totals['async'][1]:.2f}, "
        f"sync {totals['sync'][1]:.2f} ({smi})")


def recovery_phase(record: dict, smi: str) -> None:
    """Phase 6b: RecoveryRunner over the async runtime, 4 -> 3 devices."""
    import gc
    import shutil

    import numpy as np
    import torch

    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.dist import Fault, FaultInjector, FaultSchedule, RecoveryRunner, ShardedRuntime

    ckpt_dir = ROOT / "chip_scratch" / "smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    kw = dict(engine_backend="cuda", comm="neighbor", lb_interval=10, strict_syncs=True,
              pipeline="async")

    def make(n_devices):
        return ShardedRuntime(full_width_problem(), n_devices, **kw)

    inj = FaultInjector(FaultSchedule([Fault("kill_device", interval=2, device=1)]))
    n_steps = 40
    for fn in launch_counters().values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    runner = RecoveryRunner(make, 4, ckpt_dir=ckpt_dir, keep=2, injector=inj)
    runner.run(n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_sp = len(runner.runtime._qm)
    # intervals 0-2 on 4 devices (2 lost with device 1), 2-3 again on 3
    read_launches(record, 30 * n_sp * 4 + 20 * n_sp * 3, "recovery")
    restores = [e for e in runner.events if e["kind"] == "restore"]
    if len(restores) != 1 or restores[0]["ckpt_step"] != 20 or runner.n_devices_active != 3:
        raise AssertionError(f"recovery: events {runner.events}")
    rt = runner.runtime
    if rt.step_idx != n_steps or rt.dropped_total != 0 or not alive_prefix_ok(rt):
        raise AssertionError(f"recovery: step {rt.step_idx}, drops {rt.dropped_total}")
    newest = ckpt_dir / f"step_{n_steps:010d}"
    ckpt_bytes = sum(p.stat().st_size for p in newest.iterdir())
    t1 = time.perf_counter()
    tree, _ = restore_checkpoint(ckpt_dir, None)
    load_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    save_checkpoint(ckpt_dir / "timed", tree, n_steps)
    write_s = time.perf_counter() - t1
    ckpts = [e for e in runner.events if e["kind"] == "checkpoint"]
    got = {k: list(rt.history[k]) for k in ("field_energy", "kinetic_energy")}
    census = rt.total_alive()
    log(
        f"recovery: 4 -> 3 devices ({smi}): {wall:.1f} s for {n_steps} steps with "
        f"{len(ckpts)} checkpoints; restore of step {restores[0]['ckpt_step']} at step "
        f"{restores[0]['from_step']}, {restores[0]['intervals_lost']} intervals lost, "
        f"{restores[0]['restore_s']:.2f} s to rebuild on 3 devices and restore; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )
    log(
        f"recovery: checkpoint {ckpt_bytes} bytes; snapshot {[e['snapshot_s'] for e in ckpts]} s, "
        f"checkpoint call (snapshot + handing the write to its thread) {[e['wall_s'] for e in ckpts]} s; "
        f"one synchronous write {write_s:.2f} s, one template-free load {load_s:.2f} s"
    )
    log(f"recovery: events {[{k: v for k, v in e.items() if k != 'error'} for e in runner.events]}")
    del tree, rt, runner
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    ref = make(3)
    ref.run(n_steps)
    ref.flush()
    for k, want in got.items():
        np.testing.assert_allclose(want, ref.history[k][n_steps - len(want):], rtol=1e-3,
                                   err_msg=f"recovered vs uninterrupted {k}")
    if ref.total_alive() != census:
        raise AssertionError(f"recovery: census {census}, uninterrupted {ref.total_alive()}")
    log(f"recovery: matches an uninterrupted 3-device run: census {census}, "
        f"energies of steps {n_steps - len(got['field_energy']) + 1}-{n_steps} within rtol 1e-3")
    del ref
    torch.cuda.empty_cache()


def cross_checks() -> None:
    """Phase 5d at 256²: cuda vs torch, torch vs the global solver, ring vs
    neighbour; energies within rtol 1e-3 and the same census."""
    import numpy as np

    from repro_torch.dist import ShardedRuntime
    from repro_torch.pic import SimConfig, Simulation, laser_ion_problem

    def problem():
        return laser_ion_problem(nz=256, nx=256, box_cells=32, ppc=16, device="cuda")

    def sharded(**kw):
        rt = ShardedRuntime(problem(), 4, lb_interval=10, improvement_threshold=10.0,
                            strict_syncs=True, **kw)
        rt.run(10)
        return rt.history, rt.total_alive()

    sim = Simulation(problem(), SimConfig(engine_backend="torch", strict_syncs=True))
    sim.run(10)
    runs = {
        "cuda": sharded(engine_backend="cuda"),
        "torch": sharded(engine_backend="torch"),
        "ring": sharded(engine_backend="cuda", comm="ring"),
        "global": (sim.history, sum(int(p.alive.sum()) for p in sim.species)),
    }
    for a, b in (("cuda", "torch"), ("torch", "global"), ("ring", "cuda")):
        (ha, ca), (hb, cb) = runs[a], runs[b]
        for k in ("field_energy", "kinetic_energy"):
            np.testing.assert_allclose(ha[k], hb[k], rtol=1e-3, err_msg=f"{a} vs {b} {k}")
        if ca != cb:
            raise AssertionError(f"sharded: census {a} {ca} vs {b} {cb}")
        rel = max(abs(x / y - 1) for x, y in zip(ha["field_energy"], hb["field_energy"]) if y)
        log(f"sharded: 256^2 {a} vs {b}: census {ca}, max rel field energy diff {rel:.3g}")


# ---------------------------------------------------------------------------
# phase 7: the activity-ledger strategy, the strong-scaling model,
# split-phase stepping, BoxRuntime and the sharded FDTD
# ---------------------------------------------------------------------------


def _ranks(a):
    """Ranks with ties averaged (for Spearman's correlation)."""
    import numpy as np

    order = np.argsort(a, kind="stable")
    ranks = np.empty(len(a), np.float64)
    ranks[order] = np.arange(len(a), dtype=np.float64)
    for v in np.unique(a):
        tie = a == v
        ranks[tie] = ranks[tie].mean()
    return ranks


def _pearson(a, b) -> float:
    import numpy as np

    return float(np.corrcoef(np.asarray(a, np.float64), np.asarray(b, np.float64))[0, 1])


def box_device_times(sim, reps: int = 3):
    """Device time of the plain deposit of each (species, box) subset of
    the current state, summed per box, with the host's issue hidden: a
    sleep kernel holds the card while the launches queue, so the events
    bracket device work only (median of ``reps``).  Returns the boxes and
    their milliseconds."""
    import numpy as np
    import torch

    from repro_torch.pic.deposition import deposit_current

    per_box = {}
    for b, sub in sim.box_subsets():
        times = []
        for _ in range(reps + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(20_000_000)
            start.record()
            deposit_current(sub, sim.grid, sim.config.shape_order)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        per_box[b] = per_box.get(b, 0.0) + statistics.median(times[1:])
    boxes = np.array(sorted(per_box))
    return boxes, np.array([per_box[b] for b in boxes])


def ledger_phase(record: dict, smi: str) -> dict:
    """Phase 7a: ``activity_ledger`` against ``work_counter`` on the main
    path (1920², cuda kernels, 8 virtual devices, LB every 10), 20 steps
    each, in turns (ledger, counter, counter, ledger).  Returns the first
    counter run, for 7b."""
    import numpy as np
    import torch

    from repro_torch.pic import SimConfig, Simulation

    runs = {"activity_ledger": [], "work_counter": []}
    keep = None
    for strategy in ("activity_ledger", "work_counter", "work_counter", "activity_ledger"):
        sim = Simulation(full_width_problem(), SimConfig(
            engine_backend="cuda", cost_strategy=strategy, lb_interval=10,
            n_virtual_devices=8, strict_syncs=True,
        ))
        n_sp = len(sim.species)
        torch.cuda.synchronize()
        for fn in launch_counters().values():
            fn.launches = 0
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            sim.run(10)  # each interval opens with a measurement round
            ms.append((time.perf_counter() - t0) * 1e3 / 10)
        read_launches(record, 20 * n_sp, f"ledger: {strategy}")
        if sim.history["lb_steps"] and not set(sim.history["lb_steps"]) <= {0, 10}:
            raise AssertionError(f"ledger: {strategy}: lb_steps {sim.history['lb_steps']} off the rounds")
        if [e.step for e in sim.balancer.events] != [0, 10]:
            raise AssertionError(f"ledger: {strategy}: LB events at {[e.step for e in sim.balancer.events]}")
        for e in sim.balancer.events:
            if not (np.isfinite(e.current_efficiency) and np.isfinite(e.proposed_efficiency)):
                raise AssertionError(f"ledger: {strategy}: non-finite event {e}")
        if not np.isfinite(sim.history["field_energy"]).all():
            raise AssertionError(f"ledger: {strategy}: non-finite energies")
        runs[strategy].append(ms)
        log(f"ledger: {strategy} ({smi}): {[round(m, 2) for m in ms]} ms/step per interval "
            f"(each with one measurement round), lb_steps {sim.history['lb_steps']}, events "
            f"{[(e.step, e.adopted, round(e.current_efficiency, 4), round(e.proposed_efficiency, 4)) for e in sim.balancer.events]}")
        for rnd in sim.activity_rounds:
            timed = rnd["box_s"] > 0
            cost, work = rnd["box_s"][timed], rnd["work"][timed]
            slope, icept = np.polyfit(work, cost * 1e3, 1)
            log(f"ledger: round at step {rnd['step']}: {rnd['records']} records over {int(timed.sum())} boxes, "
                f"{rnd['host_s'] * 1e3:.1f} ms on the host clock, summed event time "
                f"{rnd['box_s'].sum() * 1e3:.2f} ms (per box min/median/max "
                f"{cost.min() * 1e3:.3f}/{np.median(cost) * 1e3:.3f}/{cost.max() * 1e3:.3f} ms, fit "
                f"{icept:.3f} ms + {slope * 1e6:.4f} ms per 1e6 work units); ledger cost vs work counter over "
                f"those boxes: Pearson {_pearson(cost, work):.4f}, Spearman "
                f"{_pearson(_ranks(cost), _ranks(work)):.4f}")
        if strategy == "activity_ledger" and len(runs[strategy]) == 2:
            # the same deposits with the host's issue time hidden: does the
            # counter track the device time per box?
            from repro_torch.pic.deposition import box_particle_counts, box_work_counters

            boxes, dev_ms = box_device_times(sim)
            counts = sum(box_particle_counts(p, sim.grid) for p in sim.species)
            work = box_work_counters(counts, sim.grid).cpu().numpy()[boxes]
            slope, icept = np.polyfit(work, dev_ms, 1)
            log(f"ledger: device time per box of the same deposits with the host's issue hidden "
                f"({len(boxes)} boxes, final state): min/median/max {dev_ms.min():.4f}/"
                f"{np.median(dev_ms):.4f}/{dev_ms.max():.4f} ms, fit {icept:.4f} ms + "
                f"{slope * 1e6:.4f} ms per 1e6 work units; vs work counter Pearson "
                f"{_pearson(dev_ms, work):.4f}, Spearman {_pearson(_ranks(dev_ms), _ranks(work)):.4f}")
        if strategy == "work_counter" and keep is None:
            keep = sim
        else:
            del sim
        torch.cuda.empty_cache()
    for i in range(2):
        led = [r[i] for r in runs["activity_ledger"]]
        cnt = [r[i] for r in runs["work_counter"]]
        log(f"ledger: interval {i}: activity_ledger {led} vs work_counter {cnt} ms/step, ratio of the means "
            f"{statistics.mean(led) / statistics.mean(cnt):.3f} ({smi})")
    return keep


def perfmodel_phase(lb_sim, record: dict, smi: str) -> None:
    """Phase 7b: the paper's Eq. 2 on the main path's first interval, and
    the VirtualCluster model's speedup of LB over no LB (a model of
    ``n_virtual_devices`` devices, not a measurement)."""
    import torch

    from repro_torch.core import fraction_of_predicted, imbalance_summary, predicted_max_speedup
    from repro_torch.pic import SimConfig, Simulation

    steps = len(lb_sim.history["efficiency"])
    off = Simulation(full_width_problem(), SimConfig(
        engine_backend="cuda", lb_enabled=False, lb_interval=10, n_virtual_devices=8,
        strict_syncs=True,
    ))
    for fn in launch_counters().values():
        fn.launches = 0
    off.run(steps)
    read_launches(record, steps * len(off.species), "perfmodel: lb_enabled=False")
    e0 = imbalance_summary(off.history["max_over_avg"])["e0"]
    speedup = off.modeled_walltime / lb_sim.modeled_walltime
    log(f"perfmodel: E0 {e0:.4f} (first step, no LB); predicted max speedup (1/E0)^x: "
        f"x=0.91 {predicted_max_speedup(e0, 0.91):.4f}, x=1 {predicted_max_speedup(e0, 1.0):.4f}")
    log(f"perfmodel: VirtualCluster model over {steps} steps on 8 modelled devices (a model, not a "
        f"measurement): LB {lb_sim.modeled_walltime:.6g} s vs no LB {off.modeled_walltime:.6g} s, "
        f"modelled speedup {speedup:.4f}, fraction of predicted (x=0.91) "
        f"{fraction_of_predicted(speedup, e0, 0.91):.4f}, lb_steps {lb_sim.history['lb_steps']} ({smi})")
    del off
    torch.cuda.empty_cache()


def overlap_phase(smi: str) -> None:
    """Phase 7c: split-phase stepping on four logical devices at 1920²
    (plain tensor path), against the monolithic step on the same steps; the
    interval_trace order check; the cuda backend must refuse overlap."""
    import numpy as np
    import torch

    from repro_torch.dist import ShardedRuntime, split_phase_order
    from repro_torch.pic import laser_ion_problem

    try:
        ShardedRuntime(laser_ion_problem(nz=256, nx=256, box_cells=32, ppc=1, device="cuda"), 4,
                       engine_backend="cuda", overlap=True)
    except ValueError as e:
        log(f"overlap: engine_backend='cuda' with overlap=True raises: {e}")
    else:
        raise AssertionError("overlap: engine_backend='cuda' with overlap=True did not raise")

    kw = dict(engine_backend="torch", comm="neighbor", strict_syncs=True, improvement_threshold=10.0)
    probe = ShardedRuntime(full_width_problem(), 4, lb_interval=10, **kw)
    probe.run(1)  # the first step also pays the allocator's growth
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probe.run(1)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    del probe
    torch.cuda.empty_cache()
    # about 20 s for both runs; the split pays a second deposit sweep
    fit = int(10.0 / step_s)
    n = max(2, min(10, fit))
    note = "a whole interval" if n == 10 else f"lb_interval cut to the {n} steps that fit"
    log(f"overlap: plain path {step_s * 1e3:.1f} ms/step measured first; running {n} steps each ({note})")
    out = {}
    for overlap in (False, True):
        rt = ShardedRuntime(full_width_problem(), 4, lb_interval=n, overlap=overlap, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rt.run(n)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        if rt.dropped_total or not np.isfinite(rt.history["field_energy"]).all():
            raise AssertionError(f"overlap={overlap}: drops {rt.dropped_total} or non-finite energies")
        out[overlap] = (np.stack([c.numpy() for c in rt.fields]), rt.total_alive())
        log(f"overlap: overlap={overlap} on 4 logical devices at 1920^2 ({smi}): {ms:.1f} ms/step over {n} "
            f"steps, census {rt.total_alive()}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del rt
        torch.cuda.empty_cache()
    (f_ser, n_ser), (f_ovl, n_ovl) = out[False], out[True]
    rel = float(np.abs(f_ovl - f_ser).max() / max(np.abs(f_ser).max(), 1e-30))
    if rel > 1e-5 or n_ovl != n_ser:
        raise AssertionError(f"overlap: fields differ by {rel:.3g} of max, census {n_ovl} vs {n_ser}")
    log(f"overlap: split-phase vs monolithic: max|dF|/max {rel:.3g}, census {n_ser} on both")

    rt = ShardedRuntime(laser_ion_problem(nz=256, nx=256, box_cells=32, ppc=16, device="cuda"), 4,
                        lb_interval=2, overlap=True, **kw)
    spans = rt.interval_trace()
    bad = split_phase_order(spans, 4)
    if bad:
        raise AssertionError(f"overlap: interval_trace order: {bad[:5]}")
    log(f"overlap: interval_trace at 256^2 on 4 logical devices: {len(spans)} split-phase spans over "
        f"2 steps, the window holds (interior between exchange start and done, folds after it)")
    del rt
    torch.cuda.empty_cache()


def box_runtime_phase(smi: str) -> None:
    """Phase 7d: BoxRuntime on four logical devices: a few steps at 1920²
    through one adoption; at 256² against ShardedRuntime ("torch") and
    RecoveryRunner with device 1 killed against an uninterrupted 3-device
    run."""
    import gc
    import shutil

    import numpy as np
    import torch

    from repro_torch.dist import (
        BoxRuntime, Fault, FaultInjector, FaultSchedule, RecoveryRunner, ShardedRuntime,
    )
    from repro_torch.pic import laser_ion_problem

    t0 = time.perf_counter()
    rt = BoxRuntime(full_width_problem(), 4, lb_interval=2)
    n0 = rt.total_alive()
    log(f"box: setup {time.perf_counter() - t0:.1f} s at 1920^2 on 4 logical devices, caps {rt._caps}")
    for i in range(2):
        d0 = rt.host_dispatches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = rt.step()
        torch.cuda.synchronize()
        log(f"box: step {i}: {(time.perf_counter() - t0) * 1e3:.1f} ms, {rt.host_dispatches - d0} host "
            f"dispatches, adopted {info['adopted']} ({smi})")
        if i == 0 and not any(e.adopted for e in rt.balancer.events):
            # no adoption of its own: force one (every box to the next device)
            d0 = rt.host_dispatches
            t0 = time.perf_counter()
            rt.apply_mapping((np.asarray(rt.balancer.mapping) + 1) % 4)
            torch.cuda.synchronize()
            log(f"box: no adoption at step 0; forced one moving all {rt.grid.n_boxes} boxes to the next "
                f"logical device: {(time.perf_counter() - t0) * 1e3:.1f} ms, "
                f"{rt.host_dispatches - d0} host dispatches")
    if rt.total_alive() != n0 or not np.isfinite(np.stack([c.cpu().numpy() for c in rt.fields])).all():
        raise AssertionError(f"box: census {rt.total_alive()} vs {n0}, or non-finite fields")
    log(f"box: 1920^2 events {[(e.step, e.adopted, e.boxes_moved) for e in rt.balancer.events]}, "
        f"devices in use {rt.devices_in_use()}, census {rt.total_alive()}")
    del rt
    gc.collect()
    torch.cuda.empty_cache()

    def small():
        return laser_ion_problem(nz=256, nx=256, box_cells=32, ppc=16, device="cuda")

    box = BoxRuntime(small(), 4, lb_interval=10)
    box.run(10)
    sh = ShardedRuntime(small(), 4, lb_interval=10, engine_backend="torch", strict_syncs=True)
    sh.run(10)
    f_box = np.stack([c.numpy() for c in box.fields])
    f_sh = np.stack([c.numpy() for c in sh.fields])
    rel = float(np.abs(f_box - f_sh).max() / max(np.abs(f_sh).max(), 1e-30))
    if rel > 1e-5 or box.total_alive() != sh.total_alive():
        raise AssertionError(f"box: vs sharded {rel:.3g} of max, census {box.total_alive()} vs {sh.total_alive()}")
    log(f"box: 256^2 BoxRuntime vs ShardedRuntime(torch), 10 steps on 4 logical devices: max|dF|/max "
        f"{rel:.3g}, census {sh.total_alive()} on both")
    del box, sh

    ckpt_dir = ROOT / "chip_scratch" / "box_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    def make(k):
        return BoxRuntime(small(), k, lb_interval=2)

    inj = FaultInjector(FaultSchedule([Fault("kill_device", interval=2, device=1)]))
    t0 = time.perf_counter()
    runner = RecoveryRunner(make, 4, ckpt_dir=ckpt_dir, keep=2, injector=inj)
    runner.run(8)
    wall = time.perf_counter() - t0
    restores = [e for e in runner.events if e["kind"] == "restore"]
    if len(restores) != 1 or restores[0]["ckpt_step"] != 4 or runner.n_devices_active != 3:
        raise AssertionError(f"box: recovery events {runner.events}")
    ref = make(3)
    ref.run(8)
    got = runner.runtime
    rel = float(np.abs(np.stack([c.numpy() for c in got.fields]) - np.stack([c.numpy() for c in ref.fields])).max()
                / max(float(np.abs(np.stack([c.numpy() for c in ref.fields])).max()), 1e-30))
    if rel > 1e-5 or got.total_alive() != ref.total_alive():
        raise AssertionError(f"box: recovered vs uninterrupted {rel:.3g}, census {got.total_alive()} vs {ref.total_alive()}")
    log(f"box: RecoveryRunner 4 -> 3 logical devices at 256^2: {wall:.1f} s for 8 steps, restore of step "
        f"{restores[0]['ckpt_step']} in {restores[0]['restore_s']:.2f} s; matches an uninterrupted 3-device "
        f"run: max|dF|/max {rel:.3g}, census {ref.total_alive()}")
    del runner, got, ref
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)


def sharded_fdtd_phase(smi: str) -> None:
    """Phase 7e: the block-sharded FDTD on 2x2 logical devices at 1920²,
    50 field steps, against the global field step."""
    import torch

    from repro_torch.pic import Grid2D
    from repro_torch.pic.fields import Fields, step_b_half, step_e
    from repro_torch.pic.sharded import make_sharded_fdtd_step

    grid = Grid2D(nz=1920, nx=1920, dz=0.274, dx=0.274, box_nz=64, box_nx=64)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    f0 = [torch.randn(grid.shape, generator=gen, device="cuda") for _ in range(6)]
    j = [0.1 * torch.randn(grid.shape, generator=gen, device="cuda") for _ in range(3)]
    step, sh = make_sharded_fdtd_step(grid, [["cuda", "cuda"], ["cuda", "cuda"]])
    fb = Fields(*(sh.split(c) for c in f0))
    jb = tuple(sh.split(c) for c in j)
    ref = Fields(*f0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fb = step(fb, jb)
    torch.cuda.synchronize()
    ms_sh = (time.perf_counter() - t0) * 1e3 / 50
    t0 = time.perf_counter()
    for _ in range(50):
        ref = step_b_half(step_e(step_b_half(ref, grid), j, grid), grid)
    torch.cuda.synchronize()
    ms_ref = (time.perf_counter() - t0) * 1e3 / 50
    err = max(float((sh.join(b) - r).abs().max()) for b, r in zip(fb, ref))
    scale = max(float(r.abs().max()) for r in ref)
    if not err <= 1e-5 * scale:
        raise AssertionError(f"fdtd: 2x2 blocks vs global: max|dF| {err:.3g}, max {scale:.3g}")
    log(f"fdtd: 2x2 logical devices at 1920^2, 50 field steps: max|dF|/max {err / scale:.3g}; "
        f"{ms_sh:.2f} ms/step sharded vs {ms_ref:.2f} global ({smi})")


# ---------------------------------------------------------------------------
# phase 8: the MoE serving lane
# ---------------------------------------------------------------------------

SERVE_TOY = dict(
    name="serve-toy", kind="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
    head_dim=16, d_ff=64, vocab=64, n_experts=16, top_k=2,
)
SERVE_TOY_TRAFFIC = dict(seed=3, d_model=32, batch=2, seq=16, n_topics=8, skew=2.5,
                         period=64, night_load=0.5, flip_every=8, burst_every=12)
SERVE_FULL_TRAFFIC = dict(seed=7, batch=8, seq=1024, n_topics=16, skew=2.5,
                          night_load=1.0, flip_every=15)


@contextlib.contextmanager
def serve_taps(keep_out: bool = False):
    """Inside: every forward the serving runtimes run logs its routing stats
    (and, with ``keep_out``, its output), and every expert permutation is
    bracketed by two CUDA events; nothing waits on the device."""
    import torch

    import repro_torch.serve.expert_runtime as er

    taps = {"stats": [], "out": [], "perm_events": [], "perm_host_s": []}
    moe, permute = er.moe, er.apply_expert_permutation

    def logged_moe(p, cfg, x):
        out, stats = moe(p, cfg, x)
        taps["stats"].append({k: stats[k] for k in ("tokens_per_expert", "slots_filled",
                                                     "dropped_fraction")})
        if keep_out:
            taps["out"].append(out)
        return out, stats

    def timed_permute(p, perm):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = permute(p, perm)
        end.record()
        taps["perm_host_s"].append(time.perf_counter() - t0)
        taps["perm_events"].append((start, end))
        return out

    er.moe, er.apply_expert_permutation = logged_moe, timed_permute
    try:
        yield taps
    finally:
        er.moe, er.apply_expert_permutation = moe, permute


class TimedTraffic:
    """A traffic generator whose ``batch`` draws are timed on the host."""

    def __init__(self, gen):
        self.gen, self.seconds = gen, 0.0

    def batch(self, step):
        t0 = time.perf_counter()
        x = self.gen.batch(step)
        self.seconds += time.perf_counter() - t0
        return x


def _events(rt):
    import dataclasses

    return [dataclasses.astuple(e) for e in rt.balancer.events]


def serve_toy_phase() -> None:
    """Phase 8a: the serve-toy config and traffic through the port on the
    card and on the CPU: routing stats per step, events and mappings equal,
    outputs within 1e-5; ``einsum`` against ``sort`` on the card."""
    import numpy as np
    import torch

    from repro_torch._device import map_tensors
    from repro_torch.models import ModelConfig, init_moe, moe
    from repro_torch.serve import ExpertRuntime, TrafficConfig, TrafficGenerator

    cfg = ModelConfig(**SERVE_TOY, param_dtype=torch.float32)
    params_cpu, _ = init_moe(torch.Generator().manual_seed(0), cfg)
    params = {"cuda": map_tensors(lambda t: t.to("cuda"), params_cpu), "cpu": params_cpu}
    n_steps, runs = 30, {}
    for dev in ("cuda", "cpu"):
        rt = ExpertRuntime(params[dev], cfg, TrafficGenerator(TrafficConfig(**SERVE_TOY_TRAFFIC)),
                           n_devices=8, lb_interval=5, ema_alpha=0.5, device=dev)
        mappings = []
        with serve_taps(keep_out=True) as taps:
            for _ in range(n_steps):
                rt.step()
                mappings.append(tuple(rt.balancer.mapping))
        runs[dev] = dict(rt=rt, mappings=mappings,
                         stats=[{k: v.cpu().numpy() for k, v in s.items()} for s in taps["stats"]],
                         out=[o.cpu().numpy() for o in taps["out"]])
    a, b = runs["cuda"], runs["cpu"]
    for step, (sa, sb) in enumerate(zip(a["stats"], b["stats"])):
        for k in sa:
            if not np.array_equal(sa[k], sb[k]):
                raise AssertionError(f"serve: toy step {step}: {k} card {sa[k]} vs cpu {sb[k]}")
    err = max(float(np.abs(oa - ob).max()) for oa, ob in zip(a["out"], b["out"]))
    if err > 1e-5:
        raise AssertionError(f"serve: toy outputs card vs cpu max|d| {err:.3g}")
    if _events(a["rt"]) != _events(b["rt"]) or a["mappings"] != b["mappings"]:
        raise AssertionError("serve: toy balancer events or mappings differ between card and cpu")
    for ca, cb in zip(a["rt"].interval_costs, b["rt"].interval_costs):
        if not np.array_equal(ca, cb):
            raise AssertionError("serve: toy interval costs differ between card and cpu")
    gen = TrafficGenerator(TrafficConfig(**SERVE_TOY_TRAFFIC))
    impl_err = 0.0
    with torch.no_grad():
        for step in (0, 9, 17):
            x = torch.from_numpy(gen.batch(step)).to("cuda")
            out_s, st_s = moe(params["cuda"], cfg.scaled(moe_impl="sort"), x)
            out_e, st_e = moe(params["cuda"], cfg.scaled(moe_impl="einsum"), x)
            for k in ("tokens_per_expert", "slots_filled", "dropped_fraction"):
                if not torch.equal(st_s[k], st_e[k]):
                    raise AssertionError(f"serve: toy sort vs einsum {k} differ on the card")
            impl_err = max(impl_err, float((out_s - out_e).abs().max()))
    if impl_err > 1e-5:
        raise AssertionError(f"serve: toy sort vs einsum on the card max|d| {impl_err:.3g}")
    log(f"serve: toy (D 32, E 16, top-2, f32) card vs cpu over {n_steps} steps: routing stats "
        f"equal every step, outputs max|d| {err:.3g}, {len(_events(a['rt']))} LB events and "
        f"the mappings equal ({a['rt'].lb_adoptions} adoptions); sort vs einsum on the card "
        f"max|d| {impl_err:.3g}, stats equal")


def serve_full_run(params, cfg, n_steps: int, x_fixed, out_fixed, fwd_ms: float, smi: str,
                   slow_at=None, **kw):
    """One ``ExpertRuntime`` run at full width: ms/step (host traffic
    generation and the rest), tokens/s, adoptions with their permutation
    times, host syncs, efficiency, peak memory; checks the counters per
    step, one host sync per interval, and the served function on
    ``x_fixed`` after the run.  With ``slow_at``, modelled device 1 drops
    to half speed before that step (``update_capacities``), which forces
    the next LB round to rebalance: the traffic alone is near-uniform at
    this width, and the gate refuses it."""
    import numpy as np
    import torch

    from repro_torch.models import moe
    from repro_torch.serve import ExpertRuntime, TrafficConfig, TrafficGenerator

    traffic = TimedTraffic(TrafficGenerator(TrafficConfig(d_model=cfg.d_model, **SERVE_FULL_TRAFFIC)))
    rt = ExpertRuntime(params, cfg, traffic, n_devices=4, lb_interval=5, ema_alpha=0.5, **kw)
    label = f"{rt.pipeline}/{rt.cost_source}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    placements = []  # the layout each step ran under
    with serve_taps() as taps:
        t0 = time.perf_counter()
        for step in range(n_steps):
            if step == slow_at:
                rt.update_capacities([1.0, 0.5, 1.0, 1.0])
            placements.append(rt.expert_placement())
            rt.step()
        rt.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_tok = SERVE_FULL_TRAFFIC["batch"] * SERVE_FULL_TRAFFIC["seq"] * cfg.top_k
    by_expert = {"slots_filled": [], "tokens_per_expert": []}
    for step, (st, placement) in enumerate(zip(taps["stats"], placements)):
        tpe, sf = st["tokens_per_expert"].cpu(), st["slots_filled"].cpu()
        if float(tpe.sum()) != n_tok or bool((sf > tpe).any()):
            raise AssertionError(f"serve: {label} step {step}: tokens {tpe.tolist()}, slots {sf.tolist()}")
        for key, t in (("slots_filled", sf), ("tokens_per_expert", tpe)):
            row = np.zeros(cfg.n_experts)
            row[placement] = t.numpy()
            by_expert[key].append(row)
    interval = rt.balancer.interval
    n_rounds = -(-n_steps // interval)
    if rt.host_syncs != n_rounds or len(rt.efficiency_trace) != n_rounds:
        raise AssertionError(f"serve: {label}: {rt.host_syncs} host syncs for {n_rounds} intervals")
    if slow_at is not None and rt.lb_adoptions < 1:
        raise AssertionError(f"serve: {label}: no adoption after the capacity change")
    last = (n_rounds - 1) * interval
    last_round = {k: np.sum(v[max(0, last - interval + 1):last + 1], axis=0) for k, v in by_expert.items()}
    source_key = "slots_filled" if rt.cost_source == "work_counter" else "tokens_per_expert"
    if not np.array_equal(last_round[source_key], rt.interval_costs[-1]):
        raise AssertionError(f"serve: {label}: last round's costs {rt.interval_costs[-1]} vs the "
                             f"forwards' {last_round[source_key]}")
    with torch.no_grad():
        out = moe(rt.params, cfg, x_fixed)[0]
    err = float((out - out_fixed).abs().max())
    bound = 1e-5 * float(out_fixed.abs().max())
    if not err <= bound:
        raise AssertionError(f"serve: {label}: served function moved by {err:.3g} > {bound:.3g}")
    perm_ms = [s.elapsed_time(e) for s, e in taps["perm_events"]]
    gen_ms = traffic.seconds * 1e3 / n_steps
    step_ms = wall * 1e3 / n_steps
    log(f"serve: {label} {n_steps} steps ({smi}): {step_ms:.2f} ms/step = "
        f"{gen_ms:.2f} host traffic generation + {step_ms - gen_ms:.2f} the rest; "
        f"{n_steps * SERVE_FULL_TRAFFIC['batch'] * SERVE_FULL_TRAFFIC['seq'] / wall:.0f} tokens/s; "
        f"forward alone / ms per step {fwd_ms / step_ms:.3f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    slow = f"device 1 at half speed from step {slow_at}; " if slow_at is not None else ""
    log(f"serve: {label}: {slow}lb_adoptions {rt.lb_adoptions} at steps "
        f"{[e.step for e in rt.balancer.events if e.adopted]}, host_syncs {rt.host_syncs}, "
        f"mean_efficiency {rt.mean_efficiency():.4f}, efficiency trace "
        f"{[(s, round(e, 4)) for s, e in rt.efficiency_trace]}; permutation device ms "
        f"{[round(m, 3) for m in perm_ms]}, host ms {[round(s * 1e3, 2) for s in taps['perm_host_s']]}; "
        f"served function after adoptions max|d| {err:.3g} (bound {bound:.3g})")
    log(f"serve: {label}: last round (steps {max(0, last - interval + 1)}-{last}) per expert id: "
        f"slots_filled {last_round['slots_filled'].astype(int).tolist()}, tokens_per_expert "
        f"{last_round['tokens_per_expert'].astype(int).tolist()}")
    return rt


def serve_phase(smi: str) -> None:
    """Phase 8: the serving lane.  8a the toy on card and CPU; 8b Scout's
    full MoE block through ``ExpertRuntime`` (sync, async, heuristic), its
    forward against the fp32 bound, snapshot and a 4 -> 2 restore; 8c
    Mixtral's block, sort against einsum on one batch."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.deposition import deposit_local_tiles
    from repro_torch.kernels.gather_push import gather_push_move
    from repro_torch.models import init_moe, moe
    from repro_torch.serve import ExpertRuntime, TrafficConfig, TrafficGenerator

    log(f"serve: torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    for fn in (gather_push_move, deposit_local_tiles):
        fn.launches = 0
    serve_toy_phase()

    cfg = get_config("llama4-scout-17b-a16e")
    t0 = time.perf_counter()
    params, _ = init_moe(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    stack_b = sum(params[k].numel() * params[k].element_size() for k in ("w_gate", "w_up", "w_down"))
    shared_b = sum(t.numel() * t.element_size() for t in params["shared"].values())
    B, S = SERVE_FULL_TRAFFIC["batch"], SERVE_FULL_TRAFFIC["seq"]
    C = max(1, int(np.ceil(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts)))
    log(f"serve: {cfg.name} MoE block D {cfg.d_model} F {cfg.d_ff} E {cfg.n_experts} top-{cfg.top_k} "
        f"shared expert {cfg.shared_expert}, {str(cfg.param_dtype)}: expert stacks {stack_b / 1e9:.2f} GB, "
        f"shared {shared_b / 1e9:.2f} GB, drawn on the card in {time.perf_counter() - t0:.2f} s; "
        f"{B}x{S} tokens per step, C {C} per sequence")

    gen = TrafficGenerator(TrafficConfig(d_model=cfg.d_model, **dict(SERVE_FULL_TRAFFIC, seed=11)))
    x_fixed = torch.from_numpy(gen.batch(0)).to("cuda")
    with torch.no_grad():
        out_fixed = moe(params, cfg, x_fixed)[0]
        fwd_ms = cuda_time_ms(lambda: moe(params, cfg, x_fixed))
    slots = B * cfg.n_experts * C
    flops = (slots + (B * S if cfg.shared_expert else 0)) * 6 * cfg.d_model * cfg.d_ff
    bytes_ = stack_b + shared_b + 2 * x_fixed.numel() * 4 + params["router"].numel() * 4
    b_ms, b_by = bound_ms(bytes_, flops)
    log(f"serve: forward alone on a pre-drawn batch: {fwd_ms:.2f} ms (CUDA-event median of 10); "
        f"bound {b_ms:.2f} ms ({b_by}: {flops / 1e12:.3f} TFLOP fp32 over {slots} capacity slots "
        f"+ {B * S} shared-expert tokens; {bytes_ / 1e9:.2f} GB); {flops / fwd_ms / 1e9:.1f} TFLOP/s ({smi})")

    for n_steps, kw in ((20, dict(pipeline="sync", slow_at=10)),
                        (20, dict(pipeline="async", slow_at=10)),
                        (10, dict(cost_source="heuristic"))):
        rt = serve_full_run(params, cfg, n_steps, x_fixed, out_fixed, fwd_ms, smi, **kw)
        if kw.get("pipeline") == "sync":
            keep = rt
        else:
            del rt
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    snap = keep.snapshot()
    t_snap = time.perf_counter() - t0
    del keep
    torch.cuda.empty_cache()
    rt2 = ExpertRuntime(params, cfg, TrafficGenerator(TrafficConfig(d_model=cfg.d_model, **SERVE_FULL_TRAFFIC)),
                        n_devices=2, lb_interval=5, ema_alpha=0.5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt2.restore(snap)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    with torch.no_grad():
        err = float((moe(rt2.params, cfg, x_fixed)[0] - out_fixed).abs().max())
    bound = 1e-5 * float(out_fixed.abs().max())
    if not err <= bound or np.bincount(rt2.balancer.mapping, minlength=2).tolist() != [8, 8]:
        raise AssertionError(f"serve: restore 4 -> 2: max|d| {err:.3g} (bound {bound:.3g}), "
                             f"mapping {rt2.balancer.mapping}")
    log(f"serve: snapshot {t_snap:.2f} s (to CPU tensors), restore onto 2 modelled devices "
        f"{t_restore:.2f} s; served function max|d| {err:.3g} (bound {bound:.3g}); "
        f"placement {rt2.expert_placement().tolist()}")
    del rt2, snap, params, x_fixed, out_fixed
    torch.cuda.empty_cache()

    cfg = get_config("mixtral-8x7b")
    params, _ = init_moe(torch.Generator(device="cuda").manual_seed(1), cfg)
    stack_b = sum(params[k].numel() * params[k].element_size() for k in ("w_gate", "w_up", "w_down"))
    gen = TrafficGenerator(TrafficConfig(seed=13, d_model=cfg.d_model, batch=2, seq=1024,
                                         n_topics=8, skew=2.5, night_load=1.0))
    x = torch.from_numpy(gen.batch(0)).to("cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.perf_counter()
        out_s, st_s = moe(params, cfg.scaled(moe_impl="sort"), x)
        out_e, st_e = moe(params, cfg.scaled(moe_impl="einsum"), x)
        torch.cuda.synchronize()
        t_both = time.perf_counter() - t0
    for k in ("tokens_per_expert", "slots_filled", "dropped_fraction"):
        if not torch.equal(st_s[k], st_e[k]):
            raise AssertionError(f"serve: mixtral sort vs einsum {k} differ")
    err = float((out_s - out_e).abs().max())
    bound = 1e-5 * float(out_s.abs().max())
    if not err <= bound:
        raise AssertionError(f"serve: mixtral sort vs einsum max|d| {err:.3g} > {bound:.3g}")
    log(f"serve: {cfg.name} MoE block D {cfg.d_model} F {cfg.d_ff} E {cfg.n_experts} top-{cfg.top_k}, "
        f"{stack_b / 1e9:.2f} GB: sort vs einsum on 2x1024 tokens max|d| {err:.3g} (bound {bound:.3g}), "
        f"stats equal (tokens {st_s['tokens_per_expert'].int().tolist()}, dropped "
        f"{float(st_s['dropped_fraction']):.4f}); both in {t_both:.2f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if gather_push_move.launches or deposit_local_tiles.launches:
        raise AssertionError("serve: the serving lane launched a PIC kernel")


# ---------------------------------------------------------------------------
# phase 9: the LM serving path
# ---------------------------------------------------------------------------

#: H100 SXM bf16 dense tensor-core peak (700 W)
PEAK_BF16_PER_S = 989e12
#: Qwen3-14B at full width and depth: (batch, seq) of the two prefills, and
#: the decode run's batch, context and greedy steps
LM_PREFILL = (4, 2048)
LM_FLASH_PREFILL = (1, 8192)
LM_DECODE = dict(batch=16, context=4096, steps=32)
#: the other families: (prefill batch, prompt), decode batch and context
LM_FAMILIES = {
    "mamba2-780m": dict(prefill=(4, 2048), batch=16, context=4096),
    "recurrentgemma-9b": dict(prefill=(4, 2048), batch=16, context=4096),
    "whisper-medium": dict(prefill=(4, 448), batch=16, context=448),
}
LM_DECODE_OTHERS = 16
#: prompt of the decode-vs-forward checks
LM_CONSISTENCY_PROMPT = 32
#: families whose full-depth bf16 decode-vs-forward gap is reported, not
#: held: over mamba2's 48 layers the bf16 roundings of the chunked scan and
#: of the step recurrence drift apart, the reference's as well
#: (``tests/decode_gap_at_depth.py`` prints both packages' gaps)
LM_BF16_DEPTH_REPORTED = ("mamba2-780m",)


def _lm_flat(tree, path=""):
    """{path: tensor} of a decode state (dicts and NamedTuples)."""
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_lm_flat(v, f"{path}/{k}"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            out.update(_lm_flat(v, f"{path}/{k}"))
    else:
        out[path] = tree
    return out


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``: what they hold on
    the device, whatever the allocator rounded the blocks up to."""
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in tensors}
    return sum(storages.values())


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _lm_flat(tree).values())


def _numel(tree) -> int:
    return sum(t.numel() for t in _lm_flat(tree).values())


def lm_batch(cfg, B: int, S: int, gen, device="cuda"):
    """A prompt batch drawn on the device: tokens, and the audio frames or
    patch embeddings the config takes."""
    import torch

    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device,
                                     dtype=torch.int32)}
    if cfg.kind == "encdec":
        batch["audio_embed"] = torch.randn((B, cfg.enc_seq, cfg.d_model), generator=gen,
                                           device=device).to(torch.bfloat16)
    if cfg.n_patches > 0:
        batch["patch_embeds"] = torch.randn((B, cfg.n_patches, cfg.d_model), generator=gen,
                                            device=device).to(torch.bfloat16)
    return batch


def _attention_layers(cfg) -> int:
    if cfg.kind == "encdec":
        return cfg.n_layers
    n_groups = cfg.n_layers // len(cfg.block_pattern)
    rem = cfg.block_pattern[: cfg.n_layers % len(cfg.block_pattern)]
    return n_groups * cfg.block_pattern.count("a") + rem.count("a")


def prefill_bound(cfg, params, B: int, S: int):
    """(bound ms, bound_by, flops, bytes) of one prefill: 2·(block params)·
    tokens (the encoder's on the audio frames), the LM head on the last
    position, and 4·B·S²·H·hd per attention layer (the full score matrix
    ``_sdpa`` computes; whisper's cross-attention 4·B·S·T·H·hd) at the bf16
    peak; the params read once at 3.35 TB/s.  The SSD/RG-LRU scans' own
    elementwise work is not counted."""
    H, hd = cfg.n_heads, cfg.hd
    n_attn = _attention_layers(cfg)
    if cfg.kind == "encdec":
        T = cfg.enc_seq
        flops = 2 * _numel(params["enc_blocks"]) * B * T + 2 * _numel(params["dec_blocks"]) * B * S
        flops += cfg.n_enc_layers * 4 * B * T * T * H * hd
        flops += n_attn * (4 * B * S * S * H * hd + 4 * B * S * T * H * hd)
    else:
        blocks = _numel(params["blocks"]) + _numel(params.get("tail_blocks", {}))
        flops = 2 * blocks * B * S + n_attn * 4 * B * S * S * H * hd
    flops += 2 * B * cfg.d_model * cfg.vocab_padded
    bytes_ = _nbytes(params)
    t_ops = flops / PEAK_BF16_PER_S * 1e3
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations", flops, bytes_) if t_ops >= t_bytes else (t_bytes, "bytes", flops, bytes_)


def decode_bound(cfg, params, state, B: int):
    """(bound ms, bytes) of one decode step: the params read once (of the
    embedding table only the B rows gathered), the KV caches read once,
    the recurrent states read and written, at 3.35 TB/s."""
    embed = params["embed"]
    bytes_ = _nbytes(params) - embed.numel() * embed.element_size() + B * cfg.d_model * embed.element_size()
    for path, t in _lm_flat(state).items():
        b = t.numel() * t.element_size()
        if "/kv/" in path or path.endswith("/xk") or path.endswith("/xv") or path == "/enc_out":
            bytes_ += b
        elif "/rg/" in path or "/ssd/" in path:
            bytes_ += 2 * b
    return bytes_ / PEAK_BYTES_PER_S * 1e3, bytes_


def profile_decode_step(step, params, token, state):
    """One decode step under ``torch.profiler``: host launches (CUDA
    runtime launch calls), kernels, device busy time (kernel time, summed)
    and the step's wall time.  Returns (token, state, stats)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        token, state = step(params, token, state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, kernels, launches = 0.0, 0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.key != "Command Buffer Full":
                busy_ms += ev.self_device_time_total / 1e3
                kernels += ev.count
        elif ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += ev.count
    return token, state, dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=kernels, launches=launches)


def lm_card_vs_cpu_phase() -> None:
    """Phase 9a: every SMOKE config with float32 params made on the CPU from
    one generator and copied to the card: ``forward_train`` and 4
    ``decode_step``s on both, logits within 1e-4·max|logits|, float32 state
    leaves within 1e-4·max|leaf|, the bfloat16 KV caches within one
    bfloat16 rounding (2^-7·max|leaf|), MoE stats equal."""
    import numpy as np
    import torch

    from repro_torch._device import map_tensors
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import decode_step, forward_train, init_decode_state, init_params

    worst = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True).scaled(param_dtype=torch.float32)
        params_cpu, _ = init_params(torch.Generator().manual_seed(0), cfg)
        batch_cpu = lm_batch(cfg, 2, 16, torch.Generator().manual_seed(1), device="cpu")
        res = {}
        for dev in ("cuda", "cpu"):
            params = map_tensors(lambda t: t.to(dev), params_cpu)
            batch = {k: v.to(dev) for k, v in batch_cpu.items()}
            with torch.no_grad():
                logits, stats = forward_train(params, cfg, batch)
                state = init_decode_state(cfg, 2, 16, filled=False, device=dev)
                steps = []
                for i in range(4):
                    out, state = decode_step(params, cfg, batch["tokens"][:, i : i + 1], state)
                    steps.append(out)
            res[dev] = dict(logits=[logits] + steps, stats=stats, state=_lm_flat(state))
        a, b = res["cuda"], res["cpu"]
        err = 0.0
        for la, lb in zip(a["logits"], b["logits"]):
            lb = lb.float()
            d = float((la.float().cpu() - lb).abs().max())
            bound = 1e-4 * float(lb.abs().max())
            if not d <= bound:
                raise AssertionError(f"lm: {arch} smoke logits card vs cpu max|d| {d:.3g} > {bound:.3g}")
            err = max(err, d / float(lb.abs().max()))
        for k in a["stats"]:
            if k != "aux_loss" and not torch.equal(a["stats"][k].cpu(), b["stats"][k]):
                raise AssertionError(f"lm: {arch} smoke MoE {k} card vs cpu differ")
        state_err = 0.0
        for path, tb in b["state"].items():
            ta = a["state"][path].cpu()
            if not tb.is_floating_point():
                if not torch.equal(ta, tb):
                    raise AssertionError(f"lm: {arch} smoke state {path} card vs cpu differ")
                continue
            scale = max(float(tb.float().abs().max()), 1e-30)
            d = float((ta.float() - tb.float()).abs().max())
            bound = (2.0 ** -7 if tb.dtype == torch.bfloat16 else 1e-4) * scale
            if not d <= bound:
                raise AssertionError(f"lm: {arch} smoke state {path} card vs cpu max|d| {d:.3g} > {bound:.3g}")
            state_err = max(state_err, d / scale)
        worst[arch] = (err, state_err)
    log("lm: 9a SMOKE configs, float32 params made on the CPU, card vs cpu (forward + 4 decode "
        "steps): max|d|/max|logits|, max state |d|/max|leaf| " +
        ", ".join(f"{a} {e:.2g}/{s:.2g}" for a, (e, s) in worst.items()) + "; MoE stats equal")


def lm_prefill(params, cfg, B: int, S: int, label: str, smi: str, reps: int = 5):
    """Time ``make_prefill_step`` on a B x S prompt drawn on the device:
    CUDA-event median of ``reps`` after a warm-up, tokens/s, the bound and
    the peak memory.  Returns (logits, ms)."""
    import torch

    from repro_torch.train.servestep import make_prefill_step

    batch = lm_batch(cfg, B, S, torch.Generator(device="cuda").manual_seed(2))
    step = make_prefill_step(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits = step(params, batch)
        ms = cuda_time_ms(lambda: step(params, batch), reps=reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if tuple(logits.shape) != (B, cfg.vocab_padded) or not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"lm: {cfg.name} {label}: logits {tuple(logits.shape)} not finite or misshapen")
    b_ms, b_by, flops, bytes_ = prefill_bound(cfg, params, B, S)
    log(f"lm: {cfg.name} {label} {B}x{S}: {ms:.2f} ms (CUDA-event median of {reps}), "
        f"{B * S / ms * 1e3:.0f} tokens/s; bound {b_ms:.2f} ms ({b_by}: {flops / 1e12:.2f} TFLOP at "
        f"989 TFLOP/s bf16, {bytes_ / 1e9:.2f} GB), {b_ms / ms:.3f} of it; "
        f"{flops / ms / 1e9:.1f} TFLOP/s; peak memory {peak:.2f} GiB ({smi})")
    return logits, ms


def lm_decode(params, cfg, B: int, context: int, n_steps: int, label: str, smi: str):
    """``make_serve_step`` from ``init_decode_state(filled=True)``: two
    warm-up steps, one profiled step, then ``n_steps`` greedy steps under
    sync-debug "error" (the tokens stay on the device, read once at the
    end), timed on the host clock closed by one ``synchronize``."""
    import torch

    from repro_torch._device import sync_free_region
    from repro_torch.models import init_decode_state
    from repro_torch.train.servestep import make_serve_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_decode_state(cfg, B, context, filled=True, device="cuda")
    state_gb = _nbytes(state) / 1e9
    b_ms, bytes_ = decode_bound(cfg, params, state, B)
    step = make_serve_step(cfg)
    token = torch.randint(0, cfg.vocab, (B, 1), generator=torch.Generator(device="cuda").manual_seed(3),
                          device="cuda", dtype=torch.int32)
    with torch.no_grad():
        for _ in range(2):
            token, state = step(params, token, state)
        token, state, prof = profile_decode_step(step, params, token, state)
        tokens = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sync_free_region(True):
            for _ in range(n_steps):
                token, state = step(params, token, state)
                tokens.append(token)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
    out = torch.cat(tokens, dim=1).cpu()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab or int(state.position) != context + 3 + n_steps:
        raise AssertionError(f"lm: {cfg.name} {label}: tokens {out.min()}..{out.max()} or position "
                             f"{int(state.position)} wrong")
    log(f"lm: {cfg.name} {label} batch {B}, context {context}, {n_steps} greedy steps under sync-debug "
        f"\"error\": {ms:.2f} ms/step (host clock), {B / ms * 1e3:.0f} tokens/s; bound {b_ms:.2f} ms "
        f"(bytes: {bytes_ / 1e9:.2f} GB, of which state {state_gb:.2f} GB), {b_ms / ms:.3f} of it; "
        f"one profiled step: {prof['launches']} host launches, {prof['kernels']} kernels, device busy "
        f"{prof['busy_ms']:.2f} of {prof['wall_ms']:.2f} ms ({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%); "
        f"peak memory {peak:.2f} GiB ({smi})")
    log(f"lm: {cfg.name} {label} tokens of sequence 0: {out[0, :16].tolist()}")
    del state
    return ms


def lm_decode_vs_forward(params, cfg, label: str, bound=None, hold: bool = True,
                         f32_cache: bool = False):
    """Decode a prompt token by token from ``filled=False`` and compare the
    last step's logits with ``forward_train``'s last position: max|d|,
    relative to max|logits|, and the argmax agreement.  ``bound`` is a
    float (max|d| ≤ bound·max|logits|) or ``"bf16"`` (the reference's
    rtol 0.1 / atol 0.15); with ``hold`` a miss fails the phase, else it
    is reported with the number of logits over the bound.  ``f32_cache``
    swaps the (bf16) KV caches for float32 ones."""
    import torch

    from repro_torch.models import decode_step, forward_train, init_decode_state
    from repro_torch.models.attention import KVCache

    S = LM_CONSISTENCY_PROMPT
    batch = lm_batch(cfg, 1, S, torch.Generator(device="cuda").manual_seed(4))
    with torch.no_grad():
        full, _ = forward_train(params, cfg, batch)
        state = init_decode_state(cfg, 1, S, filled=False, device="cuda")
        if f32_cache:
            state = state._replace(caches={
                name: dict(c, kv=KVCache(c["kv"].k.float(), c["kv"].v.float(), c["kv"].length))
                if "kv" in c else c for name, c in state.caches.items()})
        for i in range(S):
            logits, state = decode_step(params, cfg, batch["tokens"][:, i : i + 1], state)
    a, b = logits[0, 0].float(), full[0, -1].float()
    diff = (a - b).abs()
    d, scale = float(diff.max()), float(b.abs().max())
    agree = int(a[: cfg.vocab].argmax()) == int(b[: cfg.vocab].argmax())
    held = ""
    ok = True
    if bound is not None:
        limit = 0.15 + 0.1 * b.abs() if bound == "bf16" else bound * scale
        n_over = int((diff > limit).sum())
        ok = n_over == 0
        what = "rtol 0.1 / atol 0.15" if bound == "bf16" else f"{bound:g}·max|logits|"
        held = (f"; {'held' if hold else 'reported'} at {what}: "
                f"{'within' if ok else f'{n_over} of {diff.numel()} logits over'}")
    log(f"lm: {cfg.name} {label}: decode of a {S}-token prompt vs forward's last position: "
        f"max|d| {d:.4g}, max|logits| {scale:.4g}, ratio {d / scale:.3g}, argmax agrees {agree}{held}")
    if hold and not ok:
        raise AssertionError(f"lm: {cfg.name} {label}: decode vs forward beyond its bound")
    return d / scale


def lm_shallow_consistency(cfg, n_layers: int) -> None:
    """Decode vs forward at full width and ``n_layers`` layers with float32
    params: with the reference's bf16 KV caches (reported against 1e-3),
    and with float32 caches, held at 1e-3·max|logits|."""
    import torch

    from repro_torch.models import init_params

    cfg = cfg.scaled(n_layers=n_layers, param_dtype=torch.float32)
    params, _ = init_params(torch.Generator(device="cuda").manual_seed(5), cfg)
    label = f"full width, {n_layers} layers, float32 params"
    if _attention_layers(cfg):
        lm_decode_vs_forward(params, cfg, f"{label}, bf16 KV caches", bound=1e-3, hold=False)
    lm_decode_vs_forward(params, cfg, f"{label}{', float32 KV caches' if _attention_layers(cfg) else ''}",
                         bound=1e-3, f32_cache=True)
    del params
    torch.cuda.empty_cache()


def lm_library_row(params, cfg, B: int, S: int, smi: str) -> None:
    """Off the path: layer 0's q/k/v of the B x S prefill through the port's
    ``_sdpa`` and ``_flash_sdpa`` and through one
    ``F.scaled_dot_product_attention`` call (causal, GQA), timed with CUDA
    events (median of 5), with the max |d| against ``_sdpa``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_rope, rmsnorm

    batch = lm_batch(cfg, B, S, torch.Generator(device="cuda").manual_seed(2))
    bp = {k: (v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()})
          for k, v in params["blocks"]["a0"].items()}
    with torch.no_grad():
        x = rmsnorm(params["embed"][batch["tokens"]], bp["ln1"], cfg.norm_eps)
        q, k, v = attn._project_qkv(bp["attn"], cfg, x, x)
        pos = torch.arange(S, device="cuda").expand(B, S)
        q, k = apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta)
        mask = attn._mask(S, S, 0, True, None, None, device="cuda")
        G = cfg.n_heads // cfg.n_kv_heads

        def sdpa_lib():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(G, dim=1),
                v.transpose(1, 2).repeat_interleave(G, dim=1), is_causal=True).transpose(1, 2)

        ref = attn._sdpa(q, k, v, mask)
        flash = attn._flash_sdpa(q, k, v, causal=True, window=None, chunk=None)
        lib = sdpa_lib()
        t_sdpa = cuda_time_ms(lambda: attn._sdpa(q, k, v, mask), reps=5)
        t_flash = cuda_time_ms(lambda: attn._flash_sdpa(q, k, v, causal=True, window=None, chunk=None), reps=5)
        t_lib = cuda_time_ms(sdpa_lib, reps=5)
    flops = 4 * B * S * S * cfg.n_heads * cfg.hd
    log(f"lm: library row (off the path), {cfg.name} layer 0 q/k/v of the {B}x{S} prefill "
        f"(H {cfg.n_heads}, K {cfg.n_kv_heads}, hd {cfg.hd}, bf16): _sdpa {t_sdpa:.3f} ms, "
        f"_flash_sdpa {t_flash:.3f} ms (max|d| vs _sdpa {float((flash - ref).float().abs().max()):.3g}), "
        f"F.scaled_dot_product_attention {t_lib:.3f} ms (max|d| vs _sdpa "
        f"{float((lib - ref).float().abs().max()):.3g}; K/V repeated to H heads inside the timed call); "
        f"{flops / 1e12:.3f} TFLOP, bound {flops / PEAK_BF16_PER_S * 1e3:.3f} ms ({smi})")


def lm_phase(smi: str) -> None:
    """Phase 9: 9a SMOKE configs card vs CPU; 9b Qwen3-14B at full width
    and depth (both prefill paths, 32 greedy decode steps, the library
    row, decode-vs-forward); 9c mamba2, recurrentgemma and whisper at full
    width.  No PIC kernel launches here."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.deposition import deposit_local_tiles
    from repro_torch.kernels.gather_push import gather_push_move
    from repro_torch.models import init_params

    t_phase = time.perf_counter()
    log(f"lm: torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    for fn in (gather_push_move, deposit_local_tiles):
        fn.launches = 0
    lm_card_vs_cpu_phase()

    cfg = get_config("qwen3-14b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params, _ = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n, gb = _numel(params), _nbytes(params) / 1e9
    if n != cfg.n_params:
        raise AssertionError(f"lm: {cfg.name} params {n} != n_params {cfg.n_params}")
    log(f"lm: {cfg.name} {cfg.n_layers} layers, D {cfg.d_model}, H {cfg.n_heads}, K {cfg.n_kv_heads}, "
        f"hd {cfg.hd}, F {cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.vocab_padded}), qk-norm "
        f"{cfg.qk_norm}: {n:,} params = n_params, {gb:.2f} GB bf16, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    lm_prefill(params, cfg, *LM_PREFILL, "prefill (_sdpa path)", smi)
    lm_library_row(params, cfg, *LM_PREFILL, smi)
    lm_prefill(params, cfg, *LM_FLASH_PREFILL, "prefill (flash path)", smi)
    lm_decode(params, cfg, LM_DECODE["batch"], LM_DECODE["context"], LM_DECODE["steps"], "decode", smi)
    lm_decode_vs_forward(params, cfg, "full depth bf16")
    del params
    torch.cuda.empty_cache()
    lm_shallow_consistency(cfg, 2)

    for arch, kw in LM_FAMILIES.items():
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params, _ = init_params(torch.Generator(device="cuda").manual_seed(6), cfg)
        torch.cuda.synchronize()
        n = _numel(params)
        if n != cfg.n_params:
            raise AssertionError(f"lm: {cfg.name} params {n} != n_params {cfg.n_params}")
        log(f"lm: {cfg.name} ({cfg.kind}, {cfg.n_layers} layers"
            f"{f' + {cfg.n_enc_layers} encoder' if cfg.n_enc_layers else ''}, D {cfg.d_model}): "
            f"{n:,} params = n_params, {_nbytes(params) / 1e9:.2f} GB bf16, drawn in "
            f"{time.perf_counter() - t0:.1f} s")
        lm_prefill(params, cfg, *kw["prefill"], "prefill", smi, reps=3)
        lm_decode(params, cfg, kw["batch"], kw["context"], LM_DECODE_OTHERS, "decode", smi)
        if cfg.kind != "encdec":  # whisper: decode ropes, the forward does not
            lm_decode_vs_forward(params, cfg, "full depth bf16", bound="bf16",
                                 hold=arch not in LM_BF16_DEPTH_REPORTED)
        del params
        torch.cuda.empty_cache()
        if cfg.kind != "encdec":
            lm_shallow_consistency(cfg, len(cfg.block_pattern) if cfg.kind == "hybrid" else 2)
    if gather_push_move.launches or deposit_local_tiles.launches:
        raise AssertionError("lm: the LM serving path launched a PIC kernel")
    log(f"lm: phase 9 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: the training path
# ---------------------------------------------------------------------------

#: each SMOKE config's gradient atol relative to the leaf's max|g|: twice
#: the float32-vs-float64 gap measured on the CPU
#: (``tests/test_torch_trainstep.py``, ``GRAD_ATOL_REL_BY_ARCH``)
TRAIN_GRAD_ATOL_REL = {
    "recurrentgemma-9b": 2.5e-6, "whisper-medium": 2.0e-6, "qwen3-14b": 1.9e-6,
    "yi-9b": 1.8e-6, "phi3-medium-14b": 1.8e-6, "qwen2.5-32b": 2.7e-6,
    "mamba2-780m": 5.4e-6, "mixtral-8x7b": 2.1e-6, "llama4-scout-17b-a16e": 8.3e-6,
    "qwen2-vl-72b": 2.2e-6,
}
#: the train step's learning rate (``make_train_step``'s default)
TRAIN_LR = 3e-4
#: Qwen3-14B at full width, depth cut: layers (of 40), global batch,
#: sequence (train_4k's), microbatches, plain steps (then one compressed)
TRAIN_QWEN = dict(n_layers=4, batch=2, seq=4096, grad_accum=2, steps=3)
#: mamba2-780m at full width and depth
TRAIN_MAMBA = dict(batch=1, seq=2048, steps=2)
TRAIN_SPANS = ("train_step/forward_backward", "train_step/accumulate", "train_step/optimizer")


def _grads_of_loss(params, cfg, batch):
    """{path: grad} of ``loss_fn`` over the batch, and (loss, metrics)."""
    import torch

    from repro_torch.models import loss_fn

    flat = _lm_flat(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, metrics = loss_fn(params, cfg, batch)
    loss.backward()
    grads = {k: torch.zeros_like(t) if t.grad is None else t.grad for k, t in flat.items()}
    for t in flat.values():
        t.requires_grad_(False)
        t.grad = None
    return grads, loss.detach(), {k: v.detach() for k, v in metrics.items()}


def train_card_vs_cpu_phase() -> None:
    """Phase 10a: every SMOKE config with params made on the CPU from one
    generator and copied, a 4 x 16 ``SyntheticLMData`` batch: float32
    params, ``loss_fn``'s loss (rtol 1e-5), gradients (per leaf, 1e-4·|g|
    + the CPU tests' atol·max|g|) and MoE stats (equal), then one
    ``grad_accum=2`` step: its loss (rtol 1e-5) and new params (within
    2·lr; the share beyond 1e-5·max|p| reported); then the same step with
    bfloat16 params, reported: the loss, the params and the embedding's
    gradient (bf16 scatter-adds of repeated rows) card vs CPU."""
    import torch

    from repro_torch._device import map_tensors
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import init_params
    from repro_torch.train.trainstep import init_train_state, make_train_step

    f32_lines, bf16_lines = [], []
    for arch in ARCH_IDS:
        for dtype in (torch.float32, torch.bfloat16):
            cfg = get_config(arch, smoke=True).scaled(param_dtype=dtype)
            params_cpu, _ = init_params(torch.Generator().manual_seed(0), cfg)
            batch_cpu = SyntheticLMData(cfg, 4, 16, seed=3, device="cpu").batch_at(0)
            res = {}
            for dev in ("cuda", "cpu"):
                params = map_tensors(lambda t: t.to(dev, copy=True), params_cpu)
                batch = {k: v.to(dev) for k, v in batch_cpu.items()}
                grads, loss, metrics = _grads_of_loss(params, cfg, batch)
                state, m = make_train_step(cfg, grad_accum=2)(init_train_state(params), batch)
                if int(state.opt.step) != 1 or not bool(torch.isfinite(m["loss"])):
                    raise AssertionError(f"train: {arch} {dev}: step {int(state.opt.step)}, loss {float(m['loss'])}")
                res[dev] = dict(loss=float(loss), step_loss=float(m["loss"]), metrics=metrics,
                                grads={k: g.float().cpu() for k, g in grads.items()},
                                params={k: t.float().cpu() for k, t in _lm_flat(state.params).items()})
            a, b = res["cuda"], res["cpu"]
            p_far = p_n = 0
            p_worst = 0.0
            for k, want in b["params"].items():
                d = (a["params"][k] - want).abs()
                p_worst = max(p_worst, float(d.max()))
                p_far += int((d > 1e-5 * float(want.abs().max())).sum())
                p_n += d.numel()
            loss_gap = abs(a["loss"] - b["loss"]) / abs(b["loss"])
            step_gap = abs(a["step_loss"] - b["step_loss"]) / abs(b["step_loss"])
            if dtype == torch.bfloat16:
                g, want = a["grads"]["/embed"], b["grads"]["/embed"]
                emb = float((g - want).abs().max()) / float(want.abs().max())
                bf16_lines.append(f"{arch} loss {loss_gap:.2g}, step loss {step_gap:.2g}, params max|d| "
                                  f"{p_worst:.3g}, embed grad max|d|/max|g| {emb:.3g}")
                continue
            if not (loss_gap <= 1e-5 and step_gap <= 1e-5):
                raise AssertionError(f"train: {arch} loss card vs cpu rel {loss_gap:.3g}, step {step_gap:.3g} > 1e-5")
            atol_rel, g_worst = TRAIN_GRAD_ATOL_REL[arch], 0.0
            for k, want in b["grads"].items():
                scale = float(want.abs().max())
                excess = float(((a["grads"][k] - want).abs() - 1e-4 * want.abs()).max())
                if not excess <= atol_rel * scale:
                    raise AssertionError(f"train: {arch} grad {k} card vs cpu beyond 1e-4·|g| + {atol_rel:g}·max|g|")
                g_worst = max(g_worst, excess / max(scale, 1e-30))
            for key in ("tokens_per_expert", "slots_filled"):
                if key in b["metrics"] and not torch.equal(a["metrics"][key].cpu(), b["metrics"][key]):
                    raise AssertionError(f"train: {arch} MoE {key} card vs cpu differ")
            if not p_worst <= 2 * TRAIN_LR:
                raise AssertionError(f"train: {arch} params after one step max|d| {p_worst:.3g} > 2·lr")
            f32_lines.append(f"{arch} loss {loss_gap:.2g}/{step_gap:.2g}, grads (excess over 1e-4·|g|) "
                             f"{g_worst:.2g}·max|g|, params max|d| {p_worst:.2g} ({p_far} of {p_n} beyond "
                             f"1e-5·max|p|)")
    log("train: 10a SMOKE configs, float32 params made on the CPU, card vs cpu (loss_fn, its gradients, "
        "one grad_accum=2 step; held: loss rtol 1e-5, grads 1e-4·|g| + the CPU tests' atol, params "
        "within 2·lr, MoE stats equal): " + "; ".join(f32_lines))
    log("train: 10a bfloat16 params, one step card vs cpu (reported): " + "; ".join(bf16_lines))


def profile_train_step(step, state, batch):
    """One train step under ``torch.profiler``: its wall time, host
    launches, kernels, device busy time, and the kernel time of each
    ``train_step/*`` span.  A span's kernels are those that start on the
    device between the start of its device-side annotation and the start
    of the next span's: the backward's kernels are launched by autograd's
    device thread, outside the host-side range, and so run after the
    forward's annotation ends and before the accumulation's begins.
    Returns (state, metrics, stats)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, kernels, launches = 0.0, 0, 0
    for ev in prof.key_averages():
        if ev.key in TRAIN_SPANS:
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.key != "Command Buffer Full":
                busy_ms += ev.self_device_time_total / 1e3
                kernels += ev.count
        elif ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx"):
            launches += ev.count
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = sorted((e.time_range.start, e.name) for e in on_device if e.name in TRAIN_SPANS)
    spans = dict.fromkeys(TRAIN_SPANS, 0.0)
    spans["before the first span"] = 0.0
    for e in on_device:
        if e.name in TRAIN_SPANS or e.name == "Command Buffer Full":
            continue
        owner = "before the first span"
        for t, name in marks:
            if t > e.time_range.start:
                break
            owner = name
        spans[owner] += e.time_range.elapsed_us() / 1e3
    return state, metrics, dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=kernels, launches=launches,
                                spans=spans, n_marks=len(marks))


def train_run(cfg, state, data, n_steps: int, grad_accum: int, label: str, smi: str,
              profile_first: bool = False):
    """``n_steps`` of ``make_train_step`` from ``state`` (fresh, consumed),
    each on the host clock closed by one ``synchronize`` (the batch drawn
    before the clock starts); the first under ``torch.profiler`` with
    ``profile_first``.  Holds finite losses and ``opt.step`` counting 1..n.
    Returns (state, step ms list, losses, profile stats or None)."""
    import numpy as np
    import torch

    from repro_torch.train.trainstep import make_train_step

    step = make_train_step(cfg, grad_accum=grad_accum, lr=TRAIN_LR)
    times, losses, prof = [], [], None
    for s in range(n_steps):
        batch = data.batch_at(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if s == 0 and profile_first:
            state, m, prof = profile_train_step(step, state, batch)
        else:
            state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        if int(state.opt.step) != s + 1 or not np.isfinite(losses[-1]):
            raise AssertionError(f"train: {cfg.name} {label} step {s}: opt.step {int(state.opt.step)}, "
                                 f"loss {losses[-1]}")
    return state, times, losses, prof


def train_qwen_phase(smi: str) -> None:
    """Phase 10b: Qwen3-14B at full width, 4 of 40 layers, bf16 params drawn
    on the card, ``SyntheticLMData(seed=0)`` 2 x 4096 tokens as 2
    microbatches of 1, per-layer remat: the memory the state and a batch
    take held against the dry run's plan of the cell on a 1x1 mesh, 3
    steps (the first profiled), then one step with ``compression=True`` on
    the same state."""
    import numpy as np
    import torch

    from repro_torch._device import map_tensors
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.dryrun import plan_cell
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.train.trainstep import init_train_state, make_train_step

    kw = TRAIN_QWEN
    cfg = get_config("qwen3-14b").scaled(n_layers=kw["n_layers"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    params, _ = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    n = _numel(params)
    if n != cfg.n_params:
        raise AssertionError(f"train: {cfg.name} params {n} != n_params {cfg.n_params}")
    data = SyntheticLMData(cfg, kw["batch"], kw["seq"], seed=0, device="cuda")
    state = init_train_state(params)
    batch0 = data.batch_at(0)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - mem0
    tensors = [*_lm_flat(state).values(), *batch0.values()]
    held = _storage_bytes(tensors)
    t0 = time.perf_counter()
    plan = plan_cell(cfg, "train_4k", make_mesh((1, 1), ("data", "model"), device="meta"),
                     batch_override=kw["batch"], grad_accum=kw["grad_accum"])
    mem = plan["memory_analysis"]
    by_part, want, temp = mem["argument_bytes_by_part"], mem["argument_bytes"], mem["temp_bytes"]
    log(f"train: 10b state and batch on the card: {held:,} B of storage; the dry run's argument_bytes on a "
        f"1x1 mesh ({time.perf_counter() - t0:.2f} s): {want:,} B ({by_part}), {held - want:+,} B over "
        f"{len(tensors)} tensors (held at 512 B each); memory_allocated grew {grown:,} B "
        f"({grown - held:+,} B of the allocator's rounding)")
    if abs(held - want) > 512 * len(tensors):
        raise AssertionError(f"train: 10b memory {held} B against the plan's {want} B")
    predicted = want + temp
    log(f"train: 10b predicted step peak, before the first step: argument_bytes {want:,} + temp_bytes "
        f"{temp:,} = {predicted:,} B ({predicted / 2**30:.2f} GiB; the dry run's plan of the cell with "
        f"{plan['scan_info']['grad_accum']} microbatches of {kw['batch'] // kw['grad_accum']})")
    del batch0
    state, times, losses, prof = train_run(cfg, state, data, kw["steps"], kw["grad_accum"], "4 layers",
                                           smi, profile_first=True)
    measured = torch.cuda.max_memory_allocated() - mem0
    gap = predicted / measured - 1
    log(f"train: 10b peak over {kw['steps']} steps: max_memory_allocated less the memory before the state "
        f"{measured:,} B ({measured / 2**30:.2f} GiB) against the predicted {predicted:,} B "
        f"({predicted / 2**30:.2f} GiB): {100 * gap:+.2f}% ({smi})")
    if abs(gap) > 0.10:
        raise AssertionError(f"train: 10b predicted peak {predicted} B is {100 * gap:+.1f}% off the "
                             f"card's {measured} B")
    ms = statistics.median(times[1:])
    tokens = kw["batch"] * kw["seq"]
    embed = state.params["embed"].numel()
    n_mm = n - embed  # the embedding is a gather, not a product
    attn_flops = 12 * kw["batch"] * kw["seq"] ** 2 * cfg.n_heads * cfg.hd * cfg.n_layers
    flops = 6 * n_mm * tokens + attn_flops
    flops_6nt = 6 * n * tokens + attn_flops
    b_ms = flops / PEAK_BF16_PER_S * 1e3
    static_gb = n * (2 + 2 + 4 + 4 + 4) / 1e9  # params, grads, f32 accumulators, m, v
    peak = torch.cuda.max_memory_allocated() / 2**30
    spans = ", ".join(f"{k.split('/')[-1]} {v:.2f} ({100 * v / max(prof['busy_ms'], 1e-9):.1f}%)"
                      for k, v in prof["spans"].items())
    log(f"train: 10b {cfg.name} full width (D {cfg.d_model}, H {cfg.n_heads}, K {cfg.n_kv_heads}, hd "
        f"{cfg.hd}, F {cfg.d_ff}, vocab {cfg.vocab} padded {cfg.vocab_padded}), {cfg.n_layers} of 40 layers, "
        f"{n:,} params = n_params, bf16; global batch {kw['batch']} x {kw['seq']} as {kw['grad_accum']} "
        f"microbatches, per-layer remat: steps {', '.join(f'{t:.1f}' for t in times)} ms (host clock; the "
        f"first profiled), {ms:.1f} ms/step (median after the first), {tokens / ms * 1e3:.0f} tokens/s; "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; opt.step 1..{kw['steps']}")
    log(f"train: 10b bound {b_ms:.2f} ms ({flops / 1e12:.2f} TFLOP of products: 6·{n_mm:,}·{tokens} + "
        f"attention {attn_flops / 1e12:.2f}, at 989 TFLOP/s bf16; recompute not counted), {b_ms / ms:.3f} of it "
        f"({flops / ms / 1e9:.1f} TFLOP/s); with the embedding counted, 6·N·T + attention = "
        f"{flops_6nt / 1e12:.2f} TFLOP, {flops_6nt / PEAK_BF16_PER_S * 1e3:.2f} ms, "
        f"{flops_6nt / PEAK_BF16_PER_S * 1e3 / ms:.3f} of the step; peak memory {peak:.2f} GiB against "
        f"{static_gb:.2f} GB of static state (16 B/param) ({smi})")
    log(f"train: 10b profiled first step: {prof['wall_ms']:.1f} ms wall, {prof['launches']} host launches, "
        f"{prof['kernels']} kernels, device busy {prof['busy_ms']:.1f} ms "
        f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f}%); kernel ms by span ({prof['n_marks']} device-side "
        f"span starts): {spans} ({smi})")

    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32, device=t.device)  # noqa: E731
    state = state._replace(opt=state.opt._replace(error_feedback=map_tensors(zeros, state.params)))
    step = make_train_step(cfg, grad_accum=kw["grad_accum"], lr=TRAIN_LR, compression=True)
    batch = data.batch_at(kw["steps"])
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    c_ms = (time.perf_counter() - t0) * 1e3
    loss = float(m["loss"])
    if int(state.opt.step) != kw["steps"] + 1 or not np.isfinite(loss):
        raise AssertionError(f"train: compressed step: opt.step {int(state.opt.step)}, loss {loss}")
    log(f"train: 10b compressed step {kw['steps'] + 1} (int8 + error feedback, {n * 4 / 1e9:.2f} GB more "
        f"state): {c_ms:.1f} ms, loss {loss:.4f}, grad_norm {float(m['grad_norm']):.4g}, opt.step "
        f"{int(state.opt.step)}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    del state, params, m
    torch.cuda.empty_cache()


#: 10e's (arch, layers, mesh, global batch, microbatches): 10b's cell
#: tensor-parallel (2 microbatches of 1, as 10b), data-parallel and both
#: (2 microbatches of 2, one sequence per data shard in each),
#: data-parallel in one microbatch of 2 (the embedding's backward on
#: local blocks, ``common.embed_rows``), on a model axis of 16, which does
#: not divide its 8 KV heads (each pair of chips runs one KV head's 5
#: query heads, ``attention._head_groups``), and Mixtral's MoE at full
#: width with 2 layers, tensor- and data-parallel
TRAIN_SHARDED = (("qwen3-14b", TRAIN_QWEN["n_layers"], (1, 2), 2, 2),
                 ("qwen3-14b", TRAIN_QWEN["n_layers"], (2, 1), 4, 2),
                 ("qwen3-14b", TRAIN_QWEN["n_layers"], (2, 1), 2, 1),
                 ("qwen3-14b", TRAIN_QWEN["n_layers"], (2, 2), 4, 2),
                 ("qwen3-14b", TRAIN_QWEN["n_layers"], (1, 16), 2, 2),
                 ("mixtral-8x7b", 2, (1, 2), 2, 2),
                 ("mixtral-8x7b", 2, (2, 1), 4, 2))


def train_sharded_phase(smi: str) -> None:
    """Phase 10e: the dry run's temporaries on sharded meshes against the
    card's allocator.  For each cell of :data:`TRAIN_SHARDED` (10b's
    Qwen3-14B cell and Mixtral's MoE at full width, 4096 tokens a
    sequence), ``plan_cell`` predicts rank 0's peak as ``argument_bytes +
    temp_bytes``, printed before the step runs; then the
    same step runs on the card on DTensors over a fake process group of
    the mesh's size and a ``"cuda"`` ``DeviceMesh`` (``dryrun.cell_step``:
    rank 0's blocks, zeros; the fake group moves no data, but each
    collective allocates its output as a real one does), and
    ``torch.cuda.max_memory_allocated()`` less the memory before the
    arguments is held to the prediction within 10%."""
    import gc

    import torch
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import fake_device_mesh
    from repro_torch.launch.dryrun import cell_step, plan_cell
    from repro_torch.launch.mesh import make_mesh

    seq = TRAIN_QWEN["seq"]
    for arch, n_layers, shape, batch, grad_accum in TRAIN_SHARDED:
        cfg = get_config(arch).scaled(n_layers=n_layers)
        mesh = make_mesh(shape, ("data", "model"), device="meta")
        plan = plan_cell(cfg, "train_4k", mesh, batch_override=batch, grad_accum=grad_accum)
        mem = plan["memory_analysis"]
        predicted = mem["argument_bytes"] + mem["temp_bytes"]
        cell = (f"{arch} {n_layers} layers, {shape} mesh (batch {batch} x {seq} as {grad_accum} microbatches, one "
                f"card for rank 0 on a fake group of {shape[0] * shape[1]})")
        log(f"train: 10e {cell}: predicted peak, before the step: argument_bytes {mem['argument_bytes']:,} + "
            f"temp_bytes {mem['temp_bytes']:,} = {predicted:,} B ({predicted / 2**30:.2f} GiB; plan "
            f"{plan['plan_seconds']:.2f} s, torch {torch.__version__})")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        with fake_device_mesh(mesh, "cuda") as device_mesh:
            step, args = cell_step(cfg, "train_4k", mesh, device_mesh, batch_override=batch,
                                   grad_accum=grad_accum, device="cuda")
            t0 = time.perf_counter()
            with torch.no_grad(), implicit_replication():
                out = step(*args)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            measured = torch.cuda.max_memory_allocated() - mem0
            del out, args, step
        gap = predicted / measured - 1
        log(f"train: 10e {cell}: predicted peak {predicted:,} B ({predicted / 2**30:.2f} GiB), card's "
            f"max_memory_allocated less the memory before the arguments {measured:,} B "
            f"({measured / 2**30:.2f} GiB): {100 * gap:+.2f}%; the step {step_s:.1f} s on DTensors; collectives "
            f"per chip {int(plan['collectives']['total_per_chip_bytes']):,} B ({smi})")
        if abs(gap) > 0.10:
            raise AssertionError(f"train: 10e {arch} {shape} predicted peak {predicted} B is {100 * gap:+.1f}% "
                                 f"off the card's {measured} B")
    gc.collect()
    torch.cuda.empty_cache()


def train_mamba_phase(smi: str) -> None:
    """Phase 10c: mamba2-780m at full width and depth, 2 steps at 1 x 2048
    with ``grad_accum=1``: the SSD chunk loop's backward on the card."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import init_params
    from repro_torch.train.trainstep import init_train_state

    kw = TRAIN_MAMBA
    cfg = get_config("mamba2-780m")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, _ = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    data = SyntheticLMData(cfg, kw["batch"], kw["seq"], seed=0, device="cuda")
    state, times, losses, _ = train_run(cfg, init_train_state(params), data, kw["steps"], 1, "full", smi)
    log(f"train: 10c {cfg.name} full width and depth ({cfg.n_layers} layers, D {cfg.d_model}, "
        f"{_numel(params):,} params, bf16), {kw['batch']} x {kw['seq']}, grad_accum 1: steps "
        f"{', '.join(f'{t:.1f}' for t in times)} ms (host clock), {kw['seq'] / times[-1] * 1e3:.0f} tokens/s "
        f"at the last; losses {', '.join(f'{x:.4f}' for x in losses)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    del state, params
    torch.cuda.empty_cache()


def train_restart_phase() -> None:
    """Phase 10d: ``tests/test_infra.py::test_checkpoint_restart_resumes_training``
    on the card: yi-9b SMOKE (bf16), 5 steps, a checkpoint at step 3 through
    the port's ``CheckpointManager`` with a ``TrainState`` template,
    restored and steps 3-4 replayed: losses at rtol 1e-6."""
    import shutil

    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.convert import train_state_from
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import init_params
    from repro_torch.train.trainstep import init_train_state, make_train_step

    cfg = get_config("yi-9b", smoke=True)
    params, _ = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    state = init_train_state(params)
    step_fn = make_train_step(cfg)
    data = SyntheticLMData(cfg, batch=4, seq_len=16, seed=42, device="cuda")
    ckpt_dir = ROOT / "chip_scratch" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        mgr = CheckpointManager(ckpt_dir)
        losses_a = []
        for s in range(5):
            if s == 3:
                mgr.save(state, step=s)
            state, m = step_fn(state, data.batch_at(s))
            losses_a.append(float(m["loss"]))
        restored, start = mgr.restore(state)
        state2 = train_state_from(restored, "cuda")
        losses_b = []
        for s in range(start, 5):
            state2, m = step_fn(state2, data.batch_at(s))
            losses_b.append(float(m["loss"]))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses_a[3:], losses_b))
    if start != 3 or not rel <= 1e-6:
        raise AssertionError(f"train: restart replay losses {losses_b} vs {losses_a[3:]} (rel {rel:.3g})")
    log(f"train: 10d restart on the card (yi-9b SMOKE, bf16): losses {', '.join(f'{x:.6f}' for x in losses_a)}; "
        f"restored at step {start}, replayed {', '.join(f'{x:.6f}' for x in losses_b)}: max rel {rel:.3g} "
        f"(held at 1e-6)")


def train_phase(smi: str) -> None:
    """Phase 10: 10a SMOKE configs card vs CPU; 10b Qwen3-14B at full
    width, 4 layers; 10c mamba2-780m at full width and depth; 10d restart;
    10e the dry run's sharded temporaries against the card.  No PIC kernel
    launches here."""
    import torch

    from repro_torch.kernels.deposition import deposit_local_tiles
    from repro_torch.kernels.gather_push import gather_push_move

    t_phase = time.perf_counter()
    for fn in (gather_push_move, deposit_local_tiles):
        fn.launches = 0
    torch.cuda.empty_cache()
    train_card_vs_cpu_phase()
    train_qwen_phase(smi)
    train_mamba_phase(smi)
    train_restart_phase()
    train_sharded_phase(smi)
    if gather_push_move.launches or deposit_local_tiles.launches:
        raise AssertionError("train: the training path launched a PIC kernel")
    log(f"train: phase 10 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: the launch layer
# ---------------------------------------------------------------------------

#: Qwen3-14B's layers placed over the production meshes in 11a
LAUNCH_LAYERS = 4
#: the dry-run cells of 11b: (arch, shape, mesh); Scout's train_4k is the
#: MoE cell whose per-chip size PERF.md quotes
LAUNCH_CELLS = (("qwen3-14b", "train_4k", "single"), ("qwen3-14b", "prefill_32k", "single"),
                ("qwen3-14b", "decode_32k", "single"), ("qwen3-14b", "decode_32k", "multi"),
                ("llama4-scout-17b-a16e", "train_4k", "single"))
HBM_BYTES = 80 * 2**30
#: phase 11's time limit (the dry run's four cells dominate it)
LAUNCH_SECONDS = 60


def launch_placement_phase(smi: str) -> None:
    """Phase 11a: Qwen3-14B's params at full width with 4 layers (bf16,
    drawn on the card) placed by the sharding rules over the production
    meshes' 256 and 512 logical devices on the one card: each logical
    device's bytes against ``argument_bytes`` ' per-chip param bytes on
    that mesh, and ``gather`` back bitwise."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import bytes_per_device, default_rules, device_put, gather, tree_shardings
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import init_params

    cfg = get_config("qwen3-14b").scaled(n_layers=LAUNCH_LAYERS)
    params, axes = init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    flat = _lm_flat(params)
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        want = argument_bytes(cfg, "decode_32k", mesh)["params"]
        shardings = tree_shardings(axes, params, mesh, default_rules(mesh, expert_sharding=cfg.expert_sharding))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        placed = device_put(params, shardings)
        torch.cuda.synchronize()
        t_put = time.perf_counter() - t0
        per_dev = bytes_per_device(placed)
        t0 = time.perf_counter()
        back = _lm_flat(gather(placed))
        torch.cuda.synchronize()
        t_gather = time.perf_counter() - t0
        bad = [k for k, t in flat.items()
               if back[k].dtype != t.dtype or not torch.equal(back[k].view(torch.int16), t.view(torch.int16))]
        sharded = sum(any(e is not None for e in sh.spec) for sh in _lm_flat(shardings).values())
        log(f"launch: 11a {cfg.name} {cfg.n_layers} layers ({_nbytes(params) / 1e9:.2f} GB bf16) over "
            f"{dict(mesh.shape)} = {mesh.size} logical devices on the card ({sharded} of {len(flat)} leaves "
            f"sharded): device_put {t_put:.2f} s, {per_dev.sum() / 1e9:.2f} GB of blocks, {int(per_dev.min()):,}"
            f"-{int(per_dev.max()):,} B per logical device against argument_bytes' {want:,}; gather {t_gather:.2f} s, "
            f"{len(flat) - len(bad)} of {len(flat)} leaves bitwise ({smi})")
        if not (per_dev == want).all():
            raise AssertionError(f"launch: per-device bytes {per_dev.min()}-{per_dev.max()} != plan {want}")
        if bad:
            raise AssertionError(f"launch: gather differs on {bad}")
        del placed, back
        torch.cuda.empty_cache()
    del params, flat
    torch.cuda.empty_cache()


def launch_dryrun_phase() -> None:
    """Phase 11b: ``lower_cell`` for Qwen3-14B's cells and Llama-4-Scout's
    MoE ``train_4k`` at full depth on ``meta``, each step run on DTensors
    over the production mesh: per-chip argument
    and temporary bytes against the card's 80 GiB, collectives by kind,
    FLOPs and bytes accessed per chip and the model-FLOPs ratio of each
    cell."""
    import io

    from repro_torch.launch.dryrun import lower_cell

    for arch, shape, kind in LAUNCH_CELLS:
        with contextlib.redirect_stdout(io.StringIO()):  # lower_cell prints its own JSON line
            r = lower_cell(arch, shape, kind)
        if r["status"] != "ok":
            raise AssertionError(f"launch: dry run {shape} x {kind}: {r}")
        mem = r["memory_analysis"]
        arg, temp = mem["argument_bytes"], mem["temp_bytes"]
        coll = r["collectives"]
        kinds = ", ".join(f"{k} {coll['counts'][k]} x {int(b):,} B" for k, b in coll["bytes_by_kind"].items()
                          if coll["counts"][k])
        log(f"launch: 11b dry run {arch} {shape} x {kind} ({r['n_chips']} chips, {r['scan_info']}): "
            f"argument {arg:,} B per chip ({arg / HBM_BYTES:.2%} of 80 GiB; by part "
            f"{mem['argument_bytes_by_part']}), temp {temp:,} B ({temp / HBM_BYTES:.2%} of 80 GiB), output "
            f"{mem['output_bytes']:,} B; collectives per chip {int(coll['total_per_chip_bytes']):,} B ({kinds}); "
            f"flops_per_chip {r['flops_per_chip']:.4g}, bytes_accessed_per_chip "
            f"{r['bytes_accessed_per_chip']:.4g}, model_flops {r['model_flops']:.4g} (ratio "
            f"{r['useful_flops_ratio']:.4f}), plan {r['plan_seconds']:.2f} s")
        if not (r["flops_per_chip"] > 0 and r["bytes_accessed_per_chip"] > 0 and temp > 0):
            raise AssertionError(f"launch: dry run {shape} x {kind}: {r}")
        if kind == "single" and not coll["total_per_chip_bytes"] > 0:
            raise AssertionError(f"launch: dry run {shape} x {kind} counted no collective: {coll}")


def launch_phase(smi: str) -> None:
    """Phase 11: 11a the placement over the production meshes, 11b the dry
    run.  No PIC kernel launches here."""
    import torch

    from repro_torch.kernels.deposition import deposit_local_tiles
    from repro_torch.kernels.gather_push import gather_push_move

    t_phase = time.perf_counter()
    for fn in (gather_push_move, deposit_local_tiles):
        fn.launches = 0
    torch.cuda.empty_cache()
    launch_placement_phase(smi)
    launch_dryrun_phase()
    if gather_push_move.launches or deposit_local_tiles.launches:
        raise AssertionError("launch: the launch layer launched a PIC kernel")
    took = time.perf_counter() - t_phase
    log(f"launch: phase 11 took {took:.1f} s (at most {LAUNCH_SECONDS} s)")
    if took > LAUNCH_SECONDS:
        raise AssertionError(f"launch: phase 11 took {took:.1f} s, over {LAUNCH_SECONDS} s")


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.cuda_env import set_performance_flags

    env = set_performance_flags()  # before CUDA initializes, which reads it
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    initialized = torch.cuda.is_initialized()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    cuda_vars = {k: v for k, v in os.environ.items() if k in CUDA_ENV_VARS}
    log(f"env: set_performance_flags() set {env} with torch.cuda.is_initialized() {initialized}; "
        f"in the environment: {cuda_vars}")

    from repro_torch.kernels._build import build_info, load_library, persistent_blocks

    load_library()
    info = build_info()
    log(f"build: {info['seconds']:.1f} s (compiled here: {info['built']})")
    spills = []
    for line in str(info["log"]).splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"build: {line.strip()}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and (int(m.group(1)) or int(m.group(2))):
            spills.append(line.strip())
    if spills:
        raise AssertionError(f"a kernel spills registers: {spills}")

    from repro_torch.pic import SimConfig, Simulation, laser_ion_problem
    from repro_torch.pic.deposition import box_particle_counts

    t0 = time.perf_counter()
    prob = laser_ion_problem(
        nz=1920, nx=1920, box_cells=64, ppc=16, mass_ratio=1836, device="cuda"
    )
    sim = Simulation(
        prob,
        SimConfig(
            engine_backend="cuda", cost_strategy="work_counter", lb_interval=10,
            n_virtual_devices=8, strict_syncs=True,
        ),
    )
    del prob
    counts0 = sum(box_particle_counts(p, sim.grid) for p in sim.species)
    log(
        f"setup: {time.perf_counter() - t0:.1f} s; {sim.grid.n_boxes} boxes, "
        f"{int((counts0 > 0).sum())} occupied, "
        f"{[int(p.alive.sum()) for p in sim.species]} particles per species, cap {sim.kernel_cap}"
    )

    bzx = sim.grid.box_nz + 6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kernel, n_tiles in (("gather_push", 6), ("deposition", 3), ("deposition_from_momenta", 3)):
        blocks = persistent_blocks(kernel, bzx, bzx, torch.cuda.current_device())
        log(
            f"build: {kernel} persistent grid {blocks} blocks ({blocks / sms:g} per SM, {sms} SMs), "
            f"{n_tiles * bzx * bzx * 4} B of dynamic shared memory per block"
        )

    source = "src/repro_torch/kernels/csrc/"
    record = {
        "gather_push": dict(
            name="gather_push_move_", route="cuda", source=source + "gather_push.cu",
            replaces="src/repro/kernels/gather_push.py:28", library_ms=None,
        ),
        "deposition": dict(
            name="deposit_local_tiles", route="cuda", source=source + "deposition.cu",
            replaces="src/repro/kernels/deposition.py:34", library_ms=None,
        ),
    }
    marks = [("1 build and setup", time.perf_counter())]

    def mark(label: str) -> None:
        marks.append((label, time.perf_counter()))

    kernel_phase(sim, record)
    torch.cuda.empty_cache()
    mark("2 kernels")
    main_path(sim, len(sim.species), record)
    profile_interval(sim)
    del sim
    torch.cuda.empty_cache()
    mark("3 main path")
    backends_phase()
    mark("4 backends")
    sharded_phase(record)
    mark("5 sharded")
    async_phase(record, smi)
    recovery_phase(record, smi)
    mark("6 async and recovery")
    lb_sim = ledger_phase(record, smi)
    perfmodel_phase(lb_sim, record, smi)
    del lb_sim
    torch.cuda.empty_cache()
    overlap_phase(smi)
    box_runtime_phase(smi)
    sharded_fdtd_phase(smi)
    mark("7 ledger, perfmodel, overlap, box, fdtd")
    serve_phase(smi)
    mark("8 serving lane")
    lm_phase(smi)
    mark("9 LM serving path")
    train_phase(smi)
    mark("10 training path")
    launch_phase(smi)
    mark("11 launch layer")
    log("time: " + ", ".join(f"phase {label} {t - t_prev:.1f} s" for (_, t_prev), (label, t)
                             in zip(marks, marks[1:])))

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r[k] for k in keys} for r in record.values()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
