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
     copies made once, on both orders of the electrons;
  3. main path: ``Simulation.run`` of the laser-ion problem on the paper's
     1920² grid (64² boxes, mass ratio 1836, 16 particles per cell per
     species) for 20 steps (2 LB rounds), every interval under
     ``torch.cuda.set_sync_debug_mode("error")``; each kernel must launch
     steps x species times, and the fetched work counters must equal
     ``box_work_counters`` of the fetched per-species counts; then one more
     interval under ``torch.profiler`` prints where the step's time goes,
     with each kernel's device time per launch;
  4. backends: ``engine_backend="cuda"`` against ``"torch"`` at 256² for 10
     steps: energies within rtol 1e-3, the same particle census and LB steps.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repository's ``src/repro_torch`` beside this file, it exits 2
and prints no result.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

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


def kernel_phase(sim, record: dict) -> None:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.deposition import (
        deposit_local_tiles,
        deposit_local_tiles_plain,
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
            del scratch, launch
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
        del args, arrays, dep_args, k_out, kd, pd, v, counts, sz, sx, ux, uy, uz
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

    from repro_torch.kernels.deposition import deposit_local_tiles
    from repro_torch.kernels.gather_push import gather_push_move
    from repro_torch.pic.deposition import box_work_counters

    n_particles = sum(int(p.alive.sum()) for p in sim.species)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gather_push_move.launches = 0
    deposit_local_tiles.launches = 0
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
    for fn in (gather_push_move, deposit_local_tiles):
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
    ``torch.profiler``, and the device's busy share of the wall time.
    Informational; it checks nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(10)
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
        f"profile: 10 steps, wall {wall_ms:.1f} ms, kernels busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%, idle {100 * (1 - busy / wall_ms):.1f}%), "
        f"launch queue full {queue_full_ms:.1f} ms"
    )
    # the top rows, and the port's two kernels wherever they rank
    ours = ("gather_push_kernel", "deposition_kernel")
    for i, (ms, count, name) in enumerate(rows):
        if i < top or any(k in name for k in ours):
            log(f"profile: {ms / 10:9.3f} ms/step {100 * ms / busy:5.1f}%  x{count // 10:<4d} {name[:90]}")
        if any(k in name for k in ours):
            log(f"profile: {name[:40]} {ms / count:.3f} ms of device time per launch ({count} launches)")
    kernels_ms = sum(ms for ms, _, name in rows if any(k in name for k in ours))
    log(f"profile: the two PIC kernels {kernels_ms / 10:.3f} ms/step of device time")


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


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

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
    for kernel, n_tiles in (("gather_push", 6), ("deposition", 3)):
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
    kernel_phase(sim, record)
    torch.cuda.empty_cache()
    main_path(sim, len(sim.species), record)
    profile_interval(sim)
    del sim
    torch.cuda.empty_cache()
    backends_phase()

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
