"""The reference's partitioned program for small cells, on 8 fake host devices.

For each (arch, mode, mesh) cell given as JSON on the command line, the
reference's ``launch/dryrun.py`` lowering at a SMOKE config's width: the
step (``make_train_step`` with the reference's microbatch rule,
``make_prefill_step`` or ``make_serve_step``) jitted with its shardings
over ``jax.make_mesh(mesh, ("data", "model"))`` on the inputs its
``input_specs`` makes (``_token_specs``: whisper's audio frames and
qwen2-vl's patch embeddings besides the tokens and labels; decode's
token), lowered and compiled by GSPMD.  Prints one JSON line per cell:
``inputs`` (each input's shape), ``parse_collectives`` of the compiled
text and the compiled ``temp_size_in_bytes``.  The port's
partitioned dry run is held against these numbers
(``tests/test_torch_partition.py``); run alone:

    PYTHONPATH=src python tests/partition_oracle.py \\
        '[["qwen3-14b", "prefill", [4, 2], 16, 64, {}, "auto"]]'

each cell ``[arch, mode, [data, model], batch, seq]`` (decode: ``seq``
is the cache's context), or with a sixth entry, a dict of
``ModelConfig.scaled`` overrides of that cell's SMOKE config, and a
seventh, ``"auto"``, for a mesh whose axes are ``AxisType.Auto`` (see
below).  Each line also holds ``collectives_by_dtype``: the same bytes
split by the dtype of each collective's result shapes, and ``elements``:
those bytes over each dtype's size, by kind (the host lowering carries
float32 and int32 where the port's traffic is bf16, so the two are
compared in elements); ``collectives_per_trip``,
``collectives_by_dtype_per_trip`` and ``elements_per_trip``: the same
three with each collective counted as often as the ``while`` loops around
it run (``loop_trips``: the microbatch and layer scans; the keys above
count a loop's body once, as ``parse_collectives`` does, which also
skips a collective whose result is a tuple of six or more shapes; these
count it); ``flops_per_chip``: the compiled program's ``cost_analysis()``
FLOPs (a scan's body counted once); and ``wo_dots``: the result and
operand shapes of each forward dot that the reference's ``... @ p["wo"]``
lowers to (found by the HLO's stack frames; a backward dot's innermost
frame is its remat's checkpoint); ``batched_dot_flops``: the FLOPs of its
dots with batch dims (attention's products) per loop trip;
``all_reduce_operands``: the
all-reduces' operands over one step, ``{axes: {elements: count}}``, each
counted per loop trip and keyed by the mesh axes its replica group spans
(``"model"``, ``"data"``, ``"model[2]"`` for a group of 2 chips of the
model axis); and ``dot_all_reduces``: for each all-reduce whose operands
all come from dots, ``[axes, backward, widths]``, the width each
operand's dot contracts over (a backward all-reduce's ``op_name`` is a
``transpose``).

``jax.make_mesh`` 's axes are ``Explicit`` under this jax, where the
reference's ``constrain_batch`` (a ``with_sharding_constraint``, which
asserts on an explicit mesh) falls back to a no-op: every activation is
replicated, every weight gathered, and each chip computes the whole
step, so the lowering shows no tensor-parallel product.  An ``"auto"``
cell lowers the same step on ``Auto`` axes, where the constraints act and
GSPMD partitions each product as the reference's sharding was written
for: the tests hold the port to that lowering, counted per trip.  With
``--port`` each line also holds the port's ``plan_cell`` of the same cell
(the step on DTensors over the same mesh on a fake process group), the
ratio of the two collective totals in bytes (``ratio``: the reference's
once per loop body, as PERF.md's history quotes it) and in elements
(``ratio_elements``: the reference's per trip).
``--scaled '{"d_model": 1024, "head_dim": 256, "d_ff": 4096}'`` widens
both packages' SMOKE configs by ``ModelConfig.scaled`` for every cell
without overrides of its own.  ``--scan-psum N`` prints, instead of any
cell, :func:`scan_psum` 's counts of a scan of ``N`` trips with one and
with six arrays all-reduced in its body.
"""
import json
import os
import re
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding, PartitionSpec  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.shapes import _token_specs  # noqa: E402
from repro.dist.sharding import batch_sharding, default_rules, tree_shardings  # noqa: E402
from repro.launch.dryrun import _DTYPE_BYTES, _SHAPE_RE, _decode_state_shardings, parse_collectives  # noqa: E402
from repro.models import init_decode_state, init_params  # noqa: E402
from repro.train.servestep import make_prefill_step, make_serve_step  # noqa: E402
from repro.train.trainstep import TrainState, init_train_state, make_train_step  # noqa: E402


#: ``ModelConfig.scaled`` overrides of both packages' SMOKE configs (``--scaled``)
SCALED: dict = {}


def collectives_by_dtype(hlo_text: str) -> dict:
    """``parse_collectives`` ' bytes by kind, each split by the dtypes of
    its result shapes: ``{kind: {dtype: bytes}}``.  Each collective line
    is parsed alone by ``parse_collectives`` and its bytes shared among
    the dtypes of its result (a tuple's elements) in proportion to their
    bytes, so the splits add up to the totals."""
    out: dict = {}
    for line in hlo_text.splitlines():
        one = parse_collectives(line)
        kind = next((k for k, n in one["counts"].items() if n), None)
        if kind is None:
            continue
        lhs, _, rhs = line.strip().partition("=")
        shapes = [(dt, dims) for dt, dims in _SHAPE_RE.findall(rhs.split(kind)[0]) if dt in _DTYPE_BYTES] or \
            [(dt, dims) for dt, dims in _SHAPE_RE.findall(lhs) if dt in _DTYPE_BYTES]
        raw = {}
        for dt, dims in shapes:
            raw[dt] = raw.get(dt, 0) + int(np.prod([int(d) for d in dims.split(",") if d])) * _DTYPE_BYTES[dt]
        total = sum(raw.values())
        for dt, b in raw.items():
            out.setdefault(kind, {})
            out[kind][dt] = out[kind].get(dt, 0.0) + one["bytes_by_kind"][kind] * b / total
    return out


#: the reference's lines that multiply by ``wo``
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src", "repro", "models",
                       "attention.py")) as _f:
    WO_LINES = {i + 1 for i, line in enumerate(_f) if '@ p["wo"]' in line}


def _instructions(hlo_text: str) -> dict:
    """``{name: (result, op, operands, line)}`` of every instruction."""
    out = {}
    for m in re.finditer(r"^\s*(?:ROOT )?%(\S+) = (\(.*?\)|\w+\[[\d,]*\])\S* ([\w-]+)\(([^)]*)\)(.*)$",
                         hlo_text, re.M):
        out[m.group(1)] = (m.group(2), m.group(3), re.findall(r"%([\w.-]+)", m.group(4)), m.group(5))
    return out


def wo_dots(hlo_text: str) -> list:
    """``[result, lhs, rhs]`` shapes of each dot whose innermost stack frame
    is a line of the reference's attention that multiplies by ``wo``."""
    files = dict(re.findall(r'^(\d+) "([^"]+)"$', hlo_text.split("\nFunctionNames\n")[0], re.M))
    locs = {i: (f, int(n)) for i, f, n in re.findall(r"^(\d+) \{file_name_id=(\d+) function_name_id=\d+ line=(\d+)",
                                                     hlo_text, re.M)}
    frames = dict(re.findall(r"^(\d+) \{file_location_id=(\d+) parent", hlo_text, re.M))
    insts = _instructions(hlo_text)
    out = []
    for result, op, args, rest in insts.values():
        frame = re.search(r"stack_frame_id=(\d+)", rest)
        if op == "dot" and frame:
            f, n = locs[frames[frame.group(1)]]
            if files[f].endswith(os.path.join("repro", "models", "attention.py")) and n in WO_LINES:
                out.append([result, insts[args[0]][0], insts[args[1]][0]])
    return out


def loop_trips(hlo_text: str) -> dict:
    """``{computation: times it runs in one step}``: the product of the
    known trip counts of the ``while`` loops around it (1 for the entry
    and for a computation called outside any loop)."""
    comps, entry, cur = {}, None, None
    for line in hlo_text.splitlines():
        m = re.match(r"^(ENTRY )?%(\S+) .*\{$", line)
        if m:
            cur = m.group(2)
            comps[cur] = []
            entry = cur if m.group(1) else entry
        elif cur is not None and line.startswith("  "):
            comps[cur].append(line)
    callers: dict = {}
    for c, lines in comps.items():
        for line in lines:
            trip = re.search(r'known_trip_count":\{"n":"(\d+)"', line)
            for key, name in re.findall(r"(body|condition|to_apply|calls)=%([\w.-]+)", line):
                callers.setdefault(name, []).append((c, int(trip.group(1)) if key == "body" and trip else 1))
            for group in re.findall(r"branch_computations=\{([^}]*)\}", line):
                for name in re.findall(r"%([\w.-]+)", group):
                    callers.setdefault(name, []).append((c, 1))
    trips = {entry: 1}

    def times(c):
        if c not in trips:
            trips[c] = 0
            trips[c] = sum(times(caller) * n for caller, n in callers.get(c, []))
        return trips[c]

    return {c: (times(c), lines) for c, lines in comps.items()}


def batched_dot_flops(hlo_text: str) -> int:
    """The FLOPs of the module's dots with batch dims (attention's scores
    and their product with v, forward and backward, and any other batched
    product), each counted as often as the loops around it run:
    2 x its result's elements x its contraction's size."""
    insts = _instructions(hlo_text)
    total = 0
    for times, lines in loop_trips(hlo_text).values():
        for line in lines:
            m = re.match(r"\s*(?:ROOT )?%(\S+) = \S+ dot\(", line)
            if not m or "lhs_batch_dims" not in insts[m.group(1)][3]:
                continue
            result, _, args, rest = insts[m.group(1)]
            lhs = [int(d) for d in re.search(r"\[([\d,]*)\]", insts[args[0]][0]).group(1).split(",")]
            dims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rest).group(1).split(",")
            out = re.search(r"\[([\d,]*)\]", result).group(1).split(",")
            total += times * 2 * int(np.prod([int(d) for d in out])) * int(np.prod([lhs[int(d)] for d in dims]))
    return total


def _elements(by_dtype: dict) -> dict:
    """``{kind: elements}`` of ``{kind: {dtype: bytes}}``: each dtype's
    bytes over its size."""
    return {k: sum(b / _DTYPE_BYTES[d] for d, b in by.items()) for k, by in by_dtype.items()}


#: the ``/*index=5*/`` marks in a tuple of six or more shapes, which
#: ``parse_collectives`` ' pattern does not pass: it skips such a collective
_COMMENT = re.compile(r"/\*.*?\*/")


def per_trip(hlo_text: str) -> dict:
    """The collectives over one step, each counted as often as the loops
    around it run (:func:`loop_trips`), where ``parse_collectives`` counts
    a loop's body once, and each whose result is a tuple of six or more
    shapes counted too: ``collectives_per_trip`` (``parse_collectives`` '
    keys), ``collectives_by_dtype_per_trip`` (:func:`collectives_by_dtype`
    's) and ``elements_per_trip`` (``{kind: elements}``)."""
    coll = {"bytes_by_kind": {}, "counts": {}, "total_per_chip_bytes": 0.0}
    by_dtype: dict = {}
    for times, lines in loop_trips(hlo_text).values():
        if not times:
            continue
        body = _COMMENT.sub("", "\n".join(lines))
        one = parse_collectives(body)
        for kind, b in one["bytes_by_kind"].items():
            coll["bytes_by_kind"][kind] = coll["bytes_by_kind"].get(kind, 0.0) + times * b
            coll["counts"][kind] = coll["counts"].get(kind, 0) + times * one["counts"][kind]
        for kind, by in collectives_by_dtype(body).items():
            for dt, b in by.items():
                by_dtype.setdefault(kind, {})
                by_dtype[kind][dt] = by_dtype[kind].get(dt, 0.0) + times * b
    coll["total_per_chip_bytes"] = sum(coll["bytes_by_kind"].values())
    return {"collectives_per_trip": coll, "collectives_by_dtype_per_trip": by_dtype,
            "elements_per_trip": _elements(by_dtype)}


def _group_axes(rhs: str, mesh_shape) -> str:
    """The mesh axes that a collective's first replica group spans, with
    the group's size in brackets where it is only part of them."""
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?", rhs)
    if m:
        ids = np.arange(int(np.prod([int(d) for d in m.group(3).split(",")]))).reshape(
            [int(d) for d in m.group(3).split(",")])
        if m.group(4):
            ids = ids.transpose([int(p) for p in m.group(4).split(",")])
        group = ids.reshape(int(m.group(1)), int(m.group(2)))[0].tolist()
    else:
        m = re.search(r"replica_groups=\{\{([\d,]+)\}", rhs)
        group = [int(i) for i in m.group(1).split(",")] if m else list(range(int(np.prod(mesh_shape))))
    coords = np.array([np.unravel_index(i, tuple(mesh_shape)) for i in group])
    axes = [a for i, a in enumerate(("data", "model")) if len(set(coords[:, i])) > 1]
    whole = len(group) == int(np.prod([mesh_shape[("data", "model").index(a)] for a in axes]))
    return "+".join(axes) + ("" if whole else f"[{len(group)}]")


def all_reduces(hlo_text: str, mesh_shape):
    """``(all_reduce_operands, dot_all_reduces)`` of the module (see the
    module's doc)."""
    insts = _instructions(hlo_text)
    operands: dict = {}
    dots = []

    def dot_width(name):
        for _ in range(4):  # through the converts and bitcasts XLA fuses after a dot
            result, op, args, rest = insts[name]
            if op == "dot":
                dims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rest).group(1)
                lhs = [int(d) for d in re.search(r"\[([\d,]*)\]", insts[args[0]][0]).group(1).split(",")]
                return int(np.prod([lhs[int(d)] for d in dims.split(",")]))
            if len(args) != 1 or op not in ("fusion", "convert", "bitcast", "copy", "reshape"):
                return None
            name = args[0]
        return None

    for times, lines in loop_trips(hlo_text).values():
        for line in lines:
            m = re.match(r"\s*(?:ROOT )?%(\S+) = (.*?) all-reduce(?:-start)?\(", line)
            if not m or not times:
                continue
            axes = _group_axes(line, mesh_shape)
            by = operands.setdefault(axes, {})
            for _, dims in _SHAPE_RE.findall(m.group(2)):
                n = str(int(np.prod([int(d) for d in dims.split(",") if d])))
                by[n] = by.get(n, 0) + times
            widths = [dot_width(a) for a in insts[m.group(1)][2]]
            if all(w is not None for w in widths):
                op_name = re.search(r'op_name="([^"]*)"', line)
                dots.append([axes, bool(op_name and "transpose(" in op_name.group(1)), widths])
    return operands, dots


def scan_psum(n: int, parts: int = 1, width: int = 96) -> dict:
    """A ``jax.lax.scan`` of ``n`` trips whose body all-reduces its carry,
    ``parts`` (``width``,) float32 arrays, over the 8 devices (a ``psum``
    under ``shard_map``, which XLA issues as one all-reduce of a tuple),
    compiled: its ``collectives`` (the body once) and :func:`per_trip` 's
    keys, for a check of the trip counting."""
    mesh = jax.make_mesh((8,), ("model",), axis_types=(AxisType.Auto,))

    def body(c, _):
        return tuple(a + b for a, b in zip(c, jax.lax.psum(tuple(jnp.sin(a) for a in c), "model"))), None

    f = jax.shard_map(lambda *x: jax.lax.scan(body, x, None, length=n)[0], mesh=mesh,
                      in_specs=PartitionSpec("model"), out_specs=PartitionSpec("model"))
    arg = jax.ShapeDtypeStruct((8 * width,), jnp.float32)
    text = jax.jit(f).lower(*[arg] * parts).compile().as_text()
    return {"collectives": parse_collectives(text), **per_trip(text)}


def lower(arch: str, mode: str, mesh_shape, B: int, S: int, scaled=None, axes=None) -> dict:
    cfg = get_config(arch, smoke=True).scaled(**(SCALED if scaled is None else scaled))
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"),
                         **({"axis_types": (AxisType.Auto,) * 2} if axes == "auto" else {}))
    rules = default_rules(mesh, expert_sharding=cfg.expert_sharding)
    box = {}

    def build():
        p, s = init_params(jax.random.PRNGKey(0), cfg)
        box["axes"] = s
        return p

    params = jax.eval_shape(build)
    params_sh = tree_shardings(box["axes"], params, mesh, rules)
    # the step's inputs as the reference's own dry run makes them
    # (``input_specs``): the audio frames and patch embeddings too
    batch = _token_specs(cfg, B, S, labels=True)
    with jax.sharding.set_mesh(mesh):
        if mode == "decode":
            state = jax.eval_shape(lambda: init_decode_state(cfg, B, S))
            token = jax.ShapeDtypeStruct((B, 1), jnp.int32)
            batch = {"token": token}
            shardings = (params_sh, batch_sharding(mesh, rules, shape=token.shape),
                         _decode_state_shardings(state, mesh, rules))
            lowered = jax.jit(make_serve_step(cfg), in_shardings=shardings,
                              donate_argnums=(2,)).lower(params, token, state)
        else:
            batch_sh = {k: batch_sharding(mesh, rules, shape=v.shape) for k, v in batch.items()}
            if mode == "prefill":
                lowered = jax.jit(make_prefill_step(cfg), in_shardings=(params_sh, batch_sh)).lower(
                    params, batch)
            else:
                dp = int(np.prod([mesh.shape[a] for a in (
                    (rules["batch"],) if isinstance(rules["batch"], str) else rules["batch"])]))
                grad_accum = max(1, B // (dp * 4))
                state = jax.eval_shape(init_train_state, params)
                state_sh = TrainState(params=params_sh, opt=type(state.opt)(
                    step=NamedSharding(mesh, PartitionSpec()), m=params_sh, v=params_sh,
                    error_feedback=None))
                lowered = jax.jit(make_train_step(cfg, grad_accum=grad_accum),
                                  in_shardings=(state_sh, batch_sh), donate_argnums=(0,)).lower(
                    state, batch)
        compiled = lowered.compile()
    text = compiled.as_text()
    operands, dots = all_reduces(text, mesh_shape)
    by_dtype = collectives_by_dtype(text)
    return {"arch": arch, "mode": mode, "mesh": list(mesh_shape), "batch": B, "seq": S,
            "scaled": SCALED if scaled is None else scaled, "axes": axes or "explicit",
            "inputs": {k: list(v.shape) for k, v in batch.items()},
            "collectives": parse_collectives(text), "collectives_by_dtype": by_dtype,
            "elements": _elements(by_dtype), **per_trip(text),
            "temp_bytes": compiled.memory_analysis().temp_size_in_bytes,
            "flops_per_chip": compiled.cost_analysis()["flops"], "wo_dots": wo_dots(text),
            "batched_dot_flops": batched_dot_flops(text),
            "all_reduce_operands": operands, "dot_all_reduces": dots}


def plan(arch: str, mode: str, mesh_shape, B: int, S: int, scaled=None, axes=None) -> dict:
    """The port's plan of the same cell."""
    from repro_torch.configs import get_config as port_config
    from repro_torch.configs.shapes import SHAPES, ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    name = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[mode]
    saved = SHAPES[name]
    SHAPES[name] = ShapeSpec(name, S, saved.global_batch, mode)
    try:
        mesh = make_mesh(tuple(mesh_shape), ("data", "model"), device="meta")
        cfg = port_config(arch, smoke=True).scaled(**(SCALED if scaled is None else scaled))
        return dryrun.plan_cell(cfg, name, mesh, batch_override=B)
    finally:
        SHAPES[name] = saved


if __name__ == "__main__":
    if "--scan-psum" in sys.argv:
        i = sys.argv.index("--scan-psum")
        print(json.dumps([scan_psum(int(sys.argv[i + 1]), parts) for parts in (1, 6)]))
        sys.exit()
    if "--scaled" in sys.argv:
        SCALED.update(json.loads(sys.argv[sys.argv.index("--scaled") + 1]))
    for cell in json.loads(sys.argv[1]):
        row = lower(*cell)
        if "--port" in sys.argv[2:]:
            port = plan(*cell)
            row["port"] = {"collectives": port["collectives"], "flops_per_chip": port["flops_per_chip"],
                           "temp_bytes": port["memory_analysis"]["temp_bytes"]}
            ref_total = row["collectives"]["total_per_chip_bytes"]
            row["ratio"] = port["collectives"]["total_per_chip_bytes"] / ref_total if ref_total else None
            ref_elements = sum(row["elements_per_trip"].values())
            row["ratio_elements"] = (sum(port["collective_elements_by_kind"].values()) / ref_elements
                                     if ref_elements else None)
        print(json.dumps(row), flush=True)
