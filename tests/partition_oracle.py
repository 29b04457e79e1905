"""The reference's partitioned program for small cells, on 8 fake host devices.

For each (arch, mode, mesh) cell given as JSON on the command line, the
reference's ``launch/dryrun.py`` lowering at a SMOKE config's width: the
step (``make_train_step`` with the reference's microbatch rule,
``make_prefill_step`` or ``make_serve_step``) jitted with its shardings
over ``jax.make_mesh(mesh, ("data", "model"))``, lowered and compiled by
GSPMD.  Prints one JSON line per cell: ``parse_collectives`` of the
compiled text and the compiled ``temp_size_in_bytes``.  The port's
partitioned dry run is held against these numbers
(``tests/test_torch_partition.py``); run alone:

    PYTHONPATH=src python tests/partition_oracle.py \\
        '[["qwen3-14b", "prefill", [4, 2], 16, 64]]'

each cell ``[arch, mode, [data, model], batch, seq]`` (decode: ``seq``
is the cache's context), or with a sixth entry, a dict of
``ModelConfig.scaled`` overrides of that cell's SMOKE config.  Each line
also holds ``collectives_by_dtype``: the same bytes split by the dtype of
each collective's result shapes.  With ``--port`` each line also holds the
port's ``plan_cell`` of the same cell (the step on DTensors over the same
mesh on a fake process group) and the ratio of the two collective totals.
``--scaled '{"d_model": 1024, "head_dim": 256, "d_ff": 4096}'`` widens
both packages' SMOKE configs by ``ModelConfig.scaled`` for every cell
without overrides of its own.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from repro.configs import get_config  # noqa: E402
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


def lower(arch: str, mode: str, mesh_shape, B: int, S: int, scaled=None) -> dict:
    cfg = get_config(arch, smoke=True).scaled(**(SCALED if scaled is None else scaled))
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"))
    rules = default_rules(mesh, expert_sharding=cfg.expert_sharding)
    box = {}

    def build():
        p, s = init_params(jax.random.PRNGKey(0), cfg)
        box["axes"] = s
        return p

    params = jax.eval_shape(build)
    params_sh = tree_shardings(box["axes"], params, mesh, rules)
    with jax.sharding.set_mesh(mesh):
        if mode == "decode":
            state = jax.eval_shape(lambda: init_decode_state(cfg, B, S))
            token = jax.ShapeDtypeStruct((B, 1), jnp.int32)
            shardings = (params_sh, batch_sharding(mesh, rules, shape=token.shape),
                         _decode_state_shardings(state, mesh, rules))
            lowered = jax.jit(make_serve_step(cfg), in_shardings=shardings,
                              donate_argnums=(2,)).lower(params, token, state)
        else:
            batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
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
    return {"arch": arch, "mode": mode, "mesh": list(mesh_shape), "batch": B, "seq": S,
            "scaled": SCALED if scaled is None else scaled,
            "collectives": parse_collectives(text), "collectives_by_dtype": collectives_by_dtype(text),
            "temp_bytes": compiled.memory_analysis().temp_size_in_bytes}


def plan(arch: str, mode: str, mesh_shape, B: int, S: int, scaled=None) -> dict:
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
    if "--scaled" in sys.argv:
        SCALED.update(json.loads(sys.argv[sys.argv.index("--scaled") + 1]))
    for cell in json.loads(sys.argv[1]):
        row = lower(*cell)
        if "--port" in sys.argv[2:]:
            port = plan(*cell)
            row["port"] = {"collectives": port["collectives"],
                           "temp_bytes": port["memory_analysis"]["temp_bytes"]}
            ref_total = row["collectives"]["total_per_chip_bytes"]
            row["ratio"] = port["collectives"]["total_per_chip_bytes"] / ref_total if ref_total else None
        print(json.dumps(row), flush=True)
