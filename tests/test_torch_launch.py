"""The port's launch layer: the CUDA environment (``launch.cuda_env``), the
production meshes and the dry run on ``meta`` (``launch.dryrun``), against
the reference's ``launch`` where it has a counterpart.

* ``_decode_state_shardings``: every leaf's spec and shard shape equal to
  the reference's on both production meshes (``AbstractMesh``, no
  devices), for every applicable ``decode_32k`` / ``long_500k`` cell;
* ``plan_cell``'s per-chip argument bytes equal to the sum over the
  reference's shard shapes of its ``eval_shape`` state (the arguments its
  ``lower_cell`` compiles), and ``scan_info`` equal to its formula;
* the FLOPs ``step_counts`` counts on ``meta`` (two and three layer groups,
  extended to the full depth) equal to ``FlopCounterMode`` over the same
  step at full depth on real CPU tensors, for every SMOKE config and mode;
* ``plan_cell`` 's collectives, temporaries and bytes accessed counted
  (``tests/test_torch_partition.py`` holds them to the reference's
  partitioned program and to exact counts).

The reference's dry run fakes 512 host devices through ``XLA_FLAGS`` when
it is imported; the fixture initializes jax's backend first and restores
the variable afterwards.
"""
import json
import math
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import input_specs as ref_input_specs
from repro.dist import sharding as ref
from repro.train.trainstep import TrainState as RefTrainState
from repro.train.trainstep import init_train_state as ref_init_train_state
from repro_torch.configs import get_config
from repro_torch.configs.shapes import applicable, input_specs
from repro_torch.launch import cuda_env, dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh, require_devices
from repro_torch.models import init_decode_state, init_params
from repro_torch.train.servestep import make_prefill_step, make_serve_step
from repro_torch.train.trainstep import init_train_state, make_train_step
from test_torch_sharding import MESHES, assert_same_shardings, ref_param_tree

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref_dryrun():
    jax.devices()  # the backend starts with this process's flags, not 512 devices
    saved = os.environ.get("XLA_FLAGS")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _meshes(kind):
    (shape, names), multi = MESHES[kind]
    return AbstractMesh(shape, names), make_production_mesh(multi_pod=multi, device="meta")


def _ref_bytes(shardings, shapes) -> int:
    sh = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, JNamedSharding))
    leaves = jax.tree.leaves(shapes)
    assert len(sh) == len(leaves)
    return sum(math.prod(s.shard_shape(l.shape)) * l.dtype.itemsize for s, l in zip(sh, leaves))


# ---------------------------------------------------------------------------
# decode-state shardings
# ---------------------------------------------------------------------------


DECODE_CELLS = [(a, s) for a in ARCH_IDS for s in ("decode_32k", "long_500k")
                if applicable(get_config(a), s) is None]


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_decode_state_shardings_match_reference(ref_dryrun, arch, shape, kind):
    amesh, pmesh = _meshes(kind)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    ref_state = ref_input_specs(rcfg, shape)["state"]
    state = input_specs(cfg, shape)["state"]
    ref_sh = ref_dryrun._decode_state_shardings(ref_state, amesh, ref.default_rules(amesh))
    port_sh = dryrun._decode_state_shardings(state, pmesh, dryrun.default_rules(pmesh))
    assert_same_shardings(ref_sh, ref_state, port_sh, state)


def test_decode_cells_cover_the_skips():
    skipped = [(a, s) for a in ARCH_IDS for s in ("decode_32k", "long_500k")
               if (a, s) not in DECODE_CELLS]
    assert skipped and all(s == "long_500k" for _, s in skipped)
    from repro.configs.shapes import applicable as ref_applicable

    for a, s in skipped:
        assert ref_applicable(ref_get_config(a), s) == applicable(get_config(a), s)


# ---------------------------------------------------------------------------
# plan_cell against the reference's compiled arguments
# ---------------------------------------------------------------------------


def _ref_arguments(ref_dryrun, arch, shape, amesh):
    """The arguments the reference's ``lower_cell`` compiles, with their
    shardings (its code, on an ``AbstractMesh``)."""
    cfg = ref_get_config(arch)
    spec = REF_SHAPES[shape]
    rules = ref.default_rules(amesh, expert_sharding=cfg.expert_sharding)
    specs_in = ref_input_specs(cfg, shape)
    params_shapes, axes = ref_param_tree(cfg)
    params_sh = ref.tree_shardings(axes, params_shapes, amesh, rules)
    if spec.mode == "decode":
        state = specs_in["state"]
        token = specs_in["token"]
        sh = (params_sh, ref.batch_sharding(amesh, rules, shape=token.shape),
              ref_dryrun._decode_state_shardings(state, amesh, rules))
        return sh, (params_shapes, token, state), rules
    batch_sh = {k: ref.batch_sharding(amesh, rules, shape=v.shape) for k, v in specs_in["batch"].items()}
    if spec.mode == "prefill":
        return (params_sh, batch_sh), (params_shapes, specs_in["batch"]), rules
    state_shapes = jax.eval_shape(ref_init_train_state, params_shapes)
    state_sh = RefTrainState(
        params=params_sh,
        opt=type(state_shapes.opt)(step=JNamedSharding(amesh, JP()), m=params_sh, v=params_sh,
                                   error_feedback=None),
    )
    return (state_sh, batch_sh), (state_shapes, specs_in["batch"]), rules


def _ref_scan_info(arch, shape, amesh, rules):
    """``scan_info`` by the reference's formula (``launch/dryrun.py``)."""
    cfg = ref_get_config(arch)
    spec = REF_SHAPES[shape]
    batch_axes = rules["batch"]
    dp = int(np.prod([amesh.shape[a] for a in (
        (batch_axes,) if isinstance(batch_axes, str) else batch_axes)]))
    n_groups = cfg.n_layers // len(cfg.block_pattern)
    return {
        "mode": spec.mode,
        "grad_accum": max(1, spec.global_batch // (4 * dp)) if spec.mode == "train" else 1,
        "layer_groups": cfg.n_layers if cfg.kind == "encdec" else n_groups,
        "enc_layers": cfg.n_enc_layers,
        "tail_layers": cfg.n_layers % len(cfg.block_pattern),
        "seq_len": spec.seq_len,
        "global_batch": spec.global_batch,
        "n_params": None,
    }


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", [("qwen3-14b", "train_4k"), ("mixtral-8x7b", "decode_32k")])
def test_plan_argument_bytes_and_scan_info_match_reference(ref_dryrun, arch, shape, kind):
    amesh, pmesh = _meshes(kind)
    sh, shapes, rules = _ref_arguments(ref_dryrun, arch, shape, amesh)
    plan = dryrun.plan_cell(get_config(arch), shape, pmesh)
    mem = plan["memory_analysis"]
    assert mem["argument_bytes"] == _ref_bytes(sh, shapes)
    assert mem["argument_bytes"] == sum(mem["argument_bytes_by_part"].values())
    assert plan["scan_info"] == _ref_scan_info(arch, shape, amesh, rules)
    assert plan["n_chips"] == math.prod(amesh.shape.values())
    coll = plan["collectives"]
    assert set(coll) == {"bytes_by_kind", "counts", "total_per_chip_bytes"}
    assert coll["total_per_chip_bytes"] == sum(coll["bytes_by_kind"].values()) > 0
    assert mem["temp_bytes"] > 0 and plan["bytes_accessed_per_chip"] > 0
    assert plan["flops_per_chip"] > 0 and 0 < plan["useful_flops_ratio"] < 1
    if shape == "train_4k":  # params + m + v + the replicated step + the batch
        by = mem["argument_bytes_by_part"]
        assert by["optimizer"] == 4 * by["params"] + 4
        # the state, updated in place, and the float32 loss and grad_norm
        assert mem["output_bytes"] == by["params"] + by["optimizer"] + 2 * 4


@pytest.mark.parametrize("arch,shape", [("qwen3-14b", "train_4k"), ("mixtral-8x7b", "decode_32k"),
                                        ("yi-9b", "prefill_32k")])
def test_argument_bytes_equal_plan_cells_parts(arch, shape):
    """The byte plan alone, without the step, is ``plan_cell`` 's."""
    cfg = get_config(arch, smoke=True)
    mesh = make_mesh((2, 2), ("data", "model"), device="meta")
    plan = dryrun.plan_cell(cfg, shape, mesh, batch_override=8)["memory_analysis"]
    by = dryrun.argument_bytes(cfg, shape, mesh, batch_override=8)
    assert by == plan["argument_bytes_by_part"] and sum(by.values()) == plan["argument_bytes"]


def test_plan_on_one_chip_holds_the_whole_train_state():
    """On a 1x1 mesh the train cell's arguments are the whole state: bf16
    params, float32 m and v (10 B/param), the step and the batch: the
    prediction ``chip_smoke.py`` phase 10b holds the card's memory to."""
    cfg = get_config("qwen3-14b", smoke=True).scaled(n_layers=3)
    mesh = make_mesh((1, 1), ("data", "model"), device="meta")
    plan = dryrun.plan_cell(cfg, "train_4k", mesh, batch_override=2)
    n = plan["n_params"]
    assert cfg.param_dtype == torch.bfloat16 and n == cfg.n_params
    assert plan["memory_analysis"]["argument_bytes"] == 10 * n + 4 + 2 * 2 * 4096 * 4
    assert plan["scan_info"]["global_batch"] == 2 and plan["scan_info"]["grad_accum"] == 1
    assert plan["model_flops"] == 6 * n * 2 * 4096


# ---------------------------------------------------------------------------
# FLOPs on meta against a real run
# ---------------------------------------------------------------------------


B, S, ACCUM = 2, 32, 2


def _deeper(cfg):
    """The SMOKE config with five groups per stack (and a tail where the
    pattern allows one): ``step_counts`` runs two and three groups, so its
    count is extended two groups past the deepest step it ran."""
    if cfg.kind == "encdec":
        return cfg.scaled(n_layers=5, n_enc_layers=6)
    pat = len(cfg.block_pattern)
    return cfg.scaled(n_layers=5 * pat + (pat > 1))


def _args(cfg, mode, device, gen=None):
    """The step and its arguments at (B, S) on ``device``; random data
    where the device is real."""
    params, _ = init_params(gen if gen is not None else None, cfg, device=device)

    def ints(shape):
        if device == "meta":
            return torch.empty(shape, dtype=torch.int32, device="meta")
        return torch.randint(0, cfg.vocab, shape, generator=gen, dtype=torch.int32)

    def embeds(shape):
        if device == "meta":
            return torch.empty(shape, dtype=torch.bfloat16, device="meta")
        return torch.randn(shape, generator=gen).to(torch.bfloat16)

    if mode == "decode":
        state = init_decode_state(cfg, B, S, device=device)
        return make_serve_step(cfg), (params, ints((B, 1)), state)
    batch = {"tokens": ints((B, S)), "labels": ints((B, S))}
    if cfg.kind == "encdec":
        batch["audio_embed"] = embeds((B, cfg.enc_seq, cfg.d_model))
    if cfg.n_patches > 0:
        batch["patch_embeds"] = embeds((B, cfg.n_patches, cfg.d_model))
    if mode == "prefill":
        return make_prefill_step(cfg), (params, batch)
    return make_train_step(cfg, grad_accum=ACCUM), (init_train_state(params), batch)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_flops_on_meta_equal_a_real_run(arch, mode):
    cfg = _deeper(get_config(arch, smoke=True))
    flops = dryrun.step_counts(cfg, lambda c: _args(c, mode, "meta"))[0]["flops"]
    step, args = _args(cfg, mode, "cpu", torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        step(*args)
    assert flops == fc.get_total_flops() > 0


def test_step_flops_counts_what_flop_counter_mode_counts_on_meta():
    """The count's own dispatch mode against ``FlopCounterMode`` at full
    depth on ``meta`` (the flash path's block loop included)."""
    cfg = get_config("yi-9b", smoke=True).scaled(n_layers=2)
    from repro_torch.models import attention

    step, args = _args(cfg, "prefill", "meta")
    old = attention.FLASH_THRESHOLD
    attention.FLASH_THRESHOLD = 16
    try:
        flops = dryrun.count_step(dryrun.StepCount(), step, args)[0]["flops"]
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            step(*args)
    finally:
        attention.FLASH_THRESHOLD = old
    assert flops == fc.get_total_flops() > 0


# ---------------------------------------------------------------------------
# the CUDA environment
# ---------------------------------------------------------------------------


#: settings of the kind ``GPU_PERF_ENV`` may hold, for the merge tests
SAMPLE_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True", "CUDA_DEVICE_MAX_CONNECTIONS": "32"}


def test_merge_env_replaces_same_key_entries_and_keeps_the_rest(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "max_split_size_mb:128,expandable_segments:False")
    monkeypatch.setenv("CUDA_DEVICE_MAX_CONNECTIONS", "1")
    monkeypatch.setenv("REPRO_UNRELATED", "kept")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = cuda_env.merge_env(SAMPLE_ENV)
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == "max_split_size_mb:128,expandable_segments:True"
    assert os.environ["CUDA_DEVICE_MAX_CONNECTIONS"] == "32"
    assert os.environ["REPRO_UNRELATED"] == "kept"
    assert out == {k: os.environ[k] for k in SAMPLE_ENV}
    # merging twice changes nothing
    assert cuda_env.merge_env(SAMPLE_ENV) == out

    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF")
    assert cuda_env.merge_env({"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}) == {
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}


def test_merge_env_warns_once_cuda_is_initialized(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setenv("CUDA_DEVICE_MAX_CONNECTIONS", "8")
    with pytest.warns(RuntimeWarning, match="after CUDA was initialized"):
        cuda_env.merge_env({"CUDA_DEVICE_MAX_CONNECTIONS": "32"})
    assert os.environ["CUDA_DEVICE_MAX_CONNECTIONS"] == "32"


@pytest.mark.parametrize("env", [{}, SAMPLE_ENV], ids=["gpu_perf_env", "sample"])
def test_set_performance_flags_applies_gpu_perf_env(monkeypatch, env):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setattr(cuda_env, "GPU_PERF_ENV", env)
    for k in SAMPLE_ENV:
        monkeypatch.delenv(k, raising=False)
    before = dict(os.environ)
    assert cuda_env.set_performance_flags() == env
    assert dict(os.environ) == {**before, **env}


def test_gpu_env_changes_no_result():
    """No TF32, determinism, sync-debug or blocking-launch switch."""
    switches = {"NVIDIA_TF32_OVERRIDE", "TORCH_ALLOW_TF32_CUBLAS_OVERRIDE", "CUBLAS_WORKSPACE_CONFIG",
                "CUDA_LAUNCH_BLOCKING", "PYTORCH_NO_CUDA_MEMORY_CACHING"}
    assert not switches & set(cuda_env.GPU_PERF_ENV)


# ---------------------------------------------------------------------------
# meshes and the CLI
# ---------------------------------------------------------------------------


def test_production_meshes_and_require_devices():
    single = make_production_mesh(device="meta")
    multi = make_production_mesh(multi_pod=True, device="meta")
    assert dict(single.shape) == {"data": 16, "model": 16} and single.size == 256
    assert dict(multi.shape) == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert list(multi.shape) == list(multi.axis_names)
    assert {d.type for d in multi.devices.flat} == {"meta"}
    require_devices(256, single.devices.flat)
    with pytest.raises(RuntimeError, match="mesh needs 512 devices but only 256"):
        require_devices(512, single.devices.flat)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_production_mesh()
        with pytest.raises(RuntimeError, match="mesh needs 1 devices but only 0"):
            require_devices(1)


def _subprocess_env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in cuda_env.GPU_PERF_ENV:
        env.pop(k, None)
    return env


def test_importing_the_dry_run_changes_no_environment():
    code = (
        "import os, json\n"
        "before = dict(os.environ)\n"
        "import repro_torch.launch.dryrun, repro_torch.launch, repro_torch.dist.sharding\n"
        "print(json.dumps(dict(os.environ) == before))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_subprocess_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "true"


def test_cli_writes_a_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` 's ``main`` with the results
    directory pointed at a temporary one."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import repro_torch.launch.dryrun as d\n"
        "d.RESULTS_DIR = Path(sys.argv[1])\n"
        "d.main(sys.argv[2:])\n"
    )
    args = ["--arch", "qwen3-14b", "--shape", "decode_32k", "--mesh", "single"]
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), *args], env=_subprocess_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert 'DONE {"ok": 1, "skipped": 0, "error": 0}' in out.stdout
    cell = json.loads((tmp_path / "qwen3-14b__decode_32k__single.json").read_text())
    assert cell["status"] == "ok" and cell["n_chips"] == 256
    assert cell["collectives"]["total_per_chip_bytes"] > 0 and cell["notes"]["collectives"]
    assert sum(cell["collectives"]["counts"].values()) > 0
    mem = cell["memory_analysis"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0 and mem["temp_bytes"] > 0
    assert cell["flops_per_chip"] > 0 and cell["bytes_accessed_per_chip"] > 0 and cell["plan_seconds"] >= 0
