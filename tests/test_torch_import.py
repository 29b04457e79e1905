"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``.

Checked two ways: every submodule imports in a fresh interpreter with
``jax`` blocked, and an AST scan finds no such import statement anywhere in
the port's sources or the smoke script.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 20  # every module of the slices was imported
    for module in ("ckpt.checkpoint", "dist.faults", "dist.elastic", "dist.recovery",
                   "dist.sharded_runtime", "dist.box_runtime", "core.perfmodel",
                   "pic.sharded", "pic.engine", "models.common", "models.moe",
                   "configs", "configs.llama4_scout_17b_a16e", "serve.traffic",
                   "serve.expert_runtime", "train.servestep", "kernels.ref",
                   "models.attention", "models.ssm", "models.rglru", "models.transformer",
                   "configs.shapes", "train.optimizer", "train.trainstep", "data",
                   "data.pipeline", "dist.sharding", "launch.mesh", "launch.cuda_env",
                   "launch.dryrun"):
        assert f"repro_torch.{module}" in names, module


def test_lm_serving_entry_points_are_exported():
    """The LM serving path: the models package's entry points and the
    serve-step factories beside ``RequestBalancer``."""
    import repro_torch.models as models
    from repro_torch.train import servestep

    for name in ("init_params", "forward_train", "prefill", "decode_step", "init_decode_state"):
        assert callable(getattr(models, name)), name
    for name in ("make_serve_step", "make_prefill_step", "RequestBalancer"):
        assert name in servestep.__all__ and callable(getattr(servestep, name)), name


def test_training_entry_points_are_exported():
    """The training path: ``loss_fn``, the optimizer, the train step and
    the data pipeline, under the reference's names."""
    import repro_torch.data as data
    import repro_torch.models as models
    from repro_torch.train import optimizer, trainstep

    assert "loss_fn" in models.__all__ and callable(models.loss_fn)
    assert data.__all__ == ["SyntheticLMData"]
    for name in ("AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
                 "quantize_int8", "dequantize_int8", "compress_decompress"):
        assert name in optimizer.__all__ and callable(getattr(optimizer, name)), name
    for name in ("TrainState", "init_train_state", "make_train_step"):
        assert name in trainstep.__all__ and callable(getattr(trainstep, name)), name


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"
