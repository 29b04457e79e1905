"""The port's ``repro_torch.ckpt`` against ``tests/test_checkpoint.py``'s
contract, and against the reference's own files.

The port writes the reference's format (``manifest.json`` with each leaf's
path, steps, dtype and shape; raw bytes in one ``.npz``) from its own
flattening, so a checkpoint written by either package restores in the
other, bit for bit, with or without a template.  The rest are the
counterparts of the reference's tests: template-free restore with int dict
keys, template validation, torn-write fallback, async write-failure
surfacing, retention and its race with concurrent deletes.
"""
import json
import shutil
import threading

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    CorruptCheckpointError,
    available_steps,
    restore_checkpoint,
    save_checkpoint,
)

_ARRAYS = "arrays.npz"


def _runtime_like_tree(step=3):
    """A tree shaped like the runtimes' snapshots: nested dicts, a list of
    per-species dicts, int-keyed mig_cap tables, numpy scalars."""
    rng = np.random.default_rng(step)
    return {
        "tiles": rng.standard_normal((4, 6, 8, 8)).astype(np.float32),
        "species": [
            {k: rng.standard_normal(17).astype(np.float32) for k in ("z", "x", "w")},
            {k: rng.standard_normal(9).astype(np.float32) for k in ("z", "x", "w")},
        ],
        "counts": rng.random(4),
        "t": np.float64(1.5 * step),
        "step_idx": np.int64(step),
        "mapping": np.arange(4, dtype=np.int64),
        "mig_caps": [{0: np.int64(32), 1: np.int64(64)}],
    }


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (bfloat16 tensors and ml_dtypes arrays alike)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (list(a), list(b))
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert np.shape(a) == np.shape(b)
        assert _bits(a) == _bits(b)


# ---------------------------------------------------------------------------
# the port's own contract (counterparts of tests/test_checkpoint.py)
# ---------------------------------------------------------------------------


def test_template_free_restore_rebuilds_runtime_tree(tmp_path):
    tree = _runtime_like_tree()
    save_checkpoint(tmp_path, tree, step=3)
    restored, step = restore_checkpoint(tmp_path, None)
    assert step == 3
    assert isinstance(restored, dict) and isinstance(restored["species"], list)
    assert set(restored["mig_caps"][0].keys()) == {0, 1}  # int, not "0"
    np.testing.assert_array_equal(restored["tiles"], tree["tiles"])
    np.testing.assert_array_equal(restored["species"][1]["w"], tree["species"][1]["w"])
    assert int(restored["step_idx"]) == 3


def test_template_restore_still_validates_structure(tmp_path):
    save_checkpoint(tmp_path, {"a": np.zeros(3)}, step=0)
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path, {"a": np.zeros(3), "b": np.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path, {"a": torch.zeros(4)})
    tree, _ = restore_checkpoint(tmp_path, {"a": np.ones(3)})
    np.testing.assert_array_equal(tree["a"], np.zeros(3))


def _tear(directory, step):
    p = directory / f"step_{step:010d}" / _ARRAYS
    data = p.read_bytes()
    p.write_bytes(data[: len(data) // 2])


def test_corrupt_newest_falls_back_to_valid_step(tmp_path):
    for s in (1, 2, 3):
        save_checkpoint(tmp_path, _runtime_like_tree(s), step=s)
    _tear(tmp_path, 3)
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        tree, step = restore_checkpoint(tmp_path, None)
    assert step == 2
    _assert_trees_equal(tree, _runtime_like_tree(2))


def test_explicitly_requested_corrupt_step_raises(tmp_path):
    save_checkpoint(tmp_path, _runtime_like_tree(1), step=1)
    save_checkpoint(tmp_path, _runtime_like_tree(2), step=2)
    _tear(tmp_path, 2)
    with pytest.raises(CorruptCheckpointError):
        restore_checkpoint(tmp_path, None, step=2)


def test_all_corrupt_raises_file_not_found(tmp_path):
    save_checkpoint(tmp_path, _runtime_like_tree(1), step=1)
    _tear(tmp_path, 1)
    with pytest.warns(UserWarning), pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path, None)


def test_async_saves_land_in_order(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=10)
    for s in range(5):
        mgr.save_async(_runtime_like_tree(s), step=s)
    mgr.wait()
    assert available_steps(tmp_path) == [0, 1, 2, 3, 4]
    tree, step = restore_checkpoint(tmp_path, None)
    assert step == 4 and int(tree["step_idx"]) == 4


def test_async_write_failure_surfaces_at_next_save_and_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    fail_once = {"left": 1}

    def on_write(step):
        if fail_once["left"]:
            fail_once["left"] -= 1
            raise OSError("injected write failure")

    mgr.on_write = on_write
    mgr.save_async(_runtime_like_tree(1), step=1)  # dies in the worker
    with pytest.raises(OSError, match="injected write failure"):
        mgr.save_async(_runtime_like_tree(2), step=2)
    assert available_steps(tmp_path) == []  # neither write landed
    mgr.wait()  # error already consumed
    mgr.save(_runtime_like_tree(2), step=2)  # the retry lands
    assert mgr.latest_step() == 2


def test_async_write_failure_surfaces_at_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.on_write = lambda step: (_ for _ in ()).throw(OSError("boom"))
    mgr.save_async(_runtime_like_tree(1), step=1)
    with pytest.raises(OSError, match="boom"):
        mgr.wait()


def test_keep_gc_retains_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in range(5):
        mgr.save(_runtime_like_tree(s), step=s)
    assert available_steps(tmp_path) == [3, 4]


def test_gc_tolerates_concurrent_deletes(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1)
    for s in range(4):
        save_checkpoint(tmp_path, {"a": np.zeros(2)}, step=s)
    stop = threading.Event()

    def cleaner():
        while not stop.is_set():
            for s in range(4):
                shutil.rmtree(tmp_path / f"step_{s:010d}", ignore_errors=True)

    t = threading.Thread(target=cleaner)
    t.start()
    try:
        for s in range(4, 30):
            mgr.save({"a": np.zeros(2)}, step=s)
    finally:
        stop.set()
        t.join()
    assert mgr.latest_step() == 29


def test_manager_restore_runtime_tree_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save_async(_runtime_like_tree(7), step=7)
    tree, step = mgr.restore(None)
    assert step == 7
    _assert_trees_equal(tree, _runtime_like_tree(7))


def test_tensor_leaves_namedtuples_and_bfloat16(tmp_path):
    """Tensors are written from host copies (save_async's cut is taken at
    the call: a later in-place update does not reach the file), NamedTuples
    restore through a template, bfloat16 comes back as bfloat16."""
    from repro_torch.pic import Particles

    p = Particles(*(torch.arange(4, dtype=torch.float32) + i for i in range(6)),
                  torch.ones(4, dtype=torch.bool), torch.tensor(-1.0), torch.tensor(1.0))
    tree = {"p": p, "h": torch.linspace(-2, 2, 5).to(torch.bfloat16), "none": None}
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(tree, step=1)
    p.z.add_(100.0)
    with pytest.raises(ValueError, match="NamedTuple"):
        mgr.restore(None)
    got, _ = mgr.restore(tree)
    assert isinstance(got["p"], Particles) and got["none"] is None
    np.testing.assert_array_equal(got["p"].z, np.arange(4, dtype=np.float32))
    assert got["h"].dtype == torch.bfloat16 and torch.equal(got["h"], tree["h"])


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _manifest(directory, step):
    m = json.loads((directory / f"step_{step:010d}" / "manifest.json").read_text())
    return [(e["path"], e["steps"], e["dtype"], e["shape"]) for e in m["leaves"]]


def _mixed_tree(step, bf16):
    tree = _runtime_like_tree(step)
    tree["half"] = bf16(np.linspace(-3, 3, 7, dtype=np.float32))
    tree["flag"] = np.bool_(True)
    return tree


def test_reference_writes_port_restores_bit_for_bit(tmp_path):
    import jax.numpy as jnp

    from repro.ckpt import save_checkpoint as ref_save

    tree = _mixed_tree(5, lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)))
    ref_save(tmp_path / "ref", tree, step=5)
    save_checkpoint(tmp_path / "port", tree, step=5)
    assert _manifest(tmp_path / "ref", 5) == _manifest(tmp_path / "port", 5)
    for template in (None, tree):
        got, step = restore_checkpoint(tmp_path / "ref", template)
        assert step == 5
        _assert_trees_equal(got, tree)


def test_port_writes_reference_restores_bit_for_bit(tmp_path):
    from repro.ckpt import restore_checkpoint as ref_restore

    tree = _mixed_tree(6, lambda a: torch.from_numpy(a).to(torch.bfloat16))
    save_checkpoint(tmp_path, tree, step=6)
    for template in (None, _mixed_tree(6, lambda a: np.zeros(7, np.float32))):
        got, step = ref_restore(tmp_path, template)
        assert step == 6
        assert str(got["half"].dtype) == "bfloat16"
        _assert_trees_equal(got, tree)


def test_sharded_snapshot_crosses_packages_bit_for_bit(tmp_path):
    """A real snapshot of the port's ShardedRuntime, written by the port,
    read by the reference, written again by it and read by the port,
    comes back bit for bit."""
    from repro.ckpt import restore_checkpoint as ref_restore
    from repro.ckpt import save_checkpoint as ref_save
    from repro_torch.dist import ShardedRuntime
    from repro_torch.pic import laser_ion_problem

    rt = ShardedRuntime(laser_ion_problem(nz=32, nx=32, box_cells=8, ppc=2, device="cpu"), 2,
                        lb_interval=2, device="cpu", pipeline="async")
    rt.run(4)
    snap = rt.snapshot()
    save_checkpoint(tmp_path / "a", snap, step=4)
    ref_tree, _ = ref_restore(tmp_path / "a", None)
    ref_save(tmp_path / "b", ref_tree, step=4)
    got, _ = restore_checkpoint(tmp_path / "b", None)
    _assert_trees_equal(got, snap)


def test_box_snapshot_crosses_packages_bit_for_bit(tmp_path):
    """The same round trip for a snapshot of the port's BoxRuntime."""
    from repro.ckpt import restore_checkpoint as ref_restore
    from repro.ckpt import save_checkpoint as ref_save
    from repro_torch.dist import BoxRuntime
    from repro_torch.pic import laser_ion_problem

    rt = BoxRuntime(laser_ion_problem(nz=32, nx=32, box_cells=8, ppc=2, device="cpu"), 2,
                    lb_interval=2, device="cpu", pipeline="async")
    rt.run(4)
    snap = rt.snapshot()
    save_checkpoint(tmp_path / "a", snap, step=4)
    ref_tree, _ = ref_restore(tmp_path / "a", None)
    ref_save(tmp_path / "b", ref_tree, step=4)
    got, _ = restore_checkpoint(tmp_path / "b", None)
    _assert_trees_equal(got, snap)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_box_checkpoint_restores_in_the_other_package(writer, tmp_path):
    """A BoxRuntime checkpoint written by one package, restored into the
    other's BoxRuntime, goes on with the writer's physics: fields within
    1e-5·max, the same census per box."""
    from repro.ckpt import restore_checkpoint as ref_restore
    from repro.ckpt import save_checkpoint as ref_save
    from repro.dist import BoxRuntime as JBox
    from repro.pic import laser_ion_problem as j_laser_ion
    from repro_torch.dist import BoxRuntime as TBox
    from repro_torch.pic import laser_ion_problem

    kw = dict(nz=32, nx=32, box_cells=8, ppc=2)
    make = {
        "reference": lambda: JBox(j_laser_ion(**kw), n_devices=1, lb_interval=2),
        "port": lambda: TBox(laser_ion_problem(**kw, device="cpu"), 1, lb_interval=2, device="cpu"),
    }
    save = {"reference": ref_save, "port": save_checkpoint}
    load = {"reference": ref_restore, "port": restore_checkpoint}
    reader = "port" if writer == "reference" else "reference"
    src = make[writer]()
    src.run(4)
    save[writer](tmp_path, src.snapshot(), step=4)
    tree, step = load[reader](tmp_path, None)
    dst = make[reader]()
    dst.restore(tree)
    assert step == 4 and dst.step_idx == 4
    src.run(4)
    dst.run(4)
    f_src = np.stack([np.asarray(c) for c in src.fields])
    f_dst = np.stack([np.asarray(c) for c in dst.fields])
    assert np.abs(f_dst - f_src).max() <= 1e-5 * max(np.abs(f_src).max(), 1e-30)
    np.testing.assert_array_equal(np.asarray(dst.box_counts()), np.asarray(src.box_counts()))
