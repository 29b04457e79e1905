"""Checkpoint/restart for nested state of numpy arrays, torch tensors and
scalars (counterpart of ``repro.ckpt.checkpoint``, same on-disk format).

  * atomic: written to a temp dir, fsynced, then ``os.replace``d, so a crash
    never leaves a half-written checkpoint visible;
  * manifest-driven: ``manifest.json`` records each leaf's tree path, dtype
    and shape; the leaves' raw bytes go into one ``.npz``;
  * retention: :class:`CheckpointManager` keeps the newest ``keep``;
  * async: ``save_async`` copies the state to the host at the call (the
    consistent cut) and writes on a thread; a failure there is re-raised at
    the next ``save``/``save_async``/``wait``, never swallowed;
  * torn-write tolerant: ``restore_checkpoint(step=None)`` skips a truncated
    or corrupt newest checkpoint with a warning and loads the newest valid
    one;
  * template-free: the manifest's structured path steps rebuild a dict/list
    tree without a template, which is what a recovery restore needs.

The tree is flattened here, without ``jax.tree_util``, in its order: dict
keys sorted, sequences and NamedTuple fields in order, ``None`` holding no
leaf.  Paths are written as its key strings (``['species'][0]['z']``,
``.field``), so the reference restores the port's checkpoints with or
without a template, and the other way round, bit for bit.  Tensors are
written from host copies; bfloat16 goes through torch's ``uint16`` view
(numpy has no bfloat16 without ``ml_dtypes``) and comes back as a bfloat16
tensor.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import map_tensors

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "available_steps",
    "CheckpointManager",
    "CorruptCheckpointError",
]

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


class CorruptCheckpointError(RuntimeError):
    """A checkpoint's bytes are unreadable (torn write, truncated container,
    unparseable manifest).  A template or shape mismatch is a ``ValueError``
    instead: only corruption falls back to an older step."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in the reference's flatten order; a path is a
    tuple of ``("k", key)``, ``("i", index)`` or ``("a", field)`` hops."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], path + (("k", k),))
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += _flatten(getattr(tree, name), path + (("a", name),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, path + (("i", i),))
        return out
    return [(path, tree)]


def _keystr(path: Tuple) -> str:
    """The reference's key string of a path."""
    parts = []
    for kind, key in path:
        parts.append(f".{key}" if kind == "a" else f"[{key!r}]")
    return "".join(parts)


def _path_steps(path: Tuple) -> Optional[List[Dict]]:
    """JSON-able steps (``{"k": key}``, ``{"i": index}``), or ``None`` for a
    path through a NamedTuple (restorable with a template only)."""
    steps: List[Dict] = []
    for kind, key in path:
        if kind == "k":
            if not isinstance(key, (str, int, bool)):
                return None
            steps.append({"k": key})
        elif kind == "i":
            steps.append({"i": int(key)})
        else:
            return None
    return steps


def _unflatten(template, leaves: List) -> Any:
    """Rebuild ``template``'s structure around ``leaves`` (flatten order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            rebuilt = {k: build(t[k]) for k in sorted(t)}
            return {k: rebuilt[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def _tree_from_paths(entries: List[Dict], leaves: List) -> Any:
    """Rebuild a nested dict/list tree from per-leaf path steps (tuples come
    back as lists)."""
    if any(e.get("steps") is None for e in entries):
        raise ValueError("checkpoint contains NamedTuple nodes; pass tree_like to restore")
    if len(entries) == 1 and not entries[0]["steps"]:
        return leaves[0]
    root: Any = {} if "k" in entries[0]["steps"][0] else []
    for entry, leaf in zip(entries, leaves):
        node = root
        steps = entry["steps"]
        for j, s in enumerate(steps):
            last = j == len(steps) - 1
            child = leaf if last else ({} if "k" in steps[j + 1] else [])
            if "k" in s:
                if last:
                    node[s["k"]] = leaf
                else:
                    node = node.setdefault(s["k"], child)
            else:
                # flatten order fills sequences left to right
                if s["i"] == len(node):
                    node.append(child)
                elif last:
                    node[s["i"]] = leaf
                if not last:
                    node = node[s["i"]]
    return root


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array plus its manifest dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_bytes(raw: np.ndarray, dtype: str, shape) -> Any:
    if dtype == "bfloat16":  # numpy cannot hold it: a torch tensor, via uint16
        a = np.frombuffer(raw.tobytes(), dtype=np.uint16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return np.frombuffer(raw.tobytes(), dtype=np.dtype(dtype)).reshape(shape)


def save_checkpoint(directory: os.PathLike, tree, step: int, extra: Optional[Dict] = None) -> Path:
    """Atomically write one checkpoint; returns its final path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:010d}"
    flat = _flatten(tree)
    host = [_to_host(leaf) for _, leaf in flat]
    arrays = {f"leaf_{i}": np.frombuffer(a.tobytes(), np.uint8) for i, (a, _) in enumerate(host)}
    manifest = {
        "step": step,
        "time": time.time(),
        "extra": extra or {},
        "leaves": [
            {
                "key": f"leaf_{i}",
                "path": _keystr(path),
                "steps": _path_steps(path),
                "dtype": dtype,
                "shape": list(a.shape),
            }
            for i, ((path, _), (a, dtype)) in enumerate(zip(flat, host))
        ],
    }
    tmp = Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_"))
    try:
        with open(tmp / _ARRAYS, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        with open(tmp / _MANIFEST, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _load_step(path: Path, tree_like):
    """Load one checkpoint directory.  Unreadable bytes raise
    :class:`CorruptCheckpointError`; template mismatches ``ValueError``."""
    try:
        manifest = json.loads((path / _MANIFEST).read_text())
        with np.load(path / _ARRAYS) as data:
            leaves = [
                _from_bytes(data[e["key"]], e["dtype"], e["shape"]) for e in manifest["leaves"]
            ]
    except Exception as e:
        raise CorruptCheckpointError(f"{path.name}: {type(e).__name__}: {e}") from e
    if tree_like is None:
        return _tree_from_paths(manifest["leaves"], leaves), manifest["step"]
    flat = _flatten(tree_like)
    if len(flat) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves but target tree has {len(flat)}")
    for (path, target), loaded, entry in zip(flat, leaves, manifest["leaves"]):
        name = _keystr(path)
        if entry["path"] != name:
            raise ValueError(f"leaf order mismatch: {entry['path']} vs {name}")
        want = tuple(target.shape) if hasattr(target, "shape") else np.shape(target)
        if tuple(loaded.shape) != tuple(want):
            raise ValueError(f"shape mismatch at {name}: {tuple(loaded.shape)} vs {tuple(want)}")
    return _unflatten(tree_like, leaves), manifest["step"]


def restore_checkpoint(directory: os.PathLike, tree_like=None, step: Optional[int] = None):
    """Restore a checkpoint; returns ``(tree, step)``.

    With ``tree_like`` the stored leaves are checked against the template's
    paths and shapes and put into its structure; with ``None`` the tree is
    rebuilt from the manifest (dicts and lists).  Leaves come back as numpy
    arrays (bfloat16 as torch tensors).  With ``step=None`` the newest valid
    checkpoint is loaded, corrupt ones skipped with a warning; an explicit
    ``step`` raises its corruption error.
    """
    directory = Path(directory)
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    if step is not None:
        if step not in steps:
            raise FileNotFoundError(f"no checkpoint for step {step} under {directory}")
        return _load_step(directory / f"step_{step:010d}", tree_like)
    last_err: Optional[BaseException] = None
    for cand in reversed(steps):
        try:
            return _load_step(directory / f"step_{cand:010d}", tree_like)
        except CorruptCheckpointError as e:  # torn: fall back to an older step
            last_err = e
            warnings.warn(f"skipping corrupt checkpoint: {e}")
    raise FileNotFoundError(
        f"no valid checkpoint under {directory} ({len(steps)} corrupt)"
    ) from last_err


def available_steps(directory: os.PathLike) -> List[int]:
    """Sorted step numbers of the complete checkpoints under ``directory``
    (tolerates concurrent deletion and stray entries)."""
    directory = Path(directory)
    out = []
    try:
        entries = list(directory.iterdir())
    except FileNotFoundError:
        return []
    for p in entries:
        if not p.name.startswith("step_"):
            continue
        try:
            step = int(p.name.split("_", 1)[1])
        except ValueError:
            continue
        if (p / _MANIFEST).exists():
            out.append(step)
    return sorted(out)


class CheckpointManager:
    """Retention and async save over :func:`save_checkpoint`.

    ``on_write`` (optional) is called with the step inside the writer just
    before each write, a telemetry and fault-injection seam: what it raises
    takes the path of a real I/O failure (``save`` propagates it,
    ``save_async`` records it and re-raises at the next
    ``save``/``save_async``/``wait``).
    """

    def __init__(
        self,
        directory: os.PathLike,
        keep: int = 3,
        *,
        on_write: Optional[Callable[[int], None]] = None,
    ):
        self.directory = Path(directory)
        self.keep = keep
        self.on_write = on_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, tree, step: int, extra: Optional[Dict] = None) -> Path:
        """Synchronous write plus retention; surfaces a previous
        ``save_async`` failure first."""
        self.wait()
        if self.on_write is not None:
            self.on_write(step)
        path = save_checkpoint(self.directory, tree, step, extra)
        self._gc()
        return path

    def save_async(self, tree, step: int, extra: Optional[Dict] = None) -> None:
        """Copy tensors to the host now (the consistent cut) and write on a
        thread; joins the previous write first, re-raising its failure."""
        self.wait()  # one outstanding write at a time
        snapshot = map_tensors(lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            try:
                if self.on_write is not None:
                    self.on_write(step)
                save_checkpoint(self.directory, snapshot, step, extra)
                self._gc()
            except BaseException as e:  # surfaced on the next save/save_async/wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the async write in flight; re-raise its failure if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, tree_like=None, step: Optional[int] = None):
        """:func:`restore_checkpoint` after draining any async write; a
        recorded write failure becomes a warning, so it cannot block a
        recovery restore."""
        try:
            self.wait()
        except Exception as e:
            warnings.warn(f"pending async checkpoint write had failed: {e}")
        return restore_checkpoint(self.directory, tree_like, step)

    def latest_step(self) -> Optional[int]:
        """Newest complete step, or ``None``."""
        steps = available_steps(self.directory)
        return steps[-1] if steps else None

    def _gc(self) -> None:
        steps = available_steps(self.directory)
        if self.keep <= 0:
            return
        for old in steps[: -self.keep]:
            # best effort: a racing GC may have deleted it already
            shutil.rmtree(self.directory / f"step_{old:010d}", ignore_errors=True)
