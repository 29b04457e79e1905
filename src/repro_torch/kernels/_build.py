"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/*.cu`` is compiled for ``sm_90a`` (one ``nvcc`` per source, all
started together), the objects are linked into one shared library with a
plain C interface, and the library is loaded with ``ctypes``.  The library
name carries a hash of the sources and flags, so an edited source is never
served from a stale build.  The build directory is
``src/repro_torch/kernels/build/`` (listed in ``.gitignore``).

Nothing here runs at import time: :func:`load_library` builds on first use,
so the CPU tests import every module without ``nvcc``.  A failed build
raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

__all__ = ["load_library", "build_info", "persistent_blocks", "NVCC_FLAGS"]

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",  # no contracted multiply-adds: round like the plain versions
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_V = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

#: C signatures of the launchers (every pointer and the stream as c_void_p)
#: and of the queries of their persistent grids
_SIGNATURES = {
    "gather_push_launch": [_V] * 15 + [_I] * 7 + [_F] * 3 + [_V],
    "deposition_launch": [_V] * 11 + [_I] * 7 + [_V],
    "deposition_from_momenta_launch": [_V] * 14 + [_I] * 7 + [_F] * 2 + [_V],
    "gather_push_blocks": [_I, _I, _IP],
    "deposition_blocks": [_I, _I, _IP],
    "deposition_from_momenta_blocks": [_I, _I, _IP],
}

_lib: Optional[ctypes.CDLL] = None
_info: Dict[str, object] = {}
_blocks: Dict[Tuple[str, int, int, int], int] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(lib_path: Path) -> str:
    """Compile every source in parallel, link one library, return the log."""
    nvcc = _nvcc()
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src.name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for name, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernel library failed:\n" + "\n".join(log))
        os.replace(tmp_lib, lib_path)  # atomic: a reader never sees half a file
    return "\n".join(log)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use in this process."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    lib_path = BUILD_DIR / f"libreprotorch_kernels_{_digest()}.so"
    log = ""
    built = not lib_path.exists()
    if built:
        log = _compile(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _info.update(
        path=str(lib_path), built=built, seconds=time.perf_counter() - t0, log=log
    )
    _lib = lib
    return lib


def build_info() -> Dict[str, object]:
    """Path, whether this process compiled it, seconds taken and the
    compiler log (``-Xptxas -v``: registers, shared memory, spills) of the
    library :func:`load_library` returned; empty before the first load."""
    return dict(_info)


def persistent_blocks(kernel: str, bz: int, bx: int, device: int) -> int:
    """Blocks of the persistent grid that ``kernel`` (``"gather_push"``,
    ``"deposition"`` or ``"deposition_from_momenta"``) launches for (bz,
    bx) tiles on CUDA device ``device``, the current one: resident blocks
    per SM times SMs.  Queried once per
    (kernel, tiles, device); the query also sets the kernel's shared-memory
    limit on that device, which its launches need."""
    key = (kernel, int(bz), int(bx), int(device))
    if key not in _blocks:
        blocks = ctypes.c_int(0)
        err = getattr(load_library(), f"{kernel}_blocks")(bz, bx, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"{kernel} occupancy query failed: cudaError {err}")
        _blocks[key] = blocks.value
    return _blocks[key]
