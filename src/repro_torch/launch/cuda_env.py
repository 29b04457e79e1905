"""CUDA environment settings for the port's entry points (counterpart of
``repro.launch.xla``).

The reference tunes ``XLA_FLAGS`` before the jax backend starts; here the
settings are environment variables that PyTorch's caching allocator and
the CUDA driver read when CUDA initializes in the process.  So the helpers
mutate ``os.environ`` only and must run before the first CUDA call
(``chip_smoke.py`` calls :func:`set_performance_flags` first thing).  No
setting may change a result: there is no TF32, determinism or sync-debug
switch here.

The reference's ``force_host_device_count`` has no counterpart: the port's
logical devices are an argument of the mesh constructors
(``repro_torch.launch.mesh``), not a process-wide setting.
"""
from __future__ import annotations

import os
import sys
import warnings
from typing import Dict, Mapping

__all__ = ["GPU_PERF_ENV", "merge_env", "set_performance_flags"]

#: Environment for runs on the card, read at CUDA init.  Empty: a setting
#: goes in only once an A/B on the card shows a gain for it alone.
#: ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` left steady train
#: steps unchanged and made the steps that grow the pool slower;
#: ``CUDA_DEVICE_MAX_CONNECTIONS`` widens the queues between streams, and
#: the port issues its work on the default stream.
GPU_PERF_ENV: Dict[str, str] = {}

#: variables whose value is a comma-separated list of ``key:value`` options
_OPTION_LISTS = ("PYTORCH_CUDA_ALLOC_CONF",)


def _warn_if_cuda_initialized() -> None:
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        warnings.warn(
            "CUDA environment changed after CUDA was initialized; the new settings "
            "will not take effect in this process",
            RuntimeWarning,
            stacklevel=3,
        )


def merge_env(new: Mapping[str, str]) -> Dict[str, str]:
    """Merge ``new`` into ``os.environ``, replacing same-key entries and
    keeping the rest: a variable is set or replaced, except an option list
    (``PYTORCH_CUDA_ALLOC_CONF``), where a same-key option is replaced and
    the other options are kept.  Returns the resulting values."""
    _warn_if_cuda_initialized()
    out = {}
    for var, value in new.items():
        if var in _OPTION_LISTS:
            parts = [p for p in os.environ.get(var, "").split(",") if p]
            for opt in value.split(","):
                key = opt.split(":", 1)[0]
                parts = [p for p in parts if p.split(":", 1)[0] != key]
                parts.append(opt)
            value = ",".join(parts)
        os.environ[var] = value
        out[var] = value
    return out


def set_performance_flags() -> Dict[str, str]:
    """Apply :data:`GPU_PERF_ENV`.  Returns what was set."""
    return merge_env(GPU_PERF_ENV)
