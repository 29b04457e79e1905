"""PyTorch/CUDA port of the in-situ work-assessment + dynamic load balancing
PIC system (arXiv 2104.11385).

Mirrors ``repro``'s module layout (``pic``, ``kernels``, ``core``) on torch
tensors.  The two PIC kernels are hand-written CUDA for Hopper
(``kernels/csrc``), built with ``nvcc`` at first use; on CPU tensors their
plain PyTorch versions run instead.  Entry points default to
``device="cuda"``.
"""
from ._device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "resolve_device"]
