"""The PIC kernels of the port: current deposition and fused gather + push +
move, hand-written in CUDA for Hopper (``csrc/``), each beside a plain
PyTorch version of the same contract.

``ops`` holds the binned layout and the per-species substep that drives
both kernels; ``_build`` compiles ``csrc/*.cu`` with ``nvcc`` at first use.
"""
from . import constants

__all__ = ["constants"]
