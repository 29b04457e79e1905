"""Kernel work-accounting constants (leaf module).

Properties of the kernels (operations per particle lane / per cell), not
tunable weights: the work-counter cost strategy takes them from the kernel
itself.  Shared by the CUDA kernels, their plain versions and
``pic.deposition.box_work_counters`` so all produce bit-identical counters.
Same values as ``repro.kernels.constants``.
"""

DEPOSIT_TILE = 256  # particle lanes per kernel chunk
DEPOSIT_OPS = 48  # deposition ops per particle lane: 3 components x 16 stencil
PUSH_OPS = 128  # gather (6 comps x 16 stencil = 96) + Boris push (32)
GATHER_PUSH_OPS_PER_PARTICLE = DEPOSIT_OPS + PUSH_OPS  # 176
CELL_OPS = 24  # FDTD update flops per cell (6 components x 4)
