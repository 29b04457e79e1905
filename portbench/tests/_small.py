"""The small size the CPU tests run every cell at: 64² cells in 16² boxes,
2 particles per cell, 20-step stretches."""
CONFIG = dict(nz=64, nx=64, box_cells=16, ppc=2)
TRAFFIC = dict(stretch_intervals=2)
SEED = 2**31 + 12345
