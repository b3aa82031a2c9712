"""Geometry ops and the flow kernels.

Each hand-written CUDA kernel (`csrc/`) sits in the module of its plain
PyTorch version: `ops.fps` (farthest point sampling) and `ops.flow` (the
forward and inverse flow chains). A wrapper launches its kernel for a
CUDA tensor and runs the plain version for a CPU tensor.
"""
