"""Geometry ops and the model's kernels.

Each hand-written CUDA kernel (`csrc/`) sits in the module of its plain
PyTorch version: `ops.fps` (farthest point sampling), `ops.knn` (the
self k-NN of a patch), `ops.encoder` (the condition encoder), `ops.interp`
(the interpolation head) and `ops.flow` (the forward flow, the inverse
flow, and the latent blend plus inverse flow). A wrapper launches its
kernel for a CUDA tensor and runs the plain version for a CPU tensor.
The serving paths' kernels do so through `torch.library` ops
(``torch.ops.puflow.*``, registered in the same modules), which
`torch.export` keeps as one node a launch (`puflow_torch.serving`).
"""
