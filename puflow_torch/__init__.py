"""PU-Flow in PyTorch for NVIDIA Hopper: the port of `puflow_tpu`.

Module paths and function names mirror `puflow_tpu`, so each function has
a counterpart there. Public functions keep the JAX package's channel-last
layouts and its ``[in, out]`` weight layout. Every Pallas kernel on the
ported path is a hand-written CUDA kernel under `puflow_torch/csrc`, built
with nvcc at first use (`puflow_torch.ops._build`); on CPU tensors each
kernel wrapper runs its plain PyTorch version instead.

Importing this package runs nothing and imports neither jax nor
`puflow_tpu`.
"""

__version__ = "0.1.0"
