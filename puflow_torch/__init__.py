"""PU-Flow in PyTorch for NVIDIA Hopper: the port of `puflow_tpu`.

Module paths and function names mirror `puflow_tpu`, so each function has
a counterpart there. Public functions keep the JAX package's channel-last
layouts and its ``[in, out]`` weight layout. Every Pallas kernel on the
ported path is a hand-written CUDA kernel under `puflow_torch/csrc`, built
with nvcc at first use (`puflow_torch.ops._build`); on CPU tensors each
kernel wrapper runs its plain PyTorch version instead.

Importing this package pins the float32 precision policy (below) and
imports neither jax nor `puflow_tpu`.
"""

import torch as _torch

# Precision policy: float32 matmuls and convolutions are exact float32,
# never TF32, as `puflow_tpu/__init__.py:14-18` pins
# jax_default_matmul_precision to "highest": flow invertibility and the
# log-dets depend on it. The hand-written kernels do not read these.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
