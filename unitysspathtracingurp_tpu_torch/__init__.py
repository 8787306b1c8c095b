"""PyTorch + CUDA port of the screen-space path tracer.

The counterpart of ``unitysspathtracingurp_tpu`` (the JAX package, kept
as the reference), module for module. Plain tensor code is PyTorch; the
marches' hot loops (the hiz march's front half and resolve rounds, the
parity march) are hand-written CUDA kernels for Hopper (``csrc/``,
built by ``kernels/build.py``), each with a plain PyTorch version
beside its wrapper that CPU tensors run.

Conventions are the JAX package's (see camera.py): reversed-Z raw depth
in [0, 1] with 0.0 = sky, uv with v up, arrays (H, W[, C]) with row 0
at the bottom. Everything is f32; TF32 is off, because a reduced
precision product moves projected texels.

This package never imports JAX.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
