"""A frozen copy of the port's plain path: the benchmark's reference.

Copied from ``unitysspathtracingurp_tpu_torch`` at the commit that
defined the benchmark, cut to what the benchmark's configurations run
(the hiz march on plain and, for refraction and back faces, dual-layer
depth tiles, the hashed RNG, offline and real-time accumulation,
À-Trous, reprojection, the probes) and without
``kernels/`` and ``csrc/``: each kernel's entry here runs its plain
PyTorch version on every device. Later changes to the port do not move
this copy, so the benchmark's comparison and inputs stay fixed. The
benchmark's tests hold it against the JAX package, which shares none of
its code, and against the port's plain path.

It imports nothing of the port and nothing of JAX. Everything is f32;
TF32 is off, because a reduced precision product moves projected
texels.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
