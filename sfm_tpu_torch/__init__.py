"""sfm_tpu_torch — the structure-from-motion pipeline of sfm_tpu, ported to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Images in -> per-image intrinsics, world->camera poses and a sparse point
cloud with tracks out, through the same stages, configs and fixed-capacity
padding contract as the JAX package (which stays the reference). This
package never imports jax or sfm_tpu.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and bundle adjustment are fp32 and tested against fp32 references
# computed at full precision; TF32 products (matmul or cuDNN) keep ~3 decimal
# digits and would break that parity silently.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from sfm_tpu_torch.api import reconstruct  # noqa: E402,F401
