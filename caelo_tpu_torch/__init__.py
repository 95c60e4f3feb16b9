"""PyTorch + CUDA port of caelo_tpu's front-end odometry window.

The JAX package ``caelo_tpu`` is the reference and stays as it is; this
package mirrors its module paths and function names (``caelo_tpu.X.Y`` ->
``caelo_tpu_torch.X.Y``) for the main path: spherical-ring projection,
respond net, saliency NMS, voxel pyramid, bit-table patch query, patch
encoder, matching, RANSAC, the motion-prior retry and the windowed odometry
loop.  The two TPU kernels of that path are hand-written CUDA for Hopper
(``csrc/``), each with a plain-PyTorch twin that CPU tensors use.

It imports ``torch`` and never ``jax``; host-only modules of ``caelo_tpu``
whose import chain is free of JAX (``config``, ``data.synthetic``,
``models.weights_io``) are imported, not copied.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def setup_device(device) -> torch.device:
    """Return ``torch.device(device)`` with float32 convs and matmuls set to
    full float32.  cuDNN runs float32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), which keeps ~3 decimal
    digits and would break parity with the JAX reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device(device)
