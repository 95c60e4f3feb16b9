"""PyTorch + CUDA port of caelo_tpu's odometry pipeline.

The JAX package ``caelo_tpu`` is the reference and stays as it is; this
package mirrors its module paths and function names (``caelo_tpu.X.Y`` ->
``caelo_tpu_torch.X.Y``) for ``run_full_pipeline``: spherical-ring
projection, respond net, saliency NMS, voxel pyramid, bit-table patch query,
patch encoder, matching, RANSAC, the windowed odometry loop, de-jump, ICP
refinement, burst rescue, loop closure and the pose graph.  The two TPU
kernels of that path are hand-written CUDA for Hopper (``csrc/``), each with
a plain-PyTorch twin that CPU tensors use.

It imports ``torch`` and nothing of ``jax`` or ``caelo_tpu``: the host-only
modules it shares with the JAX package (``config``, ``data.synthetic``,
``data.hard_synthetic``, ``data.artifacts``, ``backend.refine``,
``utils.telemetry``, the ``.h5`` readers of ``models.weights_io``) are the
port's own copies, held to the JAX ones by ``tests/test_torch_imports.py``.
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
