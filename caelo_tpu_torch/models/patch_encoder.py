"""3D voxel-patch descriptor encoder (port of
``caelo_tpu/models/patch_encoder.py::PatchEncoder``).

16^3 occupancy patch -> conv(8) -> pool -> conv(16) -> pool -> conv(32) ->
flatten -> dense(200) -> dense(code_dim).  The shipped reference weights use
tanh everywhere (the default); the reference training recipe gives relu
convs and a linear code, selected by the activation names.
"""
from __future__ import annotations

import torch
from torch import nn

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "linear": lambda x: x,
    "sigmoid": torch.sigmoid,
}


class PatchEncoder(nn.Module):
    """16^3 occupancy patch -> ``code_dim`` descriptor."""

    def __init__(self, code_dim: int = 20, activation: str = "tanh",
                 code_activation: str = "tanh"):
        super().__init__()
        self.activation = activation
        self.code_activation = code_activation
        self.conv1 = nn.Conv3d(1, 8, 3, padding=1)
        self.conv2 = nn.Conv3d(8, 16, 3, padding=1)
        self.conv3 = nn.Conv3d(16, 32, 3, padding=1)
        self.fn1 = nn.Linear(32 * 4 * 4 * 4, 200)      # 16^3 pooled twice
        self.fn2 = nn.Linear(200, code_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(N, D, H, W)`` or ``(N, D, H, W, 1)`` occupancy, channels-last as
        in the JAX package -> ``(N, code_dim)``."""
        if x.dim() == 5:
            x = x[..., 0]
        a = _ACTIVATIONS[self.activation]
        h = a(self.conv1(x[:, None]))
        h = nn.functional.max_pool3d(h, 2)
        h = a(self.conv2(h))
        h = nn.functional.max_pool3d(h, 2)
        h = a(self.conv3(h))
        # Flax flattens channels-last (C-order over D, H, W, C): permute the
        # activations to NDHWC so fn1 takes the Flax weight rows unchanged
        h = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)
        h = a(self.fn1(h))
        return _ACTIVATIONS[self.code_activation](self.fn2(h))
