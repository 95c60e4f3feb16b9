"""The spherical-ring auto-encoder and its respond layer (port of
``caelo_tpu/models/respond_net.py``).

``RespondLayer``: Conv2D(32, 3x3, relu, same) -> Conv2D(8, 1x1, relu,
same), NCHW: its output is the 8 channel planes the saliency kernel reads.
``SphericalRingAE`` wraps it (submodule ``respond``) in the unsupervised
auto-encoder that trains it.  Parameter names follow the Flax modules; see
``weights_io.respond_params_to_torch`` and
``weights_io.spherical_ae_params_to_torch``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class RespondLayer(nn.Module):
    """The keypoint-saliency feature extractor (encoder head only)."""

    def __init__(self, features: int = 8, width: int = 32):
        super().__init__()
        self.conv1_1 = nn.Conv2d(3, width, 3, padding=1)
        self.conv1_1_2 = nn.Conv2d(width, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(N, 3, H, W)`` -> ``(N, 8, H, W)`` respond planes."""
        return torch.relu(self.conv1_1_2(torch.relu(self.conv1_1(x))))


class SphericalRingAE(nn.Module):
    """Full auto-encoder for unsupervised training (MSE reconstruction,
    ``AE4SphericalRingPC.py:132-142``): the respond layer, two pool + conv
    encoder stages, and a nearest-upsampling decoder back to the 3-channel
    input.

    Flax's ``max_pool(..., padding="SAME")`` with stride 2 pads an odd side
    with -inf on the far edge; ``ceil_mode=True`` is the same window, so an
    odd side ``s`` pools to ``ceil(s / 2)`` as in the JAX module (and the
    output is then larger than the input, there as here).
    """

    def __init__(self, channels: int = 3):
        super().__init__()
        self.respond = RespondLayer()
        self.conv1_2 = nn.Conv2d(8, 16, 3, padding=1)
        self.conv2_2 = nn.Conv2d(16, 16, 3, padding=1)
        self.conv2_3 = nn.Conv2d(16, 8, 3, padding=1)
        self.out = nn.Conv2d(8, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(N, 3, H, W)`` -> reconstruction ``(N, 3, 4 ceil(H/4), 4
        ceil(W/4))``, NCHW."""
        h = F.max_pool2d(self.respond(x), 2, ceil_mode=True)
        h = torch.relu(self.conv1_2(h))
        h = F.max_pool2d(h, 2, ceil_mode=True)
        h = torch.relu(self.conv2_2(h))
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = torch.relu(self.conv2_3(h))
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        return self.out(h)
