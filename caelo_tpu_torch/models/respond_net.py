"""The respond layer of the spherical-ring auto-encoder (port of
``caelo_tpu/models/respond_net.py::RespondLayer``).

Conv2D(32, 3x3, relu, same) -> Conv2D(8, 1x1, relu, same), NCHW: its
output is the 8 channel planes the saliency kernel reads.  Parameter names
follow the Flax module (``conv1_1``, ``conv1_1_2``); see
``weights_io.respond_params_to_torch``.
"""
from __future__ import annotations

import torch
from torch import nn


class RespondLayer(nn.Module):
    """The keypoint-saliency feature extractor (encoder head only)."""

    def __init__(self, features: int = 8, width: int = 32):
        super().__init__()
        self.conv1_1 = nn.Conv2d(3, width, 3, padding=1)
        self.conv1_1_2 = nn.Conv2d(width, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(N, 3, H, W)`` -> ``(N, 8, H, W)`` respond planes."""
        return torch.relu(self.conv1_1_2(torch.relu(self.conv1_1(x))))
