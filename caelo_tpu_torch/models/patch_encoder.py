"""3D voxel-patch descriptor encoder and its auto-encoder (port of
``caelo_tpu/models/patch_encoder.py``).

``PatchEncoder``: 16^3 occupancy patch -> conv(8) -> pool -> conv(16) ->
pool -> conv(32) -> flatten -> dense(200) -> dense(code_dim).  The shipped
reference weights use tanh everywhere (the default); the reference training
recipe gives relu convs and a linear code, selected by the activation names.
``VoxelPatchAE`` adds the decoder that trains it (submodule ``encoder``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

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


class VoxelPatchAE(nn.Module):
    """Full AE for unsupervised training (binary cross-entropy loss,
    ``AE4VoxelPatch.py:198-207``): encoder -> dense 200 -> dense 2048 ->
    4^3 x 32 -> conv / upsample stack -> occupancy logits.

    ``fn4``'s 2048 outputs are read channels-last, as Flax reshapes them to
    ``(N, 4, 4, 4, 32)``, then permuted to NCDHW: ``fn4`` takes the Flax
    kernel's columns unchanged (the mirror of ``PatchEncoder``'s permute
    before ``fn1``).
    """

    def __init__(self, code_dim: int = 20, activation: str = "relu",
                 code_activation: str = "linear"):
        super().__init__()
        self.activation = activation
        self.encoder = PatchEncoder(code_dim, activation, code_activation)
        self.fn3 = nn.Linear(code_dim, 200)
        self.fn4 = nn.Linear(200, 4 * 4 * 4 * 32)
        self.conv2_1 = nn.Conv3d(32, 16, 3, padding=1)
        self.conv2_2 = nn.Conv3d(16, 8, 3, padding=1)
        self.out = nn.Conv3d(8, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(N, 16, 16, 16)`` (or ``(..., 1)``) occupancy -> ``(N, 16, 16,
        16)`` logits, the sigmoid left to the loss."""
        a = _ACTIVATIONS[self.activation]
        h = a(self.fn3(self.encoder(x)))
        h = a(self.fn4(h))
        h = h.reshape(h.shape[0], 4, 4, 4, 32).permute(0, 4, 1, 2, 3)
        h = a(self.conv2_1(h))
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = a(self.conv2_2(h))
        h = F.interpolate(h, scale_factor=2, mode="nearest")
        return self.out(h)[:, 0]


@torch.no_grad()
def describe(encoder, patches3, batch_chunk: int | None = None):
    """The per-scale codes of ``encoder`` concatenated into the 3-scale
    descriptor ``(K, 3 * code_dim)`` (``GetFeaturesFromPatches``,
    ``Match.py:130-135``).

    Args:
      encoder: a ``PatchEncoder`` (or any callable on a patch batch).
      patches3: three ``(K, 16, 16, 16)`` patch tensors.
      batch_chunk: if given, each scale is encoded ``batch_chunk`` patches
        at a time, bounding the conv activations (the JAX function takes
        the argument and encodes each scale in one call).
    """
    def codes(p):
        if not batch_chunk:
            return encoder(p)
        return torch.cat([encoder(c) for c in p.split(batch_chunk)])

    return torch.cat([codes(p) for p in patches3], -1)
