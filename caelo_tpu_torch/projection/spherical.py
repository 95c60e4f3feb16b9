"""Spherical-ring projection as one scatter (port of
``caelo_tpu/projection/spherical.py:27-106``).

Cell-collision rule as in the JAX package: the nearest point by 1/64 m
quantized range wins, the lowest point index breaking ties inside a bucket,
elected by ONE scatter-min of a packed (quantized range, index) int32 key.
"""
from __future__ import annotations

import math

import torch

from ..config import SensorConfig

_INT32_MAX = 2 ** 31 - 1


def project_to_spherical_ring(pts: torch.Tensor, mask: torch.Tensor,
                              cfg: SensorConfig = SensorConfig()):
    """Project a padded scan into the (ImgH, ImgW, 5) spherical-ring image.

    Args:
      pts: ``(N, 4)`` float32 -- x, y, z, reflectance; padded.
      mask: ``(N,)`` bool -- validity of each point.

    Returns:
      image: ``(ImgH, ImgW, 5)`` float32 -- x, y, z, reflectance, range.
      counter: ``(ImgH, ImgW)`` int32 -- points per cell.
    """
    H, W = cfg.img_h, cfg.img_w
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r = torch.sqrt(x * x + y * y + z * z)
    valid = mask & (r > 0)
    rsafe = torch.where(valid, r, 1.0)

    col = torch.floor((math.pi - torch.atan2(y, x)) / cfg.azimuth_res
                      ).to(torch.int32)
    beta = torch.arcsin(torch.clamp(z / rsafe, -1.0, 1.0))
    row = H - torch.floor(beta / cfg.vertical_res + cfg.vertical_pixel_offset
                          ).to(torch.int32)
    col = torch.clamp(col, 0, W - 1)
    inb = valid & (row >= 0) & (row < H)
    flat = torch.where(inb, row * W + col, H * W).long()   # H*W = trash slot

    # winner election: one scatter-min of (quantized range << idx_bits | idx)
    n = pts.shape[0]
    idx_bits = max(n - 1, 1).bit_length()
    rq = torch.clamp_max((r * 64.0).to(torch.int32), (1 << (30 - idx_bits)) - 1)
    idx = torch.arange(n, dtype=torch.int32, device=pts.device)
    packed = torch.where(inb, (rq << idx_bits) | idx, _INT32_MAX)
    best = torch.full((H * W + 1,), _INT32_MAX, dtype=torch.int32,
                      device=pts.device)
    best.scatter_reduce_(0, flat, packed, "amin")
    win = best[:H * W]
    occupied = win != _INT32_MAX
    winner = torch.where(occupied, win & ((1 << idx_bits) - 1), 0).long()
    g = pts[winner, :4]
    # the range channel is recomputed from the winner's own x, y, z with the
    # same expression that produced ``r``
    rw = torch.sqrt(g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2])
    image = torch.where(occupied[:, None], torch.cat([g, rw[:, None]], 1), 0.0)
    image = image.reshape(H, W, 5)

    counter = torch.zeros(H * W + 1, dtype=torch.int32, device=pts.device)
    counter.scatter_add_(0, flat, inb.to(torch.int32))
    return image, counter[:H * W].reshape(H, W)


def model_input(image: torch.Tensor, cfg: SensorConfig = SensorConfig()):
    """Crop the ring image to the respond-net input window: rows
    [0, n_lines), cols [0, img_w - crop), channels x, y, z."""
    return image[:cfg.n_lines, :cfg.model_w, 0:3]
