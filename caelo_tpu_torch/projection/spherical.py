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
from ..xlamath import (asin_base, atan2, fma32, mul_reciprocal,
                       mul_reciprocal_add, sqrt32)

_INT32_MAX = 2 ** 31 - 1


def ring_bins(pts: torch.Tensor, mask: torch.Tensor,
              cfg: SensorConfig = SensorConfig()):
    """Each point's cell of the spherical-ring image: ``(range, row, col,
    in_bounds)``, ``row`` and ``col`` int32 (``col`` clamped to the
    image)."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    # JAX's x * x + y * y + z * z, contracted by XLA's CPU into fused
    # multiply-adds
    r = sqrt32(fma32(z, z, fma32(x, x, y * y)))
    valid = mask & (r > 0)
    rsafe = torch.where(valid, r, 1.0)
    # the column's atan2 and the elevation's asin(u) = 2 atan2(u, base)
    # in one call
    u = torch.clamp(z / rsafe, -1.0, 1.0)
    ang = atan2(torch.cat([y, u]), torch.cat([x, asin_base(u)]))
    col = torch.floor(mul_reciprocal(math.pi - ang[:len(u)],
                                     cfg.azimuth_res)).to(torch.int32)
    beta = ang[len(u):] + ang[len(u):]
    row = cfg.img_h - torch.floor(mul_reciprocal_add(
        beta, cfg.vertical_res, cfg.vertical_pixel_offset)).to(torch.int32)
    col = torch.clamp(col, 0, cfg.img_w - 1)
    return r, row, col, valid & (row >= 0) & (row < cfg.img_h)


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
    r, row, col, inb = ring_bins(pts, mask, cfg)
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
    # the range channel is recomputed from the winner's own x, y, z; JAX
    # sums the three as a reduction, which contracts in another order
    gx, gy, gz = g[:, 0], g[:, 1], g[:, 2]
    rw = sqrt32(fma32(gz, gz, fma32(gy, gy, gx * gx)))
    image = torch.where(occupied[:, None], torch.cat([g, rw[:, None]], 1), 0.0)
    image = image.reshape(H, W, 5)

    counter = torch.zeros(H * W + 1, dtype=torch.int32, device=pts.device)
    counter.scatter_add_(0, flat, inb.to(torch.int32))
    return image, counter[:H * W].reshape(H, W)


def pixel_to_point(rows: torch.Tensor, cols: torch.Tensor,
                   values: torch.Tensor, cfg: SensorConfig = SensorConfig()):
    """Inverse projection of (row, col, range) -> (x, y, z)."""
    img_bottom = cfg.img_h - cfg.vertical_pixel_offset
    beta = (img_bottom - rows) * cfg.vertical_res
    alpha = math.pi - cols * cfg.azimuth_res
    z = values * torch.sin(beta)
    rho = values * torch.cos(beta)
    return torch.stack([rho * torch.cos(alpha), rho * torch.sin(alpha), z], -1)


def model_input(image: torch.Tensor, cfg: SensorConfig = SensorConfig()):
    """Crop the ring image to the respond-net input window: rows
    [0, n_lines), cols [0, img_w - crop), channels x, y, z."""
    return image[:cfg.n_lines, :cfg.model_w, 0:3]


def extend_keypoints(image: torch.Tensor, counter: torch.Tensor,
                     key_pixels: torch.Tensor, key_mask: torch.Tensor,
                     cfg: SensorConfig = SensorConfig(), radius: int = 6):
    """Gather the occupied pixels of a ``(2r+1)^2`` window around each key
    pixel (port of ``caelo_tpu/projection/spherical.py:109-146``).

    A pixel covered by several windows belongs to the lowest keypoint index
    whose window covers it, elected by one int32 scatter-min into H*W+1
    slots (slot H*W collects the unoccupied and masked entries).  Masked
    keypoints own nothing.

    Returns ``nbr_pts (K, (2r+1)^2, 3)`` and ``nbr_mask (K, (2r+1)^2)``.
    """
    H, W = cfg.img_h, cfg.img_w
    K = key_pixels.shape[0]
    dev = key_pixels.device
    dr = torch.arange(-radius, radius + 1, device=dev)
    oy, ox = torch.meshgrid(dr, dr, indexing="ij")
    rows = key_pixels[:, None, 0].long() + oy.reshape(1, -1)      # (K, W2)
    cols = key_pixels[:, None, 1].long() + ox.reshape(1, -1)
    inb = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    rc = torch.where(inb, rows, 0)
    cc = torch.where(inb, cols, 0)
    occ = (counter[rc, cc] > 0) & inb & key_mask[:, None]
    flat = torch.where(occ, rc * W + cc, H * W)
    kid = torch.arange(K, dtype=torch.int32, device=dev)
    owner = torch.full((H * W + 1,), K, dtype=torch.int32, device=dev)
    owner.scatter_reduce_(0, flat.reshape(-1),
                          kid[:, None].expand_as(flat).reshape(-1), "amin")
    mine = occ & (owner[flat] == kid[:, None])
    nbr_pts = image[rc, cc, 0:3]
    return torch.where(mine[..., None], nbr_pts, 0.0), mine
