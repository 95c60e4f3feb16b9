"""Planar points with normals from the spherical-ring image (port of
``caelo_tpu/projection/normals.py``).

Per pixel: a 5x5-window covariance from shifted-slice sums, its smallest
eigenvector by Smith's closed form, and a planarity gate (small smallest
eigenvalue, low saliency); then the top ``max_planar`` candidates on a
strided grid.  Every intermediate is a separate ``(H, W)`` plane per
component, as in the JAX module, which keeps the two side by side.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import SensorConfig
from ..ops.nms import top_k
from ..xlamath import mul_reciprocal


def _smallest_eigvec_sym3x3(axx, axy, axz, ayy, ayz, azz):
    """Closed-form smallest eigenpair of symmetric 3x3 matrices given as six
    scalar planes.  Returns ``(lam0, lam1, nx, ny, nz)``: the two smallest
    eigenvalues and the unit eigenvector of ``lam0``."""
    q = mul_reciprocal(axx + ayy + azz, 3.0)
    p1 = axy * axy + axz * axz + ayz * ayz
    bxx, byy, bzz = axx - q, ayy - q, azz - q
    p2 = bxx * bxx + byy * byy + bzz * bzz + 2.0 * p1
    p = torch.sqrt(mul_reciprocal(torch.clamp_min(p2, 1e-30), 6.0))
    ip = 1.0 / p
    cxx, cyy, czz = bxx * ip, byy * ip, bzz * ip
    cxy, cxz, cyz = axy * ip, axz * ip, ayz * ip
    detB = (cxx * (cyy * czz - cyz * cyz)
            - cxy * (cxy * czz - cyz * cxz)
            + cxz * (cxy * cyz - cyy * cxz))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = mul_reciprocal(torch.arccos(r), 3.0)
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_hi - lam_lo

    # eigenvector of lam_lo: the best-conditioned cross product of two rows
    # of (A - lam_lo I)
    d0, d1, d2 = axx - lam_lo, ayy - lam_lo, azz - lam_lo
    c01x = axy * ayz - d1 * axz
    c01y = axz * axy - d0 * ayz
    c01z = d0 * d1 - axy * axy
    c02x = axy * d2 - ayz * axz
    c02y = axz * axz - d0 * d2
    c02z = d0 * ayz - axy * axz
    c12x = d1 * d2 - ayz * ayz
    c12y = ayz * axz - axy * d2
    c12z = axy * ayz - d1 * axz
    n01 = c01x * c01x + c01y * c01y + c01z * c01z
    n02 = c02x * c02x + c02y * c02y + c02z * c02z
    n12 = c12x * c12x + c12y * c12y + c12z * c12z
    use02 = n02 > n01
    bx = torch.where(use02, c02x, c01x)
    by = torch.where(use02, c02y, c01y)
    bz = torch.where(use02, c02z, c01z)
    bn = torch.where(use02, n02, n01)
    use12 = n12 > bn
    bx = torch.where(use12, c12x, bx)
    by = torch.where(use12, c12y, by)
    bz = torch.where(use12, c12z, bz)
    bn = torch.where(use12, n12, bn)
    inv = torch.rsqrt(torch.clamp_min(bn, 1e-30))
    return lam_lo, lam_mid, bx * inv, by * inv, bz * inv


def extract_planar_points(image: torch.Tensor, counter: torch.Tensor,
                          saliency: torch.Tensor,
                          sensor: SensorConfig = SensorConfig(),
                          max_planar: int = 4096,
                          planar_threshold: float = 0.4,
                          stride: int = 4, window: int = 5):
    """Return ``(P, 6)`` rows of (x, y, z, nx, ny, nz) and their mask.

    Args:
      image: ``(ImgH, ImgW, 5)`` ring image.
      counter: occupancy counter.
      saliency: ``(n_lines, model_w)`` NMS min-diff map (planar = LOW
        saliency, the complement of keypoints).
      stride: subsample the pixel grid to bound the candidate count.
    """
    H, W = saliency.shape
    rad = window // 2
    occ = (counter[:H, :W] > 0).to(torch.float32)
    px = image[:H, :W, 0] * occ
    py = image[:H, :W, 1] * occ
    pz = image[:H, :W, 2] * occ

    # window sums of p, the upper triangle of p p^T, and the count: float32
    # per-pixel products, added in float64 in the JAX loop's order, one add
    # of all ten planes per window offset.  float64, because the covariance
    # sxx/n - mx^2 cancels ranges of tens of metres down to the ~1e-5 m^2
    # eigenvalue of a plane, where float32 sums keep no correct digit and
    # the gates and the top-k order below turn on rounding.  The JAX module
    # accumulates in the default float type, which is float64 where x64 is
    # on, as in its tests.
    prods = F.pad(torch.stack([px, py, pz, px * px, px * py, px * pz,
                               py * py, py * pz, pz * pz, occ]),
                  (rad, rad, rad, rad))
    sums = torch.zeros((10, H, W), dtype=torch.float64, device=image.device)
    for dy in range(2 * rad + 1):
        for dx in range(2 * rad + 1):
            sums += prods[:, dy:dy + H, dx:dx + W]
    sx, sy, sz, sxx, sxy, sxz, syy, syz, szz, cnt = sums.unbind(0)
    n = torch.clamp_min(cnt, 1.0)
    mx, my, mz = sx / n, sy / n, sz / n
    axx = sxx / n - mx * mx
    axy = sxy / n - mx * my
    axz = sxz / n - mx * mz
    ayy = syy / n - my * my
    ayz = syz / n - my * mz
    azz = szz / n - mz * mz

    lam0, lam1, nx, ny, nz = _smallest_eigvec_sym3x3(
        axx, axy, axz, ayy, ayz, azz)
    # orient normals toward the sensor (origin)
    flip = (nx * px.double() + ny * py.double() + nz * pz.double()) > 0
    nx, ny, nz = (torch.where(flip, -c, c) for c in (nx, ny, nz))

    # planarity: smallest eigenvalue much smaller than the window spread
    lam0c = torch.clamp_min(lam0, 0.0)
    lam1c = torch.clamp_min(lam1, 1e-12)
    rows = torch.arange(H, device=image.device)[:, None]
    cols = torch.arange(W, device=image.device)[None, :]
    planar = ((occ > 0) & (cnt >= 8) & (lam0c < 0.01)
              & (lam0c / lam1c < 0.1) & (saliency < planar_threshold)
              & (rows % stride == 0) & (cols % stride == 0))

    score = torch.where(planar, -lam0c, -math.inf).reshape(-1)
    vals, idx = top_k(score, max_planar)
    mask = torch.isfinite(vals)
    out = torch.stack([c.reshape(-1)[idx].float()
                       for c in (px, py, pz, nx, ny, nz)], 1)
    return torch.where(mask[:, None], out, 0.0), mask
