"""Baseline keypoint detectors: ISS, Harris3D, SIFT3D and random (port of
``caelo_tpu/frontend/baselines.py``).

The reference runs PCL's detectors (``PclKeyPts.py:92-122``, parameters at
``:41-58``) as evaluation baselines.  Here, as in the JAX package, they are
batched tensor ops over the padded scan on the device of the points:

* neighbourhoods: the K nearest points by a distance matmul and a top-k per
  query chunk, radius-masked;
* ISS: scatter-covariance eigenvalues, saliency lambda3 with the gamma-ratio
  gates, radius NMS;
* Harris3D: ``det - k trace^2`` of the summed outer products of the
  neighbours' surface normals, the same NMS;
* SIFT3D: difference-of-Gaussians scale space over the z field by Gaussian
  KNN smoothing, scale and space extremum test, contrast gate.

``random_keypoints`` is the reference's 'random' row.  The JAX ``lax.map``
over query chunks and scale levels is a Python loop here, so no (levels, N,
K) stack is ever held.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.nms import top_k

_INF = float("inf")
_EIGH_BATCH = 16384


class KeypointResult(NamedTuple):
    key_pts: torch.Tensor     # (n_keypoints, 3)
    key_mask: torch.Tensor    # (n_keypoints,) bool


def _knn_neighbors(pts: torch.Tensor, mask: torch.Tensor, k: int,
                   chunk: int = 512) -> torch.Tensor:
    """``(N, k)`` int64 indices of the k nearest points of every point.

    Scores are JAX's ``2 q.p - |p|^2 - |q|^2`` with masked points at
    ``|p|^2 = 1e12``, so they order as JAX's do; each row comes back in
    ``lax.top_k``'s order (score descending, the lower index first among
    equal scores).  Which of the points tied at the k-th score make the cut
    is left to ``torch.topk``.  Queries run ``chunk`` rows at a time: a
    chunk holds a ``(chunk, N)`` float32 score matrix.
    """
    p2m = torch.where(mask, (pts * pts).sum(-1), 1e12)
    out = []
    for qc in pts.split(chunk):
        q2 = (qc * qc).sum(-1)
        score = 2.0 * (qc @ pts.T) - p2m[None, :] - q2[:, None]
        vals, idx = torch.topk(score, k, dim=-1)
        # lax.top_k's order: index ascending, then a stable sort by score
        idx, perm = idx.sort(-1)
        order = vals.gather(-1, perm).sort(dim=-1, descending=True,
                                           stable=True).indices
        out.append(idx.gather(-1, order))
    return torch.cat(out)


def _neighbor_cov(pts: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
                  radius: float):
    """Per-point covariance of the neighbours within ``radius`` (masked):
    ``(cov (N, 3, 3), n_neighbors (N,))``."""
    nbr = pts[idx]                                    # (N, K, 3)
    ok = mask[idx] & mask[:, None]
    ok &= torch.linalg.norm(nbr - pts[:, None, :], dim=-1) <= radius
    w = ok.to(torch.float32)[..., None]
    cnt = w.sum(1).clamp_min(1.0)
    mean = (nbr * w).sum(1) / cnt
    c = (nbr - mean[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", c, c) / cnt[..., None]
    return cov, ok.sum(1)


def _eigh(cov: torch.Tensor):
    """``(eigenvalues ascending, eigenvectors)`` of symmetric 3x3 matrices,
    ``_EIGH_BATCH`` matrices per solver call: cuSOLVER's batched solver
    refuses 32,768 or more at once (``CUSOLVER_STATUS_INVALID_VALUE``)."""
    parts = [torch.linalg.eigh(c) for c in cov.split(_EIGH_BATCH)]
    return (torch.cat([w for w, _ in parts]),
            torch.cat([v for _, v in parts]))


def _radius_nms(pts: torch.Tensor, mask: torch.Tensor, score: torch.Tensor,
                radius: float, n_keypoints: int, idx: torch.Tensor):
    """The points that are maxima of ``score`` among their neighbours within
    ``radius``, the ``n_keypoints`` best: ``(key_pts, key_mask)``."""
    near = mask[idx] & (
        torch.linalg.norm(pts[idx] - pts[:, None, :], dim=-1) <= radius)
    nbr_score = torch.where(near, score[idx], -_INF)
    is_max = score >= nbr_score.max(1).values
    final = torch.where(mask & is_max & torch.isfinite(score), score, -_INF)
    vals, top = top_k(final, n_keypoints)
    out_mask = torch.isfinite(vals)
    return pts[top] * out_mask[:, None], out_mask


def iss_keypoints(pts: torch.Tensor, mask: torch.Tensor,
                  salient_radius: float = 2.0, nms_radius: float = 2.0,
                  gamma_21: float = 0.975, gamma_32: float = 0.975,
                  min_neighbors: int = 5, n_keypoints: int = 1024,
                  k: int = 64) -> KeypointResult:
    """Intrinsic Shape Signatures (parameters per ``PclKeyPts.py:41-46``)."""
    idx = _knn_neighbors(pts, mask, k)
    cov, n_nbr = _neighbor_cov(pts, mask, idx, salient_radius)
    evals = _eigh(cov)[0]                            # ascending l3<=l2<=l1
    l3, l2, l1 = evals[:, 0], evals[:, 1], evals[:, 2]
    ok = (mask & (n_nbr >= min_neighbors)
          & (l2 / l1.clamp_min(1e-12) < gamma_21)
          & (l3 / l2.clamp_min(1e-12) < gamma_32))
    score = torch.where(ok, l3, -_INF)
    return KeypointResult(*_radius_nms(pts, mask, score, nms_radius,
                                       n_keypoints, idx))


def harris3d_keypoints(pts: torch.Tensor, mask: torch.Tensor,
                       radius: float = 1.0, nms_threshold: float = 1e-3,
                       harris_k: float = 0.04, n_keypoints: int = 1024,
                       k: int = 64) -> KeypointResult:
    """Harris3D (parameters per ``PclKeyPts.py:48-51``): response ``det(C) -
    k trace(C)^2`` of ``C``, the unnormalised sum of outer products of the
    neighbours' surface normals (PCL's HarrisKeypoint3D).  ``C`` does not
    depend on the sign the eigen solver gives a normal."""
    idx = _knn_neighbors(pts, mask, k)
    cov, n_nbr = _neighbor_cov(pts, mask, idx, radius)
    normals = _eigh(cov)[1][:, :, 0]                 # smallest eigenvector
    nbr_n = normals[idx]                             # (N, K, 3)
    ok = mask[idx] & (
        torch.linalg.norm(pts[idx] - pts[:, None, :], dim=-1) <= radius)
    w = ok.to(torch.float32)[..., None]
    C = torch.einsum("nki,nkj->nij", nbr_n * w, nbr_n)
    tr = C[:, 0, 0] + C[:, 1, 1] + C[:, 2, 2]
    resp = torch.linalg.det(C) - harris_k * tr * tr
    score = torch.where(mask & (n_nbr >= 5) & (resp > nms_threshold), resp,
                        -_INF)
    return KeypointResult(*_radius_nms(pts, mask, score, radius, n_keypoints,
                                       idx))


def _sift_scale_space(pts: torch.Tensor, mask: torch.Tensor,
                      idx: torch.Tensor, min_scale: float, n_octaves: int,
                      n_scales_per_octave: int):
    """SIFT3D's difference-of-Gaussians of the z field over the neighbour
    lists ``idx``, one level at a time: ``(dog (S-1, N), sigmas (S,), d2
    (N, K), okn (N, K))``, ``d2`` the squared neighbour distances and
    ``okn`` the valid neighbours."""
    nbr = pts[idx]                                    # (N, K, 3)
    d2 = ((nbr - pts[:, None, :]) ** 2).sum(-1)
    okn = mask[idx] & mask[:, None]
    zn = torch.where(okn, nbr[..., 2], 0.0)
    wv = okn.to(torch.float32)
    n_levels = n_octaves * n_scales_per_octave + 1
    sigmas = min_scale * 2.0 ** (
        torch.arange(n_levels, dtype=torch.float32, device=pts.device)
        / n_scales_per_octave)
    smoothed = []
    for sig in sigmas:
        w = torch.exp(-d2 / (2.0 * sig * sig)) * wv
        smoothed.append((w * zn).sum(-1) / w.sum(-1).clamp_min(1e-12))
    smoothed = torch.stack(smoothed)                  # (S, N)
    return smoothed[1:] - smoothed[:-1], sigmas, d2, okn


def sift3d_keypoints(pts: torch.Tensor, mask: torch.Tensor,
                     min_scale: float = 0.5, n_octaves: int = 4,
                     n_scales_per_octave: int = 8,
                     min_contrast: float = 0.1, n_keypoints: int = 1024,
                     k: int = 64) -> KeypointResult:
    """SIFT3D (parameters per ``PclKeyPts.py:53-57``): the z field smoothed
    by a Gaussian-weighted mean over each point's K nearest neighbours at
    scales ``min_scale * 2^(o + i/s)``; a keypoint's DoG is an extremum
    across the two adjacent scales and over its neighbours within 2 sigma,
    with ``|DoG| > min_contrast`` (``caelo_tpu/frontend/baselines.py:143``).
    """
    idx = _knn_neighbors(pts, mask, k)
    dog, sigmas, d2, okn = _sift_scale_space(pts, mask, idx, min_scale,
                                             n_octaves, n_scales_per_octave)
    score = torch.full_like(dog[0], -_INF)
    for ell in range(len(sigmas) - 3):
        lo, mid, hi = dog[ell], dog[ell + 1], dog[ell + 2]
        okr = okn & (d2 <= (2.0 * sigmas[ell + 1]) ** 2)
        nbr_mid = mid[idx]
        is_max = ((mid > lo) & (mid > hi)
                  & (mid >= torch.where(okr, nbr_mid, -_INF).max(1).values))
        is_min = ((mid < lo) & (mid < hi)
                  & (mid <= torch.where(okr, nbr_mid, _INF).min(1).values))
        ok = (mask & (is_max | is_min) & (mid.abs() > min_contrast)
              & (okr.sum(1) >= 2))
        score = torch.maximum(score, torch.where(ok, mid.abs(), -_INF))
    vals, top = top_k(score, n_keypoints)
    out_mask = torch.isfinite(vals)
    return KeypointResult(pts[top] * out_mask[:, None], out_mask)


def random_keypoints(generator: torch.Generator | None, pts: torch.Tensor,
                     mask: torch.Tensor, n_keypoints: int = 1024,
                     idx: torch.Tensor | None = None) -> KeypointResult:
    """The reference's 'random' row (``PclKeyPts.py:127-129``):
    ``n_keypoints`` valid points drawn uniformly *with replacement*, as
    ``jax.random.categorical`` draws them, from ``generator``.  ``idx``, if
    given, replaces the draw (the parity seam: the tests feed JAX's)."""
    if idx is None:
        weights = mask.to(torch.float32)
        if not bool(mask.any()):          # nothing to draw from: all masked
            weights = torch.ones_like(weights)
        idx = torch.multinomial(weights, n_keypoints, replacement=True,
                                generator=generator)
    idx = torch.as_tensor(idx, device=pts.device).long()
    return KeypointResult(pts[idx], mask[idx])
