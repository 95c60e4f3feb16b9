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

from .. import _build
from ..ops.nms import top_k
from ..utils.telemetry import span

_INF = float("inf")
_EIGH_BATCH = 16384


class KeypointResult(NamedTuple):
    key_pts: torch.Tensor     # (n_keypoints, 3)
    key_mask: torch.Tensor    # (n_keypoints,) bool


def _knn_neighbors_plain(pts: torch.Tensor, mask: torch.Tensor, k: int,
                         chunk: int = 512) -> torch.Tensor:
    """``(N, k)`` int64 indices of the k nearest points of every point.

    Scores are JAX's ``2 q.p - |p|^2 - |q|^2`` with masked points at
    ``|p|^2 = 1e12``, so they order as JAX's do; each row comes back in
    ``lax.top_k``'s order (score descending, the lower index first among
    equal scores).  Which of the points tied at the k-th score make the cut
    is left to ``torch.topk``.  Queries run ``chunk`` rows at a time: a
    chunk holds a ``(chunk, N)`` float32 score matrix.  The plain version
    of :func:`_knn_neighbors`, which takes it for CPU tensors.
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


# K4's block (csrc/knn_select.cu): queries a block, points a tile
_KNN_QUERIES, _KNN_TILE = 128, 256
_KNN_KMAX = 128
# the Morton curve's cells: 2^10 a side over the scan's bounding box
_MORTON_BITS = 10


def _morton_spread(c: torch.Tensor) -> torch.Tensor:
    """Bit b of each 10-bit ``c`` moved to bit ``3 b``."""
    for shift, keep in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3),
                        (2, 0x09249249)):
        c = (c | (c << shift)) & keep
    return c


def _knn_visit_order(pts: torch.Tensor, mask: torch.Tensor):
    """K4's visiting order: ``(perm (N,) int64, start (ceil(N / 128),)
    int32)``.  ``perm`` sorts the valid points along a Morton curve over
    the scan's bounding box, the masked ones last; ``start`` is the tile of
    ``_KNN_TILE`` sorted points where each block's first query would lie,
    masked or not, which the block visits first.  Speed only: the kernel's
    result does not depend on the order."""
    lo, hi = torch.aminmax(pts, dim=0)
    top = (1 << _MORTON_BITS) - 1
    cell = ((pts - lo) * (top / (hi - lo).clamp_min(1e-30))).clamp_(0, top)
    c = _morton_spread(cell.long())
    code = c[:, 0] | (c[:, 1] << 1) | (c[:, 2] << 2)
    keys, perm = torch.sort(torch.where(mask, code, 1 << 3 * _MORTON_BITS))
    start = torch.searchsorted(keys, code[perm[::_KNN_QUERIES]])
    return perm, (start // _KNN_TILE).int()


def _knn_tile_boxes(rows: torch.Tensor) -> torch.Tensor:
    """``(T, 8)`` float32, K4's view of each tile of ``_KNN_TILE`` sorted
    points, from their ``rows (N, 5)`` ``(x, y, z, -p2m, p2 - p2m)``: the
    least x, y, z, the tile's lift, the largest x, y, z and a pad.  A point
    ``p`` of the tile scores at most ``-D^2 + lift + 2^-17 q2`` against a
    query ``q`` at distance ``D`` from the box: ``lift`` is the tile's
    largest ``p2 - p2m`` (0 where all are valid, about -1e12 where all are
    masked) plus ``2^-18 (2 P^2 + M)``, with ``P`` bounding ``|p|`` and
    ``M`` the largest ``p2m``; with ``2^-17 q2`` that is ten times the
    rounding of the score's float32 operations and of ``p2`` and ``q2``.
    NaN in a tile makes its lift NaN, which K4 never skips."""
    pad = -rows.shape[0] % _KNN_TILE
    if pad:
        rows = torch.cat([rows, rows[-1:].expand(pad, -1)])
    lo, hi = torch.aminmax(rows.view(-1, _KNN_TILE, rows.shape[1]), dim=1)
    xyz_lo, xyz_hi = lo[:, :3], hi[:, :3]
    p2 = torch.maximum(xyz_lo * xyz_lo, xyz_hi * xyz_hi).sum(1)
    lift = hi[:, 4] + 2.0 ** -18 * (2.0 * p2 - lo[:, 3])
    return torch.cat([xyz_lo, lift[:, None], xyz_hi, torch.zeros_like(
        lift[:, None])], 1).contiguous()


def _knn_neighbors(pts: torch.Tensor, mask: torch.Tensor, k: int,
                   chunk: int = 512) -> torch.Tensor:
    """K4 wrapper: :func:`_knn_neighbors_plain`'s ``(N, k)`` rows in one
    kernel launch that writes no score and skips the tiles of points that
    no query of a block can use.

    A CPU tensor takes the plain version (``chunk`` queries at a time); a
    CUDA tensor launches ``csrc/knn_select.cu`` on the current stream (the
    plain version's float32 scores, the k best by score descending, then
    index ascending, bit for bit) or raises.  ``pts`` is float32 ``(N, 3)``
    (contiguous on the card), ``1 <= k <= 128``."""
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts {tuple(pts.shape)}: want (N, 3)")
    if pts.dtype != torch.float32:
        raise TypeError(f"the KNN takes float32, got {pts.dtype}")
    if not 1 <= k <= _KNN_KMAX:
        raise ValueError(f"k {k}: the KNN kernel takes 1 to {_KNN_KMAX}")
    with span("caelo.frontend.knn"):
        if pts.device.type == "cpu":
            return _knn_neighbors_plain(pts, mask, k, chunk)
        if pts.device.type != "cuda":
            raise ValueError(f"no KNN kernel for device {pts.device}")
        n = pts.shape[0]
        if not pts.is_contiguous():
            raise ValueError("the KNN kernel takes contiguous points")
        if (mask.shape != (n,) or mask.dtype != torch.bool
                or mask.device != pts.device):
            raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype} on "
                             f"{mask.device}: want ({n},) bool on "
                             f"{pts.device}")
        if k > n:
            raise ValueError(f"k {k} > {n} points")
        # the plain version's own operations, so its bits
        p2 = (pts * pts).sum(-1)
        p2m = torch.where(mask, p2, 1e12)
        perm, start = _knn_visit_order(pts, mask)
        rows = torch.cat([pts, p2m.neg()[:, None], (p2 - p2m)[:, None]],
                         1)[perm]
        pp = rows[:, :4].contiguous()
        boxes = _knn_tile_boxes(rows)
        perm32 = perm.int()
        out = torch.empty((n, k), dtype=torch.int64, device=pts.device)
        _build.check(_build.kernel("caelo_knn_select")(
            pp.data_ptr(), perm32.data_ptr(), p2.data_ptr(),
            start.data_ptr(), boxes.data_ptr(), out.data_ptr(), n, k,
            _build.stream(pts.device)), "KNN kernel")
        _knn_kernel.launches += 1
        return out


_knn_neighbors.launches = 0
# the counter's owner: the wrapper counts through this name, so a function
# put in its place (a profiler's timer, a test's) does not take the count
_knn_kernel = _knn_neighbors


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
