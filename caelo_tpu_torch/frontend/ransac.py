"""Batched RANSAC rigid-pose estimation (port of
``caelo_tpu/frontend/ransac.py::ransac_rigid``).

All hypotheses are drawn at once, solved in parallel with Horn's quaternion
method (structure-of-arrays, the batched Jacobi on the last axis), scored
against every pair at every rung of the 0.4/0.8/1.6 m ladder, and the
smallest accepting rung's best hypothesis is refit on its inliers and
tightened ``refit_iters`` times.  Batched over leading axes, so a window's
pairs run as one call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RansacConfig
from ..geometry import se3
from ..utils.telemetry import span

_INF = float("inf")


class RansacResult(NamedTuple):
    R: torch.Tensor            # (..., 3, 3)
    t: torch.Tensor            # (..., 3)
    success: torch.Tensor      # (...,) bool
    inlier_mask: torch.Tensor  # (..., K) bool -- over the input pairs
    n_inliers: torch.Tensor    # (...,) int64
    threshold: torch.Tensor    # (...,) float32 -- accepted residual rung


def _horn_N_lanes(M):
    """Horn's symmetric 4x4 from 9 cross-covariance entry vectors:
    ``M[i][j]`` each ``(B,)`` -> ``(4, 4, B)``."""
    tr = M[0][0] + M[1][1] + M[2][2]
    d0 = M[1][2] - M[2][1]
    d1 = M[2][0] - M[0][2]
    d2 = M[0][1] - M[1][0]
    rows = [
        [tr, d0, d1, d2],
        [d0, 2 * M[0][0] - tr, M[0][1] + M[1][0], M[0][2] + M[2][0]],
        [d1, M[0][1] + M[1][0], 2 * M[1][1] - tr, M[1][2] + M[2][1]],
        [d2, M[0][2] + M[2][0], M[1][2] + M[2][1], 2 * M[2][2] - tr],
    ]
    return torch.stack([torch.stack(r) for r in rows])


def _quat_to_rot_entries(q):
    """``(4, ...)`` quaternion (w, x, y, z) -> 3x3 nested list of entries."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (y * w + z * x)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]


def sample_candidates(pair_mask, pair_dist, cfg: RansacConfig):
    """``(B, K)`` bool: the pairs hypotheses may draw from -- the valid pairs,
    or with ``pair_dist`` the best ``sample_top_frac`` of them."""
    if pair_dist is None or cfg.sample_top_frac >= 1.0:
        return pair_mask
    K = pair_mask.shape[-1]
    n_valid = pair_mask.sum(-1)
    n_top = torch.clamp_min(
        (cfg.sample_top_frac * n_valid.to(torch.float32)).to(torch.int64),
        4 * cfg.sample_size)
    d = torch.where(pair_mask, pair_dist, _INF)
    cutoff = torch.sort(d, -1).values.gather(
        -1, torch.clamp(n_top - 1, 0, K - 1)[:, None])
    return pair_mask & (d <= cutoff)


def draw_samples(sample_ok, cfg: RansacConfig, generator=None):
    """``(B, H, S)`` int64 pair indices drawn uniformly (with replacement)
    from each row's candidates, by inverse CDF on ``generator``.  A row
    with no candidate gets index K-1 (its pairs are all invalid anyway)."""
    B, K = sample_ok.shape
    H, S = cfg.n_hypotheses, cfg.sample_size
    cdf = torch.cumsum(sample_ok.to(torch.float32), -1)
    u = torch.rand((B, H * S), generator=generator, device=sample_ok.device)
    idx = torch.searchsorted(cdf, u * cdf[:, -1:], right=True)
    return idx.clamp_max(K - 1).view(B, H, S)


def ransac_rigid(pairs0: torch.Tensor, pairs1: torch.Tensor,
                 pair_mask: torch.Tensor, cfg: RansacConfig = RansacConfig(),
                 pair_dist: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 samples: torch.Tensor | None = None) -> RansacResult:
    """Estimate the rigid transform mapping ``pairs1 -> pairs0``.

    Args:
      pairs0/pairs1: ``(..., K, 3)`` matched point pairs (padded).
      pair_mask: ``(..., K)`` validity.
      pair_dist: optional ``(..., K)`` descriptor distance; hypotheses then
        draw only from the best ``cfg.sample_top_frac`` of pairs.
      generator: the ``torch.Generator`` of the sample draw.
      samples: optional ``(..., H, S)`` int64 pair indices to use instead of
        drawing -- the parity seam that lets a test feed the exact
        ``jax.random.categorical`` draw of the JAX version.
    """
    batch = pairs0.shape[:-2]
    K = pairs0.shape[-2]
    H, S = cfg.n_hypotheses, cfg.sample_size
    p0 = pairs0.reshape(-1, K, 3)
    p1 = pairs1.reshape(-1, K, 3)
    pm = pair_mask.reshape(-1, K)
    B = p0.shape[0]
    if samples is None:
        with span("caelo.ransac.draw"):
            pd = None if pair_dist is None else pair_dist.reshape(-1, K)
            samples = draw_samples(sample_candidates(pm, pd, cfg), cfg,
                                   generator)
    # --- solve all hypotheses: every entry below is a (B, H) plane
    with span("caelo.ransac.solve"):
        samp = samples.to(p0.device, torch.int64).reshape(
            B, H * S, 1).expand(B, H * S, 3)
        s0 = p0.gather(1, samp).view(B, H, S, 3)
        s1 = p1.gather(1, samp).view(B, H, S, 3)
        mean0 = s0.mean(2)                                  # (B, H, 3)
        mean1 = s1.mean(2)
        q0 = s0 - mean0[:, :, None]
        q1 = s1 - mean1[:, :, None]
        M = [[(q1[..., i] * q0[..., j]).sum(-1).reshape(-1)
              for j in range(3)] for i in range(3)]
        quat = se3.max_eigvec_sym4x4_lanes(_horn_N_lanes(M)).view(4, B, H)
        r = _quat_to_rot_entries(quat)                  # r[i][j]: (B, H)
        t_l = [mean0[..., i]
               - sum(r[i][j] * mean1[..., j] for j in range(3))
               for i in range(3)]

    # --- residuals of every hypothesis on every pair, the rung counts and
    # the winner
    with span("caelo.ransac.score"):
        n_valid = pm.sum(-1)
        bidx = torch.arange(B, device=p0.device)
        d2 = torch.zeros((B, H, K), dtype=p0.dtype, device=p0.device)
        for i in range(3):
            pred_i = (r[i][0][..., None] * p1[:, None, :, 0]
                      + r[i][1][..., None] * p1[:, None, :, 1]
                      + r[i][2][..., None] * p1[:, None, :, 2]
                      + t_l[i][..., None])
            diff = pred_i - p0[:, None, :, i]
            d2 = d2 + diff * diff                       # (B, H, K)

        thresholds = torch.tensor(cfg.residual_thresholds,
                                  dtype=torch.float32, device=p0.device)
        T = thresholds.shape[0]
        d2m = torch.where(pm[:, None, :], d2, _INF)
        counts = torch.stack([(d2m < th * th).sum(-1)
                              for th in cfg.residual_thresholds])  # (T, B, H)
        Rs = torch.stack([torch.stack(r[i], -1)
                          for i in range(3)], -2)               # (B, H, 3, 3)
        ts = torch.stack(t_l, -1)                               # (B, H, 3)

        least = torch.clamp_max(
            (cfg.min_inlier_frac * n_valid.to(torch.float32)).to(torch.int64),
            cfg.min_inlier_abs)
        least = torch.clamp_min(least, S + 1)                   # (B,)

        best_h = torch.argmax(counts, -1)                       # (T, B)
        best_c = counts.gather(-1, best_h[..., None])[..., 0]
        rung_ok = best_c >= least
        rung = torch.where(rung_ok.any(0),
                           torch.argmax(rung_ok.to(torch.uint8), 0),
                           T - 1)                               # (B,)
        h = best_h[rung, bidx]
        success = rung_ok[rung, bidx]
        inlier_mask = d2m[bidx, h] < (thresholds[rung] ** 2)[:, None]

    # --- least-squares refit on the winning inlier set, then the refit
    # tightening: re-gate at the smallest rung the refit pose supports and
    # refit again
    with span("caelo.ransac.refit"):
        R_fit, t_fit = se3.solve_rigid_horn(p0, p1, inlier_mask.to(p0.dtype))
        if cfg.refit_iters > 0:
            R_c, t_c, rung_c, mask_c = R_fit, t_fit, rung, inlier_mask
            for _ in range(cfg.refit_iters):
                pred = torch.einsum("bij,bkj->bki", R_c, p1) + t_c[:, None]
                d2p = torch.where(pm, ((pred - p0) ** 2).sum(-1), _INF)
                counts_p = torch.stack([(d2p < th * th).sum(-1)
                                        for th in cfg.residual_thresholds])
                ok_p = counts_p >= least
                rung_c = torch.where(ok_p.any(0),
                                     torch.argmax(ok_p.to(torch.uint8), 0),
                                     rung_c)
                mask_c = d2p < (thresholds[rung_c] ** 2)[:, None]
                R_c, t_c = se3.solve_rigid_horn(p0, p1, mask_c.to(p0.dtype))
            R_fit = torch.where(success[:, None, None], R_c, R_fit)
            t_fit = torch.where(success[:, None], t_c, t_fit)
            rung = torch.where(success, rung_c, rung)
            inlier_mask = torch.where(success[:, None], mask_c, inlier_mask)

    R = torch.where(success[:, None, None], R_fit, Rs[bidx, h])
    t = torch.where(success[:, None], t_fit, ts[bidx, h])
    n_inliers = torch.where(success, inlier_mask.sum(-1), counts[rung, bidx, h])
    return RansacResult(
        R=R.reshape(*batch, 3, 3),
        t=t.reshape(*batch, 3),
        success=success.reshape(batch),
        inlier_mask=inlier_mask.reshape(*batch, K),
        n_inliers=n_inliers.reshape(batch),
        threshold=thresholds[rung].reshape(batch),
    )
