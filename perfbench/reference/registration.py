"""Pair registration, plain: nearest-descriptor matching (optionally gated
by a motion prior), RANSAC over given 4-point hypotheses with Horn's
quaternion solve, the 0.4 / 0.8 / 1.6 m rung ladder, the least-squares
refit and its tightening (CAE-LO ``Match.py:162-283``), and the
motion-prior retry of the two odometry drivers.

RANSAC takes the hypotheses' pair indices as given (``samples``): the
benchmark compares the pose each driver computed from the draw it made."""
from __future__ import annotations

import numpy as np
import torch

from .frontend import matmul, tf32

_INF = float("inf")
_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
_GOLDEN = -7046029254386353131        # 0x9E3779B97F4A7C15, signed


def sq_dist(a, b, low=False):
    """``(..., N, M)`` squared distances ``|a|^2 + |b|^2 - 2 a.b``,
    clamped at 0."""
    ab = matmul(a, b.transpose(-1, -2), low)
    return torch.clamp_min((a * a).sum(-1)[..., :, None]
                           + (b * b).sum(-1)[..., None, :] - 2.0 * ab, 0.0)


def _row_ids(bits):
    N, D = bits.shape
    mult = torch.arange(1, D + 1, dtype=torch.int64,
                        device=bits.device) * _GOLDEN | 1
    fp = (bits.to(torch.int64) * mult).sum(-1)
    groups, ids = torch.unique(fp, return_inverse=True)
    first = torch.full(groups.shape, N, dtype=torch.int64, device=bits.device)
    first.scatter_reduce_(0, ids, torch.arange(N, device=bits.device), "amin")
    if torch.equal(bits[first[ids]], bits):
        return ids
    return torch.unique(bits, dim=0, return_inverse=True)[1]


def match(c0, m0, c1, m1, p0=None, p1=None, prior_R=None, prior_t=None,
          gate_m=0.0, ratio=0.0, low=False):
    """For each frame-1 keypoint its nearest frame-0 descriptor: ``(idx,
    mask, dist)``.  Bit-equal descriptors are at distance exactly 0."""
    d2 = sq_dist(c0, c1, low)
    *_, K0, D = c0.shape
    K1 = c1.shape[-2]
    rows = torch.cat([c0.reshape(-1, K0, D), c1.reshape(-1, K1, D)], 1)
    ids = _row_ids(rows.reshape(-1, D).view(torch.int32)).view(-1, K0 + K1)
    same = (ids[:, :K0, None] == ids[:, None, K0:]).view(d2.shape)
    d2 = torch.where(same, 0.0, d2)
    d2 = torch.where(m0[..., :, None], d2, _INF)
    if gate_m > 0.0:
        pred = matmul(p1, prior_R.transpose(-1, -2), low) + prior_t[..., None, :]
        d2 = torch.where(sq_dist(p0, pred, low) <= gate_m * gate_m, d2, _INF)
    idx = torch.argmin(d2, dim=-2)
    best = d2.gather(-2, idx[..., None, :])[..., 0, :]
    ok = m1 & torch.isfinite(best)
    if ratio > 0.0:
        second = torch.topk(d2, 2, dim=-2, largest=False).values[..., 1, :]
        ok = ok & ((best <= ratio * ratio * second) | ~torch.isfinite(second))
    return idx, ok, torch.sqrt(torch.where(ok, best, 0.0))


def max_eigvec(A, sweeps=8):
    """Eigenvector of the largest eigenvalue of symmetric 4x4 matrices,
    ``A (4, 4, B) -> (4, B)``: cyclic Jacobi, a fixed sweep count."""
    A = A.clone()
    B = A.shape[-1]
    V = torch.eye(4, dtype=A.dtype, device=A.device)[..., None].repeat(1, 1, B)
    for _ in range(sweeps):
        for p, q in _PAIRS:
            th = 0.5 * torch.atan2(2.0 * A[p, q], A[p, p] - A[q, q])
            c, s = torch.cos(th), torch.sin(th)
            Ap, Aq = c * A[p] + s * A[q], -s * A[p] + c * A[q]
            A[p], A[q] = Ap, Aq
            Ap, Aq = c * A[:, p] + s * A[:, q], -s * A[:, p] + c * A[:, q]
            A[:, p], A[:, q] = Ap, Aq
            Vp, Vq = c * V[:, p] + s * V[:, q], -s * V[:, p] + c * V[:, q]
            V[:, p], V[:, q] = Vp, Vq
    imax = torch.argmax(torch.stack([A[i, i] for i in range(4)]), dim=0)
    v = V.gather(1, imax.view(1, 1, B).expand(4, 1, B))[:, 0]
    return v / torch.linalg.vector_norm(v, dim=0, keepdim=True)


def _horn(M):
    """Horn's symmetric 4x4 from ``M[i][j]`` entry tensors: ``(4, 4, ...)``."""
    tr = M[0][0] + M[1][1] + M[2][2]
    d0, d1, d2 = M[1][2] - M[2][1], M[2][0] - M[0][2], M[0][1] - M[1][0]
    rows = [[tr, d0, d1, d2],
            [d0, 2 * M[0][0] - tr, M[0][1] + M[1][0], M[0][2] + M[2][0]],
            [d1, M[0][1] + M[1][0], 2 * M[1][1] - tr, M[1][2] + M[2][1]],
            [d2, M[0][2] + M[2][0], M[1][2] + M[2][1], 2 * M[2][2] - tr]]
    return torch.stack([torch.stack(r) for r in rows])


def _rot(q):
    """``(4, ...)`` quaternion (w, x, y, z) -> 3x3 nested entries."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (y * w + z * x)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]


def horn_fit(p0, p1, weights, low=False):
    """Weighted least-squares rigid ``(R (B, 3, 3), t (B, 3))`` mapping
    ``p1 -> p0``."""
    w = weights[..., None]
    wsum = torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    m0 = (p0 * w).sum(-2) / wsum
    m1 = (p1 * w).sum(-2) / wsum
    r = tf32 if low else (lambda x: x)
    M = torch.einsum("...ni,...nj->...ij", r((p1 - m1[..., None, :]) * w),
                     r(p0 - m0[..., None, :]))
    lanes = _horn([[M[..., i, j] for j in range(3)] for i in range(3)])
    batch = M.shape[:-2]
    q = max_eigvec(lanes.reshape(4, 4, -1)).T.reshape(*batch, 4)
    R = torch.stack([torch.stack(row, -1) for row in _rot(q.unbind(-1))], -2)
    t = m0 - torch.einsum("...ij,...j->...i", r(R), r(m1))
    return R, t


def ransac(p0, p1, pm, samples, rc: dict, low=False):
    """RANSAC on ``(B, K, 3)`` pairs with hypotheses ``samples (B, H, S)``:
    ``(R, t, success, inlier_mask, n_inliers, threshold)``."""
    B, K = pm.shape
    H, S = samples.shape[-2:]
    samp = samples.to(p0.device, torch.int64).reshape(B, H * S, 1).expand(
        B, H * S, 3)
    n_valid = pm.sum(-1)
    bidx = torch.arange(B, device=p0.device)
    s0 = p0.gather(1, samp).view(B, H, S, 3)
    s1 = p1.gather(1, samp).view(B, H, S, 3)
    mean0, mean1 = s0.mean(2), s1.mean(2)
    q0, q1 = s0 - mean0[:, :, None], s1 - mean1[:, :, None]
    M = [[(q1[..., i] * q0[..., j]).sum(-1).reshape(-1) for j in range(3)]
         for i in range(3)]
    r = _rot(max_eigvec(_horn(M)).view(4, B, H))
    t_l = [mean0[..., i] - sum(r[i][j] * mean1[..., j] for j in range(3))
           for i in range(3)]
    d2 = torch.zeros((B, H, K), dtype=p0.dtype, device=p0.device)
    for i in range(3):
        pred = (r[i][0][..., None] * p1[:, None, :, 0]
                + r[i][1][..., None] * p1[:, None, :, 1]
                + r[i][2][..., None] * p1[:, None, :, 2] + t_l[i][..., None])
        diff = pred - p0[:, None, :, i]
        d2 = d2 + diff * diff
    ths = rc["residual_thresholds"]
    thr = torch.tensor(ths, dtype=torch.float32, device=p0.device)
    d2m = torch.where(pm[:, None, :], d2, _INF)
    counts = torch.stack([(d2m < th * th).sum(-1) for th in ths])
    Rs = torch.stack([torch.stack(r[i], -1) for i in range(3)], -2)
    ts = torch.stack(t_l, -1)
    least = torch.clamp_max((rc["min_inlier_frac"] * n_valid.to(torch.float32)
                             ).to(torch.int64), rc["min_inlier_abs"])
    least = torch.clamp_min(least, S + 1)
    best_h = torch.argmax(counts, -1)
    best_c = counts.gather(-1, best_h[..., None])[..., 0]
    rung_ok = best_c >= least
    rung = torch.where(rung_ok.any(0),
                       torch.argmax(rung_ok.to(torch.uint8), 0), len(ths) - 1)
    h = best_h[rung, bidx]
    success = rung_ok[rung, bidx]
    inl = d2m[bidx, h] < (thr[rung] ** 2)[:, None]
    R_fit, t_fit = horn_fit(p0, p1, inl.to(p0.dtype), low)
    if rc["refit_iters"] > 0:
        R_c, t_c, rung_c, mask_c = R_fit, t_fit, rung, inl
        rr = tf32 if low else (lambda x: x)
        for _ in range(rc["refit_iters"]):
            pred = torch.einsum("bij,bkj->bki", rr(R_c), rr(p1)) + t_c[:, None]
            d2p = torch.where(pm, ((pred - p0) ** 2).sum(-1), _INF)
            ok_p = torch.stack([(d2p < th * th).sum(-1) for th in ths]) >= least
            rung_c = torch.where(ok_p.any(0),
                                 torch.argmax(ok_p.to(torch.uint8), 0), rung_c)
            mask_c = d2p < (thr[rung_c] ** 2)[:, None]
            R_c, t_c = horn_fit(p0, p1, mask_c.to(p0.dtype), low)
        R_fit = torch.where(success[:, None, None], R_c, R_fit)
        t_fit = torch.where(success[:, None], t_c, t_fit)
        rung = torch.where(success, rung_c, rung)
        inl = torch.where(success[:, None], mask_c, inl)
    R = torch.where(success[:, None, None], R_fit, Rs[bidx, h])
    t = torch.where(success[:, None], t_fit, ts[bidx, h])
    n_inl = torch.where(success, inl.sum(-1), counts[rung, bidx, h])
    return R, t, success, inl, n_inl, thr[rung]


@torch.no_grad()
def register(f0, f1, cfg: dict, samples, prior=None, low=False):
    """Register frame-1 features into frame 0 (batched over a leading pair
    axis): ``(R, t, success)``.  ``f = (key_pts, descriptors, key_mask)``;
    ``prior = (R, t)`` gates the candidate matches to ``prior_gate_m``."""
    gate = cfg["prior_gate_m"] if prior is not None else 0.0
    pR, pt = prior if prior is not None else (None, None)
    idx, ok, dist = match(f0[1], f0[2], f1[1], f1[2], f0[0], f1[0], pR, pt,
                          gate, cfg["match_ratio"], low)
    pairs0 = f0[0].gather(-2, idx[..., None].expand(*idx.shape, 3))
    R, t, success = ransac(pairs0.reshape(-1, *pairs0.shape[-2:]),
                           f1[0].reshape(-1, *f1[0].shape[-2:]),
                           ok.reshape(-1, ok.shape[-1]), samples,
                           cfg["ransac"], low)[:3]
    return R, t, success


def register_window(feats, draws, cfg: dict, low=False):
    """The windowed driver's pairs: frames ``b`` and ``b + 1`` of the
    stacked ``feats`` for every ``b``, then, where some pair failed, the
    retry of every pair with the previous pair's first-pass pose (identity
    for the first pair and after a failure) as its prior, kept where the
    first pass failed and the retry succeeded.  ``draws`` holds the first
    pass's hypotheses and, where the driver retried, the retry's.
    Returns ``(R, t, success)`` of the window's pairs, or None where the
    reference retries and the driver did not (or the other way round)."""
    f0 = tuple(x[:-1] for x in feats)
    f1 = tuple(x[1:] for x in feats)
    R, t, ok = register(f0, f1, cfg, draws[0], low=low)
    retry = cfg["prior_gate_m"] > 0.0 and not bool(ok.all())
    if retry != (len(draws) > 1):
        return None
    if not retry:
        return R, t, ok
    eye = torch.eye(3, dtype=R.dtype, device=R.device)[None]
    zero = torch.zeros_like(t[:1])
    prev = ok[:-1]
    pR = torch.cat([eye, torch.where(prev[:, None, None], R[:-1], eye)])
    pt = torch.cat([zero, torch.where(prev[:, None], t[:-1], zero)])
    R2, t2, ok2 = register(f0, f1, cfg, draws[1], (pR, pt), low)
    use2 = ~ok & ok2
    return (torch.where(use2[:, None, None], R2, R),
            torch.where(use2[:, None], t2, t), ok | ok2)


def plausible(R, t, cfg: dict) -> bool:
    """The plausibility gate: a per-pair motion beyond ``max_rel_rot_deg``
    or ``max_rel_trans_m`` is an aliased consensus, not a success."""
    if cfg["max_rel_rot_deg"] <= 0:
        return True
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))
    return not (ang > cfg["max_rel_rot_deg"]
                or np.linalg.norm(t) > cfg["max_rel_trans_m"])


def register_step(f0, f1, prev, draws, cfg: dict, low=False):
    """The frame-by-frame driver's pair: plain registration, the retry with
    the previous pair's motion ``prev = (R, t)`` as the prior where it
    failed, the plausibility gate, and the previous motion where it still
    fails.  Returns ``(R (3, 3), t (3,), ok)`` host float64, or None where
    the reference retries and the driver did not (or the other way
    round)."""
    R, t, ok = register(f0, f1, cfg, draws[0], low=low)
    ok = bool(ok[0])
    retry = not ok and cfg["prior_gate_m"] > 0.0
    if retry != (len(draws) > 1):
        return None
    if retry:
        dev = f0[0].device
        prior = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                      for a in prev)
        R, t, ok = register(f0, f1, cfg, draws[1], prior, low)
        ok = bool(ok[0])
    R = R[0].double().cpu().numpy()
    t = t[0].double().cpu().numpy()
    ok = ok and plausible(R, t, cfg)
    if not ok:
        R, t = prev
    return R, t, ok
