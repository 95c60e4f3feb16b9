"""Where two runs of a baseline detector may rightly disagree.

Two runs of ``iss`` / ``harris`` / ``sift`` on the same cloud -- the card
and the CPU, or two builds of a float32 eigen solver -- round differently,
so a point whose score sits on one of the detector's decision thresholds
can be a keypoint in one run and not in the other.  :func:`explain_flips`
names, for each such point, the threshold it sits on, from one run's own
intermediate values:

* a gate (ISS's gamma ratios, Harris's response floor, SIFT's contrast);
* the NMS comparison with its best neighbour (or a neighbour's gate);
* the k-th score of the final top-k, or the place next to it that another
  flip moved;
* for Harris, a neighbour whose normal is undefined: the two smallest
  eigenvalues of its covariance within 1e-2 of the largest, so the solvers
  may return any vector of that plane.

:func:`neighbor_ties` holds two runs' neighbour lists to each other the
same way: they may differ only among points tied at the k-th place (the
baselines' KNN, and the patch KNN of ``voxel/grid.py``).

Distances are in units of the stated tolerance: ISS's ratios 1e-4 and its
scores 1e-6 of the frame's largest eigenvalue (about twice a float32 eigen
solver's bound, 3 eps |C|); Harris's response 1e-4 of the frame's largest;
SIFT's DoG comparisons and contrast 1e-5.
"""
from __future__ import annotations

import torch

from ..frontend import baselines as bl

_INF = float("inf")
GAMMA_TOL, ISS_TOL, HARRIS_TOL, DOG_TOL = 1e-4, 1e-6, 1e-4, 1e-5
UNDEFINED_GAP = 1e-2


def _nms(pts, mask, idx, score, radius):
    """``(|score - best neighbour's|, near, best)``; inf where either is not
    finite."""
    near = mask[idx] & (
        torch.linalg.norm(pts[idx] - pts[:, None, :], dim=-1) <= radius)
    best = torch.where(near, score[idx], -_INF).max(1).values
    fin = torch.isfinite(score) & torch.isfinite(best)
    return torch.where(fin, (score - best).abs(), _INF), near, best


def neighbor_ties(pts: torch.Tensor, mask: torch.Tensor, idx_a: torch.Tensor,
                  idx_b: torch.Tensor, rel: float = 1e-6,
                  queries: torch.Tensor | None = None,
                  query_mask: torch.Tensor | None = None) -> int:
    """The number of valid rows whose neighbour sets differ between two
    ``_knn_neighbors`` runs on ``pts (N, 3)``; raises unless every point
    ``j`` in one set of such a row ``i`` but not the other scores within
    ``rel (|q_i|^2 + |p_j|^2)`` of the row's k-th score
    (``_knn_neighbors``'s formula in float64, the k-th point taken from
    ``idx_a``).  The float32 formula rounds relative to those terms, not
    to the distance it leaves: at 100 m from the origin one unit in the
    last place of ``|p|^2`` is 1e-3 m^2.

    The query of row ``i`` is ``q_i = p_i``, or ``queries[i]`` when given
    (the patch KNN's keypoint voxels against the occupied voxels), the
    rows then valid where ``query_mask`` is; with ``queries`` the lists
    may come in any order and the k-th score is the lowest of ``idx_a``'s
    row."""
    idx_a, idx_b, mask = idx_a.cpu(), idx_b.cpu(), mask.cpu()
    p = pts.detach().cpu().double()
    q = p if queries is None else queries.detach().cpu().double()
    rows_ok = mask if queries is None else query_mask.cpu()
    differ = (idx_a.sort(1).values != idx_b.sort(1).values).any(1) & rows_ok
    rows = differ.nonzero()[:, 0].tolist()
    p2 = (p * p).sum(1)
    q2 = (q * q).sum(1)
    p2m = torch.where(mask, p2, 1e12)
    for i in rows:
        score = 2.0 * (p @ q[i]) - p2m - q2[i]
        kth = float(score[idx_a[i, -1]] if queries is None
                    else score[idx_a[i]].min())
        odd = set(idx_a[i].tolist()) ^ set(idx_b[i].tolist())
        if any(abs(float(score[j]) - kth) > rel * float(q2[i] + p2[j])
               for j in odd):
            raise AssertionError(f"neighbour row {i} differs beyond a tie "
                                 "at the k-th place")
    return len(rows)


def decision_margins(name: str, pts: torch.Tensor, mask: torch.Tensor,
                     n_keypoints: int, idx: torch.Tensor | None = None):
    """Per point of ``pts (N, 3)``: the distance of the detector's
    decisions to their thresholds in units of tolerance (<= 1: rounding
    may flip it), and the final score before the top-k (-inf where the
    point is no candidate).  Runs the detector's stages with its default
    parameters on the device of ``pts``, on the neighbour lists ``idx``
    (default: ``_knn_neighbors`` at k = 64)."""
    if idx is None:
        idx = bl._knn_neighbors(pts, mask, 64)
    if name == "sift":
        dog, sig, d2, okn = bl._sift_scale_space(pts, mask, idx, 0.5, 4, 8)
        m = torch.full_like(dog[0], _INF)
        score = torch.full_like(dog[0], -_INF)
        for ell in range(len(sig) - 3):
            lo, mid, hi = dog[ell], dog[ell + 1], dog[ell + 2]
            okr = okn & (d2 <= (2.0 * sig[ell + 1]) ** 2)
            nmax = torch.where(okr, mid[idx], -_INF).max(1).values
            nmin = torch.where(okr, mid[idx], _INF).min(1).values
            for q in (mid - lo, mid - hi, mid - nmax, mid - nmin,
                      mid.abs() - 0.1):
                m = torch.minimum(m, torch.where(torch.isfinite(q), q.abs(),
                                                 _INF) / DOG_TOL)
            ext = (((mid > lo) & (mid > hi) & (mid >= nmax))
                   | ((mid < lo) & (mid < hi) & (mid <= nmin)))
            ok = mask & ext & (mid.abs() > 0.1) & (okr.sum(1) >= 2)
            score = torch.maximum(score, torch.where(ok, mid.abs(), -_INF))
        tol = DOG_TOL
    else:
        radius = 2.0 if name == "iss" else 1.0
        cov, n_nbr = bl._neighbor_cov(pts, mask, idx, radius)
        ev, vecs = bl._eigh(cov)
        if name == "iss":
            r21 = ev[:, 1] / ev[:, 2].clamp_min(1e-12)
            r32 = ev[:, 0] / ev[:, 1].clamp_min(1e-12)
            gate = torch.minimum((r21 - 0.975).abs(),
                                 (r32 - 0.975).abs()) / GAMMA_TOL
            ok = mask & (n_nbr >= 5) & (r21 < 0.975) & (r32 < 0.975)
            score = torch.where(ok, ev[:, 0], -_INF)
            tol = ISS_TOL * float(ev[:, 2].max())
        elif name == "harris":
            nbr_n = vecs[:, :, 0][idx]
            near = mask[idx] & (torch.linalg.norm(
                pts[idx] - pts[:, None, :], dim=-1) <= radius)
            C = torch.einsum("nki,nkj->nij",
                             nbr_n * near.to(torch.float32)[..., None], nbr_n)
            tr = C[:, 0, 0] + C[:, 1, 1] + C[:, 2, 2]
            resp = torch.linalg.det(C) - 0.04 * tr * tr
            tol = HARRIS_TOL * float(resp.abs().max())
            gate = (resp - 1e-3).abs() / tol
            score = torch.where(mask & (n_nbr >= 5) & (resp > 1e-3), resp,
                                -_INF)
        else:
            raise ValueError(name)
        nms, near, best = _nms(pts, mask, idx, score, radius)
        # a neighbour's gate flip changes this point's NMS outcome too
        nb_gate = torch.where(near, gate[idx], _INF).min(1).values
        m = torch.minimum(torch.minimum(gate, nb_gate), nms / tol)
        if name == "harris":
            gap = (ev[:, 1] - ev[:, 0]) / ev[:, 2].clamp_min(1e-30)
            undefined = (near & (gap < UNDEFINED_GAP)[idx]).any(1)
            m = torch.where(undefined, 0.0, m)
        score = torch.where(mask & (score >= best), score, -_INF)
    cand = torch.sort(score[torch.isfinite(score)], descending=True).values
    if len(cand) > n_keypoints:            # the k-th score is a threshold
        m = torch.minimum(m, (score - cand[n_keypoints - 1]).abs() / tol)
    return m, score


def explain_flips(name: str, pts: torch.Tensor, mask: torch.Tensor,
                  key_a: torch.Tensor, mask_a: torch.Tensor,
                  key_b: torch.Tensor, mask_b: torch.Tensor,
                  n_keypoints: int, idx: torch.Tensor | None = None) -> dict:
    """Two runs' keypoints ``(key_a, mask_a)``, ``(key_b, mask_b)`` of
    detector ``name`` on ``pts`` (rows of the cloud): ``{"a", "b", "flips",
    "at_threshold", "at_cut", "unexplained"}`` counts, the margins taken
    from a run of :func:`decision_margins` on ``pts``'s device."""
    rows = {tuple(p): i for i, p in enumerate(pts.tolist())}
    pick = lambda kp, km: {rows[tuple(p)] for p in kp[km].tolist()}
    a, b = pick(key_a.cpu(), mask_a.cpu()), pick(key_b.cpu(), mask_b.cpu())
    flips = sorted(a ^ b)
    out = {"a": len(a), "b": len(b), "flips": len(flips), "at_threshold": 0,
           "at_cut": 0, "unexplained": 0}
    if not flips:
        return out
    margin, score = (x.cpu() for x in decision_margins(name, pts, mask,
                                                       n_keypoints, idx))
    near = [i for i in flips if margin[i] <= 1.0]
    rank = torch.empty(len(score), dtype=torch.long)
    rank[torch.sort(score, descending=True, stable=True).indices] = \
        torch.arange(len(score))
    # a flip moves the k-th place by one: what it lets in or pushes out
    # sits next to the cut
    cut = [i for i in flips if margin[i] > 1.0
           and abs(int(rank[i]) - n_keypoints) <= len(near)]
    out.update(at_threshold=len(near), at_cut=len(cut),
               unexplained=len(flips) - len(near) - len(cut))
    return out
