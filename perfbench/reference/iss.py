"""Intrinsic Shape Signatures keypoints, plain (PCL's ISSKeypoint3D with
the parameters of the CAE-LO reference's detector comparison,
``PclKeyPts.py:41-46``): the k nearest points by a distance matmul,
the covariance of the neighbours within the salient radius, its
eigenvalues, the gamma-ratio gates, saliency lambda3 and a radius NMS."""
from __future__ import annotations

import torch

from .frontend import matmul, tf32, top_k

_INF = float("inf")
_EIGH_BATCH = 16384        # cuSOLVER's batched solver takes fewer than 32,768


def knn(pts, mask, k: int, low=False, chunk: int = 512):
    """``(N, k)`` indices of each point's k nearest points (score ``2 q.p -
    |p|^2 - |q|^2``, masked points at ``|p|^2 = 1e12``), score descending
    and the lower index first among equal scores."""
    p2m = torch.where(mask, (pts * pts).sum(-1), 1e12)
    out = []
    for qc in pts.split(chunk):
        score = (2.0 * matmul(qc, pts.T, low) - p2m[None, :]
                 - (qc * qc).sum(-1)[:, None])
        vals, idx = torch.topk(score, k, dim=-1)
        idx, perm = idx.sort(-1)
        order = vals.gather(-1, perm).sort(dim=-1, descending=True,
                                           stable=True).indices
        out.append(idx.gather(-1, order))
    return torch.cat(out)


def keypoints(pts, mask, det: dict, n_keypoints: int, low=False):
    """``(key_pts (n, 3), key_mask (n,))`` of ``pts (N, 3)``; ``det`` holds
    ``k``, ``salient_radius``, ``nms_radius``, ``gamma_21``, ``gamma_32``
    and ``min_neighbors``."""
    idx = knn(pts, mask, det["k"], low)
    nbr = pts[idx]
    dist = torch.linalg.norm(nbr - pts[:, None, :], dim=-1)
    ok = mask[idx] & mask[:, None] & (dist <= det["salient_radius"])
    w = ok.to(torch.float32)[..., None]
    cnt = w.sum(1).clamp_min(1.0)
    mean = (nbr * w).sum(1) / cnt
    c = (nbr - mean[:, None, :]) * w
    r = tf32 if low else (lambda x: x)
    cov = torch.einsum("nki,nkj->nij", r(c), r(c)) / cnt[..., None]
    evals = torch.cat([torch.linalg.eigh(b)[0]
                       for b in cov.split(_EIGH_BATCH)])
    l3, l2, l1 = evals[:, 0], evals[:, 1], evals[:, 2]
    good = (mask & (ok.sum(1) >= det["min_neighbors"])
            & (l2 / l1.clamp_min(1e-12) < det["gamma_21"])
            & (l3 / l2.clamp_min(1e-12) < det["gamma_32"]))
    score = torch.where(good, l3, -_INF)
    near = mask[idx] & (dist <= det["nms_radius"])
    is_max = score >= torch.where(near, score[idx], -_INF).max(1).values
    final = torch.where(mask & is_max & torch.isfinite(score), score, -_INF)
    vals, top = top_k(final, n_keypoints)
    key_mask = torch.isfinite(vals)
    return pts[top] * key_mask[:, None], key_mask
