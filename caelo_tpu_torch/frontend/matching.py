"""Descriptor matching through a distance matmul (port of
``caelo_tpu/frontend/matching.py``).  Batched over leading axes: a window's
pairs are matched in one call."""
from __future__ import annotations

import torch

_INF = float("inf")


def squared_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(..., N, D), (..., M, D) -> (..., N, M)`` squared euclidean distances
    via ``||a||^2 + ||b||^2 - 2 a.b``."""
    a2 = (a * a).sum(-1)
    b2 = (b * b).sum(-1)
    ab = a @ b.transpose(-1, -2)
    return torch.clamp_min(a2[..., :, None] + b2[..., None, :] - 2.0 * ab, 0.0)


# multiplier of the row fingerprint: 0x9E3779B97F4A7C15 as a signed int64
_GOLDEN = -7046029254386353131


def _row_ids(bits: torch.Tensor) -> torch.Tensor:
    """``(N, D)`` int32 rows -> ``(N,)`` int64 ids, equal exactly where the
    rows are equal.  A multiplicative fingerprint groups the rows (one 1-D
    unique); each row is checked against its group's first row, and only
    when two fingerprints collide does a lexicographic unique decide."""
    N, D = bits.shape
    dev = bits.device
    mult = torch.arange(1, D + 1, dtype=torch.int64, device=dev) * _GOLDEN | 1
    fp = (bits.to(torch.int64) * mult).sum(-1)
    groups, ids = torch.unique(fp, return_inverse=True)
    first = torch.full(groups.shape, N, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, ids, torch.arange(N, device=dev), "amin")
    if torch.equal(bits[first[ids]], bits):
        return ids
    return torch.unique(bits, dim=0, return_inverse=True)[1]


def _zero_exact_duplicates(d2: torch.Tensor, codes0: torch.Tensor,
                           codes1: torch.Tensor) -> torch.Tensor:
    """``d2 (..., K0, K1)`` with the pairs of bit-equal rows set to 0; the
    cost is bounded by the rows, not the pairs."""
    *_, K0, D = codes0.shape
    K1 = codes1.shape[-2]
    rows = torch.cat([codes0.reshape(-1, K0, D), codes1.reshape(-1, K1, D)],
                     1)
    ids = _row_ids(rows.reshape(-1, D).view(torch.int32)).view(-1, K0 + K1)
    same = ids[:, :K0, None] == ids[:, None, K0:]
    return torch.where(same.view(d2.shape), 0.0, d2)


def match_descriptors(codes0, mask0, codes1, mask1,
                      pts0=None, pts1=None, prior_R=None, prior_t=None,
                      gate_m: float = 0.0, ratio: float = 0.0):
    """For each frame-1 keypoint, the nearest frame-0 descriptor.

    With a motion prior (``pts0``, ``pts1``, ``prior_R``, ``prior_t``,
    ``gate_m > 0``) only frame-0 keypoints within ``gate_m`` metres of the
    prior-predicted frame-1 keypoint are eligible; ``ratio > 0`` adds the
    Lowe distinctiveness gate.

    Exact duplicate descriptors (identical patches) are at distance 0: the
    expansion leaves rounding noise of either sign there, which the clamp
    turns into 0 or a tiny positive depending on the matmul's summation
    order, and the argmin's tie order and the Lowe gate turn on it.  On the
    duplicates the pipeline meets, XLA on the CPU gives 0.

    Returns ``(pair_idx (..., K1) int64, pair_mask (..., K1), pair_dist
    (..., K1))``.
    """
    d2 = squared_distance_matrix(codes0, codes1)           # (..., K0, K1)
    d2 = _zero_exact_duplicates(d2, codes0, codes1)
    d2 = torch.where(mask0[..., :, None], d2, _INF)
    if gate_m > 0.0 and pts0 is not None:
        pred1 = pts1 @ prior_R.transpose(-1, -2) + prior_t[..., None, :]
        g2 = squared_distance_matrix(pts0, pred1)
        d2 = torch.where(g2 <= gate_m * gate_m, d2, _INF)
    pair_idx = torch.argmin(d2, dim=-2)
    pair_d2 = d2.gather(-2, pair_idx[..., None, :])[..., 0, :]
    pair_mask = mask1 & torch.isfinite(pair_d2)
    if ratio > 0.0:
        second = torch.topk(d2, 2, dim=-2, largest=False).values[..., 1, :]
        distinct = pair_d2 <= (ratio * ratio) * second
        pair_mask = pair_mask & (distinct | ~torch.isfinite(second))
    return pair_idx, pair_mask, torch.sqrt(torch.where(pair_mask, pair_d2, 0.0))
