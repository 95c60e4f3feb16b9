"""ScanContext-style polar place signatures for loop-closure recall (port of
``caelo_tpu/backend/scancontext.py``).

* ``scan_context``: an (R x S) polar grid of the max point height over a
  frame's keypoints, one ``scatter_reduce_("amax")``;
* ``ring_key``: the rotation-invariant occupancy fraction per ring;
* ``align_score``: the best column-shifted cosine similarity of two scan
  contexts and the yaw that aligns them;
* ``sc_correlation_matrix``: the all-pairs, all-shift correlation of a
  trajectory as S rolled matmuls with a running max (``sc_correlation_rows``:
  a block of its query rows, bit for bit).

Every function is batched over leading axes.
"""
from __future__ import annotations

import math

import torch

from ..xlamath import atan2, hypot, mul_reciprocal
N_RINGS = 16
N_SECTORS = 64


def scan_context(pts: torch.Tensor, mask: torch.Tensor,
                 n_rings: int = N_RINGS, n_sectors: int = N_SECTORS,
                 max_range: float = 80.0) -> torch.Tensor:
    """``(..., K, 3)`` points -> ``(..., n_rings, n_sectors)`` max-height
    polar signature.

    Empty bins are 0; heights are shifted by +2 m and clipped to [0, 10] so
    ground-level structure stays positive and empty stays distinguishable.
    """
    batch = pts.shape[:-2]
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    r = hypot(x, y)
    ring = torch.clamp(
        (mul_reciprocal(r, max_range) * n_rings).to(torch.int32), 0,
        n_rings - 1)
    theta = atan2(y, x)                        # [-pi, pi)
    sector = torch.clamp(
        (mul_reciprocal(theta + math.pi, 2.0 * math.pi)
         * n_sectors).to(torch.int32),
        0, n_sectors - 1)
    RS = n_rings * n_sectors
    seg = (ring * n_sectors + sector).long().reshape(-1, pts.shape[-2])
    seg = seg + RS * torch.arange(seg.shape[0], device=pts.device)[:, None]
    h = torch.clamp(z + 2.0, 0.0, 10.0)
    h = torch.where(mask & (r < max_range), h, -torch.inf)
    sc = torch.full((seg.shape[0] * RS,), -torch.inf, dtype=h.dtype,
                    device=h.device)
    sc.scatter_reduce_(0, seg.reshape(-1), h.reshape(-1), "amax")
    sc = torch.where(torch.isfinite(sc), sc, 0.0)
    return sc.reshape(*batch, n_rings, n_sectors)


def ring_key(sc: torch.Tensor) -> torch.Tensor:
    """``(..., R, S)`` -> ``(..., R)`` occupancy fraction per ring."""
    return (sc > 0.0).to(torch.float32).mean(-1)


def _yaw_of_shift(s: torch.Tensor, S: int) -> torch.Tensor:
    yaw = 2.0 * math.pi * s.to(torch.float32) / S
    return torch.where(yaw > math.pi, yaw - 2.0 * math.pi, yaw)


def align_score(sc_a: torch.Tensor, sc_b: torch.Tensor):
    """Best circular column alignment of two scan contexts ``(..., R, S)``.

    Returns ``(score, yaw_rad)``: the max over all sector shifts of the
    mean column-wise cosine similarity (over columns non-empty in both),
    and the yaw rotating frame *b* into frame *a* at that shift; the first
    shift wins a tie.
    """
    S = sc_a.shape[-1]

    def norm_cols(m):
        n = torch.linalg.vector_norm(m, dim=-2)
        return m / torch.clamp_min(n, 1e-9)[..., None, :], n > 1e-9

    a_n, a_ok = norm_cols(sc_a)
    b_n, b_ok = norm_cols(sc_b)
    M = a_n.transpose(-1, -2) @ b_n                      # (..., S, S)
    ok = a_ok[..., :, None] & b_ok[..., None, :]
    Mw = torch.where(ok, M, 0.0)
    cnt = ok.to(torch.float32)
    j = torch.arange(S, device=sc_a.device)
    # score(s) = mean_j M[j, (j+s) % S]
    idx = (j[None, :] + j[:, None]) % S                  # idx[s, j]
    num = Mw[..., j[None, :], idx].sum(-1)
    den = torch.clamp_min(cnt[..., j[None, :], idx].sum(-1), 1.0)
    scores = num / den
    s = torch.argmax(scores, -1)
    return scores.gather(-1, s[..., None])[..., 0], _yaw_of_shift(s, S)


def align_score_batch(sc_q: torch.Tensor, sc_cands: torch.Tensor):
    """``(R, S)`` query vs ``(N, R, S)`` candidates -> (scores, yaws)."""
    return align_score(sc_q.expand_as(sc_cands), sc_cands)


# query rows per matmul of the correlation matrix, by device type.  The
# blocks start at multiples of it, so a split of the rows at block
# boundaries (the sharded search, parallel/pipeline.py) repeats the whole
# matrix's matmuls exactly: a row's float32 sums depend on the matmul's row
# count.  MKL's sgemm keeps its rate at 64 rows; cuBLAS needs about a
# thousand to fill the card (tools/ab_sc.py)
SC_ROW_BLOCK = {"cpu": 64, "cuda": 1024}


def sc_row_block(device) -> int:
    """``SC_ROW_BLOCK`` of ``device``'s type."""
    return SC_ROW_BLOCK[torch.device(device).type]


def sc_correlation_matrix(scs: torch.Tensor):
    """All-pairs, all-shift ScanContext cross-correlation over a trajectory.

    ``scs``: ``(N, R, S)``.  Returns ``(score, yaw)``, both ``(N, N)``:
    ``score[i, j]`` is the best whole-matrix cosine similarity of frames i
    and j over all S circular sector shifts of j (the first shift wins a
    tie), ``yaw[i, j]`` the yaw rotating frame j into frame i at that shift,
    as in :func:`align_score`.  S matmuls of the row-normalised signature
    matrix against its sector-rolled self with a running max: live memory
    stays at two (N, N) buffers.
    """
    return sc_correlation_rows(scs, 0, scs.shape[0])


def sc_correlation_rows(scs: torch.Tensor, lo: int, hi: int):
    """Rows ``lo:hi`` of :func:`sc_correlation_matrix`, bit for bit: the
    query rows go in blocks of ``sc_row_block(scs.device)`` from a multiple
    of it, so ``lo`` must be one (``hi`` may be any row up to N)."""
    blk = sc_row_block(scs.device)
    if lo % blk:
        raise ValueError(f"lo={lo} is not a multiple of {blk}")
    N, R, S = scs.shape
    flat = scs.reshape(N, R * S)
    inv = 1.0 / torch.clamp_min(torch.linalg.vector_norm(flat, dim=1), 1e-9)
    A = flat * inv[:, None]
    best = torch.full((hi - lo, N), -torch.inf, dtype=torch.float32,
                      device=scs.device)
    best_s = torch.zeros((hi - lo, N), dtype=torch.int32, device=scs.device)
    for s in range(S):
        # roll by -s: <A[i], roll(B[j], -s)> matches align_score's scores[s]
        Bs = torch.roll(scs, -s, dims=-1).reshape(N, R * S) * inv[:, None]
        for b in range(0, hi - lo, blk):
            top, top_s = best[b:b + blk], best_s[b:b + blk]
            sim = A[lo + b:lo + b + len(top)] @ Bs.T
            upd = sim > top
            torch.where(upd, sim, top, out=top)
            top_s.masked_fill_(upd, s)
    return best, _yaw_of_shift(best_s, S)


def yaw_rotation(yaw) -> torch.Tensor:
    """Yaw (rad, about +z), a float or a tensor of any shape -> ``(..., 3,
    3)`` float32 rotations."""
    yaw = torch.as_tensor(yaw, dtype=torch.float32)
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)
