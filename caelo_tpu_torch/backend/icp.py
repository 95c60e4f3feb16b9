"""Iterative closest point, batched over spans (port of
``caelo_tpu/backend/icp.py``).

The JAX module solves one pair per call and vmaps it over keyframe spans;
here every function takes a leading span axis ``S`` and solves all spans in
one fixed-trip loop with masked "done" freezing.  Correspondence is the
brute-force nearest neighbour of the squared-distance expansion
``q2 + r2 - 2 q.r``, tiled over 1024 queries, as the JAX package computes
it with XLA (its Pallas NN kernel was deleted); the product goes to
``torch.bmm`` in full float32 (TF32 off, ``caelo_tpu_torch.setup_device``).

Once every lane of a batch is frozen, later trips change nothing, so the
loop may stop early (``early_exit``): the result is the same as after all
``max_iters`` trips.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import IcpConfig
from ..geometry import se3


def nearest_neighbors(query: torch.Tensor, query_mask: torch.Tensor,
                      ref: torch.Tensor, ref_mask: torch.Tensor,
                      chunk: int = 1024):
    """For each query point, the index and distance of its nearest
    reference point, batched over leading axes: ``query (..., N, 3)``,
    ``ref (..., M, 3)`` -> ``idx (..., N)`` int64, ``dist (..., N)``.

    Invalid reference points are pushed to +inf; invalid queries get an
    infinite distance.  Equal distances go to the lower reference index.
    """
    r2 = torch.where(ref_mask, (ref * ref).sum(-1), torch.inf)
    refT = ref.transpose(-1, -2)
    idx = torch.cat([
        # (q2 + r2) - 2 q.r, rounded as the JAX expression is (the product
        # by 2 is exact)
        ((qc * qc).sum(-1)[..., :, None] + r2[..., None, :])
        .sub_(torch.matmul(qc, refT), alpha=2.0).argmin(-1)
        for qc in query.split(chunk, dim=-2)], -1)
    # the expansion cancels catastrophically for near-zero distances:
    # recompute the winning distance exactly from the gathered point
    nn = ref.gather(-2, idx[..., None].expand(*idx.shape, 3))
    d2 = ((query - nn) ** 2).sum(-1)
    dist = torch.sqrt(torch.clamp_min(
        torch.where(query_mask, d2, torch.inf), 0.0))
    return idx, dist


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for ``x (S, M, C)``, ``idx (S, N)``."""
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


class IcpResult(NamedTuple):
    R: torch.Tensor          # (S, 3, 3)
    t: torch.Tensor          # (S, 3)
    success: torch.Tensor    # (S,) bool
    n_inliers: torch.Tensor  # (S,) int32
    iters: torch.Tensor      # (S,) int32
    # saturated mean point-to-nearest distance of the point-to-point source
    # cloud at the initial pose and at the end (icp_hybrid only; zeros from
    # icp_point_to_point, as in the JAX module)
    init_res: torch.Tensor
    final_res: torch.Tensor


_RES_CAP = 2.0   # metres; saturation bound for the residual metric


def _sat_mean(dist, mask):
    w = mask.to(torch.float32)
    return ((torch.clamp_max(torch.where(mask, dist, 0.0), _RES_CAP) * w
             ).sum(-1) / torch.clamp_min(w.sum(-1), 1.0))


class _Loop:
    """The state and bookkeeping both ICP variants share: the pose so far,
    the done mask, the inlier count and trip count of the last step taken,
    and the threshold decay (``caelo_tpu/backend/icp.py:107-123``)."""

    def __init__(self, S, device, cfg: IcpConfig):
        self.cfg = cfg
        self.R = torch.eye(3, device=device).repeat(S, 1, 1)
        self.t = torch.zeros((S, 3), device=device)
        self.done = torch.zeros(S, dtype=torch.bool, device=device)
        self.n_in = torch.zeros(S, dtype=torch.int32, device=device)
        self.iters = torch.zeros(S, dtype=torch.int32, device=device)

    def step(self, i, tgt, src, w):
        """Solve one weighted Horn step; return the frozen-where-done
        increment ``(Rd, td)`` and the mask of lanes whose gates decay."""
        cfg = self.cfg
        n = w.sum(-1).to(torch.int32)
        enough = n >= cfg.min_inliers
        Rd, td = se3.solve_rigid_horn(tgt, src, w)
        step_ok = ~self.done & enough
        Rd = torch.where(step_ok[:, None, None], Rd,
                         torch.eye(3, device=Rd.device))
        td = torch.where(step_ok[:, None], td, 0.0)
        self.R, self.t = se3.compose(Rd, td, self.R, self.t)
        d_ang = torch.linalg.vector_norm(se3.rotmat_to_euler_xyz_deg(Rd),
                                         dim=-1)
        d_t = torch.linalg.vector_norm(td, dim=-1)
        converged = ((i >= cfg.max_iters // 2) & (d_ang < cfg.epsilon)
                     & (d_t < cfg.epsilon))
        small = ((d_ang < cfg.small_shift_threshold)
                 & (d_t < cfg.small_shift_threshold))
        self.n_in = torch.where(step_ok, n, self.n_in)
        self.iters = torch.where(step_ok, i + 1, self.iters)
        self.done = self.done | converged | ~enough
        return Rd, td, step_ok & small

    def trips(self, early_exit: bool):
        """Trip indices; with ``early_exit``, stop after the first trip that
        began with every lane frozen (that trip still refreshes the
        residual of the final pose; every later one repeats it).  A lane
        can only converge from trip ``max_iters // 2`` on, so the done mask
        is read on the host from there."""
        for i in range(self.cfg.max_iters):
            frozen = (early_exit and i > self.cfg.max_iters // 2
                      and bool(self.done.all()))
            yield i
            if frozen:
                return

    def result(self, init_res, final_res) -> IcpResult:
        return IcpResult(self.R, self.t, self.n_in >= self.cfg.min_inliers,
                         self.n_in, self.iters, init_res, final_res)


@torch.no_grad()
def icp_point_to_point(pc0: torch.Tensor, mask0: torch.Tensor,
                       pc1: torch.Tensor, mask1: torch.Tensor,
                       cfg: IcpConfig = IcpConfig(),
                       early_exit: bool = True) -> IcpResult:
    """Classic ICP aligning ``pc1 (S, N, 3)`` onto ``pc0 (S, M, 3)`` per
    span."""
    loop = _Loop(pc0.shape[0], pc0.device, cfg)
    thr = torch.full((pc0.shape[0],), cfg.inlier_threshold, device=pc0.device)
    pc1c = pc1
    for i in loop.trips(early_exit):
        idx, dist = nearest_neighbors(pc1c, mask1, pc0, mask0)
        w = ((dist < thr[:, None]) & mask1).to(torch.float32)
        Rd, td, decay = loop.step(i, _gather(pc0, idx), pc1c, w)
        pc1c = se3.apply(Rd, td, pc1c)
        thr = torch.where(decay, thr * cfg.decay, thr)
    zero = torch.zeros_like(thr)
    return loop.result(zero, zero)


@torch.no_grad()
def icp_hybrid(pc0: torch.Tensor, mask0: torch.Tensor,
               pc1: torch.Tensor, mask1: torch.Tensor,
               planar0: torch.Tensor, pmask0: torch.Tensor,
               planar1: torch.Tensor, pmask1: torch.Tensor,
               cfg: IcpConfig = IcpConfig(), thr_scale: float = 1.0,
               early_exit: bool = True) -> IcpResult:
    """Joint point-to-point + point-to-plane ICP per span.

    ``planar*`` are ``(S, P, 6)`` rows of (x, y, z, nx, ny, nz).  A planar
    correspondence pairs a frame-1 planar point with its pedal point on the
    matched frame-0 plane, weighted into the same Horn solve as the point
    pairs.  ``thr_scale`` multiplies the initial inlier gates (the retry
    rung of ``refine_odometry_batched``); the decay still tightens them.
    """
    S, dev = pc0.shape[0], pc0.device
    loop = _Loop(S, dev, cfg)
    p0_xyz, n0 = planar0[..., 0:3], planar0[..., 3:6]
    thr0 = torch.full((S,), cfg.inlier_threshold * thr_scale, device=dev)
    thr1 = torch.full((S,), cfg.plane_inlier_threshold * thr_scale,
                      device=dev)
    pc1c, pl1c = pc1, planar1[..., 0:3]
    init_res = final_res = torch.zeros(S, device=dev)
    for i in loop.trips(early_exit):
        # point-to-point correspondences
        idx, dist = nearest_neighbors(pc1c, mask1, pc0, mask0)
        final_res = _sat_mean(dist, mask1)
        if i == 0:
            init_res = final_res
        w_pt = ((dist < thr0[:, None]) & mask1).to(torch.float32)
        # point-to-plane: match planar1 -> planar0 xyz, project to the pedal
        pidx, pdist = nearest_neighbors(pl1c, pmask1, p0_xyz, pmask0)
        nrm = _gather(n0, pidx)
        d2pl = (nrm * (_gather(p0_xyz, pidx) - pl1c)).sum(-1)
        pedal = pl1c + nrm * d2pl[..., None]
        w_pl = ((pdist < thr1[:, None]) & (d2pl.abs() < thr0[:, None])
                & pmask1).to(torch.float32)
        Rd, td, decay = loop.step(
            i, torch.cat([_gather(pc0, idx), pedal], 1),
            torch.cat([pc1c, pl1c], 1), torch.cat([w_pt, w_pl], 1))
        pc1c = se3.apply(Rd, td, pc1c)
        pl1c = se3.apply(Rd, td, pl1c)
        thr0 = torch.where(decay, thr0 * cfg.decay, thr0)
        thr1 = torch.where(decay, thr1 * cfg.plane_decay, thr1)
    return loop.result(init_res, final_res)
