"""Multi-frame burst rescue: scan-to-local-map registration over degraded
sensor spans (port of ``caelo_tpu/backend/burst.py``).

Consecutive degraded frames see nearly the same narrow sensor-locked wedge,
so pairwise registration through such a burst is informationally
marginal; across the burst the visible wedge sweeps different world
structure, so the union of the burst's frames, anchored by the healthy
frame before it, covers a far wider field of view than any single frame.

``burst_map_icp`` registers each burst frame against a progressively
accumulated local map in the entry anchor's frame.  The JAX version is one
jitted ``lax.scan`` per sweep over a static ``max_span`` with fixed-trip
ICPs; here every sweep is a Python loop over the span's active frames only
(no compile buckets), and each frame's ICP stops after the trip that
freezes it, which returns what all ``max_iters`` trips return.  The map is
a fixed-capacity point buffer, each frame writing a fixed-size subsample
at its own slot.  Each frame's result carries the saturated-residual pair
of the pairwise ICP, so ``rescue_bursts`` applies the same residual-gain
acceptance as refinement; its host logic is a numpy copy of the JAX one.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import List

import numpy as np
import torch

from ..config import IcpConfig, PipelineConfig
from ..geometry import se3
from .icp import _sat_mean, nearest_neighbors

GATE_RANGE = 10.0     # metres at which icp_vs_map's angular gate term = thr


def gate_slope(thr: np.float32) -> np.float32:
    """float32 ``thr / GATE_RANGE`` as the jitted JAX loop computes it: a
    product with the reciprocal (XLA's rewrite of a division by a
    constant), which a true division misses by an ulp for ~20 % of
    thresholds."""
    return thr * (np.float32(1) / np.float32(GATE_RANGE))


class MapIcp:
    """The state of one map ICP between trips: the cloud ``pc (E, 3)``,
    moved by ``(R0, t0)``, onto the map ``mpts (M, 3)``; one lane of
    ``caelo_tpu/backend/burst.py:96-156``.

    The inlier gate is range-proportional, ``dist < max(thr, range * thr /
    GATE_RANGE)``: a narrow-wedge frame observes rotation mostly through
    its far points, which a flat metric gate excludes while the rotation
    error is still large.  A trip whose step is refused (too few inliers)
    or that converges freezes the solve (``done``); every later trip
    applies the identity and leaves the state as it is.  The step logic
    reads ``(n, d_ang, d_t)`` on the host once per trip and compares in
    float32.
    """

    def __init__(self, pc, msk, mpts, mmsk, R0, t0, icp_cfg: IcpConfig,
                 thr_scale: float):
        self.msk, self.mpts, self.mmsk = msk, mpts, mmsk
        self.R0, self.t0, self.cfg = R0, t0, icp_cfg
        self.eye = torch.eye(3, dtype=pc.dtype, device=pc.device)
        self.zero = torch.zeros(3, dtype=pc.dtype, device=pc.device)
        self.R, self.t = self.eye, self.zero
        self.pcc = se3.apply(R0, t0, pc)
        # sensor frame: invariant under the solve
        self.ranges = torch.linalg.vector_norm(pc, dim=-1)
        self.thr = np.float32(icp_cfg.inlier_threshold * thr_scale)
        self.done, self.n_in = False, 0
        self.r0m = self.rlast = None

    def trip(self, i: int):
        """Trip ``i``: correspondences, the gated Horn step, the step
        logic."""
        f32, cfg = np.float32, self.cfg
        eps, small = f32(cfg.epsilon), f32(cfg.small_shift_threshold)
        idx, dist = nearest_neighbors(self.pcc, self.msk, self.mpts,
                                      self.mmsk)
        if not self.done:
            self.rlast = _sat_mean(dist, self.msk)
            if i == 0:
                self.r0m = self.rlast
        gate = torch.clamp_min(self.ranges * float(gate_slope(self.thr)),
                               float(self.thr))
        w = ((dist < gate) & self.msk).to(torch.float32)
        Rd, td = se3.solve_rigid_horn(self.mpts[idx], self.pcc, w)
        d_ang = torch.linalg.vector_norm(se3.rotmat_to_euler_xyz_deg(Rd))
        n, d_ang, d_t = torch.stack([
            w.sum(), d_ang, torch.linalg.vector_norm(td)]).cpu().numpy()
        enough = int(n) >= cfg.min_inliers
        step_ok = not self.done and enough
        if not step_ok:                 # frozen or refused: the identity
            Rd, td, d_ang, d_t = self.eye, self.zero, f32(0.0), f32(0.0)
        self.pcc = se3.apply(Rd, td, self.pcc)
        self.R, self.t = se3.compose(Rd, td, self.R, self.t)
        if step_ok:
            if d_ang < small and d_t < small:
                self.thr = f32(self.thr * f32(cfg.decay))
            self.n_in = int(n)
        converged = i >= cfg.max_iters // 2 and d_ang < eps and d_t < eps
        self.done = self.done or converged or not enough

    def result(self):
        """``(R, t, ok, r0, rlast)``: the composed frame -> map pose
        re-projected to SO(3), success (the last accepted step kept
        ``min_inliers``), and the saturated mean residual at the initial
        pose and at the last trip before the solve froze."""
        ok = self.n_in >= self.cfg.min_inliers
        Rn, tn = se3.compose(self.R, self.t, self.R0, self.t0)
        return se3.project_so3(Rn), tn, ok, self.r0m, self.rlast


def icp_vs_map(pc: torch.Tensor, msk: torch.Tensor, mpts: torch.Tensor,
               mmsk: torch.Tensor, R0: torch.Tensor, t0: torch.Tensor,
               icp_cfg: IcpConfig, thr_scale: float):
    """``MapIcp`` run to its first frozen trip, which returns what all
    ``max_iters`` trips return (JAX runs them all in a ``fori_loop``).
    Returns ``MapIcp.result()``."""
    st = MapIcp(pc, msk, mpts, mmsk, R0, t0, icp_cfg, thr_scale)
    for i in range(icp_cfg.max_iters):
        if st.done:
            break
        st.trip(i)
    return st.result()


@torch.no_grad()
def burst_map_icp(ext_pts: torch.Tensor, ext_mask: torch.Tensor,
                  rel_Rs: torch.Tensor, rel_ts: torch.Tensor,
                  span_len: int, icp_cfg: IcpConfig = IcpConfig(),
                  frame_budget: int = 2048, thr_scale: float = 2.0):
    """Joint registration of frames ``1..span_len`` against a growing local
    map in frame 0's coordinates.

    Args:
      ext_pts: ``(M + 1, E, 3)`` extended refinement clouds: frame 0 is the
        healthy entry anchor, frames ``1..span_len`` the burst interior and
        the healthy exit anchor as the last active frame.
      ext_mask: ``(M + 1, E)`` validity.
      rel_Rs/rel_ts: ``(M, 3, 3) / (M, 3)`` initial relative poses (lidar
        frame, k -> k+1 mapping frame k+1 into frame k).
      span_len: number of active pairs (``<= M``); slots past it are not
        solved and pass their input rels through.
      thr_scale: widening of the initial inlier gate.

    Returns ``(new_rel_Rs, new_rel_ts, ok, init_res, final_res, R_cl, t_cl,
    ok_cl, cl_res)``: per-pair corrected rels (input rels where inactive or
    failed), per-frame success, the per-frame residuals at the input and at
    the final pose against the complete self-excluded map, and the exit
    anchor's registration against the entry anchor alone.
    """
    L = int(span_len)
    M = rel_Rs.shape[0]
    dev, dt = ext_pts.device, ext_pts.dtype
    E = ext_pts.shape[1]
    fb = frame_budget
    # map layout: [anchor frame 0, full resolution E][frame k slots of
    # frame_budget each, k = 1..L]
    map_cap = E + fb * L
    map_pts = torch.zeros((map_cap, 3), dtype=dt, device=dev)
    map_msk = torch.zeros(map_cap, dtype=torch.bool, device=dev)
    map_pts[:E] = ext_pts[0]
    map_msk[:E] = ext_mask[0]
    ii = torch.arange(map_cap, device=dev)
    slot_ids = torch.where(ii < E, 0, 1 + (ii - E) // fb)
    icp = lambda pc, msk, mmsk, R0, t0: icp_vs_map(
        pc, msk, map_pts, mmsk, R0, t0, icp_cfg, thr_scale)

    def insert(k, Rn, tn):
        """Write frame k's transformed even subsample of its valid prefix
        at its fixed slot."""
        pc, msk = ext_pts[k], ext_mask[k]
        n_valid = torch.clamp_min(msk.sum(), 1)
        ridx = torch.arange(fb, device=dev) * n_valid // fb
        uniq = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          ridx[1:] != ridx[:-1]])
        off = E + (k - 1) * fb
        map_pts[off:off + fb] = se3.apply(Rn, tn, pc[ridx])
        map_msk[off:off + fb] = msk[ridx] & uniq

    # ---- sweep 1: forward accumulation -- frame k registers against the
    # map built from frames 0..k-1, then joins it
    eye = torch.eye(3, dtype=dt, device=dev)
    zero = torch.zeros(3, dtype=dt, device=dev)
    R_all = eye.repeat(L + 1, 1, 1)
    t_all = zero.repeat(L + 1, 1)
    oks = np.zeros(M, bool)
    R_prev, t_prev = eye, zero
    for k in range(1, L + 1):
        R0, t0 = se3.compose(R_prev, t_prev, rel_Rs[k - 1], rel_ts[k - 1])
        Rn, tn, ok, _, _ = icp(ext_pts[k], ext_mask[k], map_msk, R0, t0)
        if not ok:
            Rn, tn = R0, t0
        insert(k, Rn, tn)
        R_all[k], t_all[k] = Rn, tn
        oks[k - 1] = ok
        R_prev, t_prev = Rn, tn

    # ---- sweep 2: polish against the COMPLETE map, each frame's own slot
    # masked out of the reference and rewritten at the updated pose; the
    # residual at the input-trajectory pose is measured against the same
    # map (the residual-gain evidence)
    Rin, tin = [eye], [zero]
    for k in range(L):
        Rc, tc = se3.compose(Rin[-1], tin[-1], rel_Rs[k], rel_ts[k])
        Rin.append(Rc)
        tin.append(tc)

    def polish():
        oks_p = np.zeros(M, bool)
        r0s_p, r1s_p = np.zeros(M, np.float32), np.zeros(M, np.float32)
        for k in range(1, L + 1):
            pc, msk = ext_pts[k], ext_mask[k]
            ref_msk = map_msk & (slot_ids != k)
            _, dist0 = nearest_neighbors(se3.apply(Rin[k], tin[k], pc), msk,
                                         map_pts, ref_msk)
            r0 = _sat_mean(dist0, msk)
            Rn, tn, ok, _, rlast = icp(pc, msk, ref_msk, R_all[k], t_all[k])
            if ok:
                R_all[k], t_all[k] = Rn, tn
            insert(k, R_all[k], t_all[k])
            oks_p[k - 1] = ok
            r0s_p[k - 1], r1s_p[k - 1] = float(r0), float(rlast)
        return oks_p, r0s_p, r1s_p

    oks2, r0s, _ = polish()

    # ---- mid-closure, twice: register the exit anchor against the
    # entry-anchor reference, distribute the endpoint delta smoothly over
    # the span (rotation-vector interpolation), rebuild the map at the
    # corrected poses and polish once more
    # a true division, as JAX's by the traced span length (a Python-number
    # divisor is a product with its reciprocal on the card)
    frac = torch.clamp(torch.arange(L + 1, dtype=torch.float32, device=dev)
                       / torch.full((), float(max(L, 1)), device=dev),
                       0.0, 1.0)[:, None]
    anchor_ref = lambda: map_msk & (slot_ids == 0)
    r1s = None
    for _round in range(2):
        Rl_m, tl_m, okl_m, _, _ = icp(ext_pts[L], ext_mask[L], anchor_ref(),
                                      R_all[L], t_all[L])
        RL, tL = R_all[L], t_all[L]
        d_rotvec = se3.log_so3(se3.matmul3(RL.T, Rl_m))
        Rcorr = se3.exp_so3(d_rotvec[None, :] * frac)
        if okl_m:
            R_all = se3.project_so3(se3.matmul3(R_all, Rcorr))
            t_all = t_all + (tl_m - tL)[None, :] * frac
        for k in range(1, L + 1):
            insert(k, R_all[k], t_all[k])
        oks3, _, r1s = polish()
        oks2 = oks2 | oks3

    # ---- sweep 3: healthy-to-healthy span closure, the exit anchor
    # against the entry anchor alone: the one unbiased absolute measurement
    R_cl, t_cl, ok_cl, _, cl_res = icp(ext_pts[L], ext_mask[L], anchor_ref(),
                                       R_all[L], t_all[L])

    # rels from the solved pose chain: rel(k-1 -> k) = T_{k-1}^-1 T_k;
    # inactive pairs pass the input rels through
    Rp, tp = R_all[:-1], t_all[:-1]
    rRs, rTs = rel_Rs.clone(), rel_ts.clone()
    rRs[:L] = se3.matmul3(Rp.transpose(-1, -2), R_all[1:])
    rTs[:L] = (Rp * (t_all[1:] - tp)[..., :, None]).sum(-2)
    active = np.arange(M) < L
    return (rRs, rTs, (oks | oks2) & active, r0s, r1s,
            R_cl, t_cl, ok_cl, float(cl_res))


@dataclasses.dataclass
class BurstStats:
    spans: List = dataclasses.field(default_factory=list)      # (a, b)
    accepted: List = dataclasses.field(default_factory=list)
    rejected: List = dataclasses.field(default_factory=list)
    gains: List = dataclasses.field(default_factory=list)      # (r0, r1)
    # per span: the accepted closure evidence ("descriptor(N)" /
    # "icp(res)" / None)
    closures: List = dataclasses.field(default_factory=list)


def find_burst_spans(healthy: np.ndarray, min_burst: int = 4,
                     max_span: int = 62):
    """Maximal runs of consecutive UNHEALTHY frames, extended by one
    healthy anchor on each side.  Returns [(a, b)] frame spans (b
    inclusive); runs longer than ``max_span - 1`` are split."""
    healthy = np.asarray(healthy, bool)
    n = len(healthy)
    spans = []
    i = 0
    while i < n:
        if healthy[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and not healthy[j + 1]:
            j += 1
        if j - i + 1 >= min_burst:
            a = max(i - 1, 0)
            b = min(j + 1, n - 1)
            while b - a > max_span:
                spans.append((a, a + max_span))
                a = a + max_span
            if b > a:
                spans.append((a, b))
        i = j + 1
    return spans


def _angle_deg(R) -> float:
    return float(np.degrees(np.arccos(np.clip(
        (np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def rescue_bursts(poses, ref_feats, healthy, rel_lidar_fn, apply_rel_fn,
                  cfg: PipelineConfig, min_burst: int = 4,
                  max_span: int = 62, thr_scale: float = 2.0,
                  anchor_register_fn=None, pair_icp_fn=None):
    """Apply burst map-ICP rescue to every qualifying unhealthy span of a
    refined trajectory (``caelo_tpu/backend/burst.py:367-712``, the host
    logic copied).  ``ref_feats`` is a ``RefinementFeatures`` with a
    leading frame axis; ``anchor_register_fn(i, j, R_prior, t_prior) ->
    (R, t, ok, n_inliers)`` and ``pair_icp_fn`` (``make_batched_icp_fn``'s
    contract) are optional closure sources and polish.

    Acceptance is the residual-gain gate of pairwise refinement over the
    span's mean residuals, halved when an anchor closure verifies; a
    verified closure is distributed smoothly over the span, the span's
    rels smoothed and polished pairwise, and an orthonormality guard
    refuses a corrupt splice.  Returns ``(poses, BurstStats)``.
    """
    from .refine import _all_rels, _rt, _row

    spans = find_burst_spans(healthy, min_burst=min_burst,
                             max_span=max_span)
    stats = BurstStats(spans=list(spans))
    if not spans:
        return poses, stats
    poses = np.asarray(poses, np.float64).copy()
    rcfg = cfg.refine
    frame_budget = min(2048, cfg.icp.max_points)
    dev = ref_feats.ext_pts.device
    for (a, b) in spans:
        L = b - a                       # active pairs
        idx = torch.arange(a, b + 1, device=dev)
        rels = [rel_lidar_fn(poses[k], poses[k + 1]) for k in range(a, b)]
        relR = np.stack([r for r, _ in rels]).astype(np.float32)
        relT = np.stack([t for _, t in rels]).astype(np.float32)
        (rRs, rTs, oks, r0s, r1s,
         R_cl, t_cl, ok_cl, cl_res) = burst_map_icp(
            ref_feats.ext_pts[idx], ref_feats.ext_mask[idx],
            torch.as_tensor(relR, device=dev),
            torch.as_tensor(relT, device=dev), L, icp_cfg=cfg.icp,
            frame_budget=frame_budget, thr_scale=thr_scale)
        r0 = float(r0s[oks].mean()) if oks.any() else 0.0
        r1 = float(r1s[oks].mean()) if oks.any() else 0.0
        stats.gains.append((r0, r1))
        nR = rRs.double().cpu().numpy()
        nT = rTs.double().cpu().numpy()
        # Healthy-to-healthy closure, by precision: (1) descriptor RANSAC
        # between the two anchors seeded with the solved chain, verified by
        # its inlier consensus; (2) the map-ICP exit registration, accepted
        # only when its converged residual is tight (<= 0.35 m).  Either
        # way the implied correction must stay within the plausibility
        # bound (20 % of the span path).
        closure_ok = False
        closure_src = None
        cum = [(np.eye(3), np.zeros(3))]
        for k in range(L):
            Ck, ck = cum[-1]
            cum.append((Ck @ nR[k], Ck @ nT[k] + ck))
        Rc, tc = cum[L]
        path = float(np.sum(np.linalg.norm(nT, axis=1)))
        bound = max(1.0, 0.2 * path)
        R_cl = R_cl.double().cpu().numpy()
        t_cl = t_cl.double().cpu().numpy()
        okd, n_inl, d_miss = False, 0, -1.0
        if anchor_register_fn is not None and oks.all():
            # prior = the best available absolute estimate of rel(a, b)
            pR, pt = (R_cl, t_cl) if bool(ok_cl) else (Rc, tc)
            Rd, td, okd, n_inl = anchor_register_fn(a, b, pR, pt)
            d_miss = float(np.linalg.norm(np.asarray(td) - tc))
            # the chain-agreement bound only excludes aliased matches:
            # floor 3 m, cap 12 m
            if okd and d_miss <= float(np.clip(0.2 * path, 3.0, 12.0)):
                R_cl = np.asarray(Rd, np.float64)
                t_cl = np.asarray(td, np.float64)
                closure_ok = True
                closure_src = f"descriptor({int(n_inl)})"
        if (not closure_ok and bool(ok_cl) and oks.all()
                and float(cl_res) <= 0.35
                and np.linalg.norm(t_cl - tc) <= bound):
            closure_ok = True
            closure_src = f"icp({float(cl_res):.2f})"
        if closure_ok and pair_icp_fn is not None:
            # dense polish of the anchor closure (both anchors are healthy
            # full-view frames); small corrections only
            pdR, pdt, pok, _, _ = pair_icp_fn(
                np.array([a], np.int32), np.array([b], np.int32),
                R_cl[None].astype(np.float32),
                t_cl[None].astype(np.float32), thr_scale=2.0)
            pR0 = np.asarray(pdR[0], np.float64)
            pt0 = np.asarray(pdt[0], np.float64)
            pang = _angle_deg(pR0)
            pmag = float(np.linalg.norm(pt0))
            if bool(pok[0]) and pang <= 2.0 and pmag <= 2.0:
                R_cl = pR0 @ R_cl
                t_cl = pR0 @ t_cl + pt0
                closure_src += f"+polish({pang:.2f}d,{pmag:.2f}m)"
        if closure_src is None:
            # diagnostic record of why both sources were refused
            closure_src = (f"none(desc_ok={bool(okd)},ni={int(n_inl)},"
                           f"dmiss={d_miss:.1f},icp_ok={bool(ok_cl)},"
                           f"res={float(cl_res):.2f},"
                           f"imiss={float(np.linalg.norm(t_cl - tc)):.1f})")
            stats.closures.append((a, b, closure_src))
            closure_src = None
        # Comparative acceptance: the verified closure referees the
        # incumbent too -- if the incumbent chain's endpoint already agrees
        # with it, keep the incumbent rels and only redistribute the miss
        incumbent_kept = False
        RcI, tcI = np.eye(3), np.zeros(3)
        for k in range(L):
            RcI, tcI = (RcI @ np.asarray(relR[k], np.float64),
                        RcI @ np.asarray(relT[k], np.float64) + tcI)
        if closure_ok:
            missI = float(np.linalg.norm(t_cl - tcI))
            angI = _angle_deg(RcI.T @ R_cl)
            print(f"burst span ({a}, {b}): incumbent-vs-closure miss "
                  f"{missI:.2f} m / {angI:.2f} deg (keep bound "
                  f"{max(2.0, 0.04 * path):.1f} m / 1.0 deg)",
                  file=sys.stderr)
            if missI <= max(2.0, 0.04 * path) and angI <= 1.0:
                incumbent_kept = True
                nR = np.stack([np.asarray(relR[k], np.float64)
                               for k in range(L)])
                nT = np.stack([np.asarray(relT[k], np.float64)
                               for k in range(L)])
                closure_src = (closure_src or "") + \
                    f"|incumbent(miss={missI:.2f}m,{angI:.2f}deg)"
        elif okd:
            # no verified closure, but the inlier-verified descriptor
            # registration exists and was refused only because the SOLVE
            # disagreed with it: check the incumbent against it directly,
            # and keep the incumbent pinned to it if they agree (kept
            # without the pair-ICP polish, as in the JAX package)
            tdv = np.asarray(td, np.float64)
            Rdv = np.asarray(Rd, np.float64)
            missI = float(np.linalg.norm(tdv - tcI))
            angI = _angle_deg(RcI.T @ Rdv)
            print(f"burst span ({a}, {b}): incumbent-vs-DESCRIPTOR miss "
                  f"{missI:.2f} m / {angI:.2f} deg (keep bound "
                  f"{max(3.0, 0.05 * path):.1f} m / 1.5 deg; solve "
                  f"unverified)", file=sys.stderr)
            if missI <= max(3.0, 0.05 * path) and angI <= 1.5:
                incumbent_kept = True
                closure_ok = True
                R_cl, t_cl = Rdv, tdv
                nR = np.stack([np.asarray(relR[k], np.float64)
                               for k in range(L)])
                nT = np.stack([np.asarray(relT[k], np.float64)
                               for k in range(L)])
                closure_src = (f"descriptor({int(n_inl)})|incumbent"
                               f"(miss={missI:.2f}m,{angI:.2f}deg,"
                               f"solve_refused)")
                # replace the refusal diagnostic recorded above
                if stats.closures and stats.closures[-1][:2] == (a, b):
                    stats.closures.pop()
        if closure_src is not None:
            stats.closures.append((a, b, closure_src))
        # the residual-gain requirement halves when the independent anchor
        # closure verified
        gain_frac = rcfg.residual_gain_frac * (0.5 if closure_ok else 1.0)
        gain_ok = (oks.mean() >= 0.5
                   and (r0 - r1) >= max(gain_frac * r0,
                                        rcfg.residual_gain_floor_m))
        # Unverified solves may only apply a plausible correction against
        # the incumbent chain.  The bound's path length comes from the
        # solve's own rels, as in the JAX package.
        if not closure_ok and not incumbent_kept:
            corr_t = float(np.linalg.norm(tc - tcI))
            corr_a = _angle_deg(RcI.T @ Rc)
            print(f"burst span ({a}, {b}): UNVERIFIED solve correction "
                  f"{corr_t:.2f} m / {corr_a:.2f} deg vs incumbent "
                  f"(plausibility bound {bound:.1f} m / 5.0 deg)",
                  file=sys.stderr)
            if corr_t > bound or corr_a > 5.0:
                stats.rejected.append((a, b))
                continue
        if not gain_ok and not incumbent_kept:
            stats.rejected.append((a, b))
            continue
        if closure_ok:
            from scipy.spatial.transform import Rotation

            Rt = R_cl
            tt = t_cl

            def redistribute(nR, nT):
                """Distribute the chain-vs-closure endpoint mismatch
                smoothly over the span (backward_update-style)."""
                cum = [(np.eye(3), np.zeros(3))]
                for k in range(L):
                    Ck, ck = cum[-1]
                    cum.append((Ck @ nR[k], Ck @ nT[k] + ck))
                Rc, tc = cum[L]
                d_rotvec = Rotation.from_matrix(Rc.T @ Rt).as_rotvec() / L
                d_t = (tt - tc) / L
                prev = (np.eye(3), np.zeros(3))
                for k in range(1, L + 1):
                    Rk = cum[k][0] @ Rotation.from_rotvec(
                        d_rotvec * k).as_matrix()
                    tk = cum[k][1] + d_t * k
                    nR[k - 1] = prev[0].T @ Rk
                    nT[k - 1] = prev[0].T @ (tk - prev[1])
                    prev = (Rk, tk)
                return nR, nT

            nR, nT = redistribute(nR, nT)
            # smooth the span's rotation-vector / translation increments
            # with two [1,2,1]/4 passes (independent per-frame solve noise
            # against smooth vehicle motion), re-distributing the closure
            # after each
            if L >= 4 and not incumbent_kept:
                def smooth(x):
                    y = x.copy()
                    y[1:-1] = 0.25 * x[:-2] + 0.5 * x[1:-1] + 0.25 * x[2:]
                    return y

                for _ in range(2):
                    rv = Rotation.from_matrix(nR).as_rotvec()
                    nR = Rotation.from_rotvec(smooth(rv)).as_matrix()
                    nT = smooth(nT)
                    nR, nT = redistribute(nR, nT)
            # per-pair polish: consecutive burst frames share one wedge, so
            # pairwise hybrid ICP pins their rels once the initialisation
            # is right; tight acceptance, closure re-distributed after
            if pair_icp_fn is not None and not incumbent_kept:
                ii = np.arange(a, b, dtype=np.int32)
                dRs, dts, poks, _, _ = pair_icp_fn(
                    ii, ii + 1, nR.astype(np.float32),
                    nT.astype(np.float32), thr_scale=1.0)
                n_pol = 0
                for k in range(L):
                    if not bool(poks[k]):
                        continue
                    dR = np.asarray(dRs[k], np.float64)
                    dt = np.asarray(dts[k], np.float64)
                    if _angle_deg(dR) <= 0.5 and np.linalg.norm(dt) <= 0.3:
                        nR[k] = dR @ nR[k]
                        nT[k] = dR @ nT[k] + dt
                        n_pol += 1
                if n_pol:
                    nR, nT = redistribute(nR, nT)
        # orthonormality guard: a corrupt rotation in the splice scales the
        # whole downstream chain exponentially -- refuse the span instead
        orth = np.max(np.abs(
            np.einsum("kji,kjl->kil", nR, nR)
            - np.eye(3)[None]), axis=(1, 2))
        if np.any(orth > 1e-3):
            stats.rejected.append((a, b))
            print(f"burst span ({a}, {b}): non-orthonormal solved rel "
                  f"(max dev {orth.max():.2e}) -- span refused",
                  file=sys.stderr)
            continue
        # splice: replace the span's rels where solved, re-chain the tail
        rel_Rs, rel_ts = _all_rels(poses)
        for k in range(L):
            if not oks[k]:
                continue
            dR, dt = _cam_rel(nR[k], nT[k], rel_lidar_fn, apply_rel_fn,
                              poses[a + k])
            rel_Rs[a + k], rel_ts[a + k] = dR, dt
        for k in range(a + 1, len(poses)):
            R0, t0 = _rt(poses[k - 1])
            poses[k] = _row(R0 @ rel_Rs[k - 1], R0 @ rel_ts[k - 1] + t0)
        stats.accepted.append((a, b))
    return poses, stats


def _cam_rel(relR_lidar, relT_lidar, rel_lidar_fn, apply_rel_fn, pose0):
    """Convert a lidar-frame relative pose into the camera-frame rel used
    by the pose chain, via the caller's own apply function (which holds the
    calib): new_pose1 = apply(pose0, rel), then rel_cam = pose0^-1 pose1."""
    p1 = apply_rel_fn(pose0, relR_lidar, relT_lidar)
    P0 = np.asarray(pose0, np.float64).reshape(3, 4)
    P1 = np.asarray(p1, np.float64).reshape(3, 4)
    R = P0[:, :3].T @ P1[:, :3]
    t = P0[:, :3].T @ (P1[:, 3] - P0[:, 3])
    return R, t
