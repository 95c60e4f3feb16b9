"""Evaluation metrics: RRE/RTE/success rate, ATE, drift, loop-closure
precision/recall, keypoint repeatability and dispersion (port of
``caelo_tpu/eval/metrics.py``).

Pose metrics are host float64 numpy, as in the JAX module: a metric never
runs through device float32 products.  The keypoint metrics take tensors
or arrays; repeatability uses the port's nearest-neighbour search on the
device of its inputs.

Definitions follow the reference: per-pair errors on lidar-frame relative
poses, RRE = sum of |XYZ Euler error components| in degrees, RTE = ||t
error||, success = RRE < 1 deg and RTE < 0.5 m.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.kitti_pose import poses_to_rt


class RegistrationErrors(NamedTuple):
    rre_deg: np.ndarray       # (N-1,) sum-abs Euler error
    rte_m: np.ndarray         # (N-1,) translation error norm
    euler_err: np.ndarray     # (N-1, 3)
    t_err: np.ndarray         # (N-1, 3)


def relative_pose_errors(poses_gt, poses_est, R_tr,
                         t_tr) -> RegistrationErrors:
    """Frame-to-frame lidar-frame relative-pose errors between two
    trajectories (both ``(N, 12)`` KITTI rows), host float64."""
    def rels(poses):
        P = np.asarray(poses, np.float64).reshape(-1, 3, 4)
        Rtr = np.asarray(R_tr, np.float64)
        ttr = np.asarray(t_tr, np.float64)
        # cam rel: inv(P0) @ P1; conjugate into lidar: Tr^-1 rel Tr
        R0, t0 = P[:-1, :, :3], P[:-1, :, 3]
        R1, t1 = P[1:, :, :3], P[1:, :, 3]
        Rc = np.einsum("nji,njk->nik", R0, R1)
        tc = np.einsum("nji,nj->ni", R0, t1 - t0)
        Rl = np.einsum("ji,njk,kl->nil", Rtr, Rc, Rtr)
        tl = np.einsum("ji,nj->ni", Rtr, np.einsum("nij,j->ni", Rc, ttr)
                       + tc - ttr)
        return Rl, tl

    Rg, tg = rels(poses_gt)
    Re, te = rels(poses_est)
    # errorR = inv(R_est) @ R_gt, expressed as XYZ Euler degrees
    errR = np.einsum("nji,njk->nik", Re, Rg)
    ay = np.degrees(np.arctan2(-errR[:, 2, 0],
                               np.hypot(errR[:, 2, 1], errR[:, 2, 2])))
    ax = np.degrees(np.arctan2(errR[:, 2, 1], errR[:, 2, 2]))
    az = np.degrees(np.arctan2(errR[:, 1, 0], errR[:, 0, 0]))
    euler_err = np.stack([ax, ay, az], axis=1)
    t_err = te - tg
    return RegistrationErrors(
        rre_deg=np.sum(np.abs(euler_err), axis=-1),
        rte_m=np.linalg.norm(t_err, axis=-1),
        euler_err=euler_err,
        t_err=t_err,
    )


def registration_summary(errors: RegistrationErrors,
                         rre_threshold: float = 1.0,
                         rte_threshold: float = 0.5,
                         n_inliers=None, n_keypoints: int | None = None,
                         thresholds=None) -> dict:
    """RRE, stdRRE, RTE, stdRTE and success rate; with front-end stats also
    the inlier ratio (``n_inliers / n_keypoints``) and the
    threshold-escalation stat of the accepted RANSAC rungs."""
    rre = np.asarray(errors.rre_deg)
    rte = np.asarray(errors.rte_m)
    ok = (rre < rre_threshold) & (rte < rte_threshold)
    out = {
        "rre_deg": float(rre.mean()),
        "rre_std": float(rre.std()),
        "rte_m": float(rte.mean()),
        "rte_std": float(rte.std()),
        "success_rate": float(ok.mean()),
        "n_pairs": int(rre.shape[0]),
    }
    if n_inliers is not None and n_keypoints:
        out["inlier_ratio"] = float(
            np.asarray(n_inliers, np.float64).mean() / n_keypoints)
    if thresholds is not None:
        t = np.asarray(thresholds, np.float64)
        out["mean_threshold_m"] = float(t.mean())
        out["escalation_rate"] = float((t > t.min()).mean())
    return out


def absolute_trajectory_error(poses_gt, poses_est) -> dict:
    """ATE on trajectory translations after rigid alignment of the two
    trajectories (host float64)."""
    tg = np.asarray(poses_gt, np.float64).reshape(-1, 3, 4)[:, :, 3]
    te = np.asarray(poses_est, np.float64).reshape(-1, 3, 4)[:, :, 3]
    mg, me = tg.mean(0), te.mean(0)
    H = (te - me).T @ (tg - mg)
    U, _, Vt = np.linalg.svd(H)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    te_aligned = (te - me) @ R.T + mg
    err = np.linalg.norm(te_aligned - tg, axis=-1)
    return {
        "ate_rmse": float(np.sqrt(np.mean(err**2))),
        "ate_mean": float(np.mean(err)),
        "ate_max": float(np.max(err)),
    }


def _histogram(d, bins) -> dict:
    if bins is None:
        bins = [0.1 * 2**i for i in range(7)]  # 0.1 .. 6.4
    return {"bins_m": list(bins),
            "fraction_within": [float((d < b).mean()) if d.size
                                else float("nan") for b in bins],
            "median_m": float(np.median(d)) if d.size else float("nan")}


def keypoint_repeatability(kp0, mask0, kp1, mask1, R01, t01,
                           bins=None) -> dict:
    """Repeatability of consecutive-frame keypoints: frame-1 keypoints
    moved into frame 0 by the ground-truth relative pose, histogram of
    their nearest-neighbour distances (bins 0.1 .. 6.4 m, doubling)."""
    from ..backend.icp import nearest_neighbors

    kp0, kp1 = torch.as_tensor(kp0), torch.as_tensor(kp1)
    mask0 = torch.as_tensor(mask0, device=kp0.device)
    mask1 = torch.as_tensor(mask1, device=kp1.device)
    R = torch.as_tensor(np.asarray(R01, np.float32), device=kp1.device)
    t = torch.as_tensor(np.asarray(t01, np.float32), device=kp1.device)
    kp1w = (R * kp1[:, None, :]).sum(-1) + t
    _, dist = nearest_neighbors(kp1w, mask1, kp0, mask0)
    return _histogram(dist[mask1].cpu().numpy(), bins)


def keypoint_dispersion(kp, mask, bins=None) -> dict:
    """Within-frame keypoint dispersion: each keypoint's distance to its
    nearest other keypoint of the same frame (self-matches excluded),
    histogrammed like repeatability."""
    kp = torch.as_tensor(kp)
    m = torch.as_tensor(mask, device=kp.device)
    d2 = ((kp[:, None, :] - kp[None, :, :]) ** 2).sum(-1)
    eye = torch.eye(kp.shape[0], dtype=torch.bool, device=kp.device)
    d2 = torch.where(eye | ~m[None, :], torch.inf, d2)
    d = torch.sqrt(d2.min(1).values)[m].cpu().numpy()
    return _histogram(d[np.isfinite(d)], bins)


PR_ROW_BLOCK = 128          # rows of the revisit matrix a pass


def revisit_matrix(pos: np.ndarray, min_gap: int, revisit_m: float):
    """``(N, N)`` bool: ``[i, j]`` where ``j - i >= min_gap`` and positions
    ``i`` and ``j`` (float64) lie within ``revisit_m``.  Built a block of
    ``PR_ROW_BLOCK`` rows at a time: the block's float64 differences take a
    few MB where all N x N x 3 of them take 495 MB at N = 4,541; each entry
    is the one the whole difference gives."""
    n = pos.shape[0]
    idx = np.arange(n)
    gt = np.empty((n, n), bool)
    for lo in range(0, n, PR_ROW_BLOCK):
        rows = slice(lo, lo + PR_ROW_BLOCK)
        dist = np.linalg.norm(pos[None, :] - pos[rows, None], axis=-1)
        gt[rows] = (dist <= revisit_m) & (
            (idx[None, :] - idx[rows, None]) >= min_gap)
    return gt


def loop_closure_pr(edge_i, edge_j, positions, min_gap: int = 50,
                    revisit_m: float = 5.0, window: int = 10) -> dict:
    """Precision/recall of detected loop closures against ground truth.

    A ground-truth revisit is a frame pair (i < j) with ``|i-j| >=
    min_gap`` whose positions are within ``revisit_m``.  An accepted edge
    is a true positive if a revisit exists within ``window`` frames of
    both endpoints; a revisit event (a run of revisiting frames) counts as
    recalled if some edge's later endpoint is within ``window`` of it.
    """
    pos = np.asarray(positions, np.float64)
    n = pos.shape[0]
    ei = np.minimum(np.asarray(edge_i, int), np.asarray(edge_j, int))
    ej = np.maximum(np.asarray(edge_i, int), np.asarray(edge_j, int))
    gt = revisit_matrix(pos, min_gap, revisit_m)

    tp = 0
    for a, b in zip(ei, ej):
        ia = slice(max(a - window, 0), min(a + window + 1, n))
        jb = slice(max(b - window, 0), min(b + window + 1, n))
        if gt[ia, jb].any():
            tp += 1
    precision = tp / len(ei) if len(ei) else float("nan")

    revisit_frames = np.where(gt.any(axis=0))[0]
    # merge adjacent revisit frames into events
    events = []
    for j in revisit_frames:
        if events and j - events[-1][-1] <= window:
            events[-1].append(j)
        else:
            events.append([j])
    recalled = sum(
        1 for ev in events
        if any(abs(b - j) <= window for b in ej for j in ev)
    )
    recall = recalled / len(events) if events else float("nan")
    return {
        "precision": precision,
        "recall": recall,
        "n_edges": int(len(ei)),
        "n_true_positive": int(tp),
        "n_revisit_events": int(len(events)),
    }


def kitti_drift(poses_gt, poses_est,
                lengths=(100, 200, 300, 400, 500, 600, 700, 800)) -> dict:
    """KITTI devkit-style translational/rotational drift: the average error
    of subsequences of fixed path lengths, host float64."""
    Rg, tg = poses_to_rt(poses_gt)
    Re, te = poses_to_rt(poses_est)
    # cumulative GT path length
    step = np.linalg.norm(np.diff(tg, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(step)])
    t_errs, r_errs = [], []
    for L in lengths:
        starts = range(0, len(cum) - 1, 10)
        for i in starts:
            js = np.searchsorted(cum, cum[i] + L)
            if js >= len(cum):
                break
            j = int(js)
            dRg = Rg[i].T @ Rg[j]
            dtg = Rg[i].T @ (tg[j] - tg[i])
            dRe = Re[i].T @ Re[j]
            dte = Re[i].T @ (te[j] - te[i])
            errR = dRe.T @ dRg
            ang = np.degrees(
                np.arccos(np.clip((np.trace(errR) - 1) / 2, -1, 1))
            )
            t_errs.append(np.linalg.norm(dte - dtg) / L)
            r_errs.append(ang / L)
    if not t_errs:
        return {"t_rel_pct": float("nan"), "r_rel_deg_per_m": float("nan")}
    return {
        "t_rel_pct": float(np.mean(t_errs) * 100.0),
        "r_rel_deg_per_m": float(np.mean(r_errs)),
    }
