"""The pose chain, plain host numpy: KITTI pose rows from per-pair lidar
motions through the camera-lidar calibration, the rotation
re-orthonormalised at every step; ``dtype=np.float32`` is the control."""
from __future__ import annotations

import numpy as np


def chain_poses(rel_Rs, rel_ts, R_tr, t_tr, dtype=np.float64):
    """``(N + 1, 12)`` pose rows of the ``N`` relative motions (frame k+1
    into frame k), starting at the identity."""
    f = lambda a: np.asarray(a, dtype)
    rel_Rs, rel_ts, R_tr, t_tr = f(rel_Rs), f(rel_ts), f(R_tr), f(t_tr)
    R_tri = R_tr.T
    t_tri = -R_tri @ t_tr
    dR = np.einsum("ij,njk,kl->nil", R_tr, rel_Rs, R_tri)
    dt = (np.einsum("ij,njk,k->ni", R_tr, rel_Rs, t_tri)
          + rel_ts @ R_tr.T + t_tr)
    out = np.empty((len(rel_Rs) + 1, 12), dtype)
    R, t = np.eye(3, dtype=dtype), np.zeros(3, dtype)
    out[0] = np.concatenate([R, t[:, None]], axis=1).reshape(12)
    for k in range(len(rel_Rs)):
        t = R @ dt[k] + t
        R = R @ dR[k]
        r0 = R[0] / np.linalg.norm(R[0])
        r1 = R[1] - (r0 @ R[1]) * r0
        r1 = r1 / np.linalg.norm(r1)
        R = np.stack([r0, r1, np.cross(r0, r1)])
        out[k + 1] = np.concatenate([R, t[:, None]], axis=1).reshape(12)
    return out


def fallback(rel_Rs, rel_ts, ok):
    """The constant-velocity fallback: a failed pair takes the previous
    pair's motion (the identity before the first)."""
    Rs, ts = np.array(rel_Rs), np.array(rel_ts)
    prev_R, prev_t = np.eye(3), np.zeros(3)
    for k in range(len(Rs)):
        if not ok[k]:
            Rs[k], ts[k] = prev_R, prev_t
        prev_R, prev_t = Rs[k], ts[k]
    return Rs, ts
