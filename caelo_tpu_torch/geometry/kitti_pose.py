"""KITTI pose-row bookkeeping, host float64 numpy.

Copied from ``caelo_tpu/geometry/kitti_pose.py``, a module that imports
JAX: pose chains are never computed in device float32 (a chained product
of thousands of 4x4s drifts measurably off SO(3) there).  ``load_calib_tr``
reads the lidar->camera calibration of a KITTI ``calib.txt``.
"""
from __future__ import annotations

import numpy as np


def _inverse(R, t):
    Ri = np.swapaxes(R, -1, -2)
    return Ri, -np.einsum("...ij,...j->...i", Ri, t)


def _compose(R1, t1, R2, t2):
    """Apply ``(R2, t2)`` first, then ``(R1, t1)``."""
    return R1 @ R2, np.einsum("...ij,...j->...i", R1, t2) + t1


def poses_to_rt(poses):
    """``(..., 12)`` pose rows -> ``(R (..., 3, 3), t (..., 3))``."""
    P = np.asarray(poses, np.float64).reshape(np.shape(poses)[:-1] + (3, 4))
    return P[..., :, 0:3], P[..., :, 3]


def rel_pose_cam(pose0, pose1):
    """Camera-frame relative transform frame 1 -> frame 0."""
    R0, t0 = poses_to_rt(pose0)
    R1, t1 = poses_to_rt(pose1)
    return _compose(*_inverse(R0, t0), R1, t1)


def rel_pose_lidar(pose0, pose1, R_tr, t_tr):
    """Lidar-frame relative transform frame 1 -> frame 0, conjugated with
    the camera-lidar calibration: ``rel_l = Tr^-1 * pose0^-1 * pose1 *
    Tr``."""
    R_tr = np.asarray(R_tr, np.float64)
    t_tr = np.asarray(t_tr, np.float64)
    Rc, tc = rel_pose_cam(pose0, pose1)
    R, t = _compose(Rc, tc, R_tr, t_tr)
    return _compose(*_inverse(R_tr, t_tr), R, t)


def lidar_rel_to_cam(relR, relT, R_tr, t_tr):
    """Conjugate a lidar-frame relative motion into the camera pose-delta used
    for chaining (``PoseEstimation.py:259-263``): ``delta_cam = Tr * rel_l *
    Tr^-1``.  Batched over leading axes of ``relR (..., 3, 3)``."""
    relR = np.asarray(relR, np.float64)
    relT = np.asarray(relT, np.float64)
    R_tr = np.asarray(R_tr, np.float64)
    t_tr = np.asarray(t_tr, np.float64)
    R_tri = R_tr.T
    t_tri = -R_tri @ t_tr
    R = relR @ R_tri
    t = np.einsum("...ij,j->...i", relR, t_tri) + relT
    return R_tr @ R, np.einsum("ij,...j->...i", R_tr, t) + t_tr


def chain_poses(rel_Rs, rel_ts, R_tr, t_tr, pose0=None):
    """Chain per-frame lidar relative motions into KITTI pose rows.

    Args:
      rel_Rs: ``(N, 3, 3)`` lidar-frame relative rotations (frame k+1 -> k).
      rel_ts: ``(N, 3)`` lidar-frame relative translations.
      R_tr, t_tr: camera-lidar calibration.
      pose0: optional ``(12,)`` starting pose row (defaults to identity).

    Returns ``(N + 1, 12)`` float64 pose rows.
    """
    rel_Rs = np.asarray(rel_Rs, np.float64)
    rel_ts = np.asarray(rel_ts, np.float64)
    R_tr = np.asarray(R_tr, np.float64)
    t_tr = np.asarray(t_tr, np.float64)
    R_tri = R_tr.T
    t_tri = -R_tri @ t_tr
    N = rel_Rs.shape[0]
    # delta_cam = Tr * rel_l * Tr^-1
    dR = np.einsum("ij,njk,kl->nil", R_tr, rel_Rs, R_tri)
    dt = (np.einsum("ij,njk,k->ni", R_tr, rel_Rs, t_tri)
          + rel_ts @ R_tr.T + t_tr)
    out = np.empty((N + 1, 12))
    if pose0 is not None:
        P = np.asarray(pose0, np.float64).reshape(3, 4)
        R, t = P[:, :3].copy(), P[:, 3].copy()
    else:
        R, t = np.eye(3), np.zeros(3)
    out[0] = np.concatenate([R, t[:, None]], axis=1).reshape(12)
    for k in range(N):
        t = R @ dt[k] + t
        R = R @ dR[k]
        # re-orthonormalize as we chain: the device rels are f32 and
        # downstream bookkeeping re-derives rels from these poses, so any
        # accumulated det error would compound there
        r0 = R[0] / np.linalg.norm(R[0])
        r1 = R[1] - (r0 @ R[1]) * r0
        r1 = r1 / np.linalg.norm(r1)
        R = np.stack([r0, r1, np.cross(r0, r1)])
        out[k + 1] = np.concatenate([R, t[:, None]], axis=1).reshape(12)
    return out


def rt_to_poses(R, t):
    """``(R (..., 3, 3), t (..., 3))`` -> ``(..., 12)`` pose rows."""
    P = np.concatenate([np.asarray(R), np.asarray(t)[..., :, None]], axis=-1)
    return P.reshape(P.shape[:-2] + (12,))


def load_calib_tr(path: str):
    """Load the 3x4 lidar->camera ``Tr`` row from a KITTI ``calib.txt``.

    The reference reads a pre-stripped ``calib_.txt`` whose 5th row is ``Tr``
    (``Match.py:362-364``); we handle both the raw ``key: values`` format and
    the stripped numeric table.
    """
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if ":" in line:
                key, vals = line.split(":", 1)
                rows.append((key.strip(), np.fromstring(vals, sep=" ")))
            else:
                rows.append((None, np.fromstring(line, sep=" ")))
    for key, vals in rows:
        if key == "Tr":
            M = vals.reshape(3, 4)
            return M[:, :3].astype(np.float64), M[:, 3].astype(np.float64)
    # stripped format: 5th numeric row is Tr
    M = rows[4][1].reshape(3, 4)
    return M[:, :3].astype(np.float64), M[:, 3].astype(np.float64)
