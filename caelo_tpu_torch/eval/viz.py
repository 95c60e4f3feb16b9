"""Visualization: trajectories, matches, fused clouds (port of
``caelo_tpu/eval/viz.py``: matplotlib figures and PLY files, headless).

matplotlib is imported inside each plot function, so the module and its PLY
exports work where matplotlib is absent.

Parity map (reference -> here):
* ``ShowTrajactory`` (Visualization.py:18-35)  -> ``plot_trajectories``
* ``ShowMatchingResult`` (Visualization.py:52-148) -> ``plot_matches``
* fused multi-frame map (ShowFusedPC.py:19-92) -> ``export_fused_ply``
* respond/saliency image render -> ``plot_saliency``
"""
from __future__ import annotations

import os

import numpy as np


def _require_mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(plt, fig, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_trajectories(path: str, named_poses: dict, axes=(0, 2)):
    """Top-down trajectory overlay (KITTI convention: x-z plane).

    Args:
      named_poses: {label: (N, 12) pose rows}.
    """
    plt = _require_mpl()
    fig, ax = plt.subplots(figsize=(8, 8))
    for label, poses in named_poses.items():
        P = np.asarray(poses).reshape(-1, 3, 4)
        ax.plot(P[:, axes[0], 3], P[:, axes[1], 3], label=label, lw=1)
        ax.plot(P[0, axes[0], 3], P[0, axes[1], 3], "k^", ms=8)
    ax.set_aspect("equal")
    ax.legend()
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    return _save(plt, fig, path)


def plot_matches(path: str, kp0, kp1, inlier_mask, shift=12.0):
    """Matched keypoints of two frames with inlier links (frame 1 lifted by
    ``shift`` in z, like the reference's display, Match.py:395-425)."""
    plt = _require_mpl()
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    kp0 = np.asarray(kp0)
    kp1 = np.asarray(kp1)
    m = np.asarray(inlier_mask)
    ax.scatter(kp0[:, 0], kp0[:, 1], kp0[:, 2], s=2, c="tab:blue")
    ax.scatter(kp1[:, 0], kp1[:, 1], kp1[:, 2] + shift, s=2, c="tab:orange")
    for a, b in zip(kp0[m], kp1[m]):
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2] + shift],
                c="lime", lw=0.3, alpha=0.5)
    return _save(plt, fig, path)


def plot_saliency(path: str, saliency):
    plt = _require_mpl()
    fig, ax = plt.subplots(figsize=(14, 3))
    im = ax.imshow(np.asarray(saliency), aspect="auto", cmap="magma")
    fig.colorbar(im, ax=ax, shrink=0.8)
    return _save(plt, fig, path)


def export_ply(path: str, pts, colors=None):
    """ASCII PLY export (viewable in CloudCompare/Meshlab)."""
    pts = np.asarray(pts, np.float32)
    n = pts.shape[0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in pts:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        else:
            c = np.asarray(colors, np.uint8)
            for p, cc in zip(pts, c):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {cc[0]} {cc[1]} {cc[2]}\n")
    return path


def export_voxels_ply(path: str, pyramid, scale: int, cfg):
    """Export one scale of an occupied-voxel pyramid (tensors on any device)
    as world-space cell centers (the reference's voxel rebuild /
    visualization path, ``Voxel.py:220-469`` + ``ShowFusedPC.py``)."""
    from ..voxel.grid import decode_voxels

    pts = decode_voxels(pyramid.coords[scale], scale, cfg).cpu().numpy()
    m = pyramid.masks[scale].cpu().numpy()
    return export_ply(path, pts[m])


def export_fused_ply(path: str, clouds, poses_rt):
    """Fuse per-frame clouds into the world frame and export
    (ShowFusedPC.py:19-92 equivalent).

    Args:
      clouds: list of (N_i, 3) arrays (lidar frame).
      poses_rt: list of (R, t) world-from-lidar transforms.
    """
    fused, cols = [], []
    palette = np.array(
        [[228, 26, 28], [55, 126, 184], [77, 175, 74], [152, 78, 163],
         [255, 127, 0], [255, 255, 51]], np.uint8
    )
    for i, (pc, (R, t)) in enumerate(zip(clouds, poses_rt)):
        pc = np.asarray(pc)
        fused.append(pc @ np.asarray(R).T + np.asarray(t))
        cols.append(np.tile(palette[i % len(palette)], (pc.shape[0], 1)))
    return export_ply(path, np.concatenate(fused), np.concatenate(cols))
