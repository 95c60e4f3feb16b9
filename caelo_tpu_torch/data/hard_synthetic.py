"""The ray-cast synthetic KITTI benchmark (port of
``caelo_tpu/data/hard_synthetic.py::generate_benchmark``).

The scene, trajectory and ray-casting helpers of the JAX package's module
are numpy with no JAX in their import chain, so they are imported, not
copied; only ``generate_benchmark``, which pads through the JAX package's
``ops.masking``, is re-written here over the port's numpy ``pad_points``.
Given the same arguments its scans are bit-identical to the JAX one's.
"""
from __future__ import annotations

import numpy as np

from caelo_tpu.data.hard_synthetic import (circuit_trajectory,  # noqa: F401
                                           make_city, raycast_scan,
                                           terrain_height)

from ..config import PipelineConfig
from ..ops.masking import pad_points


def generate_benchmark(n_frames: int = 520, seed: int = 0,
                       cfg: PipelineConfig = PipelineConfig(),
                       side: float = 96.0, az_step_deg: float | None = None,
                       yaw_rate_deg: float = 2.0, n_cars: int = 6,
                       degraded_spans=None, lap_frames: int | None = None,
                       frame_range: tuple | None = None):
    """Hard benchmark sequence: ``(scans, poses_gt)``, ``scans`` a list of
    padded ``(max_points, 4)`` arrays + masks and ``poses_gt`` the ``(N,
    12)`` ground truth (identity sensor calibration).

    Args:
      degraded_spans: optional ``(start, stop, dropout, sector_deg)`` frame
        spans where the sensor degrades: per-ray dropout raised to
        ``dropout`` and a ``sector_deg``-wide azimuth wedge (centred on +y)
        fully occluded.
      lap_frames: drive a ``lap_frames``-frame closed circuit repeatedly
        instead of one circuit stretched to ``n_frames``.
      frame_range: ``(a, b)`` generates only frames ``[a, b)``, exactly as
        in the full run.
    """
    scene = make_city(seed=seed, side=side, n_cars=n_cars)
    if lap_frames is not None:
        lap = circuit_trajectory(n_frames=lap_frames, side=side,
                                 yaw_rate_deg=yaw_rate_deg)
        reps = -(-n_frames // lap_frames)
        poses = np.concatenate([lap] * reps, axis=0)[:n_frames]
    else:
        poses = circuit_trajectory(n_frames=n_frames, side=side,
                                   yaw_rate_deg=yaw_rate_deg)
    # vehicle follows the terrain: sensor height rides h(x, y)
    poses[:, 2, 3] += terrain_height(scene, poses[:, 0, 3], poses[:, 1, 3])
    a, b = frame_range if frame_range is not None else (0, n_frames)
    scans = []
    for i in range(a, b):
        dropout, sector = 0.08, None
        for s0, s1, dr, sec in (degraded_spans or ()):
            if s0 <= i < s1:
                dropout, sector = dr, sec
        pts = raycast_scan(scene, poses[i], i, cfg.sensor,
                           az_step_deg=az_step_deg, seed=seed,
                           dropout=dropout)
        if sector:
            az = np.degrees(np.arctan2(pts[:, 1], pts[:, 0]))
            pts = pts[np.abs(az - 90.0) > sector / 2.0]
        if pts.shape[0] > cfg.max_points:
            keep = np.random.default_rng(seed + i).choice(
                pts.shape[0], cfg.max_points, replace=False)
            pts = pts[np.sort(keep)]
        scans.append(pad_points(pts, cfg.max_points))
    return scans, poses.reshape(n_frames, 12)
