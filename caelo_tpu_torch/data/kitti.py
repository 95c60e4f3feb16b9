"""KITTI odometry dataset I/O, host side (the port's copy of
``caelo_tpu/data/kitti.py``).

Scans are padded to the pipeline's static point capacity at load time, so
everything downstream has fixed shapes.

KITTI tree layout (``README.md:36``, ``Dirs.py:19-27``)::

    <root>/sequences/<SS>/velodyne/NNNNNN.bin   float32 x,y,z,reflectance
    <root>/poses/<SS>.txt                        3x4 row-major GT poses
    <root>/sequences/<SS>/calib.txt              'Tr:' lidar->cam0 row
"""
from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from ..config import PipelineConfig
from ..geometry.kitti_pose import load_calib_tr
from ..geometry.se3 import correct_beam_angle_np
from .native_loader import ScanPrefetcher
from .native_loader import load_scan as native_load


def apply_beam_correction(pts: np.ndarray, mask: np.ndarray,
                          deg: float) -> np.ndarray:
    """Apply the beam-angle intrinsic fix to a padded ``(N, 4)`` scan's xyz
    (no-op when ``deg`` is 0; padded rows untouched)."""
    if not deg:
        return pts
    xyz = correct_beam_angle_np(pts[:, :3], deg)
    return np.concatenate(
        [np.where(mask[:, None], xyz, pts[:, :3]), pts[:, 3:]], axis=1
    ).astype(np.float32)


class KittiOdometry:
    def __init__(self, root: str, cfg: PipelineConfig = PipelineConfig()):
        self.root = root
        self.cfg = cfg

    def sequence_dir(self, seq: str) -> str:
        return os.path.join(self.root, "sequences", seq, "velodyne")

    def n_frames(self, seq: str) -> int:
        d = self.sequence_dir(seq)
        return len([f for f in os.listdir(d) if f.endswith(".bin")])

    def scan_path(self, seq: str, frame: int) -> str:
        return os.path.join(self.sequence_dir(seq), f"{frame:06d}.bin")

    def load_scan(self, seq: str, frame: int):
        """Return the padded ``(max_points, 4)`` scan and its validity mask
        (native C++ loader when available, numpy otherwise).  Applies the
        beam-angle intrinsic fix when ``cfg.sensor.beam_correction_deg`` is
        nonzero (reference ``GenerateTrajactory.m:186-190``)."""
        pts, mask = native_load(self.scan_path(seq, frame),
                                self.cfg.max_points)
        return apply_beam_correction(
            pts, mask, self.cfg.sensor.beam_correction_deg), mask

    def iter_scans(self, seq: str, start: int = 0,
                   stop: int | None = None
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Ordered scans with background prefetch (C++ thread pool; the
        in-process analog of the reference's 4 loader subprocesses,
        PoseEstimation.py:91-119)."""
        stop = self.n_frames(seq) if stop is None else stop
        paths = [self.scan_path(seq, i) for i in range(start, stop)]
        deg = self.cfg.sensor.beam_correction_deg
        for pts, mask in ScanPrefetcher(paths, self.cfg.max_points):
            yield apply_beam_correction(pts, mask, deg), mask

    def load_poses(self, seq: str) -> np.ndarray:
        return np.loadtxt(os.path.join(self.root, "poses", f"{seq}.txt"))

    def load_calib(self, seq: str):
        """Return (R_tr, t_tr): lidar -> cam0 calibration."""
        return load_calib_tr(
            os.path.join(self.root, "sequences", seq, "calib.txt")
        )


def save_kitti_poses(path: str, poses: np.ndarray):
    """Write KITTI 3x4 pose rows (``PoseEstimation.py:278-284`` semantics)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, np.asarray(poses).reshape(-1, 12))
