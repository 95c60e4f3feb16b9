"""Synthetic LiDAR scenes for tests and the card's smoke run.

The port's own copy of the scene generators of
``caelo_tpu/data/synthetic.py`` (``make_scene``, ``sample_scene_points``,
``range_filter``): numpy, and given the same arguments bit-identical to the
JAX package's, as ``tests/test_torch_imports.py`` checks.  Surface points
sampled from ground, building facades and poles, so the whole pipeline runs
end to end with known ground-truth motion and no dataset.
"""
from __future__ import annotations

import numpy as np

from ..config import SensorConfig

def _boxes(rng: np.random.Generator, n: int, extent: float):
    """Random axis-aligned 'building' boxes: (center_xy, size_xy, height)."""
    c = rng.uniform(-extent, extent, size=(n, 2))
    # keep a clear area around the sensor
    c = np.where(np.abs(c) < 8.0, c + np.sign(c) * 10.0, c)
    s = rng.uniform(3.0, 14.0, size=(n, 2))
    h = rng.uniform(3.0, 12.0, size=(n,))
    return c, s, h


def make_scene(seed: int = 0, n_boxes: int = 40, n_poles: int = 60,
               extent: float = 60.0) -> dict:
    rng = np.random.default_rng(seed)
    c, s, h = _boxes(rng, n_boxes, extent)
    px = rng.uniform(-extent, extent, size=(n_poles, 2))
    px = np.where(np.abs(px) < 6.0, px + np.sign(px) * 8.0, px)
    ph = rng.uniform(1.0, 4.0, size=(n_poles,))
    return {"box_c": c, "box_s": s, "box_h": h, "pole_xy": px, "pole_h": ph}


def sample_scene_points(scene: dict, seed: int = 0, n_points: int = 120000,
                        sensor_z: float = 1.8) -> np.ndarray:
    """Sample surface points from the scene in the *world* frame.

    Densities are tuned so a scan has KITTI-like structure: ~45% ground,
    ~45% facades, ~10% poles/edges.
    """
    rng = np.random.default_rng(seed + 1)
    n_ground = int(n_points * 0.45)
    n_facade = int(n_points * 0.45)
    n_pole = n_points - n_ground - n_facade

    # ground disc (annulus: LiDAR can't see straight down)
    r = np.sqrt(rng.uniform(3.0**2, 70.0**2, n_ground))
    th = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.stack(
        [r * np.cos(th), r * np.sin(th), np.zeros(n_ground)], axis=1
    )

    # facades: pick a box, pick one of its 4 side faces
    c, s, h = scene["box_c"], scene["box_s"], scene["box_h"]
    bi = rng.integers(0, c.shape[0], n_facade)
    face = rng.integers(0, 4, n_facade)
    u = rng.uniform(-0.5, 0.5, n_facade)
    z = rng.uniform(0.0, h[bi])
    half = s[bi] / 2.0
    fx = np.where(face < 2, half[:, 0] * np.where(face == 0, 1, -1),
                  u * s[bi][:, 0])
    fy = np.where(face < 2, u * s[bi][:, 1],
                  half[:, 1] * np.where(face == 2, 1, -1))
    facade = np.stack([c[bi, 0] + fx, c[bi, 1] + fy, z], axis=1)

    # poles (vertical edges -> strong interest points)
    p, ph = scene["pole_xy"], scene["pole_h"]
    pi = rng.integers(0, p.shape[0], n_pole)
    pz = rng.uniform(0.0, ph[pi])
    ang = rng.uniform(0, 2 * np.pi, n_pole)
    pole = np.stack(
        [
            p[pi, 0] + 0.08 * np.cos(ang),
            p[pi, 1] + 0.08 * np.sin(ang),
            pz,
        ],
        axis=1,
    )

    pts = np.concatenate([ground, facade, pole], axis=0)
    pts[:, 2] -= sensor_z  # sensor at origin
    return pts.astype(np.float32)


def range_filter(pts: np.ndarray, sensor: SensorConfig = SensorConfig()):
    """Keep points inside the sensor's visible range/FOV."""
    r = np.linalg.norm(pts[:, :3], axis=1)
    el = np.arcsin(np.clip(pts[:, 2] / np.maximum(r, 1e-6), -1, 1))
    keep = (
        (r > 2.0)
        & (r < sensor.visible_range)
        & (el > np.radians(sensor.vertical_view_down_deg))
        & (el < np.radians(sensor.vertical_view_up_deg))
    )
    return pts[keep]
