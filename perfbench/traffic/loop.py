"""Loop traffic: the sensor driven around a closed circle inside one frozen
synthetic scene, one scan every ``step_m`` metres, heading along the path.

The scene (boxes as building facades, poles, a ground annulus) and its
surface points are the repository's synthetic generator, copied here
(``make_scene``, ``sample_scene_points``) and frozen with ``scene_seed``.
The seed of a run sets the scan noise (N(0, ``noise_m``) per coordinate),
the reflectance (uniform in [0, 1)) and where on the lap the run starts;
every seed gets the same lap, the same frame sizes and the same arrivals.

A lap of ``lap_frames`` scans is made on the device in a few large calls
(transform, range and field-of-view filter, noise, compaction of the
kept points to the front of a ``max_points`` buffer) and handed to the
driver from host memory, as a recorded sequence or a live sensor would.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _boxes(rng, n, extent):
    c = rng.uniform(-extent, extent, size=(n, 2))
    c = np.where(np.abs(c) < 8.0, c + np.sign(c) * 10.0, c)
    s = rng.uniform(3.0, 14.0, size=(n, 2))
    h = rng.uniform(3.0, 12.0, size=(n,))
    return c, s, h


def make_scene(seed=0, n_boxes=40, n_poles=60, extent=60.0) -> dict:
    """Random boxes and poles within +-``extent`` m."""
    rng = np.random.default_rng(seed)
    c, s, h = _boxes(rng, n_boxes, extent)
    px = rng.uniform(-extent, extent, size=(n_poles, 2))
    px = np.where(np.abs(px) < 6.0, px + np.sign(px) * 8.0, px)
    ph = rng.uniform(1.0, 4.0, size=(n_poles,))
    return {"box_c": c, "box_s": s, "box_h": h, "pole_xy": px, "pole_h": ph}


def sample_scene_points(scene, seed=0, n_points=120000, sensor_z=1.8):
    """``(n_points, 3)`` float32 world points: ~45 % ground, ~45 % facades,
    ~10 % poles, the sensor's height at z = 0."""
    rng = np.random.default_rng(seed + 1)
    n_ground = int(n_points * 0.45)
    n_facade = int(n_points * 0.45)
    n_pole = n_points - n_ground - n_facade
    r = np.sqrt(rng.uniform(3.0 ** 2, 70.0 ** 2, n_ground))
    th = rng.uniform(0, 2 * np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th), np.zeros(n_ground)], 1)
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
    facade = np.stack([c[bi, 0] + fx, c[bi, 1] + fy, z], 1)
    p, ph = scene["pole_xy"], scene["pole_h"]
    pi = rng.integers(0, p.shape[0], n_pole)
    pz = rng.uniform(0.0, ph[pi])
    ang = rng.uniform(0, 2 * np.pi, n_pole)
    pole = np.stack([p[pi, 0] + 0.08 * np.cos(ang),
                     p[pi, 1] + 0.08 * np.sin(ang), pz], 1)
    pts = np.concatenate([ground, facade, pole], 0)
    pts[:, 2] -= sensor_z
    return pts.astype(np.float32)


def lap_poses(lap_frames: int, step_m: float):
    """``(R (n, 3, 3), t (n, 3))`` float64 sensor poses in the world (x_w =
    R x_s + t): a counter-clockwise circle of circumference ``lap_frames *
    step_m`` about the scene's centre, heading along the path."""
    radius = lap_frames * step_m / (2 * math.pi)
    th = 2 * math.pi * np.arange(lap_frames) / lap_frames
    yaw = th + math.pi / 2
    R = np.zeros((lap_frames, 3, 3))
    R[:, 0, 0], R[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    R[:, 1, 0], R[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    R[:, 2, 2] = 1.0
    t = np.stack([radius * np.cos(th), radius * np.sin(th),
                  np.zeros(lap_frames)], 1)
    return R, t


@torch.no_grad()
def make_lap(params: dict, sensor: dict, max_points: int, seed: int,
             device, chunk: int = 32):
    """``(pts (n, max_points, 4) float32, mask (n, max_points) bool)`` CPU
    tensors of one lap, made on ``device``: each scan the frozen scene's
    points in the sensor's frame, those within 2 m to ``visible_range``
    and inside the vertical field of view kept and moved to the front in
    their order, N(0, noise) added to x, y, z, a uniform reflectance."""
    world = torch.from_numpy(sample_scene_points(
        make_scene(params["scene_seed"]), params["scene_seed"],
        n_points=max_points)).to(device)
    R, t = lap_poses(params["lap_frames"], params["step_m"])
    R = torch.as_tensor(R, dtype=torch.float32, device=device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    lo = math.radians(sensor["vertical_view_down_deg"])
    hi = math.radians(sensor["vertical_view_up_deg"])
    n = params["lap_frames"]
    pts = torch.empty((n, max_points, 4), dtype=torch.float32)
    mask = torch.empty((n, max_points), dtype=torch.bool)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        local = torch.einsum("fnj,fjk->fnk", world[None] - t[a:b, None],
                             R[a:b])
        r = torch.linalg.vector_norm(local, dim=-1)
        el = torch.asin(torch.clamp(local[..., 2] / r.clamp_min(1e-6), -1, 1))
        keep = ((r > 2.0) & (r < sensor["visible_range"]) & (el > lo)
                & (el < hi))
        noise = torch.randn(local.shape, generator=gen, device=device)
        refl = torch.rand(local.shape[:-1] + (1,), generator=gen,
                          device=device)
        scan = torch.cat([local + params["noise_m"] * noise, refl], -1)
        order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True
                           ).indices
        keep = keep.gather(1, order)
        scan = scan.gather(1, order[..., None].expand(-1, -1, 4))
        pts[a:b].copy_(torch.where(keep[..., None], scan, 0.0))
        mask[a:b].copy_(keep)
    return pts, mask


def start_frame(params: dict, seed: int) -> int:
    """Where on the lap a run with ``seed`` starts."""
    return int(np.random.default_rng(seed).integers(params["lap_frames"]))
