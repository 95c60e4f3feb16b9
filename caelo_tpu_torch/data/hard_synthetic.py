"""The ray-cast synthetic KITTI benchmark (the "hard" generator; the port's
own copy of ``caelo_tpu/data/hard_synthetic.py``).

It ray-casts a 64-beam Velodyne pattern against an urban scene, so scans
carry per-beam occlusion, KITTI-like density falling off with range, range
noise and per-ray dropout, moving cars that break the rigid-world
assumption, and a closed circuit for loop closure.  numpy only; given the
same arguments every function here gives bit-identical arrays to the JAX
package's (``tests/test_torch_imports.py``, and
``tests/test_torch_loop.py::test_generate_benchmark_matches_jax`` for the
padded scans).
"""
from __future__ import annotations

import numpy as np

from ..config import PipelineConfig, SensorConfig
from ..ops.masking import pad_points


# --------------------------------------------------------------- trajectory
def circuit_trajectory(n_frames: int = 520, side: float = 96.0,
                       speed: float = 1.1, yaw_rate_deg: float = 2.0,
                       sensor_z: float = 1.8):
    """Closed rounded-rectangle circuit: four straights + four left turns.

    ``yaw_rate_deg`` is per frame (2 deg/frame = 20 deg/s at 10 Hz — the
    hardest sustained turn rate in KITTI 00-10).  Returns ``(N, 3, 4)``
    sensor poses in the world frame (R | t), x forward.
    """
    turn_frames = int(round(90.0 / yaw_rate_deg))          # 45 @ 2 deg/frame
    straight_frames = max(1, (n_frames - 4 * turn_frames) // 4)
    yaw = 0.0
    pos = np.array([-side / 2.0, -side / 2.0, sensor_z])
    poses = []
    seg = 0
    frames_left = n_frames
    while frames_left > 0:
        is_turn = (seg % 2 == 1)
        length = turn_frames if is_turn else straight_frames
        length = min(length, frames_left)
        for _ in range(length):
            c, s = np.cos(yaw), np.sin(yaw)
            R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            poses.append(np.concatenate([R, pos[:, None]], axis=1))
            pos = pos + R @ np.array([speed, 0.0, 0.0])
            if is_turn:
                yaw += np.radians(yaw_rate_deg)
        frames_left -= length
        seg += 1
    return np.stack(poses[:n_frames]).astype(np.float64)


# -------------------------------------------------------------------- scene
def make_city(seed: int = 0, side: float = 96.0, n_cars: int = 6) -> dict:
    """Urban blocks around the circuit: building AABBs lining both sides of
    the road, pole cylinders at the curb, and moving car boxes on the road.
    """
    rng = np.random.default_rng(seed)
    half = side / 2.0
    boxes = []   # (cx, cy, sx, sy, h)
    poles = []   # (x, y, r, h)
    # buildings along each rectangle edge, inner and outer row
    for edge in range(4):
        along = np.arange(-half + 8.0, half - 8.0, 14.0)
        for a in along:
            for off in (rng.uniform(9.0, 13.0), -rng.uniform(9.0, 13.0)):
                sx = rng.uniform(6.0, 12.0)
                sy = rng.uniform(5.0, 9.0)
                h = rng.uniform(4.0, 15.0)
                jitter = rng.uniform(-2.0, 2.0)
                if edge == 0:
                    c = (a + jitter, -half + off)
                elif edge == 1:
                    c = (half + off, a + jitter)
                elif edge == 2:
                    c = (a + jitter, half + off)
                else:
                    c = (-half + off, a + jitter)
                boxes.append((c[0], c[1], sx, sy, h))
        # curb poles every ~12 m
        for a in np.arange(-half, half, 12.0):
            off = 5.0 * (1 if rng.uniform() < 0.5 else -1)
            r = rng.uniform(0.06, 0.15)
            h = rng.uniform(2.5, 6.0)
            if edge == 0:
                poles.append((a, -half + off, r, h))
            elif edge == 1:
                poles.append((half + off, a, r, h))
            elif edge == 2:
                poles.append((a, half + off, r, h))
            else:
                poles.append((-half + off, a, r, h))
    # moving cars: drive the circuit at a different speed/phase (dynamic,
    # non-rigid-world content the matcher must reject)
    cars = []
    for i in range(n_cars):
        cars.append({
            "phase": rng.uniform(0.0, 1.0),
            "speed": rng.uniform(0.6, 1.8),      # m/frame along the circuit
            "size": (rng.uniform(3.5, 4.5), rng.uniform(1.6, 2.0),
                     rng.uniform(1.4, 1.8)),
            "lane": rng.uniform(-2.5, 2.5),
        })
    # terrain: gentle low-frequency undulation.  A *perfectly* flat ground
    # is a degenerate synthetic world: every ground patch is an identical
    # slab, descriptors collapse, and matching votes for the identity
    # transform (the sensor-relative ring pattern matches itself).  Real
    # ground has world-anchored relief; ~15 cm over 15-40 m wavelengths
    # restores that.
    n_waves = 6
    terrain = {
        "amp": rng.uniform(0.04, 0.10, n_waves),
        "kx": rng.uniform(2 * np.pi / 40.0, 2 * np.pi / 15.0, n_waves)
              * rng.choice([-1, 1], n_waves),
        "ky": rng.uniform(2 * np.pi / 40.0, 2 * np.pi / 15.0, n_waves)
              * rng.choice([-1, 1], n_waves),
        "phx": rng.uniform(0, 2 * np.pi, n_waves),
        "phy": rng.uniform(0, 2 * np.pi, n_waves),
    }
    return {
        "boxes": np.asarray(boxes, np.float64),
        "poles": np.asarray(poles, np.float64),
        "cars": cars,
        "side": side,
        "terrain": terrain,
    }


def terrain_height(scene: dict, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """World-frame ground height h(x, y) (vectorized)."""
    t = scene.get("terrain")
    if t is None:
        return np.zeros_like(x)
    h = np.zeros_like(x, dtype=np.float32)
    for a, kx, ky, px, py in zip(t["amp"], t["kx"], t["ky"],
                                 t["phx"], t["phy"]):
        h += np.float32(a) * np.sin(np.float32(kx) * x + np.float32(px)) \
             * np.sin(np.float32(ky) * y + np.float32(py))
    return h


def _car_pose(car: dict, frame: int, side: float):
    """Car center position along the circuit at a frame (piecewise linear
    around the square; cheap analog of the sensor circuit)."""
    perim = 4.0 * side
    s = (car["phase"] * perim + car["speed"] * frame) % perim
    half = side / 2.0
    edge, u = int(s // side), s % side
    if edge == 0:
        p = np.array([-half + u, -half + car["lane"], 0.0])
        yaw = 0.0
    elif edge == 1:
        p = np.array([half + car["lane"], -half + u, 0.0])
        yaw = np.pi / 2
    elif edge == 2:
        p = np.array([half - u, half + car["lane"], 0.0])
        yaw = np.pi
    else:
        p = np.array([-half + car["lane"], half - u, 0.0])
        yaw = -np.pi / 2
    return p, yaw


# ------------------------------------------------------------------ raycast
def _ray_aabbs(o: np.ndarray, d: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Nearest-entry distance of rays (N,3) into B AABBs (lo/hi (B,3));
    min over boxes, +inf where missed.  Slab test, broadcast over the box
    axis (f32: (N, B, 3) temps)."""
    inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
    tmin = np.full((o.shape[0], lo.shape[0]), -np.inf, np.float32)
    tmax = np.full_like(tmin, np.inf)
    # unrolled per-dim slabs: elementwise (N, B) min/max beats reducing a
    # strided (N, B, 3) axis by ~5x in numpy
    for k in range(3):
        t0 = (lo[None, :, k] - o[:, k, None]) * inv[:, k, None]
        t1 = (hi[None, :, k] - o[:, k, None]) * inv[:, k, None]
        np.maximum(tmin, np.minimum(t0, t1), out=tmin)
        np.minimum(tmax, np.maximum(t0, t1), out=tmax)
    hit = (tmax >= np.maximum(tmin, 0.0)) & (tmin > 0.0)
    return np.min(np.where(hit, tmin, np.inf), axis=1)


def _ray_cylinders(o, d, cyl):
    """Nearest hit over P vertical cylinders ``cyl = (x, y, r, h) (P, 4)``."""
    ox = o[:, 0, None] - cyl[None, :, 0]
    oy = o[:, 1, None] - cyl[None, :, 1]
    dx, dy = d[:, 0, None], d[:, 1, None]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - cyl[None, :, 2] ** 2
    disc = b * b - 4.0 * a * c
    ok = (disc > 0.0) & (a > 1e-12)
    sq = np.sqrt(np.maximum(disc, 0.0))
    t = (-b - sq) / np.where(ok, 2.0 * a, 1.0)
    z = o[:, 2, None] + t * d[:, 2, None]
    ok &= (t > 0.0) & (z >= 0.0) & (z <= cyl[None, :, 3])
    return np.min(np.where(ok, t, np.inf), axis=1)


def raycast_scan(scene: dict, pose: np.ndarray, frame: int,
                 sensor: SensorConfig = SensorConfig(),
                 az_step_deg: float | None = None,
                 max_range: float = 80.0, noise_sigma: float = 0.02,
                 dropout: float = 0.08, seed: int = 0) -> np.ndarray:
    """Ray-cast one Velodyne scan from ``pose`` (3x4 world pose) at
    ``frame`` (drives the moving cars).  Returns (M, 4) sensor-frame
    points+reflectance, M <= n_beams * n_azimuths."""
    rng = np.random.default_rng(seed * 1_000_003 + frame)
    az_step = az_step_deg if az_step_deg is not None else sensor.azimuth_res_deg
    elev = np.radians(np.linspace(sensor.vertical_view_up_deg,
                                  sensor.vertical_view_down_deg,
                                  sensor.n_lines))
    azim = np.radians(np.arange(0.0, 360.0, az_step))
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(azim), np.sin(azim)
    # (beams, az, 3) sensor-frame unit rays
    d_sensor = np.stack([
        np.outer(ce, ca), np.outer(ce, sa),
        np.broadcast_to(se[:, None], (elev.size, azim.size)),
    ], axis=-1).reshape(-1, 3)
    R, tw = pose[:, :3].astype(np.float32), pose[:, 3].astype(np.float32)
    d = (d_sensor @ R.T).astype(np.float32)  # world-frame directions
    o = np.broadcast_to(tw, d.shape)

    # all AABBs this frame: buildings + moving cars (cars axis-aligned —
    # fine at the scale of a 4 m box and irrelevant to the rigid-world
    # violation they exist to create)
    b = scene["boxes"]
    lo = np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                   np.zeros(len(b))], axis=1)
    hi = np.stack([b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2,
                   b[:, 4]], axis=1)
    for car in scene["cars"]:
        p, yaw = _car_pose(car, frame, scene["side"])
        sx, sy, sz = car["size"]
        if abs(np.sin(yaw)) > 0.5:
            sx, sy = sy, sx
        lo = np.concatenate([lo, [[p[0] - sx / 2, p[1] - sy / 2, 0.0]]])
        hi = np.concatenate([hi, [[p[0] + sx / 2, p[1] + sy / 2, sz]]])
    lo = lo.astype(np.float32)
    hi = hi.astype(np.float32)
    cyl = scene["poles"].astype(np.float32)

    # chunk rays so the (chunk, B) broadcast temps stay cache-friendly
    t_best = np.empty(d.shape[0], np.float32)
    CH = 16384
    for s in range(0, d.shape[0], CH):
        oc, dc = o[s:s + CH], d[s:s + CH]
        dz = dc[:, 2]
        safe_dz = np.where(dz < -1e-9, dz, -1.0)
        tg = np.where(dz < -1e-9, -tw[2] / safe_dz, np.inf)  # flat-plane seed
        # refine against the terrain height field: fixed-point
        # t <- (h(x,y) - oz) / dz (converges fast for |grad h| << 1)
        for _ in range(3):
            gx = oc[:, 0] + np.where(np.isfinite(tg), tg, 0.0) * dc[:, 0]
            gy = oc[:, 1] + np.where(np.isfinite(tg), tg, 0.0) * dc[:, 1]
            h = terrain_height(scene, gx, gy)
            tg = np.where(dz < -1e-9, (h - tw[2]) / safe_dz, np.inf)
        tb = np.where(tg > 0, tg, np.inf)
        tb = np.minimum(tb, _ray_aabbs(oc, dc, lo, hi))
        tb = np.minimum(tb, _ray_cylinders(oc, dc, cyl))
        t_best[s:s + CH] = tb

    hit = np.isfinite(t_best) & (t_best > 2.0) & (t_best < max_range)
    hit &= rng.uniform(size=hit.shape) > dropout
    t_hit = t_best[hit] + rng.normal(0.0, noise_sigma, hit.sum())
    pts_world = o[hit] + d[hit] * t_hit[:, None]
    pts_sensor = (pts_world - tw) @ R
    refl = rng.uniform(0.0, 1.0, (pts_sensor.shape[0], 1))
    return np.concatenate([pts_sensor, refl], axis=1).astype(np.float32)



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
