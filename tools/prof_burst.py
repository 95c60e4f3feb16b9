"""Profile the burst map ICP on one CUDA card at the default config.

    python3 tools/prof_burst.py        # from the repo root

Ray-casts frames 29-42 of ``chip_smoke.py``'s phase-7 circuit (the burst
span (29, 42), 13 pairs), extracts their refinement features with random
weights (seed 0) at the default ``PipelineConfig()``, and solves the span
with ``burst_map_icp`` from the ground-truth rels moved by 0.3 deg of yaw
and 0.2 m.  Prints:

- ``burst_map_icp``'s wall time in two calls, its map ICPs (count, trips,
  ms and reference size of each) and its nearest-neighbour passes;
- the map ICP of the last burst frame against the map of all frames
  before it, traced with ``torch.profiler``: device events, events per
  trip, device busy time (the union of the events' intervals) against the
  traced call's wall time, the idle share, and the device events with the
  most device time;
- one nearest-neighbour pass and one single-lane Horn solve of that ICP,
  by CUDA events (mean of 20) and host wall time;
- the peak device memory and the card's nvidia-smi name and power limit.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from caelo_tpu_torch import _build, setup_device  # noqa: E402
from caelo_tpu_torch.backend import burst  # noqa: E402
from caelo_tpu_torch.config import PipelineConfig  # noqa: E402
from caelo_tpu_torch.data.hard_synthetic import (  # noqa: E402
    generate_benchmark)
from caelo_tpu_torch.frontend.odometry import (  # noqa: E402
    run_odometry_windowed)
from caelo_tpu_torch.geometry import se3  # noqa: E402
from caelo_tpu_torch.geometry.kitti_pose import rel_pose_lidar  # noqa: E402
from caelo_tpu_torch.models.weights_io import (  # noqa: E402
    build_models, random_flax_params)

SPAN = (29, 42)


def log(*a):
    print(*a, flush=True)


def event_ms(fn, reps=20):
    """(CUDA-event ms, host wall ms) per call, mean of ``reps``."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return (s.elapsed_time(e) / reps,
            (time.perf_counter() - t0) * 1e3 / reps)


def merged_us(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("prof_burst: no CUDA device")
    card = chip_smoke.nvidia_smi_line()
    dev = setup_device("cuda:0")
    _build.load_library()
    log(f"card: {card}")
    cfg = PipelineConfig()
    a, b = SPAN
    circuit = dict(chip_smoke.CIRCUIT, frame_range=(a, b + 1))
    t0 = time.perf_counter()
    scans, gt = generate_benchmark(cfg=cfg, **circuit)
    log(f"ray-cast frames {a}-{b} in {time.perf_counter() - t0:.1f} s")
    net, enc = build_models(*random_flax_params(0), dev, cfg)
    _, _, ref = run_odometry_windowed(scans, net, enc, cfg=cfg, window=16,
                                      seed=0, keep_refine_features=True)
    log(f"span {SPAN}: ext points per frame "
        f"{ref.ext_mask.sum(1).cpu().tolist()}")

    L = b - a
    rng = np.random.default_rng(0)
    rels = [rel_pose_lidar(gt[k], gt[k + 1], np.eye(3), np.zeros(3))
            for k in range(a, b)]
    relR = np.stack([r @ chip_smoke.yaw(0.3 * rng.choice([-1, 1]))
                     for r, _ in rels]).astype(np.float32)
    relT = np.stack([t + rng.normal(0, 0.2 / np.sqrt(3), 3)
                     for _, t in rels]).astype(np.float32)
    args = (ref.ext_pts, ref.ext_mask, torch.as_tensor(relR, device=dev),
            torch.as_tensor(relT, device=dev), L)
    kw = dict(icp_cfg=cfg.icp, frame_budget=min(2048, cfg.icp.max_points),
              thr_scale=2.0)

    # instrument the map ICPs and their trips
    icp_fn, trip_fn = burst.icp_vs_map, burst.MapIcp.trip
    nn_fn = burst.nearest_neighbors
    calls, trips, nn = [], [0], [0]
    kept = {}

    def icp(pc, msk, mpts, mmsk, *rest):
        torch.cuda.synchronize()
        n0, t0 = trips[0], time.perf_counter()
        out = icp_fn(pc, msk, mpts, mmsk, *rest)
        torch.cuda.synchronize()
        calls.append((trips[0] - n0, (time.perf_counter() - t0) * 1e3,
                      int(mmsk.sum())))
        if len(calls) == L:             # the last frame of sweep 1
            kept["args"] = [x.clone() if isinstance(x, torch.Tensor) else x
                            for x in (pc, msk, mpts, mmsk, *rest)]
        return out

    def trip(self, i):
        trips[0] += 1
        return trip_fn(self, i)

    burst.icp_vs_map, burst.MapIcp.trip = icp, trip
    burst.nearest_neighbors = lambda *x: nn.__setitem__(0, nn[0] + 1) \
        or nn_fn(*x)
    try:
        for call in range(2):
            calls.clear()
            trips[0] = nn[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = burst.burst_map_icp(*args, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            log(f"burst_map_icp call {call}: {ms:.1f} ms, {len(calls)} map "
                f"ICPs ({sum(c[1] for c in calls):.1f} ms), {nn[0]} NN "
                f"passes ({ms / max(nn[0], 1):.2f} ms per pass); oks "
                f"{out[2].astype(int).tolist()}, ok_cl {out[7]}; {card}")
    finally:
        burst.icp_vs_map, burst.MapIcp.trip = icp_fn, trip_fn
        burst.nearest_neighbors = nn_fn
    log(f"map ICP trips: {[c[0] for c in calls]}")
    log(f"map ICP ms: {[round(c[1], 1) for c in calls]}")
    log(f"map ICP reference sizes: {[c[2] for c in calls]}")

    # one map ICP, traced
    pc, msk, mpts, mmsk, R0, t0_, icp_cfg, thr = kept["args"]
    n_ref = int(mmsk.sum())
    icp_fn(*kept["args"])
    torch.cuda.synchronize()
    wall0 = time.perf_counter()
    icp_fn(*kept["args"])
    torch.cuda.synchronize()
    unprof = (time.perf_counter() - wall0) * 1e3
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    trips[0] = 0
    with torch.profiler.profile(activities=act) as prof:
        wall0 = time.perf_counter()
        burst.MapIcp.trip = trip
        try:
            icp_fn(*kept["args"])
        finally:
            burst.MapIcp.trip = trip_fn
        torch.cuda.synchronize()
        wall = (time.perf_counter() - wall0) * 1e3
    dev_ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if dev_ev:
        busy = merged_us([(e.time_range.start, e.time_range.end)
                          for e in dev_ev]) / 1e3
        log(f"profiled map ICP ({n_ref} reference points, {trips[0]} "
            f"trips): wall {wall:.1f} ms (unprofiled {unprof:.1f} ms), "
            f"{len(dev_ev)} device events, device busy {busy:.1f} ms of a "
            f"{wall:.1f} ms traced call -> idle share "
            f"{1 - busy / wall:.3f}; device events per trip "
            f"{len(dev_ev) / max(trips[0], 1):.0f}; {card}")
        by_name = {}
        for e in dev_ev:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.end
                               - e.time_range.start)
        top = sorted(by_name.items(), key=lambda x: -x[1][1])[:8]
        log("top device events (count, ms): " + "; ".join(
            f"{k[:60]} {n} {us / 1e3:.2f}" for k, (n, us) in top))
    else:
        log(f"profiled map ICP: the profiler recorded no device events "
            f"(device busy time not measured); wall {wall:.1f} ms, "
            f"unprofiled {unprof:.1f} ms")

    pcc = se3.apply(R0, t0_, pc)
    nn_ev, nn_wall = event_ms(lambda: nn_fn(pcc, msk, mpts, mmsk))
    log(f"one NN pass ({pc.shape[0]} x {n_ref}): {nn_ev:.3f} ms events, "
        f"{nn_wall:.3f} ms wall; {card}")
    idx, dist = nn_fn(pcc, msk, mpts, mmsk)
    w = ((dist < 1.0) & msk).to(torch.float32)
    h_ev, h_wall = event_ms(lambda: se3.solve_rigid_horn(mpts[idx], pcc, w))
    log(f"one single-lane Horn solve: {h_ev:.3f} ms events, {h_wall:.3f} "
        f"ms wall; {card}")
    log(f"peak memory MiB {torch.cuda.max_memory_allocated() / 2 ** 20:.1f}")


if __name__ == "__main__":
    main()
