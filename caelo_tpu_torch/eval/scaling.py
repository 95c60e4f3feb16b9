"""Scaling sweep: frames/s against the number of ranks (port of
``caelo_tpu/eval/scaling.py``).

Runs the data-parallel batched feature extractor
(``parallel/pipeline.py::make_batched_feature_extractor``) on sub-worlds of
the first 1, 2, 4, ... ranks of the initialised process group and reports
throughput and efficiency, in the JAX package's fields.  Every rank of the
world calls it; on CUDA ranks a batch is timed with CUDA events after
``torch.cuda.synchronize()``, on CPU ranks with ``time.perf_counter``, and
a batch's time is its slowest rank's.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..parallel.mesh import axis, make_mesh
from ..parallel.pipeline import make_batched_feature_extractor


def _timed_s(fn, device) -> float:
    """Seconds of one call of ``fn`` on ``device``, its work finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def scaling_sweep(respond_net, encoder, cfg: PipelineConfig,
                  frames_per_device: int = 4,
                  device_counts: List[int] | None = None,
                  reps: int = 3, seed: int = 0) -> dict:
    """``{"sweep": [{"devices", "frames", "frames_per_s", "dt_s",
    "efficiency"}, ...]}`` on every rank: for each sub-world of n ranks,
    the median over ``reps`` (after one warm call) of the time to extract
    ``frames_per_device * n`` random frames, each rep's points moved by
    1e-4 m."""
    world, rank = dist.get_world_size(), dist.get_rank()
    device = next(respond_net.parameters()).device
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= world]
    rng = np.random.default_rng(seed)
    results = []
    for n in device_counts:
        mesh = make_mesh(n_data=n, ranks=range(n))
        B = frames_per_device * n
        pts = np.zeros((B, cfg.max_points, 4), np.float32)
        pts[..., 0] = rng.uniform(10, 60, (B, cfg.max_points))
        pts[..., 1] = rng.uniform(-30, 30, (B, cfg.max_points))
        pts[..., 2] = rng.uniform(-2, 3, (B, cfg.max_points))
        dt = torch.zeros((), dtype=torch.float64)
        if rank < n:
            group = axis(mesh)[0]
            ex = make_batched_feature_extractor(mesh, cfg)
            msk = torch.ones((B, cfg.max_points), dtype=torch.bool,
                             device=device)
            variants = [torch.from_numpy(pts + np.float32(1e-4 * r)).to(device)
                        for r in range(reps + 1)]
            ex(respond_net, encoder, variants[0], msk)
            times = []
            for r in range(reps):
                dist.barrier(group=group)
                t = torch.tensor(_timed_s(lambda: ex(
                    respond_net, encoder, variants[r + 1], msk), device),
                    dtype=torch.float64, device=device)
                dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
                times.append(float(t))
            dt = torch.tensor(sorted(times)[len(times) // 2],
                              dtype=torch.float64)
        # rank 0 takes part in every sub-world: its times go to every rank
        dt = dt.to(device)
        dist.broadcast(dt, src=0)
        results.append({"devices": n, "frames": B,
                        "frames_per_s": B / float(dt), "dt_s": float(dt)})
    base = results[0]["frames_per_s"]
    for r in results:
        r["efficiency"] = r["frames_per_s"] / (base * r["devices"])
    return {"sweep": results}
