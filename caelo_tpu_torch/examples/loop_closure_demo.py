"""Full-stack demo: a square loop trajectory with drift -> loop closure
fixes it (port of ``examples/loop_closure_demo.py``).

Drives the odometry stack on a synthetic sequence that revisits its start:
front end, de-jump, loop-closure detection (place recognition + geometric
verification with the shipped weights) and the pose-graph solve.  Prints
the ATE before and after and writes a trajectory plot to
``runs/loop_demo.png`` (where matplotlib is installed).

    python -m caelo_tpu_torch.examples.loop_closure_demo [--platform cpu]

Exits 1 if no loop closure was accepted.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..cli import _add_common, _device
from ..config import PipelineConfig
from ..data.synthetic import make_scene, range_filter, sample_scene_points
from ..eval.metrics import absolute_trajectory_error
from ..eval.viz import plot_trajectories
from ..models import weights_io
from ..ops.masking import pad_points
from ..pipeline import run_full_pipeline


def square_path(n_side=10, step=2.0):
    """Poses along a closed square (yaw turns at corners)."""
    from scipy.spatial.transform import Rotation

    Rs, ts = [], []
    R, t = np.eye(3), np.zeros(3)
    for leg in range(4):
        for _ in range(n_side):
            Rs.append(R.copy())
            ts.append(t.copy())
            t = t + R @ np.array([step, 0, 0])
        R = R @ Rotation.from_euler("z", 90, degrees=True).as_matrix()
    Rs.append(np.eye(3))
    ts.append(np.zeros(3))  # exact revisit of the start
    return np.array(Rs), np.array(ts)


def run(args, cfg: PipelineConfig) -> int:
    device = _device(args)
    print("devices:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu")
    scene = make_scene(seed=5, n_boxes=60, extent=40.0)
    world = sample_scene_points(scene, seed=5, n_points=cfg.max_points)
    Rs, ts = square_path()
    n = len(Rs)
    rng = np.random.default_rng(0)
    scans = []
    for i in range(n):
        local = (world - ts[i]) @ Rs[i]
        local = range_filter(local.astype(np.float32), cfg.sensor)
        local = local + rng.normal(0, 0.01, local.shape).astype(np.float32)
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        scans.append(pad_points(np.concatenate([local, refl], 1),
                                cfg.max_points))
    print(f"{n} frames around a {10*2.0:.0f} m square")

    respond, encoder = weights_io.build_models(
        weights_io.load_respond_layer_params(),
        weights_io.load_patch_encoder_params(), device, cfg)
    t0 = time.time()
    out = run_full_pipeline(
        scans, respond, encoder, cfg=cfg,
        enable_refinement=False,           # isolate the loop-closure effect
        enable_loop_closure=True, min_loop_gap=25,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"pipeline: {time.time()-t0:.1f}s, "
          f"pair success {out.odometry.successes.mean()*100:.0f}%, "
          f"loop closures accepted: {out.n_loop_closures}")

    gt = np.concatenate(
        [np.concatenate([Rs[i], ts[i][:, None]], 1).reshape(1, 12)
         for i in range(n)]
    )
    ate_raw = absolute_trajectory_error(gt, out.poses_raw)
    ate_final = absolute_trajectory_error(gt, out.poses_final)
    print(f"ATE raw:   {ate_raw['ate_rmse']:.3f} m rmse "
          f"(max {ate_raw['ate_max']:.3f})")
    print(f"ATE final: {ate_final['ate_rmse']:.3f} m rmse "
          f"(max {ate_final['ate_max']:.3f})")

    try:
        p = plot_trajectories(
            "runs/loop_demo.png",
            {"ground truth": gt, "odometry": out.poses_raw,
             "after loop closure": out.poses_final},
            axes=(0, 1),
        )
    except ImportError:
        p = "not written (matplotlib is not installed)"
    print("trajectory plot:", p)
    if out.n_loop_closures < 1:
        print("FAIL: no loop closures accepted", file=sys.stderr)
        return 1
    print("OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _add_common(ap)
    return run(ap.parse_args(argv), PipelineConfig())


if __name__ == "__main__":
    sys.exit(main())
