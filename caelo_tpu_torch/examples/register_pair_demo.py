"""End-to-end demo: synthetic scan pair -> the port's front end -> pose
(port of ``examples/register_pair_demo.py``).

Extracts keypoints and descriptors of two scans with the shipped reference
weights, matches them, runs batched RANSAC and prints the pose error
against the ground truth.

    python -m caelo_tpu_torch.examples.register_pair_demo [--platform cpu]

Exits 1 if the registration fails or misses the reference's success gate
(RRE < 1 deg, RTE < 0.5 m).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..cli import _add_common, _device
from ..config import PipelineConfig
from ..data.synthetic import synthetic_scan_pair
from ..frontend.registration import extract_frame_features, register_pair
from ..geometry.se3 import rotation_geodesic_deg
from ..models import weights_io


def timed(fn, device):
    """``(fn(), seconds)``: CUDA events around the call on the card, the
    host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def run(args, cfg: PipelineConfig) -> int:
    device = _device(args)
    print("devices:", torch.cuda.get_device_name(device)
          if device.type == "cuda" else "cpu")
    print("generating synthetic scan pair...")
    scan0, mask0, scan1, mask1, R_gt, t_gt = synthetic_scan_pair(seed=0,
                                                                 cfg=cfg)
    print(f"scan0: {mask0.sum()} pts, scan1: {mask1.sum()} pts")

    respond, encoder = weights_io.build_models(
        weights_io.load_respond_layer_params(),
        weights_io.load_patch_encoder_params(), device, cfg)
    on = lambda a: torch.from_numpy(a).to(device)
    f0, s0 = timed(lambda: extract_frame_features(
        respond, encoder, on(scan0), on(mask0), cfg), device)
    f1, s1 = timed(lambda: extract_frame_features(
        respond, encoder, on(scan1), on(mask1), cfg), device)
    print(f"feature extraction: {s0:.2f}s (compile+run), {s1:.3f}s (cached)")
    print(f"keypoints: {int(f0.mask.sum())} / {int(f1.mask.sum())}")

    reg, s2 = timed(lambda: register_pair(
        f0, f1, cfg, generator=torch.Generator(device).manual_seed(0)),
        device)
    reg, s3 = timed(lambda: register_pair(
        f0, f1, cfg, generator=torch.Generator(device).manual_seed(1)),
        device)
    print(f"registration: {s2:.2f}s (compile+run), {s3:.3f}s (cached)")

    ang_err = float(rotation_geodesic_deg(
        reg.R, torch.as_tensor(R_gt, dtype=torch.float32, device=device)))
    t_err = float(np.linalg.norm(reg.t.double().cpu().numpy() - t_gt))
    print(f"success={bool(reg.success)} inliers={int(reg.n_inliers)} "
          f"threshold={float(reg.threshold):.2f}")
    print(f"rotation error: {ang_err:.4f} deg   translation error: "
          f"{t_err:.4f} m")
    if not bool(reg.success):
        print("FAIL: registration failed", file=sys.stderr)
        return 1
    if not (ang_err < 1.0 and t_err < 0.5):
        print("FAIL: pose error above KITTI success gate", file=sys.stderr)
        return 1
    print("OK: within the reference success thresholds (RRE<1deg, RTE<0.5m)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _add_common(ap)
    return run(ap.parse_args(argv), PipelineConfig())


if __name__ == "__main__":
    sys.exit(main())
