"""Sequence-scale proof run: the KITTI seq-00 frame count through the full
pipeline (port of ``examples/seq_scale.py``).

The reference's operating point is 4,541 frames (seq 00,
``PoseEstimation.py:241-268`` + ``RefinePoses.py`` over full sequences).
This run proves the port at that scale on one card: the memory of the
features kept on the device for every frame, the windowed front end, the
loop-closure candidate search at N ~ 4.5k (the all-pairs descriptor GEMM +
batched verification) and the exact host pose-graph solve at 27k unknowns.

The trajectory is the hard ray-cast circuit driven for ~8.7 laps, so every
place is revisited ~8 times: a multi-revisit loop-closure stress the
520-frame benchmark cannot produce.

    python -m caelo_tpu_torch.examples.seq_scale [--frames 4541] \\
        [--weights runs/scratch] [--json-out runs/seq_scale.json] \\
        [--platform cpu]

Gates (VERDICT r4 item 3 and the reference's registration gates): pair
success >= 99 %, >= 20 frames/s end to end, peak host RSS < 8 GB, loop
precision >= 0.9 and the final ATE at most half the raw one.  Prints the
result JSON on standard output, the verdict on standard error, and exits 0
iff the gates pass.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

from ..cli import _add_common, _device
from ..config import PipelineConfig
from ..data.scancache import NpyScanReader, write_benchmark_cache_parallel
from ..eval.metrics import (absolute_trajectory_error, loop_closure_pr,
                            registration_summary, relative_pose_errors)
from ..pipeline import run_full_pipeline
from ..utils.telemetry import StageTimer
from .hard_benchmark import models

# the gates, as examples/seq_scale.py:160-164 has them
SUCCESS = 0.99              # per-pair success (RRE < 1 deg, RTE < 0.5 m)
FPS_E2E = 20.0              # frames/s of the whole pipeline
RSS_GB = 8.0                # peak host RSS
LOOP_PRECISION = 0.9
LOOP_ATE_SHRINK = 0.5       # final ATE <= 0.5 x raw ATE
LAP_FRAMES = 520            # the circuit driven lap after lap


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


class _Slice:
    """The first ``n`` frames of a longer cache reader."""

    def __init__(self, r, n):
        self.r, self.n = r, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.r[i]

    def mask(self, i):
        return self.r.mask(i)


def gates(out: dict) -> dict:
    """Each gate's verdict on the result JSON ``out``: per-pair success,
    frames/s end to end, peak host RSS, loop precision (NaN, so failed,
    without an accepted edge) and the ATE halved."""
    return {
        "success": out["success_rate"] >= SUCCESS,
        "fps": out["frames_per_s_e2e"] >= FPS_E2E,
        "rss": out["peak_rss_gb"] < RSS_GB,
        "precision": out["loop_precision"] >= LOOP_PRECISION,
        "ate": out["ate_m"]["final"] <= LOOP_ATE_SHRINK * out["ate_m"]["raw"],
    }


def load_scans(args, cfg: PipelineConfig):
    """``(scans, poses_gt, gen_seconds)``: the ``--scan-cache`` stacks, ray-
    cast into them first by parallel processes when they are missing, read
    frame by frame (host RSS stays O(window))."""
    t0 = time.time()
    base = args.scan_cache
    if not os.path.exists(base + ".pts.npy"):
        write_benchmark_cache_parallel(
            base, args.frames, cfg, seed=args.seed, lap_frames=LAP_FRAMES,
            progress=lambda b: print(f"  generated {b}/{args.frames}",
                                     file=sys.stderr))
    poses_gt = np.load(base + ".gt.npy")[:args.frames]
    scans = NpyScanReader(base)
    if len(scans) < args.frames:
        raise SystemExit(f"{base}: {len(scans)} frames cached, "
                         f"--frames {args.frames}")
    if len(scans) > args.frames:
        scans = _Slice(scans, args.frames)
    gen_s = time.time() - t0
    print(f"generated {args.frames} ray-cast frames in {gen_s:.0f} s "
          f"(rss {rss_gb():.1f} GB)", file=sys.stderr)
    return scans, poses_gt, gen_s


def run(args, cfg: PipelineConfig) -> int:
    device = _device(args)
    respond_net, encoder, cfg = models(args, cfg, device)
    scans, poses_gt, gen_s = load_scans(args, cfg)

    timer = StageTimer(sync=True)
    pipe_kwargs = {"window": args.window} if args.window > 0 else {}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)
    t0 = time.time()
    result = run_full_pipeline(scans, respond_net, encoder, cfg=cfg,
                               enable_loop_closure=True, timer=timer,
                               seed=args.seed,
                               candidate_source=args.candidate_source,
                               **pipe_kwargs)
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    peak_mib = (torch.cuda.max_memory_allocated(device) / 2 ** 20
                if cuda else None)
    print(f"pipeline: {wall:.1f} s ({args.frames / wall:.2f} frames/s e2e, "
          f"rss {rss_gb():.1f} GB)", file=sys.stderr)

    errs = relative_pose_errors(poses_gt, result.poses_raw, np.eye(3),
                                np.zeros(3))
    summary = registration_summary(errs)
    ate = {name: absolute_trajectory_error(poses_gt, p)["ate_rmse"]
           for name, p in [("raw", result.poses_raw),
                           ("dejumped", result.poses_dejumped),
                           ("refined", result.poses_refined),
                           ("final", result.poses_final)]}
    pr = loop_closure_pr(result.loop_edge_i, result.loop_edge_j,
                         poses_gt.reshape(-1, 3, 4)[:, :, 3])
    out = {
        "frames": args.frames,
        "window": args.window,
        "candidate_source": args.candidate_source,
        "gen_seconds": round(gen_s, 1),
        "pipeline_seconds": round(wall, 1),
        "frames_per_s_e2e": round(args.frames / wall, 2),
        "peak_rss_gb": round(rss_gb(), 2),
        "stage_seconds": timer.summary(),
        "success_rate": summary["success_rate"],
        "rre_deg": summary["rre_deg"],
        "rte_m": summary["rte_m"],
        "ate_m": {k: round(v, 3) for k, v in ate.items()},
        "n_loop_closures": int(result.n_loop_closures),
        "loop_precision": pr["precision"],
        "loop_recall": pr["recall"],
        "loop_edges": [[int(a), int(b)] for a, b in
                       zip(result.loop_edge_i, result.loop_edge_j)],
        "dejumped": len(result.dejumped_frames),
        "refined_spans": len(result.refine_stats.refined),
        "peak_device_mib": (None if peak_mib is None
                            else round(peak_mib, 1)),
        "device": (torch.cuda.get_device_name(device) if cuda
                   else str(device)),
    }
    print(json.dumps(out, indent=2))
    if os.path.dirname(args.json_out):
        os.makedirs(os.path.dirname(args.json_out), exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(out, f, indent=2)
    # loop-pin coverage: the largest frame span with no accepted-edge
    # endpoint.  On this self-similar synthetic world the pooled place
    # descriptor aliases away from the circuit-start region, so the strict
    # verification gates keep precision but concentrate the pins, and a
    # concentrated pin set cannot collapse multi-lap drift.
    pinned = np.unique(np.concatenate(
        [[0, args.frames - 1], result.loop_edge_i, result.loop_edge_j]))
    out["max_unpinned_span"] = int(np.max(np.diff(pinned))) if len(
        pinned) > 1 else args.frames
    ok = all(gates(out).values())
    with open(args.json_out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"SEQ-SCALE {'PASS' if ok else 'FAIL'} "
          f"(gates: success>=99%, >=20 fps e2e, rss<8 GB, loop P>=0.9, "
          f"ATE halved): "
          f"{args.frames} frames, success "
          f"{summary['success_rate']*100:.2f}%, ATE "
          f"{out['ate_m']['raw']:.2f}->{out['ate_m']['final']:.2f} m, "
          f"loop P {pr['precision']:.2f} R {pr['recall']:.2f} "
          f"(max unpinned span {out['max_unpinned_span']}), "
          f"rss {out['peak_rss_gb']:.1f} GB", file=sys.stderr)
    if cuda:
        print(f"peak device memory: {peak_mib:.1f} MiB ({out['device']})",
              file=sys.stderr)
    return 0 if ok else 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=4541)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", default=os.path.join("runs",
                                                       "seq_scale.json"))
    ap.add_argument("--scan-cache",
                    default=os.path.join("runs", "seq_scale_cache"),
                    help="base path for the on-disk scan stack (<path>."
                         "pts.npy/.msk.npy/.gt.npy, ~9.5 GB at 4,541 "
                         "frames): ray-cast by one process a core, a "
                         "32-frame chunk each, if missing (~13 min at "
                         "4,541 frames on 7 processes), then read frame "
                         "by frame (host RSS stays O(window))")
    ap.add_argument("--window", type=int, default=0,
                    help="front-end window size (0 = pipeline default)")
    ap.add_argument("--candidate-source", default="descriptor",
                    choices=["descriptor", "scancontext"],
                    help="loop-closure candidate source (the SC "
                         "correlation-matrix A/B, VERDICT r4 item 5)")
    ap.add_argument("--weights", default="",
                    help="load trained respond_ae/patch_ae checkpoints "
                         "from this directory (train_from_scratch_study "
                         "output) instead of the shipped .h5 models; "
                         "encoder activations switch to the training "
                         "recipe (relu convs + linear code)")
    _add_common(ap)
    return ap


def main(argv=None) -> int:
    return run(parser().parse_args(argv), PipelineConfig())


if __name__ == "__main__":
    sys.exit(main())
