"""One-command real-KITTI regression against the reference's golden row
(port of ``examples/kitti_golden.py``).

The reference's published frame-to-frame registration quality (CAE-LO
keypoints + CAE-LO descriptors over KITTI seqs 00-10) is pinned in
``Evaluation Result/EvaluationResults.mat`` row 1, computed by
``EvaluationOnRegistration.py:108-130``:

    RRE 0.1781 deg (sigma 0.1223)   RTE 0.0537 m (sigma 0.0629)
    success rate 99.80 %  (success = RRE < 1 deg and RTE < 0.5 m, :23-24)

The dataset is not part of the repository; with the tree mounted, the
whole regression is:

    python -m caelo_tpu_torch.examples.kitti_golden --data /path/to/kitti \\
        [--seqs 00,01,...] [--frames -1] [--out runs/kitti_golden] \\
        [--platform cpu]

Expected tree (the standard KITTI odometry layout, ``Dirs.py:14-27``):
    <data>/sequences/00/velodyne/000000.bin ...
    <data>/sequences/00/calib.txt
    <data>/poses/00.txt

Writes ``runs/KITTI_GOLDEN.json`` (``--json-out``) with per-sequence
summaries, the aggregate row and the diff against the pinned golden
numbers; exits 1 if the aggregate misses the golden row by more than the
tolerances below, 2 if no sequence was found.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..cli import _add_common, _device
from ..config import PipelineConfig, ci_config
from ..data.kitti import KittiOdometry, save_kitti_poses
from ..eval.metrics import (absolute_trajectory_error, kitti_drift,
                            registration_summary, relative_pose_errors)
from ..models import weights_io
from ..pipeline import run_full_pipeline
from ..utils.telemetry import StageTimer

# pinned golden row (BASELINE.md / EvaluationResults.mat row 1)
GOLDEN = {"rre_deg": 0.1781, "rre_std": 0.1223,
          "rte_m": 0.0537, "rte_std": 0.0629,
          "success_rate": 0.9980}
# acceptance: match-or-beat on success rate (within 0.2 pp), and mean
# errors within 25% relative -- the reference row is itself a mean over
# ~23k pairs with sigma comparable to the mean
TOL_SUCCESS = 0.002
TOL_REL = 0.25

ALL_SEQS = [f"{i:02d}" for i in range(11)]


def run(args, cfg: PipelineConfig) -> int:
    device = _device(args)
    ds = KittiOdometry(args.data, cfg)
    respond, encoder = weights_io.build_models(
        weights_io.load_respond_layer_params(),
        weights_io.load_patch_encoder_params(), device, cfg)

    per_seq = {}
    all_rre, all_rte = [], []
    for seq in args.seqs.split(","):
        seq = seq.strip()
        seq_dir = ds.sequence_dir(seq)
        if not os.path.isdir(seq_dir):
            print(f"sequence {seq}: missing ({seq_dir}) -- skipped",
                  file=sys.stderr)
            continue
        n = ds.n_frames(seq) if args.frames < 0 else args.frames
        R_tr, t_tr = ds.load_calib(seq)
        gt = ds.load_poses(seq)[:n]
        timer = StageTimer(sync=True)
        res = run_full_pipeline(
            list(ds.iter_scans(seq, 0, n)), respond, encoder, R_tr, t_tr,
            cfg, enable_loop_closure=not args.no_loops, timer=timer,
        )
        for name, poses in [("poses_", res.poses_raw),
                            ("poses__", res.poses_dejumped),
                            ("poses___", res.poses_refined),
                            ("poses____", res.poses_final)]:
            save_kitti_poses(os.path.join(args.out, name, f"{seq}.txt"),
                             poses)
        errs = relative_pose_errors(gt, res.poses_raw, R_tr, t_tr)
        s = registration_summary(errs)
        rre = np.asarray(errs.rre_deg)
        rte = np.asarray(errs.rte_m)
        all_rre.append(rre)
        all_rte.append(rte)
        per_seq[seq] = {
            **{k: round(float(v), 5) for k, v in s.items()},
            "rre_std": round(float(rre.std()), 5),
            "rte_std": round(float(rte.std()), 5),
            "frames": int(n),
            "ate_raw_m": round(absolute_trajectory_error(
                gt, res.poses_raw)["ate_rmse"], 4),
            "ate_final_m": round(absolute_trajectory_error(
                gt, res.poses_final)["ate_rmse"], 4),
            "kitti_drift": kitti_drift(gt, res.poses_final),
            "n_loop_closures": int(res.n_loop_closures),
            "stage_seconds": timer.summary(),
        }
        print(f"seq {seq}: success {s['success_rate']*100:.2f}% "
              f"RRE {s['rre_deg']:.4f} RTE {s['rte_m']:.4f} "
              f"ATE {per_seq[seq]['ate_final_m']:.2f} m", file=sys.stderr)

    if not per_seq:
        print("no sequences found under", args.data, file=sys.stderr)
        return 2

    rre = np.concatenate(all_rre)
    rte = np.concatenate(all_rte)
    success = float(np.mean((rre < 1.0) & (rte < 0.5)))
    agg = {"rre_deg": float(rre.mean()), "rre_std": float(rre.std()),
           "rte_m": float(rte.mean()), "rte_std": float(rte.std()),
           "success_rate": success, "n_pairs": int(rre.size)}

    diff = {
        "rre_rel": agg["rre_deg"] / GOLDEN["rre_deg"] - 1.0,
        "rte_rel": agg["rte_m"] / GOLDEN["rte_m"] - 1.0,
        "success_delta": agg["success_rate"] - GOLDEN["success_rate"],
    }
    ok = (diff["success_delta"] >= -TOL_SUCCESS
          and diff["rre_rel"] <= TOL_REL and diff["rte_rel"] <= TOL_REL)
    out = {"aggregate": agg, "golden": GOLDEN, "diff": diff,
           "pass": bool(ok), "per_seq": per_seq}
    os.makedirs(os.path.dirname(args.json_out) or ".", exist_ok=True)
    with open(args.json_out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: out[k] for k in ("aggregate", "golden", "diff",
                                          "pass")}, indent=2))
    print(f"GOLDEN {'PASS' if ok else 'FAIL'}: success "
          f"{agg['success_rate']*100:.2f}% vs "
          f"{GOLDEN['success_rate']*100:.2f}% "
          f"(tol -{TOL_SUCCESS*100:.1f} pp), RRE {agg['rre_deg']:.4f} vs "
          f"{GOLDEN['rre_deg']:.4f} (+{TOL_REL*100:.0f}% tol), RTE "
          f"{agg['rte_m']:.4f} vs {GOLDEN['rte_m']:.4f}", file=sys.stderr)
    return 0 if ok else 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", required=True, help="KITTI odometry root")
    ap.add_argument("--seqs", default=",".join(ALL_SEQS))
    ap.add_argument("--frames", type=int, default=-1,
                    help="frames per sequence (-1 = all)")
    ap.add_argument("--out", default="runs/kitti_golden")
    ap.add_argument("--no-loops", action="store_true")
    ap.add_argument("--json-out", default="runs/KITTI_GOLDEN.json")
    ap.add_argument("--ci-config", action="store_true",
                    help="CI-scale config (config.ci_config), for a "
                         "synthetic KITTI-format tree in the CPU tests")
    _add_common(ap)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    return run(args, ci_config() if args.ci_config else PipelineConfig())


if __name__ == "__main__":
    sys.exit(main())
