"""Command line of the port (port of ``caelo_tpu/cli.py``): preprocess,
train, odometry, refine, loop closure, evaluate and the full stack.

  python -m caelo_tpu_torch.cli odometry --data /kitti --seq 00 --out runs/
  python -m caelo_tpu_torch.cli refine   --poses runs/poses_/00.txt ...
  python -m caelo_tpu_torch.cli evaluate --gt ... --est ...
  python -m caelo_tpu_torch.cli train-respond / train-patch ...
  python -m caelo_tpu_torch.cli selftest   # synthetic end-to-end check
  python -m caelo_tpu_torch.cli bench      # front-end frames/s, one JSON line

Every command runs on the CUDA device (``--platform cuda``, the default)
and on the CPU only when asked (``--platform cpu``); without a CUDA device
the default fails rather than fall back.  ``odometry --keypoints`` runs
every keypoint source: the CAE-LO window, the ISS / Harris3D / SIFT3D /
random baselines and external keypoint trees.  ``scaling`` spawns one
rank per CUDA device (``--platform cpu --ranks R``: R gloo ranks on the
CPU) and sweeps the data-parallel feature extractor over them.  ``bench``
times the steady-state 64-frame front-end window (``bench.py``, its knobs
the ``BENCH_*`` environment variables).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from . import setup_device
from .config import PipelineConfig, ci_config, small_test_config
from .models import weights_io


def _add_common(p):
    p.add_argument("--platform", default="cuda",
                   help="torch device to run on (cuda, cuda:N or cpu)")


def _device(args) -> torch.device:
    """The device of ``--platform``; a CUDA request without a CUDA device
    fails instead of falling back to the CPU."""
    device = torch.device(args.platform)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--platform {args.platform}: no CUDA device; pass "
                         "--platform cpu to run on the CPU")
    return setup_device(device)


def _reference_models(device, cfg, respond_path=None, encoder_path=None):
    """The shipped respond layer and patch encoder (``.h5``) as modules."""
    return weights_io.build_models(
        weights_io.load_respond_layer_params(respond_path),
        weights_io.load_patch_encoder_params(encoder_path), device, cfg)


def _progress(seq: str, n: int):
    return lambda i: print(f"{seq}:{n}:{i}", end="\r", flush=True)


def cmd_selftest(args):
    """Synthetic end-to-end registration check (no dataset needed)."""
    device = _device(args)
    from .data.synthetic import synthetic_scan_pair
    from .frontend.registration import extract_frame_features, register_pair
    from .geometry.se3 import rotation_geodesic_deg

    cfg = small_test_config() if args.small else PipelineConfig()
    scan0, mask0, scan1, mask1, R_gt, t_gt = synthetic_scan_pair(seed=0, cfg=cfg)
    if weights_io.reference_models_available():
        respond, encoder = _reference_models(device, cfg)
    else:
        respond, encoder = weights_io.build_models(
            *weights_io.random_flax_params(0), device, cfg)
    on = lambda a: torch.from_numpy(a).to(device)
    f0 = extract_frame_features(respond, encoder, on(scan0), on(mask0), cfg)
    f1 = extract_frame_features(respond, encoder, on(scan1), on(mask1), cfg)
    reg = register_pair(f0, f1, cfg,
                        generator=torch.Generator(device).manual_seed(0))
    ang = float(rotation_geodesic_deg(
        reg.R, torch.as_tensor(R_gt, dtype=torch.float32, device=device)))
    terr = float(np.linalg.norm(reg.t.double().cpu().numpy() - t_gt))
    out = {"success": bool(reg.success), "n_inliers": int(reg.n_inliers),
           "rot_err_deg": round(ang, 4), "trans_err_m": round(terr, 4),
           "device": str(device)}
    print(json.dumps(out))
    return 0 if out["success"] and ang < 1.0 and terr < 0.5 else 1


def _external_feature_fn(args, encoder, device, cfg):
    """``feature_fn`` of ``--keypoints external``: frame i's keypoints of
    the external tree (``EvalOnReg_KeyPts.py:73-204`` / ``Dirs.py:35-41``)
    with the file's descriptors, or described by the CAE-LO encoder where
    the layout has none."""
    import itertools

    from .data.external import ExternalSequence
    from .frontend.ablation import features_from_keypoints
    from .frontend.registration import FrameFeatures

    ext = ExternalSequence(args.external_dir, seq=args.seq,
                           fmt=args.external_fmt,
                           desc_dim=args.external_desc_dim,
                           n_slots=cfg.keypoint.n_keypoints)
    counter = itertools.count()
    on = lambda a: torch.as_tensor(a).to(device).contiguous()

    def feature_fn(pts, mask):
        f = ext.features(next(counter))
        if isinstance(f, FrameFeatures):
            return FrameFeatures(*map(on, f))
        kp, km = f                                   # keypoints only
        return features_from_keypoints(encoder, on(pts), on(mask), on(kp),
                                       on(km), cfg)
    return feature_fn


def cmd_odometry(args):
    device = _device(args)
    from .data.kitti import KittiOdometry, save_kitti_poses
    from .frontend.odometry import run_odometry, run_odometry_windowed

    if args.keypoints == "external" and not args.external_dir:
        print("--keypoints external requires --external-dir",
              file=sys.stderr)
        return 2
    cfg = PipelineConfig()
    ds = KittiOdometry(args.data, cfg)
    respond, encoder = _reference_models(device, cfg, args.respond_weights,
                                         args.encoder_weights)
    R_tr, t_tr = ds.load_calib(args.seq)
    n = ds.n_frames(args.seq) if args.frames < 0 else args.frames
    scans, progress = ds.iter_scans(args.seq, 0, n), _progress(args.seq, n)
    if args.keypoints == "cae-lo":
        result, _ = run_odometry_windowed(
            scans, respond, encoder, R_tr, t_tr, cfg, window=min(64, n),
            progress=progress)
    else:
        # frame by frame with another keypoint source (the JAX command's
        # run_odometry(feature_fn=...), caelo_tpu/cli.py:96-143)
        if args.keypoints == "external":
            feature_fn = _external_feature_fn(args, encoder, device, cfg)
        else:
            from .frontend.ablation import make_ablation_feature_fn

            feature_fn = make_ablation_feature_fn(args.keypoints, respond,
                                                  encoder, cfg)
        result = run_odometry(scans, respond, encoder, R_tr, t_tr, cfg,
                              feature_fn=feature_fn, progress=progress)
    out = os.path.join(args.out, "poses_", f"{args.seq}.txt")
    save_kitti_poses(out, result.poses)
    np.savez(os.path.join(args.out, f"odom_{args.seq}.npz"),
             rel_Rs=result.rel_Rs, rel_ts=result.rel_ts,
             successes=result.successes, n_inliers=result.n_inliers,
             thresholds=result.thresholds,
             **{f"inl0_{i}": p[0] for i, p in enumerate(result.inlier_pairs)},
             **{f"inl1_{i}": p[1] for i, p in enumerate(result.inlier_pairs)})
    # the reference's Matchablity_*.mat stats (GenerateTrajactory.m:284-290):
    # inlier proportion + the adaptive-effort stat (threshold escalations
    # stand in for its trial counts)
    inlier_ratio = result.n_inliers.mean() / cfg.keypoint.n_keypoints
    esc = (result.thresholds > cfg.ransac.residual_thresholds[0]).mean()
    print(f"\nwrote {out}: {len(result.poses)} poses, "
          f"{result.successes.mean()*100:.1f}% pair success, "
          f"inlier ratio {inlier_ratio*100:.1f}%, "
          f"threshold escalation {esc*100:.1f}%")
    return 0


def cmd_preprocess(args):
    """Front-end pass persisting per-frame artifacts + poses_ (the
    reference's BatchPreprocess + PoseEstimation stages; restartable
    back-end stages read these via ``cli refine`` / ``cli loop``)."""
    device = _device(args)
    from .data.artifacts import ArtifactStore
    from .data.kitti import KittiOdometry, save_kitti_poses
    from .pipeline import preprocess_to_store

    cfg = PipelineConfig()
    ds = KittiOdometry(args.data, cfg)
    respond, encoder = _reference_models(device, cfg)
    R_tr, t_tr = ds.load_calib(args.seq)
    n = ds.n_frames(args.seq) if args.frames < 0 else args.frames
    store = ArtifactStore(args.artifacts)
    odo = preprocess_to_store(
        ds.iter_scans(args.seq, 0, n), respond, encoder, R_tr, t_tr, cfg,
        store, args.seq, progress=_progress(args.seq, n))
    out = os.path.join(args.out, "poses_", f"{args.seq}.txt")
    save_kitti_poses(out, odo.poses)
    print(f"\nwrote {out} + artifacts under {args.artifacts}: "
          f"{len(odo.poses)} frames, "
          f"{odo.successes.mean()*100:.1f}% pair success")
    return 0


def cmd_refine(args):
    """De-jump + (with --artifacts) ICP refinement from stored artifacts:
    poses_ -> poses__ -> poses___ without touching raw scans
    (``RefinePoses.py:526-531`` stage toggles ``iDejump/iRefineOdometry``)."""
    device = _device(args)
    from .backend.refine import fix_jump_poses

    cfg = PipelineConfig()
    poses = np.loadtxt(args.poses).reshape(-1, 12)
    trusted = None
    if args.artifacts:
        # use the stored per-pair RANSAC evidence to gate jump detection
        # (trusted high-inlier registrations are real motion, not jumps)
        from .data.artifacts import ArtifactStore
        from .pipeline import load_stage_inputs

        data = load_stage_inputs(ArtifactStore(args.artifacts), args.seq,
                                 device=device)
        trusted = data["successes"]
    fixed, frames = fix_jump_poses(poses, cfg.refine, pair_trusted=trusted)
    out_dj = args.out or args.poses.replace("poses_", "poses__")
    os.makedirs(os.path.dirname(out_dj) or ".", exist_ok=True)
    np.savetxt(out_dj, fixed)
    print(f"de-jumped {len(frames)} frames -> {out_dj}")
    if not args.artifacts:
        return 0

    from .pipeline import stage_refinement

    poses_ref, stats = stage_refinement(
        fixed, data["ref_feats"], data["inlier_pairs"],
        data["R_tr"], data["t_tr"], cfg, pair_trusted=data["successes"])
    out_ref = out_dj.replace("poses__", "poses___")
    # the JAX command writes into this directory without making it
    os.makedirs(os.path.dirname(out_ref) or ".", exist_ok=True)
    np.savetxt(out_ref, poses_ref)
    print(f"refined {len(stats.refined)} spans "
          f"({len(stats.failed)} failed, {len(stats.rejected)} rejected) "
          f"-> {out_ref}")
    return 0


def cmd_loop(args):
    """Loop closure + pose-graph solve from stored artifacts:
    poses___ -> poses____ (``CloseLoopPipeline``, ``RefinePoses.py:477-518``
    -- restartable via ``iCloseLoop``-style staging)."""
    device = _device(args)
    from .data.artifacts import ArtifactStore
    from .pipeline import load_stage_inputs, stage_loop_closure

    cfg = PipelineConfig()
    poses = np.loadtxt(args.poses).reshape(-1, 12)
    data = load_stage_inputs(ArtifactStore(args.artifacts), args.seq,
                             device=device)
    poses_final, n_loops, ei, ej = stage_loop_closure(
        poses, data["feats"], data["rel_Rs"], data["rel_ts"],
        data["R_tr"], data["t_tr"], cfg, min_loop_gap=args.min_gap,
        candidate_source=args.candidates)
    out = args.out or args.poses.replace("poses___", "poses____")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.savetxt(out, poses_final)
    print(f"closed {n_loops} loops "
          f"({list(zip(ei.tolist(), ej.tolist()))}) -> {out}")
    return 0


def cmd_evaluate(args):
    _device(args)
    from .eval.metrics import (absolute_trajectory_error, kitti_drift,
                               registration_summary, relative_pose_errors)
    from .geometry.kitti_pose import load_calib_tr

    gt = np.loadtxt(args.gt).reshape(-1, 12)
    est = np.loadtxt(args.est).reshape(-1, 12)
    n = min(len(gt), len(est))
    gt, est = gt[:n], est[:n]
    if args.calib:
        R_tr, t_tr = load_calib_tr(args.calib)
    else:
        R_tr, t_tr = np.eye(3), np.zeros(3)
    errs = relative_pose_errors(gt, est, R_tr, t_tr)
    out = registration_summary(errs)
    out.update(absolute_trajectory_error(gt, est))
    out.update(kitti_drift(gt, est))
    print(json.dumps(out, indent=2))
    return 0


def cmd_train_respond(args):
    _device(args)
    from .training.drivers import train_respond_main

    return train_respond_main(args)


def cmd_train_patch(args):
    _device(args)
    from .training.drivers import train_patch_main

    return train_patch_main(args)


def cmd_full(args):
    device = _device(args)
    from .data.kitti import KittiOdometry, save_kitti_poses
    from .pipeline import run_full_pipeline
    from .utils.telemetry import MetricsLog, StageTimer

    cfg = ci_config() if args.ci else PipelineConfig()
    ds = KittiOdometry(args.data, cfg)
    respond, encoder = _reference_models(device, cfg)
    R_tr, t_tr = ds.load_calib(args.seq)
    n = ds.n_frames(args.seq) if args.frames < 0 else args.frames
    timer = StageTimer(sync=True)     # a stage's time holds its device work
    metrics = MetricsLog(os.path.join(args.out, f"metrics_{args.seq}.jsonl"))
    out = run_full_pipeline(
        list(ds.iter_scans(args.seq, 0, n)), respond, encoder, R_tr, t_tr,
        cfg, enable_refinement=not args.no_refine,
        enable_loop_closure=not args.no_loops,
        timer=timer, metrics=metrics)
    metrics.log("stage_timings", **{
        k: v["total_s"] for k, v in timer.summary().items()
    })
    # the reference's four-trajectory naming convention (Dirs.py:19-24)
    for name, poses in [("poses_", out.poses_raw),
                        ("poses__", out.poses_dejumped),
                        ("poses___", out.poses_refined),
                        ("poses____", out.poses_final)]:
        save_kitti_poses(os.path.join(args.out, name, f"{args.seq}.txt"), poses)
    print(json.dumps({
        "frames": int(n),
        "pair_success_rate": float(out.odometry.successes.mean()),
        "dejumped": len(out.dejumped_frames),
        "refined_spans": len(out.refine_stats.refined),
        "loop_closures": out.n_loop_closures,
    }))
    return 0


def cmd_scaling(args):
    """Frames/s of the data-parallel feature extractor over 1, 2, 4, ...
    ranks at ``small_test_config``: one NCCL rank per visible CUDA device,
    or with ``--platform cpu`` ``--ranks`` gloo ranks."""
    from .parallel.mesh import run_ranks

    device = _device(args)
    if device.type == "cuda":
        n_ranks = args.ranks or torch.cuda.device_count()
        if n_ranks > torch.cuda.device_count():
            raise SystemExit(f"--ranks {n_ranks}: only "
                             f"{torch.cuda.device_count()} CUDA devices")
    else:
        n_ranks = args.ranks or 1
    out = run_ranks(_scaling_rank, n_ranks, device_type=device.type,
                    args=(device.type, args.frames_per_device))
    print(json.dumps(out[0], indent=2))
    return 0


def _scaling_rank(rank, world, device_type, frames_per_device):
    """One rank of ``cmd_scaling``: the sweep over the world."""
    from .eval.scaling import scaling_sweep

    device = setup_device(f"cuda:{rank}" if device_type == "cuda" else "cpu")
    cfg = small_test_config()
    if weights_io.reference_models_available():
        respond, encoder = _reference_models(device, cfg)
    else:
        respond, encoder = weights_io.build_models(
            *weights_io.random_flax_params(0), device, cfg)
    return scaling_sweep(respond, encoder, cfg,
                         frames_per_device=frames_per_device)


def cmd_bench(args):
    """Steady-state front-end window throughput (``bench.py``)."""
    from .bench import main

    return main(["--platform", args.platform])


def main(argv=None):
    ap = argparse.ArgumentParser(
        "caelo_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("selftest", help="synthetic end-to-end check")
    p.add_argument("--small", action="store_true")
    _add_common(p)
    p.set_defaults(fn=cmd_selftest)

    p = sub.add_parser("odometry", help="run per-sequence odometry")
    p.add_argument("--data", required=True, help="KITTI odometry root")
    p.add_argument("--seq", default="00")
    p.add_argument("--out", default="runs")
    p.add_argument("--frames", type=int, default=-1)
    p.add_argument("--respond-weights", default=None)
    p.add_argument("--encoder-weights", default=None)
    p.add_argument("--keypoints", default="cae-lo",
                   choices=["cae-lo", "iss", "harris", "sift", "random",
                            "external"],
                   help="keypoint source: the CAE-LO window (default), a "
                        "baseline detector with CAE-LO descriptors, or "
                        "external keypoint files")
    p.add_argument("--external-dir", default=None,
                   help="external keypoint/descriptor tree "
                        "(<dir>/<seq>/<frame:06d>.bin) for --keypoints "
                        "external")
    p.add_argument("--external-fmt", default="3dfeatnet",
                   choices=["3dfeatnet", "xyzdesc", "usip"],
                   help="binary layout of the external files")
    p.add_argument("--external-desc-dim", type=int, default=32,
                   help="descriptor dim for the xyzdesc layout")
    _add_common(p)
    p.set_defaults(fn=cmd_odometry)

    p = sub.add_parser("full", help="full stack: odometry+dejump+refine+loops")
    p.add_argument("--data", required=True)
    p.add_argument("--seq", default="00")
    p.add_argument("--out", default="runs")
    p.add_argument("--frames", type=int, default=-1)
    p.add_argument("--no-refine", action="store_true")
    p.add_argument("--no-loops", action="store_true")
    p.add_argument("--ci", action="store_true",
                   help="CI-scale config (config.ci_config) -- test trees")
    _add_common(p)
    p.set_defaults(fn=cmd_full)

    p = sub.add_parser("scaling", help="frames/s scaling sweep over devices")
    p.add_argument("--frames-per-device", type=int, default=4)
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks to spawn (default: one per CUDA device; "
                        "1 with --platform cpu)")
    _add_common(p)
    p.set_defaults(fn=cmd_scaling)

    p = sub.add_parser("preprocess",
                       help="front end -> per-frame artifacts + poses_")
    p.add_argument("--data", required=True, help="KITTI odometry root")
    p.add_argument("--seq", default="00")
    p.add_argument("--out", default="runs")
    p.add_argument("--artifacts", default="runs/artifacts")
    p.add_argument("--frames", type=int, default=-1)
    _add_common(p)
    p.set_defaults(fn=cmd_preprocess)

    p = sub.add_parser("refine",
                       help="de-jump (+ ICP refine from --artifacts): "
                            "poses_ -> poses__ -> poses___")
    p.add_argument("--poses", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--artifacts", default=None,
                   help="artifact store from `preprocess`; enables the ICP "
                        "refinement stage")
    p.add_argument("--seq", default="00")
    _add_common(p)
    p.set_defaults(fn=cmd_refine)

    p = sub.add_parser("loop",
                       help="loop closure from artifacts: poses___ -> "
                            "poses____")
    p.add_argument("--poses", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--artifacts", required=True)
    p.add_argument("--seq", default="00")
    p.add_argument("--min-gap", type=int, default=100)
    p.add_argument("--candidates", default="descriptor",
                   choices=("descriptor", "scancontext"),
                   help="loop-candidate source: pooled-descriptor distance "
                        "(default) or the rotation-searched ScanContext "
                        "correlation matrix")
    _add_common(p)
    p.set_defaults(fn=cmd_loop)

    p = sub.add_parser("evaluate", help="RRE/RTE/ATE/drift vs ground truth")
    p.add_argument("--gt", required=True)
    p.add_argument("--est", required=True)
    p.add_argument("--calib", default=None)
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("train-respond", help="train the 2D respond AE")
    p.add_argument("--data", required=True)
    p.add_argument("--out", default="checkpoints/respond")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--synthetic", action="store_true",
                   help="train on synthetic scenes instead of KITTI")
    p.add_argument("--steps", type=int, default=-1)
    _add_common(p)
    p.set_defaults(fn=cmd_train_respond)

    p = sub.add_parser("train-patch", help="train the 3D voxel-patch AE")
    p.add_argument("--data", required=True)
    p.add_argument("--out", default="checkpoints/patch")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps", type=int, default=-1)
    _add_common(p)
    p.set_defaults(fn=cmd_train_patch)

    p = sub.add_parser("bench", help="front-end window frames/s, MFU and "
                                     "work counts (one JSON line; "
                                     "BENCH_FRAMES, BENCH_REPS, BENCH_DTYPE)")
    _add_common(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
