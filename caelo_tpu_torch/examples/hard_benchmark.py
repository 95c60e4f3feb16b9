"""Hard synthetic KITTI benchmark: the full pipeline on a Velodyne-realistic
ray-cast loop sequence, gated on the reference's registration metrics
(port of ``examples/hard_benchmark.py``).

Scene and trajectory: ``data.hard_synthetic``: a 64-beam ray cast with
occlusion, moving cars, 20 deg/s yaw turns and a closed ~520-frame circuit.

Gates (``BASELINE.md`` row 1, ``EvaluationOnRegistration.py:23-24``):
  * per-pair success (RRE < 1 deg, RTE < 0.5 m) >= 99 %;
  * loop-closure precision >= 0.9 at recall >= 0.5, and the final ATE at
    most half the raw one;
  * with ``--degraded`` / ``--degraded-turn``: the refinement and burst
    rescue must repair the damage the bursts did (``gates``).

    python -m caelo_tpu_torch.examples.hard_benchmark [--frames 520] \\
        [--no-loop] [--weights runs/scratch] [--platform cpu]

Prints the result JSON on standard output, the gate lines on standard
error, and exits 0 iff the gates pass.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..cli import _add_common, _device
from ..config import PipelineConfig
from ..data.hard_synthetic import generate_benchmark
from ..eval.metrics import (absolute_trajectory_error, loop_closure_pr,
                            registration_summary, relative_pose_errors)
from ..models import weights_io
from ..pipeline import run_full_pipeline
from ..utils.telemetry import StageTimer

# the gates' constants, as examples/hard_benchmark.py:240-300 has them
CIRCUIT_FRAMES = 520        # the circuit the spans and the bound refer to
CLEAN_ATE_M = 14.0          # clean-circuit raw ATE bound at 520 frames
DAMAGE_M = 2.0              # dejumped ATE above the bound that is damage
REPAIR_RATIO = 0.8          # repair: refined <= 0.8 x dejumped, or
REPAIR_SHARE = 0.35         # ... recovers >= 35 % of the damage
NO_HARM_RATIO = 1.05        # no harm: refined <= max(1.05 x dejumped,
NO_HARM_M = 0.5             # ... dejumped + 0.5 m)
RRE_DEG, RTE_M = 1.0, 0.5   # the reference's per-pair success gate
SUCCESS = 0.99              # clean per-pair success
SUCCESS_REFINED = 0.95      # post-refinement success through the turn
LOOP_PRECISION, LOOP_RECALL = 0.9, 0.5
LOOP_ATE_SHRINK = 0.5       # final ATE <= 0.5 x raw ATE


def degraded_spans(frames: int, degraded: bool, degraded_turn: bool):
    """The ``(start, stop, dropout, sector_deg)`` sensor-degradation spans,
    scaled by ``frames / 520``, or None.

    ``degraded``: one full-strength burst on a straight and one moderate
    burst over a turn entry (turns at ~85-130 / ~345-390 on the 520-frame
    circuit); at 0.8 dropout + a 140 deg wedge THROUGH a 20 deg/s turn the
    regime is informationally marginal, not a rescue test.
    ``degraded_turn``: a catastrophic burst (0.9 dropout + a 200 deg
    occluded wedge) across the first turn (~85-130), where the front end
    breaks and the multi-frame burst rescue must repair."""
    spans = None
    f = frames / CIRCUIT_FRAMES
    if degraded:
        spans = [(int(150 * f), int(190 * f), 0.8, 140.0),
                 (int(345 * f), int(372 * f), 0.5, 80.0)]
    if degraded_turn:
        spans = (spans or []) + [(int(88 * f), int(128 * f), 0.9, 200.0)]
    return spans


def cache_path(args) -> str:
    """The scan cache file of ``args`` (``--scan-cache`` directory, keyed on
    frames / seed / degradation), or ``""``."""
    if not args.scan_cache:
        return ""
    tag = ("degturn2" if args.degraded_turn
           else "deg" if args.degraded else "clean")
    return os.path.join(args.scan_cache,
                        f"hb_{args.frames}_{args.seed}_{tag}.npz")


def load_scans(args, cfg: PipelineConfig):
    """``(scans, poses_gt)`` of ``args``: read from the scan cache when it
    holds them, else ray-cast (and written to the cache when one is
    named)."""
    cache_file = cache_path(args)
    t0 = time.time()
    if cache_file and os.path.exists(cache_file):
        z = np.load(cache_file)
        # bind the arrays once: each ``z["pts"]`` access reads the whole
        # member afresh, and a slice of that fresh array pins its full base
        zp, zm = z["pts"], z["msk"]
        scans = [(zp[i], zm[i]) for i in range(zp.shape[0])]
        poses_gt = z["gt"]
        print(f"loaded {args.frames} cached frames from {cache_file}",
              file=sys.stderr)
        return scans, poses_gt
    scans, poses_gt = generate_benchmark(
        n_frames=args.frames, seed=args.seed, cfg=cfg,
        degraded_spans=degraded_spans(args.frames, args.degraded,
                                      args.degraded_turn))
    print(f"generated {args.frames} ray-cast frames in "
          f"{time.time()-t0:.0f} s", file=sys.stderr)
    if cache_file:
        os.makedirs(args.scan_cache, exist_ok=True)
        np.savez(cache_file,
                 pts=np.stack([np.asarray(p) for p, _ in scans]),
                 msk=np.stack([np.asarray(m) for _, m in scans]),
                 gt=np.asarray(poses_gt))
    return scans, poses_gt


def gates(out: dict, result_stats, args):
    """The gates over ``out`` (the result JSON, to which the degraded run's
    ``rescue_damage_m`` is added) and ``result_stats``, the run's
    ``(refine_stats, burst_stats)``.  Returns ``(gates_ok, rescue_ok,
    messages)``: ``rescue_ok`` is None without ``--degraded``, and
    ``messages`` are the RESCUE and GATES lines.

    Damage-relative rescue gates: the flat ratio (refined <= 0.8 x
    dejumped) is ill-conditioned in the RNG-seed dimension (on one
    degraded scene the dejumped ATE spans 13.2-25.6 m across registration
    seeds, while the clean raw ATE is 13.3-13.7 m), so the repair is asked
    for only where the dejumped ATE is damaged (above the clean bound by
    more than 2 m), and no harm always."""
    st, bs = result_stats
    messages = []
    rescue_ok = None
    if args.degraded:
        clean_bound = CLEAN_ATE_M * (args.frames / CIRCUIT_FRAMES)
        dej, refn = out["ate_dejumped_m"], out["ate_refined_m"]
        damage = dej - clean_bound
        no_harm = refn <= max(NO_HARM_RATIO * dej, dej + NO_HARM_M)
        acted = (len(st.refined) > 0
                 or (bs is not None and len(bs.accepted) > 0))
        if damage > DAMAGE_M:
            rescue_ok = (no_harm and acted
                         and (refn <= REPAIR_RATIO * dej
                              or (dej - refn) >= REPAIR_SHARE * damage))
        else:
            rescue_ok = no_harm
        out["rescue_damage_m"] = damage
        messages.append(
            f"RESCUE {'PASS' if rescue_ok else 'FAIL'}: ATE dejumped "
            f"{out['ate_dejumped_m']:.2f} -> refined "
            f"{out['ate_refined_m']:.2f} m (damage {damage:+.1f} m vs "
            f"clean bound; repair needs 0.8x or >=35% of damage), "
            f"{len(st.refined)} spans refined, {len(st.failed)} failed, "
            f"bursts {bs.accepted if bs else []}, "
            f"success_refined {out['success_rate_refined']*100:.2f}%")
        gates_ok = rescue_ok and out["rre_deg"] < RRE_DEG
        if args.degraded_turn:
            gates_ok = gates_ok and out["success_rate_refined"] >= \
                SUCCESS_REFINED
    else:
        gates_ok = (out["rre_deg"] < RRE_DEG and out["rte_m"] < RTE_M
                    and out["success_rate"] >= SUCCESS)
    loop_msg = ""
    if not args.no_loop:
        lp = out.get("loop_precision", 0.0)
        lr = out.get("loop_recall", 0.0)
        # a verified closure on a closed circuit must collapse endpoint
        # drift, not merely not grow it
        loop_ok = (out["n_loop_closures"] > 0 and lp >= LOOP_PRECISION
                   and lr >= LOOP_RECALL
                   and out["ate_final_m"] <= LOOP_ATE_SHRINK
                   * out["ate_raw_m"])
        gates_ok = gates_ok and loop_ok
        loop_msg = (f", loop precision {lp:.2f} (>=0.9) at recall {lr:.2f} "
                    f"(>=0.5), ATE {out['ate_raw_m']:.2f}->"
                    f"{out['ate_final_m']:.2f} m (must halve)")
    messages.append(
        f"GATES {'PASS' if gates_ok else 'FAIL'}: "
        f"RRE {out['rre_deg']:.4f} deg (<1), "
        f"RTE {out['rte_m']:.4f} m (<0.5), "
        f"success {out['success_rate']*100:.2f}% (>=99)" + loop_msg)
    return bool(gates_ok), rescue_ok, messages


def models(args, cfg: PipelineConfig, device):
    """``(respond_net, encoder, cfg)``: the ``--weights`` checkpoints with
    the training recipe's encoder activations (relu convs + linear code),
    or the shipped ``.h5`` models."""
    if args.weights:
        cfg = dataclasses.replace(cfg, encoder_activation="relu",
                                  encoder_code_activation="linear")
        return (*weights_io.build_models_from_state_dicts(
            *weights_io.load_trained(args.weights), device, cfg), cfg)
    return (*weights_io.build_models(
        weights_io.load_respond_layer_params(),
        weights_io.load_patch_encoder_params(), device, cfg), cfg)


def run(args, cfg: PipelineConfig) -> int:
    device = _device(args)
    pipe_seed = args.pipeline_seed if args.pipeline_seed >= 0 else args.seed
    respond_net, encoder, cfg = models(args, cfg, device)
    scans, poses_gt = load_scans(args, cfg)
    if args.degraded_turn:      # its gates are the degraded run's, and more
        args.degraded = True

    timer = StageTimer(sync=True)
    pipe_kwargs = {}
    if args.window > 0:
        pipe_kwargs["window"] = args.window
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)
    t0 = time.time()
    result = run_full_pipeline(
        scans, respond_net, encoder, cfg=cfg,
        enable_loop_closure=not args.no_loop, timer=timer, seed=pipe_seed,
        candidate_source=args.candidate_source, **pipe_kwargs,
    )
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    print(f"pipeline: {wall:.1f} s ({args.frames / wall:.1f} frames/s e2e)",
          file=sys.stderr)
    if cuda:
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 20:.1f} MiB "
              f"({torch.cuda.get_device_name(device)})", file=sys.stderr)

    R_tr, t_tr = np.eye(3), np.zeros(3)
    errs = relative_pose_errors(poses_gt, result.poses_raw, R_tr, t_tr)
    summary = registration_summary(errs)
    # cross-check: per-pair errors straight from the registered relative
    # poses (no pose chaining / re-derivation in the loop)
    gtr = poses_gt.reshape(-1, 3, 4)
    gt_R = np.einsum("nji,njk->nik", gtr[:-1, :, :3], gtr[1:, :, :3])
    gt_t = np.einsum("nji,nj->ni", gtr[:-1, :, :3],
                     gtr[1:, :, 3] - gtr[:-1, :, 3])
    dd_t = np.linalg.norm(result.odometry.rel_ts - gt_t, axis=1)
    tr = np.einsum("nij,nij->n", result.odometry.rel_Rs, gt_R)
    dd_r = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    print(f"direct-rel check: rte_mean {dd_t.mean():.4f} "
          f"rre_geo_mean {dd_r.mean():.4f} "
          f"rte_p90 {np.percentile(dd_t, 90):.4f}", file=sys.stderr)
    ate_raw = absolute_trajectory_error(poses_gt, result.poses_raw)
    ate_dj = absolute_trajectory_error(poses_gt, result.poses_dejumped)
    ate_ref = absolute_trajectory_error(poses_gt, result.poses_refined)
    ate_final = absolute_trajectory_error(poses_gt, result.poses_final)
    rre = np.asarray(errs.rre_deg)
    rte = np.asarray(errs.rte_m)
    out = {
        "frames": args.frames,
        "window": args.window,
        "pipeline_seed": pipe_seed,
        "candidate_source": args.candidate_source,
        "rre_deg": summary["rre_deg"],
        "rte_m": summary["rte_m"],
        "rre_p50": float(np.percentile(rre, 50)),
        "rre_p90": float(np.percentile(rre, 90)),
        "rre_max": float(rre.max()),
        "rte_p50": float(np.percentile(rte, 50)),
        "rte_p90": float(np.percentile(rte, 90)),
        "rte_max": float(rte.max()),
        "success_rate": summary["success_rate"],
        "pair_success_frontend": float(result.odometry.successes.mean()),
        "ate_raw_m": ate_raw["ate_rmse"],
        "ate_dejumped_m": ate_dj["ate_rmse"],
        "ate_refined_m": ate_ref["ate_rmse"],
        "ate_final_m": ate_final["ate_rmse"],
        "n_loop_closures": int(result.n_loop_closures),
        "dejumped": len(result.dejumped_frames),
        "stage_seconds": timer.summary(),
        "per_pair_rre_deg": [round(float(v), 5) for v in rre],
        "per_pair_rte_m": [round(float(v), 5) for v in rte],
    }
    if not args.no_loop and result.n_loop_closures > 0:
        pr = loop_closure_pr(result.loop_edge_i, result.loop_edge_j,
                             poses_gt.reshape(-1, 3, 4)[:, :, 3])
        out["loop_precision"] = pr["precision"]
        out["loop_recall"] = pr["recall"]
        out["loop_edges"] = [
            [int(a), int(b)] for a, b in
            zip(result.loop_edge_i, result.loop_edge_j)
        ]
    if args.degraded:
        # the front end is expected to fail in the bursts; refinement must
        # repair the trajectory, and the refined spans must be real
        st = result.refine_stats
        out["refined_spans"] = len(st.refined)
        out["failed_spans"] = len(st.failed)
        bs = result.burst_stats
        if bs is not None:
            out["burst_spans"] = bs.spans
            out["burst_accepted"] = bs.accepted
            out["burst_gains"] = [[round(a, 4), round(b, 4)]
                                  for a, b in bs.gains]
        # post-refinement per-pair quality: the rescue must leave the
        # refined trajectory's own rels good, not only shrink ATE
        sum_ref = registration_summary(relative_pose_errors(
            poses_gt, result.poses_refined, R_tr, t_tr))
        out["success_rate_refined"] = sum_ref["success_rate"]
        out["rre_deg_refined"] = sum_ref["rre_deg"]
    gates_ok, _, messages = gates(
        out, (result.refine_stats, result.burst_stats), args)
    for line in messages:
        print(line, file=sys.stderr)
    out["gates_pass"] = gates_ok
    print(json.dumps(out, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f)
    return 0 if gates_ok else 1


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=520)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--degraded", action="store_true",
                    help="sensor-degradation bursts (heavy dropout + a 140 "
                         "deg occluded wedge) over two spans: the "
                         "refinement-rescue scenario")
    ap.add_argument("--degraded-turn", action="store_true",
                    help="a full-strength burst (0.9 dropout + 200 deg "
                         "wedge) through a 20 deg/s turn, where pairwise "
                         "registration is degenerate and the multi-frame "
                         "burst rescue must repair; gates the repair and "
                         "post-refinement success >= 95%%")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--window", type=int, default=0,
                    help="front-end window size (0 = pipeline default)")
    ap.add_argument("--pipeline-seed", type=int, default=-1,
                    help="registration RNG seed (default: --seed), to vary "
                         "the draws on a fixed scene")
    ap.add_argument("--scan-cache", default="",
                    help="directory to cache generated scans (keyed on "
                         "frames/seed/degraded): skips the ray cast on "
                         "repeat runs")
    ap.add_argument("--candidate-source", default="descriptor",
                    choices=["descriptor", "scancontext"])
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
