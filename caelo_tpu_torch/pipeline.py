"""The odometry stack through refinement: front end -> de-jump -> ICP
refinement (port of ``caelo_tpu/pipeline.py``).

Stages 1-3 of the JAX package's ``run_full_pipeline`` run here; the pose
bookkeeping between them is host float64 numpy (``backend.refine``, shared
with the JAX package).  Burst rescue (stage 3b) and loop closure (stage 4)
are not ported yet: a run that would need either raises
``NotImplementedError`` instead of skipping the stage.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import numpy as np
import torch

from caelo_tpu.utils.telemetry import MetricsLog, StageTimer

from . import setup_device
from .backend import refine
from .backend.burst import BurstStats, find_burst_spans
from .backend.refine_runner import (RefinementFeatures,
                                    extract_refinement_features,
                                    make_batched_icp_fn, make_icp_fn)
from .config import PipelineConfig
from .frontend.odometry import OdometryResult, run_odometry_windowed
from .geometry.kitti_pose import lidar_rel_to_cam, rel_pose_lidar


@dataclasses.dataclass
class FullPipelineResult:
    poses_raw: np.ndarray        # chained odometry
    poses_dejumped: np.ndarray   # after de-jump
    poses_refined: np.ndarray    # after ICP refinement
    poses_final: np.ndarray      # after loop closure (not ported: = refined)
    odometry: OdometryResult
    dejumped_frames: List
    refine_stats: "refine.RefineStats"
    n_loop_closures: int
    loop_edge_i: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    loop_edge_j: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    # burst-rescue diagnostics: None when every frame is healthy, else the
    # (empty) stats of a sequence without a qualifying burst
    burst_stats: object = None


def extract_refinement_features_batched(scans, respond_net,
                                        cfg: PipelineConfig
                                        ) -> List[RefinementFeatures]:
    """Per-frame refinement features of ``(pts, mask)`` scans, on the
    device of ``respond_net``, one frame at a time (the JAX version
    batches frames into one dispatch; eager PyTorch has nothing to gain)."""
    dev = setup_device(next(respond_net.parameters()).device)
    return [extract_refinement_features(
        respond_net, torch.as_tensor(p).to(dev), torch.as_tensor(m).to(dev),
        cfg) for p, m in scans]


def stage_refinement(poses_dj, ref_feats, inlier_pairs, R_tr, t_tr,
                     cfg: PipelineConfig, batched: bool = True,
                     pair_trusted=None):
    """Keyframe-transfer ICP refinement of the de-jumped poses.

    ``batched`` solves all keyframe spans in batched ICP passes
    (``refine_odometry_batched``); otherwise the sequential loop runs one
    span per ICP call.  The JAX version shards the span batch over a
    device mesh when it sees several devices; the port has one device path.
    """
    def rel_lidar_fn(p0, p1):
        return rel_pose_lidar(p0, p1, R_tr, t_tr)

    def apply_rel_fn(pose0, relR, relT):
        dR, dt = lidar_rel_to_cam(relR, relT, R_tr, t_tr)
        R0, t0 = refine._rt(pose0)
        return refine._row(R0 @ dR, R0 @ dt + t0)

    if batched:
        return refine.refine_odometry_batched(
            poses_dj, make_batched_icp_fn(ref_feats, cfg), rel_lidar_fn,
            apply_rel_fn, inlier_idx_pairs=inlier_pairs, cfg=cfg.refine,
            pair_trusted=pair_trusted)
    return refine.refine_odometry(
        poses_dj, make_icp_fn(ref_feats, cfg), rel_lidar_fn, apply_rel_fn,
        inlier_idx_pairs=inlier_pairs, cfg=cfg.refine)


def run_full_pipeline(scans: Iterable, respond_net, encoder,
                      R_tr=None, t_tr=None,
                      cfg: PipelineConfig = PipelineConfig(),
                      enable_refinement: bool = True,
                      enable_loop_closure: bool = True,
                      min_loop_gap: int = 100,
                      seed: int = 0,
                      batched_refine: bool = True,
                      timer: Optional[StageTimer] = None,
                      metrics: Optional[MetricsLog] = None,
                      window: int = 16, *,
                      samples=None) -> FullPipelineResult:
    """Windowed front end, de-jump and ICP refinement over ``scans``, a
    sequence of ``(pts (N, 4), mask (N,))`` arrays, on the device of
    ``respond_net``.

    A frame with fewer than half the sequence's median valid points is
    unhealthy: its pairs are untrusted, so de-jump may replace them and
    refinement re-registers them.  Raises ``NotImplementedError`` where the
    JAX package would run a stage the port lacks: burst rescue (slice C),
    for a run of ``min_burst`` unhealthy frames, and loop closure (slice
    D), for more than ``min_loop_gap`` scans with ``enable_loop_closure``.

    ``timer`` stages are host wall clock without device sync.  ``samples``
    is the RANSAC parity seam of ``run_odometry_windowed``.
    """
    if R_tr is None:
        R_tr = np.eye(3)
    if t_tr is None:
        t_tr = np.zeros(3)
    if not (hasattr(scans, "__getitem__") and hasattr(scans, "__len__")):
        scans = list(scans)
    timer = timer or StageTimer(sync=False)

    # per-frame sensor-health gate (caelo_tpu/pipeline.py:574-587)
    if hasattr(scans, "mask"):
        n_valid = np.array([int(scans.mask(i).sum())
                            for i in range(len(scans))])
    else:
        n_valid = np.array([int(np.asarray(m).sum()) for _, m in scans])
    healthy = n_valid >= 0.5 * np.median(n_valid)
    if enable_refinement and find_burst_spans(healthy):
        raise NotImplementedError(
            f"burst rescue (slice C) is not ported: unhealthy bursts "
            f"{find_burst_spans(healthy)}")
    if enable_loop_closure and len(scans) > min_loop_gap:
        raise NotImplementedError(
            f"loop closure (slice D) is not ported: {len(scans)} scans > "
            f"min_loop_gap {min_loop_gap}; pass enable_loop_closure=False")

    # ---- stage 1: windowed front end; the refinement features come from
    # the same window passes
    with timer.stage("frontend"):
        out = run_odometry_windowed(
            scans, respond_net, encoder, R_tr, t_tr, cfg,
            window=min(window, len(scans)), seed=seed,
            keep_refine_features=enable_refinement, samples=samples)
    odo = out[0]
    poses_raw = odo.poses
    if metrics:
        metrics.log("frontend", frames=len(scans),
                    pair_success_rate=float(odo.successes.mean()),
                    mean_inliers=float(odo.n_inliers.mean()))

    pair_trusted = odo.successes & healthy[:-1] & healthy[1:]

    # ---- stage 2: de-jump, gated on the front end's per-pair evidence
    with timer.stage("dejump"):
        poses_dj, dejumped = refine.fix_jump_poses(
            poses_raw, cfg.refine, pair_trusted=pair_trusted)
    if metrics:
        metrics.log("dejump", fixed=len(dejumped))

    # ---- stage 3: keyframe-transfer ICP refinement
    if enable_refinement:
        with timer.stage("refine"):
            poses_ref, stats = stage_refinement(
                poses_dj, out[-1], odo.inlier_pairs, R_tr, t_tr, cfg,
                batched=batched_refine, pair_trusted=pair_trusted)
        if metrics:
            metrics.log("refine", refined=len(stats.refined),
                        failed=len(stats.failed),
                        rejected=len(stats.rejected))
    else:
        poses_ref, stats = poses_dj, refine.RefineStats()

    # stage 3b would rescue bursts here; with none to rescue its stats are
    # empty, as the JAX package's
    burst_stats = (BurstStats() if enable_refinement and not np.all(healthy)
                   else None)
    return FullPipelineResult(
        poses_raw=poses_raw,
        poses_dejumped=poses_dj,
        poses_refined=poses_ref,
        poses_final=poses_ref,
        odometry=odo,
        dejumped_frames=dejumped,
        refine_stats=stats,
        n_loop_closures=0,
        burst_stats=burst_stats,
    )
