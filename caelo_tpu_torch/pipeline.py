"""The full odometry stack: front end -> de-jump -> ICP refinement -> burst
rescue -> loop closure -> pose-graph solve (port of
``caelo_tpu/pipeline.py``).

Every stage is a function over explicit inputs; ``run_full_pipeline``
chains them in memory on the device of the respond net, while
``preprocess_to_store`` / ``load_stage_inputs`` persist and reload the
back end's inputs through ``data.artifacts.ArtifactStore`` (numpy only, the
JAX package's on-disk layout) so the back-end stages can re-run from
disk.  The pose bookkeeping between stages, the burst-rescue host logic and
the pose-graph solve are host float64 numpy.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import setup_device
from .backend import refine
from .backend.burst import find_burst_spans, rescue_bursts
from .backend.loopclosure import detect_and_close, stack_frame_features
from .backend.posegraph import (PoseGraph, concat_graphs, odometry_graph,
                                optimize_host)
from .backend.refine_runner import (RefinementFeatures,
                                    extract_refinement_features,
                                    make_batched_icp_fn, make_icp_fn)
from .backend.scancontext import yaw_rotation
from .config import PipelineConfig
from .data.artifacts import ArtifactStore
from .frontend.odometry import OdometryResult, run_odometry_windowed
from .frontend.registration import (FrameFeatures, register_pair,
                                    register_pair_with_prior)
from .geometry.kitti_pose import lidar_rel_to_cam, rel_pose_lidar
from .parallel.mesh import world_mesh
from .parallel.pipeline import make_sharded_icp_fn
from .utils.telemetry import MetricsLog, StageTimer


@dataclasses.dataclass
class FullPipelineResult:
    poses_raw: np.ndarray        # chained odometry
    poses_dejumped: np.ndarray   # after de-jump
    poses_refined: np.ndarray    # after ICP refinement and burst rescue
    poses_final: np.ndarray      # after loop closure + graph solve
    odometry: OdometryResult
    dejumped_frames: List
    refine_stats: "refine.RefineStats"
    n_loop_closures: int
    # accepted closure endpoints (frame indices): score with
    # eval.metrics.loop_closure_pr against ground-truth positions
    loop_edge_i: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    loop_edge_j: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    # burst-rescue diagnostics (backend.burst.BurstStats); None when the
    # stage did not run (every frame healthy, or refinement off)
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


def _pose_fns(R_tr, t_tr):
    """The refinement loop's pose callables for a calibration:
    ``rel_lidar_fn(pose0, pose1) -> (R, t)`` and ``apply_rel_fn(pose0,
    relR, relT) -> pose1`` (host float64)."""
    def rel_lidar_fn(p0, p1):
        return rel_pose_lidar(p0, p1, R_tr, t_tr)

    def apply_rel_fn(pose0, relR, relT):
        dR, dt = lidar_rel_to_cam(relR, relT, R_tr, t_tr)
        R0, t0 = refine._rt(pose0)
        return refine._row(R0 @ dR, R0 @ dt + t0)

    return rel_lidar_fn, apply_rel_fn


def stage_refinement(poses_dj, ref_feats, inlier_pairs, R_tr, t_tr,
                     cfg: PipelineConfig, batched: bool = True,
                     pair_trusted=None):
    """Keyframe-transfer ICP refinement of the de-jumped poses.

    ``batched`` solves all keyframe spans in batched ICP passes
    (``refine_odometry_batched``); otherwise the sequential loop runs one
    span per ICP call.  In an initialised process group of more than one
    rank the span batch is sharded over the ranks (``make_sharded_icp_fn``
    on ``world_mesh()``, made once per world), as the JAX version shards it
    over its devices: the stage is then a collective, so every rank must
    call it with the same inputs, and its spans go 4 to an ICP call on each
    rank instead of 16 to a one-device call, so its poses may differ
    from the one-device stage's in the last bits.
    """
    rel_lidar_fn, apply_rel_fn = _pose_fns(R_tr, t_tr)
    if batched:
        if dist.is_initialized() and dist.get_world_size() > 1:
            icp_fn = make_sharded_icp_fn(ref_feats, world_mesh(), cfg)
        else:
            icp_fn = make_batched_icp_fn(ref_feats, cfg)
        return refine.refine_odometry_batched(
            poses_dj, icp_fn, rel_lidar_fn, apply_rel_fn,
            inlier_idx_pairs=inlier_pairs, cfg=cfg.refine,
            pair_trusted=pair_trusted)
    return refine.refine_odometry(
        poses_dj, make_icp_fn(ref_feats, cfg), rel_lidar_fn, apply_rel_fn,
        inlier_idx_pairs=inlier_pairs, cfg=cfg.refine)


# loop-verification pairs per batched registration: (64, 2048, 1024)
# RANSAC residual tensors, 512 MiB each
LOOP_CHUNK = 64


def _frames(feats: FrameFeatures, idx) -> FrameFeatures:
    ii = torch.as_tensor(np.asarray(idx), device=feats.key_pts.device).long()
    return FrameFeatures(*(x[ii] for x in feats))


def _verify_loop_candidates(feats: FrameFeatures, idx_i, idx_j, yaws,
                            allow_prior, cfg: PipelineConfig,
                            generator: torch.Generator | None = None,
                            samples: Callable | None = None):
    """Geometric verification of loop candidate pairs ``(idx_i[k],
    idx_j[k])``, batched ``LOOP_CHUNK`` pairs at a time: plain registration,
    then, where it failed and ``allow_prior[k]`` is set, a retry with the
    ScanContext yaw ``yaws[k]`` as a rotation-only prior (wide 15 m gate:
    the prior carries no translation), kept where it succeeds.

    ``allow_prior`` must be False for the sequence-consistency neighbour
    pairs: a prior derived from the candidate's own alignment hypothesis
    biases the independent check toward confirming it.

    ``samples(idx_i, idx_j, yaws) -> (s1, s2)``, if given, supplies the
    RANSAC draws ``(n, H, S)`` of every pair for the plain and the prior
    pass (the parity seam of ``ransac_rigid``); otherwise they come from
    ``generator``.  Returns host ``(R (n,3,3), t (n,3), ok (n,), n_inliers
    (n,))``.
    """
    n = len(idx_i)
    allow_prior = np.asarray(allow_prior, bool)
    yaws = np.asarray(yaws, np.float32)
    s1 = s2 = None
    if samples is not None:
        s1, s2 = (np.asarray(s) for s in samples(idx_i, idx_j, yaws))
    dev = feats.key_pts.device
    Rs = np.zeros((n, 3, 3), np.float32)
    ts = np.zeros((n, 3), np.float32)
    oks = np.zeros(n, bool)
    nis = np.zeros(n, np.int64)
    draw = lambda s, sel: None if s is None else torch.as_tensor(s[sel])
    for c in range(0, n, LOOP_CHUNK):
        sel = np.arange(c, min(c + LOOP_CHUNK, n))
        f_i, f_j = _frames(feats, idx_i[sel]), _frames(feats, idx_j[sel])
        reg = register_pair(f_i, f_j, cfg, generator=generator,
                            samples=draw(s1, sel))
        R, t = reg.R.cpu().numpy(), reg.t.cpu().numpy()
        ok, ni = reg.success.cpu().numpy(), reg.n_inliers.cpu().numpy()
        retry = np.nonzero(allow_prior[sel] & ~ok)[0]
        if retry.size:
            sub = lambda f: FrameFeatures(*(
                x[torch.as_tensor(retry, device=dev)] for x in f))
            reg2 = register_pair_with_prior(
                sub(f_i), sub(f_j), yaw_rotation(yaws[sel][retry]).to(dev),
                torch.zeros((retry.size, 3), device=dev), cfg, gate_m=15.0,
                generator=generator, samples=draw(s2, sel[retry]))
            use2 = reg2.success.cpu().numpy()
            k = retry[use2]
            R[k] = reg2.R.cpu().numpy()[use2]
            t[k] = reg2.t.cpu().numpy()[use2]
            ok[k] = True
            ni[k] = reg2.n_inliers.cpu().numpy()[use2]
        Rs[sel], ts[sel], oks[sel], nis[sel] = R, t, ok, ni
    return Rs, ts, oks, nis


def stage_loop_closure(poses_ref, feats, rel_Rs, rel_ts, R_tr, t_tr,
                       cfg: PipelineConfig, min_loop_gap: int = 100,
                       seed: int = 0, frame_healthy=None,
                       candidate_source: str = "descriptor",
                       samples: Callable | None = None):
    """Loop closure + pose-graph solve of the refined poses, host logic as
    in ``caelo_tpu/pipeline.py:173-450``.

    ``feats`` is the front end's ``FrameFeatures`` with a leading frame
    axis.  ``rel_Rs``/``rel_ts`` are accepted for API compatibility but
    unused: every chain and graph edge derives from ``poses_ref``, so the
    solve keeps the de-jump and refinement corrections.  Candidates are
    verified with the Lowe ratio forced to at least 0.85, then gated by a
    drift-plausibility bound (with a per-unhealthy-frame allowance) and a
    sequence-consistency check against the neighbour pair ``(i+d, j+d)``;
    accepted closures propagate along their frame offset, and the
    odometry + loop graph is solved by ``optimize_host``.

    ``candidate_source`` is ``"descriptor"`` or ``"scancontext"`` (see
    ``loopclosure.detect_and_close``).  ``samples`` is the RANSAC seam of
    ``_verify_loop_candidates``; otherwise the draws come from a
    ``torch.Generator`` seeded with ``seed + 7``.

    Returns ``(poses_final, n_loops, loop_edge_i, loop_edge_j)``.
    """
    stacked = stack_frame_features(feats)
    generator = torch.Generator(device=stacked.key_pts.device).manual_seed(
        seed + 7)
    # the Lowe ratio gate is forced on for loop verification: distant
    # frames without a motion prior alias on repeated structure
    loop_cfg = dataclasses.replace(cfg, match_ratio=max(cfg.match_ratio, 0.85))

    P = np.asarray(poses_ref, np.float64).reshape(-1, 3, 4)
    W_R = np.einsum("nij,jk->nik", P[:, :, :3], np.asarray(R_tr))
    W_t = (np.einsum("nij,j->ni", P[:, :, :3], np.asarray(t_tr))
           + P[:, :, 3])
    n_frames = W_R.shape[0]
    rel_Rs64 = np.einsum("nji,njk->nik", W_R[:-1], W_R[1:])
    rel_ts64 = np.einsum("nji,nj->ni", W_R[:-1], W_t[1:] - W_t[:-1])

    def chain_rel(a, b):
        """Trajectory rel pose mapping frame b into frame a (prefix-
        composed: rel(a,b) = W_a^-1 W_b)."""
        R = W_R[a].T @ W_R[b]
        t = W_R[a].T @ (W_t[b] - W_t[a])
        return R, t

    # odometry path length prefix (for the drift-plausibility bound)
    step_len = np.linalg.norm(rel_ts64, axis=1)
    path_prefix = np.concatenate([[0.0], np.cumsum(step_len)])

    GATE_D = 10
    DRIFT_FLOOR_M = 12.0
    DRIFT_FRAC = 0.15
    # each unhealthy frame crossed adds a per-frame allowance: a
    # degradation burst injects a discrete kink no path-proportional bound
    # predicts
    BURST_ALLOW_M = 0.5
    unhealthy_prefix = np.concatenate(
        [[0], np.cumsum(~np.asarray(frame_healthy, bool))]
    ) if frame_healthy is not None else None
    neighbor_regs = {}

    def register_batch_fn(idx_i, idx_j, yaws):
        n = len(idx_i)
        # candidate pairs + their consistency-gate neighbour pairs (i+d,
        # j+d), verified together; the neighbour block without the
        # yaw-prior retry
        d_arr = np.minimum(GATE_D, n_frames - 1 - np.maximum(idx_i, idx_j))
        d_arr = np.maximum(d_arr, 0)
        all_i = np.concatenate([idx_i, idx_i + d_arr])
        all_j = np.concatenate([idx_j, idx_j + d_arr])
        all_y = np.concatenate([yaws, yaws])
        allow = np.concatenate([np.ones(n, bool), np.zeros(n, bool)])
        Rs, ts, oks, nis = _verify_loop_candidates(
            stacked, all_i, all_j, all_y, allow, loop_cfg,
            generator=generator, samples=samples)
        for k in range(n):
            neighbor_regs[(int(idx_i[k]), int(idx_j[k]))] = (
                int(d_arr[k]), Rs[n + k], ts[n + k], bool(oks[n + k]))
        return Rs[:n], ts[:n], oks[:n], nis[:n]

    gate_rejects = {"drift_bound": 0, "neighbor_failed": 0,
                    "inconsistent": 0}

    def edge_gate_fn(i, j, R, t, tol_t=1.5, tol_deg=3.0):
        A_R = np.asarray(R, np.float64)
        A_t = np.asarray(t, np.float64)
        # drift-plausibility bound: the correction a loop edge implies
        # cannot exceed plausible odometry drift over the i..j path
        Rij, tij = chain_rel(i, j)
        path = float(path_prefix[j] - path_prefix[i])
        allow = DRIFT_FRAC * path
        if unhealthy_prefix is not None:
            allow += BURST_ALLOW_M * float(
                unhealthy_prefix[j] - unhealthy_prefix[i])
        if np.linalg.norm(A_t - tij) > max(DRIFT_FLOOR_M, allow):
            gate_rejects["drift_bound"] += 1
            return False
        # sequence-consistency gate against the prior-free neighbour
        # registration
        d, R2, t2, ok2 = neighbor_regs[(i, j)]
        if d <= 0:
            return True
        if not ok2:
            gate_rejects["neighbor_failed"] += 1
            return False
        Ri, ti = chain_rel(i, i + d)
        Rj, tj = chain_rel(j, j + d)
        # predicted rel(i+d, j+d) = inv(rel(i,i+d)) o A o rel(j,j+d)
        pR = Ri.T @ A_R @ Rj
        pt = Ri.T @ (A_R @ tj + A_t - ti)
        R2 = np.asarray(R2, np.float64)
        t2 = np.asarray(t2, np.float64)
        ang = np.degrees(np.arccos(np.clip(
            (np.trace(R2.T @ pR) - 1.0) / 2.0, -1.0, 1.0)))
        ok = bool(np.linalg.norm(t2 - pt) <= tol_t and ang <= tol_deg)
        if not ok:
            gate_rejects["inconsistent"] += 1
        return ok

    # candidate/accept budgets scale with sequence length
    max_cand = int(max(32, min(256, 3 * n_frames // 32)))
    max_acc = int(max(16, n_frames // 64))
    loops = detect_and_close(stacked, register_batch_fn=register_batch_fn,
                             min_gap=min_loop_gap, use_scan_context=True,
                             max_candidates=max_cand, max_accept=max_acc,
                             edge_gate_fn=edge_gate_fn,
                             frame_valid=frame_healthy,
                             candidate_source=candidate_source)
    loop_edges = loops.edges
    n_prop = 0
    if loops.n_accepted > 0:
        # loop propagation: an accepted revisit (i, j) implies candidate
        # co-locations (i+D, j+D) at the same frame offset along the shared
        # segment; they need only the verification and the same gates
        STRIDE = max(20, min_loop_gap // 2)
        seen_pairs = set(
            (int(a), int(b)) for a, b in zip(
                loops.edges.edge_i.tolist(), loops.edges.edge_j.tolist()))
        offsets = sorted(set(b - a for a, b in seen_pairs))
        cand = []
        for off in offsets:
            for i2 in range(0, n_frames - off - 1, STRIDE):
                j2 = i2 + off
                if any(abs(i2 - a) < STRIDE // 2 and abs(j2 - b) < STRIDE // 2
                       for a, b in seen_pairs):
                    continue
                cand.append((i2, j2))
                seen_pairs.add((i2, j2))
        # cap: each candidate costs 2 registrations (itself + its
        # consistency neighbour)
        cand = cand[:256]
        if cand:
            ci = np.asarray([a for a, _ in cand], np.int32)
            cj = np.asarray([b for _, b in cand], np.int32)
            Rs, ts, oks, nis = register_batch_fn(
                ci, cj, np.zeros(len(cand), np.float32))
            pei, pej, pR, pt_, pw = [], [], [], [], []
            for k in range(len(cand)):
                if not bool(oks[k]):
                    continue
                if not edge_gate_fn(int(ci[k]), int(cj[k]), Rs[k], ts[k]):
                    continue
                pei.append(int(ci[k]))
                pej.append(int(cj[k]))
                pR.append(np.asarray(Rs[k]))
                pt_.append(np.asarray(ts[k]))
                pw.append(float(nis[k]))
            n_prop = len(pei)
            if n_prop:
                prop_edges = PoseGraph(
                    edge_i=torch.as_tensor(pei, dtype=torch.int32),
                    edge_j=torch.as_tensor(pej, dtype=torch.int32),
                    rel_R=torch.as_tensor(np.stack(pR)),
                    rel_t=torch.as_tensor(np.stack(pt_)),
                    weight=torch.as_tensor(np.asarray(pw) / 100.0),
                    rot_info=torch.full((n_prop,), 100.0,
                                        dtype=torch.float64))
                loop_edges = concat_graphs(loops.edges, prop_edges)

    n_loops = loops.n_accepted + n_prop
    loop_ei = loop_edges.edge_i.numpy().astype(np.int32)
    loop_ej = loop_edges.edge_j.numpy().astype(np.int32)
    poses_final = poses_ref
    if n_loops > 0:
        # lidar-frame world poses of the refined trajectory; odometry
        # edges are its own rels
        g = concat_graphs(odometry_graph(rel_Rs64, rel_ts64), loop_edges)
        # exact host-f64 Gauss-Newton (direct sparse factorisation): the
        # matrix-free CG needs ~N iterations on a chain-conditioned graph
        Ro, to, _ = optimize_host(W_R, W_t, g)
        # a diverged or degenerate solve never replaces a finite trajectory
        if not (np.all(np.isfinite(Ro)) and np.all(np.isfinite(to))):
            print("pose-graph solve returned non-finite poses; keeping the "
                  "refined trajectory", file=sys.stderr)
            return poses_ref, n_loops, loop_ei, loop_ej
        # back to camera pose rows: pose = T_world_lidar @ Tr^-1
        Rti = np.asarray(R_tr).T
        tti = -Rti @ np.asarray(t_tr)
        Rc = np.einsum("nij,jk->nik", np.asarray(Ro, np.float64), Rti)
        tc = (np.einsum("nij,j->ni", np.asarray(Ro, np.float64), tti)
              + np.asarray(to, np.float64))
        poses_final = np.concatenate([Rc, tc[:, :, None]], 2).reshape(-1, 12)
    print(f"loop closure: {loops.n_accepted} accepted / "
          f"{loops.candidates_checked} checked + {n_prop} propagated, "
          f"rejects {loops.rejects} gate={gate_rejects}",
          file=sys.stderr)
    return poses_final, n_loops, loop_ei, loop_ej


# ----------------------------------------------------- artifact persistence
def save_stage_outputs(store: ArtifactStore, seq: str, odo: OdometryResult,
                       feats: FrameFeatures,
                       ref_feats: RefinementFeatures,
                       R_tr, t_tr) -> None:
    """Persist everything the back-end stages need, in the JAX package's
    layout: per-frame front-end features, per-frame refinement features,
    per-pair RANSAC inliers + relative poses, and the calibration.  Each
    stacked field is fetched to the host once and sliced in numpy."""
    fh = FrameFeatures(*(x.cpu().numpy() for x in feats))
    rh = RefinementFeatures(*(x.cpu().numpy() for x in ref_feats))
    n = fh.key_pts.shape[0]
    for i in range(n):
        store.save("features", seq, i,
                   key_pts=fh.key_pts[i],
                   descriptors=fh.descriptors[i],
                   mask=fh.mask[i],
                   key_pixels=fh.key_pixels[i])
        store.save("refine_features", seq, i,
                   ext_pts=rh.ext_pts[i],
                   ext_mask=rh.ext_mask[i],
                   planar=rh.planar[i],
                   planar_mask=rh.planar_mask[i])
    for k, (i0, i1) in enumerate(odo.inlier_pairs):
        store.save("inliers", seq, k, idx0=np.asarray(i0, np.int32),
                   idx1=np.asarray(i1, np.int32),
                   rel_R=odo.rel_Rs[k], rel_t=odo.rel_ts[k],
                   success=np.asarray(odo.successes[k]),
                   n_inliers=np.asarray(odo.n_inliers[k]))
    store.save("meta", seq, "calib", R_tr=np.asarray(R_tr),
               t_tr=np.asarray(t_tr), n_frames=np.asarray(n))


def load_stage_inputs(store: ArtifactStore, seq: str, device="cuda"):
    """Reload what ``save_stage_outputs`` wrote (by either package).
    Returns a dict with ``feats`` / ``ref_feats`` stacked with a leading
    frame axis on ``device``, plus ``inlier_pairs``, ``rel_Rs``,
    ``rel_ts``, ``successes``, ``R_tr``, ``t_tr``, ``n_frames``.  The
    features land on the card, as every entry point of the port runs there;
    the CPU only when the caller passes ``device="cpu"``."""
    calib = store.load("meta", seq, "calib")
    n = int(calib["n_frames"])
    fcols = {k: [] for k in FrameFeatures._fields}
    rcols = {k: [] for k in RefinementFeatures._fields}
    pairs, rel_Rs, rel_ts, succ = [], [], [], []
    for i in range(n):
        z = store.load("features", seq, i)
        for k in fcols:
            fcols[k].append(z[k])
        z = store.load("refine_features", seq, i)
        for k in rcols:
            rcols[k].append(z[k])
    to_dev = lambda v: torch.as_tensor(np.stack(v), device=device)
    feats = FrameFeatures(**{k: to_dev(v) for k, v in fcols.items()})
    ref_feats = RefinementFeatures(**{k: to_dev(v) for k, v in rcols.items()})
    for k in range(n - 1):
        z = store.load("inliers", seq, k)
        pairs.append((z["idx0"], z["idx1"]))
        rel_Rs.append(z["rel_R"])
        rel_ts.append(z["rel_t"])
        succ.append(bool(z["success"]))
    return dict(
        feats=feats, ref_feats=ref_feats, inlier_pairs=pairs,
        rel_Rs=np.asarray(rel_Rs).reshape(-1, 3, 3),
        rel_ts=np.asarray(rel_ts).reshape(-1, 3),
        successes=np.asarray(succ, bool),
        R_tr=calib["R_tr"], t_tr=calib["t_tr"], n_frames=n,
    )


def preprocess_to_store(scans, respond_net, encoder, R_tr, t_tr,
                        cfg: PipelineConfig, store: ArtifactStore, seq: str,
                        seed: int = 0, window: int = 16,
                        samples=None,
                        progress: Optional[Callable[[int], None]] = None
                        ) -> OdometryResult:
    """Front-end pass that persists every artifact the back end needs.
    ``samples`` and ``progress`` are those of ``run_odometry_windowed``; an
    indexable sequence of scans is read one window at a time."""
    if not (hasattr(scans, "__getitem__") and hasattr(scans, "__len__")):
        scans = list(scans)
    odo, feats, ref_feats = run_odometry_windowed(
        scans, respond_net, encoder, R_tr, t_tr, cfg,
        window=min(window, len(scans)), seed=seed,
        keep_refine_features=True, samples=samples, progress=progress)
    save_stage_outputs(store, seq, odo, feats, ref_feats, R_tr, t_tr)
    return odo


# ------------------------------------------------------------ full pipeline
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
                      window: int = 16,
                      candidate_source: str = "descriptor", *,
                      samples=None, loop_samples: Callable | None = None,
                      anchor_samples: Callable | None = None,
                      threaded_staging: bool = False
                      ) -> FullPipelineResult:
    """The end-to-end odometry stack over ``scans``, a sequence of ``(pts
    (N, 4), mask (N,))`` arrays, on the device of ``respond_net``: front
    end, de-jump, ICP refinement, burst rescue (stage 3b) and loop closure
    with the pose-graph solve (stage 4).

    A frame with fewer than half the sequence's median valid points is
    unhealthy: its pairs are untrusted (de-jump may replace them,
    refinement re-registers them), it is left out of place recognition,
    and a run of ``min_burst`` unhealthy frames is a burst span, owned by
    stage 3b and excluded from the pairwise refinement.

    ``timer`` stages are host wall clock around each stage.  The RANSAC
    parity seams: ``samples`` of ``run_odometry_windowed``, ``loop_samples``
    of ``_verify_loop_candidates``, and ``anchor_samples(i, j, R_prior,
    t_prior) -> (H, S)`` for the burst anchor registrations; otherwise the
    draws come from ``torch.Generator``s seeded from ``seed``.
    ``threaded_staging`` is ``run_odometry_windowed``'s: the front end's
    windows staged by a producer thread (the JAX package always does so),
    the same poses bit for bit.
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

    # ---- stage 1: windowed front end; features kept for loop closure and
    # the burst anchors, refinement features from the same window passes
    with timer.stage("frontend"):
        out = run_odometry_windowed(
            scans, respond_net, encoder, R_tr, t_tr, cfg,
            window=min(window, len(scans)), seed=seed, keep_features=True,
            keep_refine_features=enable_refinement, samples=samples,
            threaded_staging=threaded_staging)
    odo, feats = out[0], out[1]
    ref_feats = out[2] if enable_refinement else None
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

    # ---- stage 3: keyframe-transfer ICP refinement.  Pairs inside burst
    # spans are marked trusted so the pairwise pass skips them: consecutive
    # burst frames see one sensor-locked wedge, and stage 3b owns them.
    refine_trusted = pair_trusted
    bursty = enable_refinement and not np.all(healthy)
    if bursty:
        bspans = find_burst_spans(healthy)
        if bspans:
            refine_trusted = pair_trusted.copy()
            for (_a, _b) in bspans:
                refine_trusted[_a:_b] = True
    if enable_refinement:
        with timer.stage("refine"):
            poses_ref, stats = stage_refinement(
                poses_dj, ref_feats, odo.inlier_pairs, R_tr, t_tr, cfg,
                batched=batched_refine, pair_trusted=refine_trusted)
        if metrics:
            metrics.log("refine", refined=len(stats.refined),
                        failed=len(stats.failed),
                        rejected=len(stats.rejected))
    else:
        poses_ref, stats = poses_dj, refine.RefineStats()

    # ---- stage 3b: multi-frame burst rescue against a local map anchored
    # at the healthy entry frame; anchor-to-anchor closure through a
    # prior-seeded descriptor registration (inlier floor relaxed to 60:
    # the anchors sit a whole burst apart)
    burst_stats = None
    if bursty:
        rel_lidar_fn, apply_rel_fn = _pose_fns(R_tr, t_tr)
        dev = feats.key_pts.device
        agen = torch.Generator(device=dev).manual_seed(seed + 31)
        anchor_cfg = dataclasses.replace(
            cfg, ransac=dataclasses.replace(cfg.ransac, min_inlier_abs=60))

        def anchor_register_fn(i, j, R_prior, t_prior):
            samp = None
            if anchor_samples is not None:
                samp = torch.as_tensor(np.asarray(
                    anchor_samples(int(i), int(j), R_prior, t_prior)))
            frame = lambda k: FrameFeatures(*(x[int(k)] for x in feats))
            reg = register_pair_with_prior(
                frame(i), frame(j),
                torch.as_tensor(np.asarray(R_prior), dtype=torch.float32,
                                device=dev),
                torch.as_tensor(np.asarray(t_prior), dtype=torch.float32,
                                device=dev),
                anchor_cfg, gate_m=5.0, generator=agen, samples=samp)
            return (reg.R.double().cpu().numpy(),
                    reg.t.double().cpu().numpy(), bool(reg.success),
                    int(reg.n_inliers))

        with timer.stage("burst_rescue"):
            poses_ref, burst_stats = rescue_bursts(
                poses_ref, ref_feats, healthy, rel_lidar_fn, apply_rel_fn,
                cfg, anchor_register_fn=anchor_register_fn,
                pair_icp_fn=make_batched_icp_fn(ref_feats, cfg))
        if burst_stats.spans:
            print(f"burst rescue: spans {burst_stats.spans} accepted "
                  f"{burst_stats.accepted} closures {burst_stats.closures}",
                  file=sys.stderr)
        if metrics and burst_stats.spans:
            metrics.log("burst_rescue", spans=len(burst_stats.spans),
                        accepted=len(burst_stats.accepted))

    # ---- stage 4: loop closure + pose-graph solve (lidar-frame graph)
    n_loops = 0
    poses_final = poses_ref
    loop_ei = np.zeros(0, np.int32)
    loop_ej = np.zeros(0, np.int32)
    if enable_loop_closure and len(scans) > min_loop_gap:
        with timer.stage("loop_closure"):
            poses_final, n_loops, loop_ei, loop_ej = stage_loop_closure(
                poses_ref, feats, odo.rel_Rs, odo.rel_ts, R_tr, t_tr, cfg,
                min_loop_gap=min_loop_gap, seed=seed,
                frame_healthy=healthy, candidate_source=candidate_source,
                samples=loop_samples)
        if metrics:
            metrics.log("loop_closure", accepted=n_loops)

    return FullPipelineResult(
        poses_raw=poses_raw,
        poses_dejumped=poses_dj,
        poses_refined=poses_ref,
        poses_final=poses_final,
        odometry=odo,
        dejumped_frames=dejumped,
        refine_stats=stats,
        n_loop_closures=n_loops,
        loop_edge_i=loop_ei,
        loop_edge_j=loop_ej,
        burst_stats=burst_stats,
    )
