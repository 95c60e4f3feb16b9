"""Sequence odometry (port of ``caelo_tpu/frontend/odometry.py``): the
frame-by-frame driver ``run_odometry`` and the windowed driver
``run_odometry_windowed``.

Feature extraction and registration run on the device; the pose chain --
the only sequential dependency -- is host float64.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from ..backend.refine_runner import RefinementFeatures
from ..config import PipelineConfig
from .. import setup_device
from ..geometry.kitti_pose import chain_poses
from ..parallel.pipeline import make_sequence_processor
from ..utils.telemetry import span
from .registration import (FrameFeatures, extract_frame_features,
                           register_pair, register_pair_with_prior)


@dataclasses.dataclass
class OdometryResult:
    poses: np.ndarray                 # (N, 12) KITTI rows
    rel_Rs: np.ndarray                # (N-1, 3, 3) lidar-frame rels
    rel_ts: np.ndarray                # (N-1, 3)
    successes: np.ndarray             # (N-1,) bool
    n_inliers: np.ndarray             # (N-1,) int
    inlier_pairs: List                # per pair: (idx0, idx1) int arrays
    thresholds: np.ndarray = None     # (N-1,) accepted RANSAC rung (m)


def _plausible(R, t, cfg: PipelineConfig) -> bool:
    """The physical-plausibility gate (``cfg.max_rel_rot_deg``): a per-pair
    motion impossible at scan rate is an aliased consensus, not a
    success."""
    if cfg.max_rel_rot_deg <= 0:
        return True
    ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)))
    return not (ang > cfg.max_rel_rot_deg
                or np.linalg.norm(t) > cfg.max_rel_trans_m)


def run_odometry(scans: Iterable, respond_net, encoder, R_tr=None, t_tr=None,
                 cfg: PipelineConfig = PipelineConfig(), seed: int = 0,
                 feature_fn: Optional[Callable] = None,
                 progress: Optional[Callable[[int], None]] = None,
                 samples=None) -> OdometryResult:
    """Frame-to-frame odometry over an iterable of ``(pts, mask)`` scans,
    one frame and one pair at a time, on the device of ``respond_net``'s
    parameters.

    ``feature_fn(pts, mask) -> FrameFeatures`` replaces the CAE-LO front
    end (keypoint-source ablations); by default it is
    ``extract_frame_features``.  A pair that fails plain registration is
    retried with the constant-velocity motion prior gating the candidate
    matches (``cfg.prior_gate_m``); a success that fails the plausibility
    gate is demoted; a failed pair takes the previous pair's motion
    (constant velocity) and stays recorded as a failure for the back end.
    ``progress(i)`` is called after frame ``i``.

    ``samples``, if given, is ``(pass1, pass2)``: ``(n-1, H, S)`` RANSAC
    pair indices per pair for the plain pass and the motion-prior retry
    (the parity seam of ``ransac_rigid``); otherwise draws come from a
    ``torch.Generator`` seeded with ``seed``.
    """
    if R_tr is None:
        R_tr = np.eye(3)
    if t_tr is None:
        t_tr = np.zeros(3)
    device = setup_device(next(respond_net.parameters()).device)
    if feature_fn is None:
        def feature_fn(pts, mask):
            return extract_frame_features(
                respond_net, encoder, torch.as_tensor(pts).to(device),
                torch.as_tensor(mask).to(device), cfg)
    generator = torch.Generator(device=device).manual_seed(seed)
    draw = lambda k, p: None if samples is None else torch.as_tensor(
        samples[p][k])

    rel_Rs, rel_ts, succ, n_inl, pairs, ths = [], [], [], [], [], []
    prev_feat: FrameFeatures | None = None
    prevR, prevT = np.eye(3), np.zeros(3)
    for i, (pts, mask) in enumerate(scans):
        # the frame's span closes before progress(i): a caller may start
        # or stop a profiler there
        with span("caelo.odometry.frame"):
            feat = feature_fn(pts, mask)
            if prev_feat is not None:
                reg = register_pair(prev_feat, feat, cfg, generator=generator,
                                    samples=draw(i - 1, 0))
                ok = bool(reg.success)
                if not ok and cfg.prior_gate_m > 0.0:
                    # retry with the constant-velocity motion prior gating
                    # the candidate matches (GenerateTrajactory.m:210
                    # semantics)
                    with span("caelo.register.retry"):
                        prior = lambda a: torch.as_tensor(
                            a, dtype=torch.float32, device=device)
                        reg = register_pair_with_prior(
                            prev_feat, feat, prior(prevR), prior(prevT), cfg,
                            generator=generator, samples=draw(i - 1, 1))
                        ok = bool(reg.success)
                R = reg.R.double().cpu().numpy()
                t = reg.t.double().cpu().numpy()
                ok = ok and _plausible(R, t, cfg)
                if not ok:
                    R, t = prevR, prevT       # constant-velocity fallback
                inl = reg.inlier_mask.cpu().numpy()
                pairs.append((reg.inlier_idx0.cpu().numpy()[inl],
                              reg.inlier_idx1.cpu().numpy()[inl]))
                rel_Rs.append(R)
                rel_ts.append(t)
                succ.append(ok)
                n_inl.append(int(reg.n_inliers))
                ths.append(float(reg.threshold))
                prevR, prevT = R, t
            prev_feat = feat
        if progress is not None:
            progress(i)

    rel_Rs = np.array(rel_Rs).reshape(-1, 3, 3)
    rel_ts = np.array(rel_ts).reshape(-1, 3)
    return OdometryResult(
        poses=chain_poses(rel_Rs, rel_ts, np.asarray(R_tr), np.asarray(t_tr)),
        rel_Rs=rel_Rs, rel_ts=rel_ts, successes=np.array(succ, bool),
        n_inliers=np.array(n_inl, np.int32), inlier_pairs=pairs,
        thresholds=np.array(ths, np.float32))


def window_starts(n: int, window: int) -> list:
    """First frame of each window; consecutive windows share one frame so
    every consecutive pair is registered."""
    starts, s0 = [], 0
    while s0 < n - 1:
        starts.append(s0)
        s0 = min(s0 + window, n) - 1
    return starts


def staged_windows(scans, n: int, window: int, pin: bool = False,
                   threaded: bool = False):
    """Yield ``(start, stop, pts, msk)`` per window: frames ``start`` to
    ``stop - 1`` of ``scans``, each frame read once and stacked straight
    into CPU tensors, pinned ones when ``pin``.

    With ``threaded`` a producer thread stages the windows (the reads of a
    disk-backed sequence and the stack) into a queue of at most two, so
    staging overlaps the device work on the window before, as
    ``caelo_tpu/frontend/odometry.py:211-263`` does.  An exception in the
    producer is raised here, in the caller's thread; if the caller stops
    early, the producer stops too.
    """
    def stack(xs):
        out = torch.empty((len(xs),) + tuple(xs[0].shape), dtype=xs[0].dtype,
                          pin_memory=pin)
        return torch.stack(xs, out=out)

    def stage(start):
        with span("caelo.odometry.stage"):
            stop = min(start + window, n)
            frames = [scans[i] for i in range(start, stop)]
            pts = stack([torch.as_tensor(p) for p, _ in frames])
            msk = stack([torch.as_tensor(m) for _, m in frames])
            return start, stop, pts, msk

    starts = window_starts(n, window)
    if not threaded:
        for start in starts:
            yield stage(start)
        return

    q: queue.Queue = queue.Queue(maxsize=2)
    stopped = threading.Event()

    def put(item):
        while not stopped.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for start in starts:
                if not put(stage(start)):
                    return
            put(None)
        except BaseException as exc:       # raised again in the caller
            put(exc)

    th = threading.Thread(target=producer, name="window-staging",
                          daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stopped.set()
        th.join()


def run_odometry_windowed(scans, respond_net, encoder, R_tr=None, t_tr=None,
                          cfg: PipelineConfig = PipelineConfig(),
                          window: int = 16, seed: int = 0,
                          keep_features: bool = False,
                          keep_refine_features: bool = False,
                          samples=None,
                          progress: Optional[Callable[[int], None]] = None,
                          threaded_staging: bool = False) -> tuple:
    """Windowed frame-to-frame odometry over ``scans``, ``(pts (N, 4), mask
    (N,))`` numpy arrays or tensors.  An indexable sequence (a list, a
    ``data.scancache.NpyScanReader``) is read one window at a time; any
    other iterable (a generator such as ``KittiOdometry.iter_scans``) is
    listed first.  ``progress(j)`` is called with the last frame of each
    window once it is done.

    Runs on the device of ``respond_net``'s parameters.  Each window is one
    call of the window processor; windows overlap by one frame.  Unlike the
    JAX version, the last window is not padded to ``window`` frames (eager
    PyTorch needs no fixed shape).  Each window is staged when it is due
    (``staged_windows``: reads and stack, pinned on a card) and copied to
    the card without blocking.  ``threaded_staging=True`` stages in a
    producer thread with a queue of two, as JAX always does; the copy and
    every RANSAC draw stay in the calling thread, so the results are the
    same bit for bit.  It is off by default: on the H100 it was not faster
    over 17 scans, from a page-cached ``NpyScanReader`` too (``PERF.md``
    §5), and a sequence whose reads would hide behind the device is not
    measured yet.

    ``samples``, if given, is ``(pass1, pass2)``: ``(n-1, H, S)`` RANSAC pair
    indices per global pair for the plain pass and the motion-prior retry
    (the parity seam of ``ransac_rigid``); otherwise draws come from a
    ``torch.Generator`` seeded with ``seed``.

    Returns ``(OdometryResult, features_or_None)``; ``features`` stacks the
    kept frames' ``FrameFeatures`` on a leading axis of length n.  With
    ``keep_refine_features`` it returns ``(OdometryResult, features,
    refine_features)``, the frames' ``RefinementFeatures`` stacked the
    same way.
    """
    if R_tr is None:
        R_tr = np.eye(3)
    if t_tr is None:
        t_tr = np.zeros(3)
    if not (hasattr(scans, "__getitem__") and hasattr(scans, "__len__")):
        scans = list(scans)
    n = len(scans)
    if n < 2:
        raise ValueError("odometry needs at least two scans")
    device = setup_device(next(respond_net.parameters()).device)
    generator = torch.Generator(device=device).manual_seed(seed)
    keep_features = keep_features or keep_refine_features
    process = make_sequence_processor(cfg, with_refine=keep_refine_features)

    rel_Rs = np.zeros((n - 1, 3, 3))
    rel_ts = np.zeros((n - 1, 3))
    succ = np.zeros((n - 1,), bool)
    n_inl = np.zeros((n - 1,), np.int32)
    ths = np.zeros((n - 1,), np.float32)
    pairs: List = [None] * (n - 1)
    feat_windows: List = []
    ref_windows: List = []

    for start, stop, pts, msk in staged_windows(
            scans, n, window, pin=device.type == "cuda",
            threaded=threaded_staging):
        # from the copy to the card to the read-backs, closed before
        # progress
        with span("caelo.odometry.window"):
            pts = pts.to(device, non_blocking=True)
            msk = msk.to(device, non_blocking=True)
            win_samples = None
            if samples is not None:
                win_samples = tuple(torch.as_tensor(s[start:stop - 1])
                                    for s in samples)
            out = process(respond_net, encoder, pts, msk, generator,
                          win_samples)
            feats, regs = out[0], out[-1]
            R_all = regs.R.double().cpu().numpy()
            t_all = regs.t.double().cpu().numpy()
            s_all = regs.success.cpu().numpy()
            ni_all = regs.n_inliers.cpu().numpy()
            th_all = regs.threshold.cpu().numpy()
            inl_mask = regs.inlier_mask.cpu().numpy()
            idx0 = regs.inlier_idx0.cpu().numpy()
            idx1 = regs.inlier_idx1.cpu().numpy()
            for k in range(stop - start - 1):
                g = start + k
                rel_Rs[g] = R_all[k]
                rel_ts[g] = t_all[k]
                succ[g] = bool(s_all[k]) and _plausible(R_all[k], t_all[k],
                                                        cfg)
                n_inl[g] = int(ni_all[k])
                ths[g] = float(th_all[k])
                pairs[g] = (idx0[k][inl_mask[k]], idx1[k][inl_mask[k]])
            if keep_features:
                j0 = 0 if start == 0 else 1         # drop the overlap frame
                feat_windows.append(FrameFeatures(*(x[j0:] for x in feats)))
                if keep_refine_features:
                    ref_windows.append(RefinementFeatures(
                        *(x[j0:] for x in out[1])))
        if progress is not None:
            progress(stop - 1)

    cat = lambda cls, windows: cls(*(torch.cat(xs) for xs in zip(*windows)))
    feats_out = cat(FrameFeatures, feat_windows) if keep_features else None

    # constant-velocity fallback on failures
    prevR, prevT = np.eye(3), np.zeros(3)
    for g in range(n - 1):
        if not succ[g]:
            rel_Rs[g] = prevR
            rel_ts[g] = prevT
        prevR, prevT = rel_Rs[g], rel_ts[g]

    poses = chain_poses(rel_Rs, rel_ts, np.asarray(R_tr), np.asarray(t_tr))
    result = OdometryResult(
        poses=poses, rel_Rs=rel_Rs, rel_ts=rel_ts, successes=succ,
        n_inliers=n_inl, inlier_pairs=pairs, thresholds=ths)
    if keep_refine_features:
        return result, feats_out, cat(RefinementFeatures, ref_windows)
    return result, feats_out
