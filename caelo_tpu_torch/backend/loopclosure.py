"""Loop-closure detection and closure via place recognition + registration
(port of ``caelo_tpu/backend/loopclosure.py``).

* global frame descriptor: the masked mean and standard deviation of a
  frame's keypoint descriptors;
* candidate search: one all-pairs distance matmul over the trajectory
  (pooled descriptors), or the rotation-searched ScanContext correlation
  matrix, masked to exclude temporal neighbours; per-frame proposals keep
  the candidates spread along the trajectory;
* geometric verification through the caller's registration callables;
  accepted closures become ``PoseGraph`` loop edges.

The top-k selections order ties as ``lax.top_k`` does (``ops.nms.top_k``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..frontend.matching import squared_distance_matrix
from ..ops.nms import top_k
from .posegraph import PoseGraph
from .scancontext import align_score, scan_context


def _align_score_pairs(scs: torch.Tensor, idx_i, idx_j):
    """ScanContext alignment of candidate pairs ``(scs[i], scs[j])``, all
    pairs in one batched call."""
    ii = torch.as_tensor(np.asarray(idx_i), device=scs.device).long()
    jj = torch.as_tensor(np.asarray(idx_j), device=scs.device).long()
    return align_score(scs[ii], scs[jj])


def frame_global_descriptor(descriptors: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """``(..., K, 60)`` keypoint descriptors -> ``(..., 120)`` global place
    signature."""
    w = mask.to(torch.float32)[..., None]
    n = torch.clamp_min(w.sum(-2), 1.0)
    mean = (descriptors * w).sum(-2) / n
    var = ((descriptors - mean[..., None, :]) ** 2 * w).sum(-2) / n
    return torch.cat([mean, torch.sqrt(var + 1e-12)], -1)


def loop_candidates(global_desc: torch.Tensor, valid: torch.Tensor,
                    min_gap: int = 100, max_candidates: int = 64):
    """Top candidate frame pairs (i < j, ``j - i >= min_gap``) by
    global-descriptor similarity over the whole pair matrix.

    Returns ``(pair_i, pair_j, score, pair_mask)``, ``(max_candidates,)``
    each.
    """
    N = global_desc.shape[0]
    d2 = squared_distance_matrix(global_desc, global_desc)
    ii = torch.arange(N, device=global_desc.device)
    far = (ii[:, None] - ii[None, :]).abs() >= min_gap
    ok = far & valid[:, None] & valid[None, :] & (ii[:, None] < ii[None, :])
    score = torch.where(ok, -d2, -torch.inf).reshape(-1)
    vals, idx = top_k(score, max_candidates)
    return idx // N, idx % N, -vals, torch.isfinite(vals)


def loop_candidates_per_frame(global_desc: torch.Tensor, valid: torch.Tensor,
                              min_gap: int = 100, max_candidates: int = 64,
                              per_frame_k: int = 3):
    """Per-frame candidate generation: every frame j proposes its
    ``per_frame_k`` best earlier matches ``i <= j - min_gap``; the
    ``max_candidates`` best proposals survive.  On a multi-revisit
    sequence the global top-k concentrates at the single most distinctive
    place; per-frame proposals spread along the trajectory, which is what
    the pose graph needs.  Same contract as ``loop_candidates``."""
    d2 = squared_distance_matrix(global_desc, global_desc)
    pi, pj, vals, mask = _per_frame_topk(-d2, valid, min_gap,
                                         max_candidates, per_frame_k)
    return pi, pj, -vals, mask


def _per_frame_topk(sim: torch.Tensor, valid: torch.Tensor, min_gap: int,
                    max_candidates: int, per_frame_k: int):
    """Per-frame proposals over a similarity matrix (higher = better;
    ``sim[j, i]`` scores later frame j against earlier frame i).  Returns
    ``(pair_i, pair_j, similarity, mask)``."""
    N = sim.shape[0]
    ii = torch.arange(N, device=sim.device)
    # row = later frame j, col = earlier frame i
    ok = (valid[:, None] & valid[None, :]
          & ((ii[:, None] - ii[None, :]) >= min_gap))
    simm = torch.where(ok, sim, -torch.inf)
    kf = min(per_frame_k, N)
    vals_k, bi = top_k(simm, kf)                 # per-row k best (N, kf)
    score = torch.where(torch.isfinite(vals_k), vals_k, -torch.inf
                        ).reshape(-1)
    rows = torch.arange(N, dtype=torch.int32, device=sim.device
                        ).repeat_interleave(kf)
    k = min(max_candidates, N * kf)
    vals, sel = top_k(score, k)
    pad = max_candidates - k
    if pad:
        vals = torch.cat([vals, vals.new_full((pad,), -torch.inf)])
        sel = torch.cat([sel, sel.new_zeros(pad)])
    return (bi.reshape(-1)[sel].to(torch.int32), rows[sel], vals,
            torch.isfinite(vals))


def loop_candidates_scancontext(scs: torch.Tensor, valid: torch.Tensor,
                                min_gap: int = 100, max_candidates: int = 64,
                                per_frame_k: int = 3):
    """Per-frame candidates from the full rotation-searched ScanContext
    correlation matrix (``scancontext.sc_correlation_matrix``) instead of
    pooled-descriptor distance: a revisit driven the other way still
    surfaces, and the aligning yaw comes out of the same matrix.

    Returns ``(pair_i, pair_j, sc_score, yaw, mask)``; ``yaw`` rotates
    frame j into frame i.
    """
    from .scancontext import sc_correlation_matrix

    score, yaw = sc_correlation_matrix(scs)
    # rows must index the LATER frame j: score/yaw are (i-rows, j-cols)
    pi, pj, vals, mask = _per_frame_topk(score.T, valid, min_gap,
                                         max_candidates, per_frame_k)
    return pi, pj, vals, yaw[pi.long(), pj.long()], mask


class LoopClosures(NamedTuple):
    edges: PoseGraph
    n_accepted: int
    candidates_checked: int
    # rejection counts by cause
    rejects: dict = {}


def stack_frame_features(features):
    """Stack a list of per-frame ``FrameFeatures`` into one with a leading
    frame axis; a stacked one passes through unchanged."""
    if isinstance(features, list) or (
            isinstance(features, tuple) and not hasattr(features, "_fields")):
        return type(features[0])(*(torch.stack(xs) for xs in zip(*features)))
    return features


def _build_signatures(desc: torch.Tensor, mask: torch.Tensor,
                      key_pts: torch.Tensor, with_sc: bool):
    """The whole trajectory's place-recognition features in batched calls:
    per-frame global descriptors, validity and (``with_sc``) scan
    contexts."""
    gd = frame_global_descriptor(desc, mask)
    valid = mask.any(1)
    scs = scan_context(key_pts[..., :3], mask) if with_sc else None
    return gd, valid, scs


def _host(x) -> np.ndarray:
    return x.cpu().numpy()


def detect_and_close(features, register_fn: Callable = None,
                     min_gap: int = 100, max_candidates: int = 32,
                     max_accept: int = 16,
                     dedup_window: int = 10,
                     use_scan_context: bool = False,
                     sc_min_score: float = 0.25,
                     sc_matrix_min_score: float = 0.45,
                     register_batch_fn: Callable = None,
                     edge_gate_fn: Callable = None,
                     frame_valid=None,
                     candidate_source: str = "descriptor") -> LoopClosures:
    """Full loop-closure pass over a sequence's ``FrameFeatures`` (a list,
    or stacked with a leading frame axis).

    Args:
      register_fn: ``(i, j) -> (R, t, success, n_inliers)``, or ``(i, j,
        yaw_rad)`` with ``use_scan_context`` (the ScanContext yaw rotating
        frame j into frame i, a motion prior for the verification).
      use_scan_context: re-rank candidates by the ScanContext alignment
        score and drop those below ``sc_min_score`` before verification.
      register_batch_fn: ``(idx_i, idx_j, yaws) -> (Rs, ts, oks, n_inls)``
        over numpy index arrays: verifies every surviving candidate in one
        batched call; the accepted set is the sequential path's.
      edge_gate_fn: optional ``(i, j, R, t) -> bool``, a final
        plausibility gate on a verified candidate.
      frame_valid: optional ``(N,)`` bool, frames eligible for place
        recognition.
      candidate_source: ``"descriptor"`` (pooled descriptor distance, then
        the ScanContext re-rank) or ``"scancontext"`` (the correlation
        matrix; requires ``use_scan_context``).

    Returns loop edges mapping frame j into frame i, weighted by inlier
    count.
    """
    if candidate_source not in ("descriptor", "scancontext"):
        raise ValueError(f"unknown candidate_source {candidate_source!r}")
    if candidate_source == "scancontext" and not use_scan_context:
        raise ValueError("candidate_source='scancontext' requires "
                         "use_scan_context=True")
    stacked = stack_frame_features(features)
    gd, valid, scs = _build_signatures(
        stacked.descriptors, stacked.mask, stacked.key_pts,
        with_sc=use_scan_context)
    if frame_valid is not None:
        valid = valid & torch.as_tensor(np.asarray(frame_valid, bool),
                                        device=valid.device)

    if candidate_source == "scancontext":
        pi, pj, sc_s, y_all, pmask = loop_candidates_scancontext(
            scs, valid, min_gap=min_gap, max_candidates=max_candidates)
        pi, pj, pmask = _host(pi), _host(pj), _host(pmask)
        yaws = [float(y) for y in _host(y_all)]
        # the correlation-matrix floor, not sc_min_score: unrelated scenes
        # already score ~0.39-0.43 on this whole-matrix cosine
        pmask = pmask & (_host(sc_s) >= sc_matrix_min_score)
    else:
        pi, pj, score, pmask = loop_candidates_per_frame(
            gd, valid, min_gap=min_gap, max_candidates=max_candidates)
        pi, pj, pmask = _host(pi), _host(pj), _host(pmask)

        yaws = [None] * len(pi)
        if use_scan_context:
            # every candidate at once (masked slots are overwritten with
            # -inf below)
            s_all, y_all = _align_score_pairs(scs, pi, pj)
            s_all, y_all = _host(s_all), _host(y_all)
            sc_scores = np.where(pmask, s_all, -np.inf)
            yaws = [float(y) for y in y_all]
            order = np.argsort(-sc_scores, kind="stable")
            pi, pj, pmask = pi[order], pj[order], pmask[order]
            yaws = [yaws[k] for k in order]
            pmask = pmask & (sc_scores[order] >= sc_min_score)

    batch_results = None
    if register_batch_fn is not None:
        live = np.nonzero(pmask)[0]
        if live.size:
            bR, bt, bok, bni = register_batch_fn(
                pi[live], pj[live],
                np.asarray([yaws[k] if yaws[k] is not None else 0.0
                            for k in live], np.float32))
            batch_results = {int(k): (bR[q], bt[q], bool(bok[q]), int(bni[q]))
                             for q, k in enumerate(live)}

    ei, ej, Rs, ts, ws = [], [], [], [], []
    seen = []
    checked = 0
    rejects = {"sc_or_invalid": 0, "dedup": 0, "registration": 0, "gate": 0}
    for slot, (i, j, m, yaw) in enumerate(zip(pi, pj, pmask, yaws)):
        if not m or len(ei) >= max_accept:
            rejects["sc_or_invalid"] += bool(not m)
            continue
        if any(abs(int(i) - a) < dedup_window
               and abs(int(j) - b) < dedup_window for a, b in seen):
            rejects["dedup"] += 1
            continue
        checked += 1
        if batch_results is not None:
            R, t, ok, n_inl = batch_results[slot]
        elif use_scan_context:
            R, t, ok, n_inl = register_fn(int(i), int(j), yaw)
        else:
            R, t, ok, n_inl = register_fn(int(i), int(j))
        if not ok:
            rejects["registration"] += 1
            continue
        if edge_gate_fn is not None and not edge_gate_fn(int(i), int(j), R, t):
            rejects["gate"] += 1
            continue
        seen.append((int(i), int(j)))
        ei.append(int(i))
        ej.append(int(j))
        Rs.append(np.asarray(R))
        ts.append(np.asarray(t))
        ws.append(float(n_inl))
    n = len(ei)
    if n == 0:
        edges = PoseGraph(
            edge_i=torch.zeros(0, dtype=torch.int32),
            edge_j=torch.zeros(0, dtype=torch.int32),
            rel_R=torch.zeros((0, 3, 3), dtype=torch.float64),
            rel_t=torch.zeros((0, 3), dtype=torch.float64),
            weight=torch.zeros(0, dtype=torch.float64),
            rot_info=torch.zeros(0, dtype=torch.float64))
    else:
        edges = PoseGraph(
            edge_i=torch.as_tensor(ei, dtype=torch.int32),
            edge_j=torch.as_tensor(ej, dtype=torch.int32),
            rel_R=torch.as_tensor(np.stack(Rs)),
            rel_t=torch.as_tensor(np.stack(ts)),
            weight=torch.as_tensor(ws, dtype=torch.float64) / 100.0,
            rot_info=torch.full((n,), 100.0, dtype=torch.float64))
    return LoopClosures(edges, n, checked, rejects)
