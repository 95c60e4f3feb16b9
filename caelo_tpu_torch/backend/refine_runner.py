"""Device side of the refinement back end (port of
``caelo_tpu/backend/refine_runner.py``).

Per-frame refinement features (extended keypoints and planar points with
normals) and the ICP callables that ``backend.refine``'s loops take:
transform frame-j features by the odometry-predicted relative pose, then
hybrid ICP against frame i.  The JAX module vmaps one pair; here the span
batch is an explicit leading axis.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..geometry import se3
from ..models.respond_net import RespondLayer
from ..ops.masking import compact
from ..ops.nms import select_keypoints_planes
from ..projection.normals import extract_planar_points
from ..projection.spherical import (extend_keypoints, model_input,
                                    project_to_spherical_ring)
from .icp import IcpResult, icp_hybrid


class RefinementFeatures(NamedTuple):
    ext_pts: torch.Tensor      # (..., E, 3) extended keypoints
    ext_mask: torch.Tensor     # (..., E)
    planar: torch.Tensor       # (..., P, 6) planar points + normals
    planar_mask: torch.Tensor  # (..., P)


def extended_cloud(pts, mask, image, counter, key_pixels, key_mask,
                   cfg: PipelineConfig):
    """Extended-keypoint cloud of one frame for refinement ICP, with the
    degraded-frame fallback: slots the extended keypoints leave unfilled
    are topped up with an even, deduplicated subsample of the raw scan
    (``caelo_tpu/backend/refine_runner.py:38-78``)."""
    nbr_pts, nbr_mask = extend_keypoints(
        image, counter, key_pixels, key_mask, cfg.sensor,
        radius=cfg.keypoint.extend_radius)
    # even coverage of the valid prefix (pad_points compacts valid points
    # to the front): index k -> floor(k * n_valid / max_points)
    S = cfg.icp.max_points
    n_valid = torch.clamp_min(mask.sum(), 1)
    ridx = torch.arange(S, device=pts.device) * n_valid // S
    # dedup repeated indices (n_valid < S) so duplicate points can't
    # inflate the ICP inlier count
    uniq = torch.cat([torch.ones(1, dtype=torch.bool, device=pts.device),
                      ridx[1:] != ridx[:-1]])
    ext_pts, ext_mask, _ = compact(
        torch.cat([nbr_pts.reshape(-1, 3), pts[ridx, 0:3]]),
        torch.cat([nbr_mask.reshape(-1), mask[ridx] & uniq]), S, fill=0.0)
    return ext_pts, ext_mask


def refinement_features(pts, mask, image, counter, key_pixels, key_mask,
                        saliency, cfg: PipelineConfig) -> RefinementFeatures:
    """One frame's refinement features from its front-end results: the
    ring image, the keypoints and the saliency map of the same NMS run."""
    ext_pts, ext_mask = extended_cloud(pts, mask, image, counter, key_pixels,
                                       key_mask, cfg)
    planar, planar_mask = extract_planar_points(
        image, counter, saliency, cfg.sensor, max_planar=cfg.icp.max_planar)
    return RefinementFeatures(ext_pts, ext_mask, planar, planar_mask)


@torch.no_grad()
def extract_refinement_features(respond_net: RespondLayer, pts: torch.Tensor,
                                mask: torch.Tensor,
                                cfg: PipelineConfig = PipelineConfig()
                                ) -> RefinementFeatures:
    """Refinement features of one padded scan, standalone (the windowed
    front end gets them from ``extract_frame_features_full`` instead)."""
    image, counter = project_to_spherical_ring(pts, mask, cfg.sensor)
    net_in = model_input(image, cfg.sensor).permute(2, 0, 1)[None]
    planes = respond_net(net_in)[0]
    _, key_pixels, key_mask, saliency = select_keypoints_planes(
        image, counter, planes, cfg.sensor, cfg.keypoint)
    return refinement_features(pts, mask, image, counter, key_pixels,
                               key_mask, saliency, cfg)


def refine_pairs_batched(f0s: RefinementFeatures, f1s: RefinementFeatures,
                         relRs: torch.Tensor, relTs: torch.Tensor,
                         cfg: PipelineConfig = PipelineConfig(),
                         thr_scale: float = 1.0) -> IcpResult:
    """ICP corrections of a batch of odometry-predicted relative poses
    ``relRs (S, 3, 3)``, ``relTs (S, 3)``: frame-1 features moved by the
    prediction, then hybrid ICP against frame 0, all spans in one loop.
    The returned ``(R, t)`` is the correction: refined rel = ``R @ relR,
    R @ relT + t``.  ``thr_scale`` is the retry rung (see ``icp_hybrid``).
    """
    p1 = se3.apply(relRs, relTs, f1s.ext_pts)
    pl1 = torch.cat([
        se3.apply(relRs, relTs, f1s.planar[..., 0:3]),
        se3.apply(relRs, torch.zeros_like(relTs), f1s.planar[..., 3:6])], -1)
    return icp_hybrid(
        f0s.ext_pts, f0s.ext_mask, p1, f1s.ext_mask,
        f0s.planar, f0s.planar_mask, pl1, f1s.planar_mask, cfg.icp,
        thr_scale=thr_scale)


def refine_pair(f0: RefinementFeatures, f1: RefinementFeatures,
                relR: torch.Tensor, relT: torch.Tensor,
                cfg: PipelineConfig = PipelineConfig(),
                thr_scale: float = 1.0) -> IcpResult:
    """``refine_pairs_batched`` for one pair (unbatched features)."""
    one = lambda f: RefinementFeatures(*(x[None] for x in f))
    res = refine_pairs_batched(one(f0), one(f1), relR[None], relT[None], cfg,
                               thr_scale)
    return IcpResult(*(x[0] for x in res))


def stack_features(features, idx) -> RefinementFeatures:
    """Gather frames ``idx`` of ``features`` into a batch: a list of
    per-frame features (stacked), or one ``RefinementFeatures`` with a
    leading frame axis (one gather per field)."""
    if isinstance(features, RefinementFeatures):
        ii = torch.as_tensor(np.asarray(idx), device=features.ext_pts.device)
        return RefinementFeatures(*(x[ii] for x in features))
    sel = [features[int(i)] for i in idx]
    return RefinementFeatures(*(torch.stack(xs) for xs in zip(*sel)))


def _stacked(features) -> RefinementFeatures:
    """``features`` with a leading frame axis (a list is stacked once)."""
    if isinstance(features, RefinementFeatures):
        return features
    return stack_features(features, range(len(features)))


def make_batched_icp_fn(features, cfg: PipelineConfig = PipelineConfig(),
                        chunk: int = 16) -> Callable:
    """Adapt ``refine_pairs_batched`` to ``refine_odometry_batched``'s
    contract: ``(idx_i, idx_j, relRs, relTs, thr_scale=1.0) -> (dRs, dts,
    oks, init_res, final_res)``, host float64 numpy.

    Spans run in batches of ``chunk``; the last batch is padded with copies
    of its last span, as in the JAX version, so every call solves the same
    shapes."""
    features = _stacked(features)
    dev = features.ext_pts.device

    def batched(idx_i, idx_j, relRs, relTs, thr_scale=1.0):
        S = len(idx_i)
        dRs = np.zeros((S, 3, 3))
        dts = np.zeros((S, 3))
        oks = np.zeros((S,), bool)
        r0s = np.zeros((S,))
        r1s = np.zeros((S,))
        for s in range(0, S, chunk):
            sel = slice(s, min(s + chunk, S))
            n = sel.stop - sel.start
            pad = lambda a: np.concatenate(
                [a[sel], np.repeat(a[sel][-1:], chunk - n, axis=0)])
            rR = torch.as_tensor(pad(np.asarray(relRs)), dtype=torch.float32,
                                 device=dev)
            rT = torch.as_tensor(pad(np.asarray(relTs)), dtype=torch.float32,
                                 device=dev)
            res = refine_pairs_batched(
                stack_features(features, pad(np.asarray(idx_i))),
                stack_features(features, pad(np.asarray(idx_j))),
                rR, rT, cfg, thr_scale=float(thr_scale))
            dRs[sel] = res.R[:n].double().cpu().numpy()
            dts[sel] = res.t[:n].double().cpu().numpy()
            oks[sel] = res.success[:n].cpu().numpy()
            r0s[sel] = res.init_res[:n].double().cpu().numpy()
            r1s[sel] = res.final_res[:n].double().cpu().numpy()
        return dRs, dts, oks, r0s, r1s

    return batched


def make_icp_fn(features, cfg: PipelineConfig = PipelineConfig()
                ) -> Callable:
    """Adapt ``refine_pair`` to the sequential ``refine_odometry`` contract:
    ``icp_fn(i, j, relR, relT) -> (dR, dt, success)``."""
    features = _stacked(features)
    dev = features.ext_pts.device
    frame = lambda i: RefinementFeatures(*(x[i] for x in features))

    def icp_fn(i: int, j: int, relR: np.ndarray, relT: np.ndarray):
        res = refine_pair(
            frame(i), frame(j),
            torch.as_tensor(np.asarray(relR), dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(relT), dtype=torch.float32, device=dev),
            cfg)
        return (res.R.double().cpu().numpy(), res.t.double().cpu().numpy(),
                bool(res.success))

    return icp_fn
