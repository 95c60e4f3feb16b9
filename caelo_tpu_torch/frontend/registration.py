"""Per-frame feature extraction and pairwise registration (port of
``caelo_tpu/frontend/registration.py:35-188``).

  scan -> spherical ring -> respond net -> NMS top-k (K1) -> voxel pyramid
  -> 3-scale patches (K2 on the bit-table route) -> encoder -> 60-dim
  descriptors -> NN matching -> batched RANSAC -> refit pose; with the
  refinement features (extended keypoints, planar points) from the same
  NMS run.

Registration is batched over leading axes of the features, so a window's
consecutive pairs register in one call.

``cfg.compute_dtype="bfloat16"`` runs the respond net and the encoder in
bfloat16 as the JAX version does: a bfloat16 copy of each module's
parameters and the network inputs cast to bfloat16, the respond map and the
codes cast back to float32.  Keypoint selection (K1), the patches (K2) and
everything after the encoder stay float32.
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import torch
from torch.func import functional_call

from ..backend.refine_runner import refinement_features
from ..config import PipelineConfig
from ..models.patch_encoder import PatchEncoder
from ..models.respond_net import RespondLayer
from ..ops.nms import select_keypoints_planes
from ..projection.spherical import model_input, project_to_spherical_ring
from ..utils.telemetry import span
from ..voxel.grid import extract_patches, voxelize
from .matching import match_descriptors
from .ransac import RansacResult, ransac_rigid


class FrameFeatures(NamedTuple):
    """Per-frame keypoints + descriptors (fixed shapes, mask-padded)."""

    key_pts: torch.Tensor      # (..., K, 3)
    descriptors: torch.Tensor  # (..., K, 60)
    mask: torch.Tensor         # (..., K) bool
    key_pixels: torch.Tensor   # (..., K, 2) int32


class PairRegistration(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    success: torch.Tensor
    inlier_idx0: torch.Tensor  # (..., K) int64 -- frame-0 keypoint per pair
    inlier_idx1: torch.Tensor  # (..., K) int64 -- frame-1 keypoint per pair
    inlier_mask: torch.Tensor  # (..., K) bool
    n_inliers: torch.Tensor
    threshold: torch.Tensor


def stack_features(feats) -> FrameFeatures:
    """A list of per-frame ``FrameFeatures`` -> one with a leading frame axis."""
    return FrameFeatures(*(torch.stack(xs) for xs in zip(*feats)))


# module -> (signature of its float32 parameters, their bfloat16 copies)
_LOW_PRECISION = weakref.WeakKeyDictionary()


def _low_precision_params(module: torch.nn.Module, dtype: torch.dtype):
    """``dtype`` copies of ``module``'s parameters, made once per module and
    made again when a parameter changes (moved, replaced, or written in
    place: a state-dict load or an optimiser step bumps its version), so
    the caller's module itself is never cast."""
    sig = (dtype,) + tuple((p.data_ptr(), p.device, p._version)
                           for p in module.parameters())
    hit = _LOW_PRECISION.get(module)
    if hit is None or hit[0] != sig:
        hit = (sig, {k: p.detach().to(dtype)
                     for k, p in module.named_parameters()})
        _LOW_PRECISION[module] = hit
    return hit[1]


def run_in(module: torch.nn.Module, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """``module(x)`` in ``dtype``: as it is for float32; otherwise its
    parameters' ``dtype`` copies and ``x`` cast to ``dtype`` through
    ``functional_call``, the output cast back to float32 (JAX's explicit
    casts, not autocast's per-op policy)."""
    if dtype == torch.float32:
        return module(x)
    return functional_call(module, _low_precision_params(module, dtype),
                           (x.to(dtype),)).to(torch.float32)


@torch.no_grad()
def _extract(respond_net: RespondLayer, encoder: PatchEncoder,
             pts: torch.Tensor, mask: torch.Tensor, cfg: PipelineConfig,
             with_refine: bool):
    """Shared front-end body: padded scan -> keypoints + descriptors, and
    (``with_refine``) the refinement features from the same projection,
    respond map and NMS run (``caelo_tpu/frontend/registration.py:55-109``).
    """
    if (encoder.activation, encoder.code_activation) != (
            cfg.encoder_activation, cfg.encoder_code_activation):
        raise ValueError("encoder activations differ from the config's")
    # any compute_dtype but "bfloat16" is float32, as in the JAX version
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    with span("caelo.frontend.extract"):
        with span("caelo.frontend.project"):
            image, counter = project_to_spherical_ring(pts, mask, cfg.sensor)
            net_in = model_input(image, cfg.sensor).permute(2, 0, 1)[None]
        # (8, H, W) NCHW planes, float32 whatever the net ran in: K1 reads
        # them
        with span("caelo.frontend.respond"):
            planes = run_in(respond_net, net_in, dtype)[0]
        with span("caelo.frontend.select"):
            key_pts, key_pixels, key_mask, saliency = select_keypoints_planes(
                image, counter, planes, cfg.sensor, cfg.keypoint)
        ref_feats = None
        if with_refine:
            ref_feats = refinement_features(pts, mask, image, counter,
                                            key_pixels, key_mask, saliency,
                                            cfg)
        descriptors = describe_keypoints(encoder, pts, mask, key_pts,
                                         key_mask, cfg, dtype)
        return (FrameFeatures(key_pts, descriptors, key_mask, key_pixels),
                ref_feats)


def describe_keypoints(encoder: PatchEncoder, pts: torch.Tensor,
                       mask: torch.Tensor, key_pts: torch.Tensor,
                       key_mask: torch.Tensor, cfg: PipelineConfig,
                       dtype: torch.dtype = torch.float32):
    """The 3-scale patch descriptors ``(K, 3 * code_dim)`` float32 of
    ``key_pts`` in the padded scan: voxel pyramid, patches (K2 at each
    bit-table scale), encoder in ``dtype``; zero where ``key_mask`` is
    false."""
    with span("caelo.frontend.voxelize"):
        pyramid = voxelize(pts[:, :3], mask, cfg.voxel)
    with span("caelo.frontend.patch_query"):
        patches = extract_patches(key_pts, key_mask, pyramid, cfg.voxel)
    # one encoder pass over all 3 scales stacked on the batch axis, in
    # chunks of encoder_chunk patches to bound the conv activations
    K = patches[0].shape[0]
    with span("caelo.frontend.encode"):
        stacked = torch.cat(patches, 0)
        ck = cfg.encoder_chunk
        if ck and stacked.shape[0] > ck and stacked.shape[0] % ck == 0:
            codes = torch.cat([run_in(encoder, c, dtype)
                               for c in stacked.split(ck)])
        else:
            codes = run_in(encoder, stacked, dtype)
    descriptors = torch.cat([codes[i * K:(i + 1) * K]
                             for i in range(len(patches))], -1)
    return torch.where(key_mask[:, None], descriptors, 0.0)


def extract_frame_features(respond_net: RespondLayer, encoder: PatchEncoder,
                           pts: torch.Tensor, mask: torch.Tensor,
                           cfg: PipelineConfig = PipelineConfig()
                           ) -> FrameFeatures:
    """Full per-frame front end: padded scan ``(N, 4)`` + mask ``(N,)`` ->
    keypoints + descriptors, on the device of ``pts``.

    ``encoder`` must carry ``cfg``'s activation names.  With
    ``cfg.compute_dtype="bfloat16"`` both networks run in bfloat16 on
    copies of their parameters (the modules are not changed) and the
    features stay float32.  On a card, call ``caelo_tpu_torch.setup_device``
    first so the float32 convs run in full float32, not TF32
    (``run_odometry_windowed`` does).
    """
    return _extract(respond_net, encoder, pts, mask, cfg, False)[0]


def extract_frame_features_full(respond_net: RespondLayer,
                                encoder: PatchEncoder, pts: torch.Tensor,
                                mask: torch.Tensor,
                                cfg: PipelineConfig = PipelineConfig()):
    """``extract_frame_features`` and the frame's ``RefinementFeatures``
    from one projection / respond / NMS pass: returns ``(FrameFeatures,
    RefinementFeatures)``."""
    return _extract(respond_net, encoder, pts, mask, cfg, True)


@torch.no_grad()
def _register(f0: FrameFeatures, f1: FrameFeatures, cfg: PipelineConfig,
              prior_R=None, prior_t=None, gate_m: float = 0.0,
              generator=None, samples=None) -> PairRegistration:
    with span("caelo.register.pair"):
        with span("caelo.register.match"):
            pair_idx, pair_mask, pair_dist = match_descriptors(
                f0.descriptors, f0.mask, f1.descriptors, f1.mask,
                pts0=f0.key_pts, pts1=f1.key_pts,
                prior_R=prior_R, prior_t=prior_t, gate_m=gate_m,
                ratio=cfg.match_ratio)
        pairs0 = f0.key_pts.gather(
            -2, pair_idx[..., None].expand(*pair_idx.shape, 3))
        res: RansacResult = ransac_rigid(
            pairs0, f1.key_pts, pair_mask, cfg.ransac, pair_dist=pair_dist,
            generator=generator, samples=samples)
        idx1 = torch.arange(pair_idx.shape[-1], device=pair_idx.device)
        return PairRegistration(
            R=res.R, t=res.t, success=res.success,
            inlier_idx0=pair_idx, inlier_idx1=idx1.expand_as(pair_idx),
            inlier_mask=res.inlier_mask, n_inliers=res.n_inliers,
            threshold=res.threshold)


def register_pair(f0: FrameFeatures, f1: FrameFeatures,
                  cfg: PipelineConfig = PipelineConfig(),
                  generator: torch.Generator | None = None,
                  samples: torch.Tensor | None = None) -> PairRegistration:
    """Rigid transform mapping frame-1 points into frame 0, for one pair or
    a batch of pairs (leading axes of the features).  ``samples`` (``(...,
    H, S)``) replaces the RANSAC draw (see ``ransac_rigid``)."""
    return _register(f0, f1, cfg, generator=generator, samples=samples)


def register_pair_with_prior(f0: FrameFeatures, f1: FrameFeatures,
                             prior_R: torch.Tensor, prior_t: torch.Tensor,
                             cfg: PipelineConfig = PipelineConfig(),
                             gate_m: float | None = None,
                             generator: torch.Generator | None = None,
                             samples: torch.Tensor | None = None
                             ) -> PairRegistration:
    """``register_pair`` with a constant-velocity motion prior: candidate
    matches are gated to ``cfg.prior_gate_m`` metres (or ``gate_m``) around
    the prior-predicted keypoint positions."""
    return _register(f0, f1, cfg, prior_R=prior_R, prior_t=prior_t,
                     gate_m=cfg.prior_gate_m if gate_m is None else gate_m,
                     generator=generator, samples=samples)
