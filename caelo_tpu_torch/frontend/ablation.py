"""Keypoint-source ablation: any detector x the CAE-LO descriptor (port of
``caelo_tpu/frontend/ablation.py``).

The reference's evaluation matrix crosses keypoint sources (CAE-LO /
3DFeatNet / USIP / ISS / Harris / SIFT / random) with descriptor sources
(``PoseEstimation.py:30-39,187-189``; ``EvalOnReg_KeyPts.py``).  This module
builds ``FrameFeatures`` from any keypoint source so the same odometry and
evaluation stack runs every combination:

* built-in detectors: ``cae-lo`` (the respond-net NMS), ``iss``,
  ``harris``, ``sift``, ``random`` (``frontend/baselines.py``);
* external keypoints (precomputed 3DFeatNet / USIP outputs) enter through
  ``features_from_keypoints``.

Descriptors are the 3-scale voxel-patch codes, the patches gathered by
kernel K2 on a CUDA device.
"""
from __future__ import annotations

from typing import Literal

import torch

from ..config import PipelineConfig
from ..models.patch_encoder import PatchEncoder
from ..utils.telemetry import span
from .baselines import (harris3d_keypoints, iss_keypoints, random_keypoints,
                        sift3d_keypoints)
from .registration import (FrameFeatures, describe_keypoints,
                           extract_frame_features)

KeypointSource = Literal["cae-lo", "iss", "harris", "sift", "random"]
_DETECTORS = {"iss": iss_keypoints, "harris": harris3d_keypoints,
              "sift": sift3d_keypoints}


@torch.no_grad()
def features_from_keypoints(encoder: PatchEncoder, pts: torch.Tensor,
                            mask: torch.Tensor, key_pts: torch.Tensor,
                            key_mask: torch.Tensor,
                            cfg: PipelineConfig = PipelineConfig()
                            ) -> FrameFeatures:
    """Describe an externally chosen keypoint set ``key_pts (K, 3)`` in the
    padded scan ``pts (N, >=3)`` with the CAE-LO encoder; ``key_pixels``
    are zeros."""
    if (encoder.activation, encoder.code_activation) != (
            cfg.encoder_activation, cfg.encoder_code_activation):
        raise ValueError("encoder activations differ from the config's")
    descriptors = describe_keypoints(encoder, pts, mask, key_pts, key_mask,
                                     cfg)
    return FrameFeatures(
        key_pts=key_pts, descriptors=descriptors, mask=key_mask,
        key_pixels=torch.zeros((key_pts.shape[0], 2), dtype=torch.int32,
                               device=key_pts.device))


def make_ablation_feature_fn(source: KeypointSource, respond_net, encoder,
                             cfg: PipelineConfig = PipelineConfig(),
                             seed: int = 0):
    """A ``feature_fn(pts, mask) -> FrameFeatures`` for ``run_odometry``
    with the chosen keypoint detector, on the device of ``encoder``.

    ``random`` draws from a generator seeded with ``seed`` anew on every
    call, so every frame gets the same draw, as the JAX version (one key,
    made once) gives it."""
    device = next(encoder.parameters()).device
    on = lambda a: torch.as_tensor(a).to(device)
    if source == "cae-lo":
        return lambda pts, mask: extract_frame_features(
            respond_net, encoder, on(pts), on(mask), cfg)
    if source not in _DETECTORS and source != "random":
        raise ValueError(source)
    n_kp = cfg.keypoint.n_keypoints

    def fn(pts, mask):
        with span("caelo.frontend.extract"):
            pts, mask = on(pts), on(mask)
            xyz = pts[:, :3].contiguous()
            with span("caelo.frontend.detect"):
                if source == "random":
                    res = random_keypoints(
                        torch.Generator(device).manual_seed(seed), xyz, mask,
                        n_keypoints=n_kp)
                else:
                    res = _DETECTORS[source](xyz, mask, n_keypoints=n_kp)
            return features_from_keypoints(encoder, pts, mask, res.key_pts,
                                           res.key_mask, cfg)

    return fn
