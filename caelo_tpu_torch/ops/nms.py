"""Keypoint saliency + NMS over the respond image (port of
``caelo_tpu/ops/nms.py::select_keypoints``).

For each pixel the minimum L2 respond difference to its occupied 5x5
neighbours; gates: pixel occupied, >=5 occupied neighbours, min-diff > 0.2,
range >= 10 m, edge crop, and the ground-speckle z-extent gate (all one
launch of kernel K1, ``ops/saliency.py::keypoint_score``); then the top-k
by saliency.

Deviation from the reference kept from the JAX package: the reference's
final slice of its ascending argsort drops the single strongest keypoint;
this keeps the true top-k.
"""
from __future__ import annotations

import torch

from ..config import KeypointConfig, SensorConfig
from .saliency import RADIUS, keypoint_score, keypoint_score_plain


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k``: the ``k`` largest entries along the last axis and
    their indices, value descending and the lower index first among equal
    values (``torch.topk`` promises neither which tied entries it keeps
    nor their order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(image: torch.Tensor, counter: torch.Tensor,
                     respond: torch.Tensor,
                     sensor: SensorConfig = SensorConfig(),
                     kp: KeypointConfig = KeypointConfig()):
    """Select the top-k salient keypoints from a respond image.

    Args:
      image: ``(ImgH, ImgW, 5)`` spherical-ring image (for 3D points/range).
      counter: ``(ImgH, ImgW)`` occupancy counter.
      respond: ``(n_lines, model_w, C)`` respond-layer feature map (the JAX
        layout; :func:`select_keypoints_planes` takes ``(C, H, W)``).

    Returns ``(key_pts (K, 3), key_pixels (K, 2) int32, key_mask (K,),
    saliency (H, W))``.
    """
    return select_keypoints_planes(
        image, counter, respond.permute(2, 0, 1).contiguous(), sensor, kp)


def select_keypoints_planes(image: torch.Tensor, counter: torch.Tensor,
                            planes: torch.Tensor,
                            sensor: SensorConfig = SensorConfig(),
                            kp: KeypointConfig = KeypointConfig()):
    """:func:`select_keypoints` on respond planes ``(C, H, W)``, the layout
    the respond conv produces and the saliency kernel reads."""
    C, H, W = planes.shape
    if kp.window // 2 == RADIUS and kp.use_pallas_nms:
        score, saliency = keypoint_score(planes, image, counter, sensor,
                                         kp)[:2]       # K1 (CPU: plain)
    else:
        score, saliency = keypoint_score_plain(planes, image, counter,
                                               sensor, kp)[:2]
    # exact ties are common -- two pixels that are each other's nearest
    # respond neighbour share one min_d2 -- and the order is what the
    # RANSAC sample indices refer to
    vals, idx = top_k(score.reshape(-1), kp.n_keypoints)
    key_mask = torch.isfinite(vals)
    r, c = idx // W, idx % W
    key_pixels = torch.stack([r, c], -1).to(torch.int32)
    key_pts = torch.where(key_mask[:, None], image[r, c, 0:3], 0.0)
    return key_pts, key_pixels, key_mask, saliency
