"""Keypoint saliency + NMS over the respond image (port of
``caelo_tpu/ops/nms.py::select_keypoints``).

For each pixel the minimum L2 respond difference to its occupied 5x5
neighbours (kernel K1, ``ops/saliency.py``); gates: pixel occupied, >=5
occupied neighbours, min-diff > 0.2, range >= 10 m, edge crop, and the
ground-speckle z-extent gate; then the top-k by saliency.

Deviation from the reference kept from the JAX package: the reference's
final slice of its ascending argsort drops the single strongest keypoint;
this keeps the true top-k.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import KeypointConfig, SensorConfig
from .saliency import RADIUS, saliency_map, saliency_map_plain

_INF = float("inf")


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


def _window_z_extent(z: torch.Tensor, occ: torch.Tensor, rad: int):
    """max - min of z over the occupied pixels of each (2 rad + 1)^2 window
    (centre included); 0 where the window holds no occupied pixel."""
    H, W = z.shape
    zpad = F.pad(z, (rad, rad, rad, rad))
    opad = F.pad(occ.to(torch.uint8), (rad, rad, rad, rad)).bool()
    zmin = torch.full((H, W), _INF, dtype=torch.float32, device=z.device)
    zmax = torch.full((H, W), -_INF, dtype=torch.float32, device=z.device)
    for dy in range(2 * rad + 1):
        for dx in range(2 * rad + 1):
            nz = zpad[dy:dy + H, dx:dx + W]
            no = opad[dy:dy + H, dx:dx + W]
            zmin = torch.minimum(zmin, torch.where(no, nz, _INF))
            zmax = torch.maximum(zmax, torch.where(no, nz, -_INF))
    return torch.where(torch.isfinite(zmin) & torch.isfinite(zmax),
                       zmax - zmin, 0.0)


def select_keypoints_planes(image: torch.Tensor, counter: torch.Tensor,
                            planes: torch.Tensor,
                            sensor: SensorConfig = SensorConfig(),
                            kp: KeypointConfig = KeypointConfig()):
    """:func:`select_keypoints` on respond planes ``(C, H, W)``, the layout
    the respond conv produces and the saliency kernel reads."""
    C, H, W = planes.shape
    occ = counter[:H, :W] > 0
    rad = kp.window // 2
    if rad == RADIUS and kp.use_pallas_nms:
        min_d2, n_occ = saliency_map(planes, occ)      # K1 (CPU: plain)
    else:
        min_d2, n_occ = saliency_map_plain(planes, occ, rad)

    finite = torch.isfinite(min_d2)
    saliency = torch.sqrt(torch.where(finite, min_d2, 0.0))

    rng = image[:H, :W, 4]
    e = sensor.edge_filter
    rows = torch.arange(H, device=planes.device)[:, None]
    cols = torch.arange(W, device=planes.device)[None, :]
    in_crop = ((rows >= e) & (rows < sensor.n_lines - e)
               & (cols >= e) & (cols < sensor.model_w - e))
    good = (occ & (n_occ >= kp.min_neighbors)
            & (saliency > kp.norm_diff_threshold)
            & (rng >= sensor.visible_bottom) & in_crop & finite)

    if kp.ground_z_max > -100.0:
        # ground-speckle suppression (caelo_tpu/ops/nms.py:96-130): a
        # candidate below ground_z_max is kept only if its window has real
        # vertical structure
        z = image[:H, :W, 2]
        zext = _window_z_extent(z * occ.to(z.dtype), occ, rad)
        low = z < kp.ground_z_max
        good = good & (~low | (zext > kp.ground_extent_m))

    score = torch.where(good, saliency, -_INF).reshape(-1)
    # exact ties are common -- two pixels that are each other's nearest
    # respond neighbour share one min_d2 -- and the order is what the
    # RANSAC sample indices refer to
    vals, idx = top_k(score, kp.n_keypoints)
    key_mask = torch.isfinite(vals)
    r, c = idx // W, idx % W
    key_pixels = torch.stack([r, c], -1).to(torch.int32)
    key_pts = torch.where(key_mask[:, None], image[r, c, 0:3], 0.0)
    return key_pts, key_pixels, key_mask, saliency
