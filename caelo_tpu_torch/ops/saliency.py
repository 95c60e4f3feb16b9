"""K1: keypoint saliency and gates in one pass (port of
``caelo_tpu/ops/pallas_nms.py`` and of the gate code around it in
``caelo_tpu/ops/nms.py::select_keypoints``).

``keypoint_score`` launches the CUDA kernel ``csrc/saliency.cu`` on CUDA
tensors: from the respond planes, the ring image and the occupancy counter
straight to each pixel's keypoint score, everything ``select_keypoints``
computes before its top-k.  ``saliency_map`` runs the same kernel for the
TPU kernel's own function (``min_d2``, ``n_occ``).  On CPU tensors both take
their plain versions, ``keypoint_score_plain`` and ``saliency_map_plain``
(the shifted-slice loops of ``caelo_tpu/ops/nms.py:60-130``).  Planes come
as ``(C, H, W)`` (or ``(B, C, H, W)``), the layout the respond conv
produces.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import _build
from ..config import KeypointConfig, SensorConfig

RADIUS = 2
CHANNELS = 8        # the only channel count the CUDA kernel instantiates
_INF = float("inf")
_NULL = None        # a null pointer for ctypes


class KeypointScore(NamedTuple):
    """Per-pixel maps ``(..., H, W)``: ``score`` (saliency where every gate
    passes, else ``-inf``) and ``saliency``; with ``extras``, also
    ``min_d2``, ``n_occ`` (int32) and ``zext`` (the 5x5 z-extent)."""

    score: torch.Tensor
    saliency: torch.Tensor
    min_d2: Optional[torch.Tensor] = None
    n_occ: Optional[torch.Tensor] = None
    zext: Optional[torch.Tensor] = None


def saliency_map_plain(planes: torch.Tensor, occ: torch.Tensor,
                       radius: int = RADIUS):
    """Min squared respond difference to the occupied neighbours of the
    ``(2 radius + 1)^2`` window, and the occupied-neighbour count.

    Args:
      planes: ``(..., C, H, W)`` float32 respond planes.
      occ: ``(..., H, W)`` bool occupancy.

    Returns ``(min_d2, n_occ)``, ``(..., H, W)`` float32 (``inf`` where no
    neighbour is occupied) and int32.
    """
    H, W = planes.shape[-2:]
    r = radius
    fpad = F.pad(planes, (r, r, r, r))
    opad = F.pad(occ.to(torch.uint8), (r, r, r, r)).bool()
    min_d2 = torch.full(occ.shape, _INF, dtype=torch.float32,
                        device=planes.device)
    n_occ = torch.zeros(occ.shape, dtype=torch.int32, device=planes.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            nf = fpad[..., r + dy:r + dy + H, r + dx:r + dx + W]
            nocc = opad[..., r + dy:r + dy + H, r + dx:r + dx + W]
            d2 = ((nf - planes) ** 2).sum(dim=-3)
            min_d2 = torch.minimum(
                min_d2, torch.where(nocc, d2, _INF))
            n_occ += nocc
    return min_d2, n_occ


def window_z_extent(z: torch.Tensor, occ: torch.Tensor, rad: int):
    """max - min of z over the occupied pixels of each (2 rad + 1)^2 window
    (centre included); 0 where the window holds no occupied pixel."""
    H, W = z.shape[-2:]
    zpad = F.pad(z, (rad, rad, rad, rad))
    opad = F.pad(occ.to(torch.uint8), (rad, rad, rad, rad)).bool()
    zmin = torch.full(z.shape, _INF, dtype=torch.float32, device=z.device)
    zmax = torch.full(z.shape, -_INF, dtype=torch.float32, device=z.device)
    for dy in range(2 * rad + 1):
        for dx in range(2 * rad + 1):
            nz = zpad[..., dy:dy + H, dx:dx + W]
            no = opad[..., dy:dy + H, dx:dx + W]
            zmin = torch.minimum(zmin, torch.where(no, nz, _INF))
            zmax = torch.maximum(zmax, torch.where(no, nz, -_INF))
    return torch.where(torch.isfinite(zmin) & torch.isfinite(zmax),
                       zmax - zmin, 0.0)


def keypoint_score_plain(planes: torch.Tensor, image: torch.Tensor,
                         counter: torch.Tensor,
                         sensor: SensorConfig = SensorConfig(),
                         kp: KeypointConfig = KeypointConfig(),
                         extras: bool = False) -> KeypointScore:
    """Each pixel's keypoint score: saliency where it passes the gates
    (occupied, ``>= min_neighbors`` occupied neighbours, saliency above
    ``norm_diff_threshold``, range ``>= visible_bottom``, inside the edge
    crop, a finite ``min_d2``, and the ground-speckle z-extent gate), else
    ``-inf``.

    Args:
      planes: ``(..., C, H, W)`` respond planes.
      image: ``(..., ImgH, ImgW, 5)`` spherical-ring image (z, range).
      counter: ``(..., ImgH, ImgW)`` occupancy counter.
    """
    H, W = planes.shape[-2:]
    occ = counter[..., :H, :W] > 0
    rad = kp.window // 2
    min_d2, n_occ = saliency_map_plain(planes, occ, rad)

    finite = torch.isfinite(min_d2)
    saliency = torch.sqrt(torch.where(finite, min_d2, 0.0))

    rng = image[..., :H, :W, 4]
    e = sensor.edge_filter
    rows = torch.arange(H, device=planes.device)[:, None]
    cols = torch.arange(W, device=planes.device)[None, :]
    in_crop = ((rows >= e) & (rows < sensor.n_lines - e)
               & (cols >= e) & (cols < sensor.model_w - e))
    good = (occ & (n_occ >= kp.min_neighbors)
            & (saliency > kp.norm_diff_threshold)
            & (rng >= sensor.visible_bottom) & in_crop & finite)

    ground_gate = kp.ground_z_max > -100.0
    zext = None
    if ground_gate or extras:
        z = image[..., :H, :W, 2]
        zext = window_z_extent(z * occ.to(z.dtype), occ, rad)
    if ground_gate:
        # ground-speckle suppression (caelo_tpu/ops/nms.py:96-130): a
        # candidate below ground_z_max is kept only if its window has real
        # vertical structure
        low = z < kp.ground_z_max
        good = good & (~low | (zext > kp.ground_extent_m))

    score = torch.where(good, saliency, -_INF)
    if extras:
        return KeypointScore(score, saliency, min_d2, n_occ, zext)
    return KeypointScore(score, saliency)


def _check_planes(planes: torch.Tensor):
    if planes.dim() not in (3, 4):
        raise ValueError(f"planes {tuple(planes.shape)}: want (B,)C,H,W")
    if planes.dtype != torch.float32:
        raise TypeError(f"planes must be float32, got {planes.dtype}")
    if planes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no saliency kernel for device {planes.device}")


def _check_kernel_input(planes: torch.Tensor, *others):
    if planes.shape[-3] != CHANNELS:
        raise ValueError(f"the kernel takes {CHANNELS} channels, got "
                         f"{planes.shape[-3]}")
    if not planes.is_contiguous():
        raise ValueError("planes must be contiguous")
    dev = planes.device
    for t in others:
        if t.device != dev:
            raise ValueError(f"planes on {dev}, an input on {t.device}")


def keypoint_score(planes: torch.Tensor, image: torch.Tensor,
                   counter: torch.Tensor,
                   sensor: SensorConfig = SensorConfig(),
                   kp: KeypointConfig = KeypointConfig(),
                   extras: bool = False) -> KeypointScore:
    """K1 wrapper: :func:`keypoint_score_plain` in one kernel launch.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/saliency.cu`` on the current stream (one launch for all frames of
    a ``(B, C, H, W)`` batch) or raises.  The kernel takes the 5x5 window
    only (``kp.window == 5``).  The per-call host work is kept to the
    checks, one allocation for every output map and one ctypes call: at one
    frame per call it, not the kernel, sets the call's rate.
    """
    _check_planes(planes)
    batched = planes.dim() == 4
    if (image.dim() != planes.dim() or counter.dim() != planes.dim() - 1
            or image.shape[-1] != 5):
        raise ValueError(f"image {tuple(image.shape)} / counter "
                         f"{tuple(counter.shape)} do not go with planes "
                         f"{tuple(planes.shape)}")
    if planes.device.type == "cpu":
        return keypoint_score_plain(planes, image, counter, sensor, kp,
                                    extras)
    _check_kernel_input(planes, image, counter)
    if kp.window != 2 * RADIUS + 1:
        raise ValueError(f"the kernel takes a {2 * RADIUS + 1}x"
                         f"{2 * RADIUS + 1} window, got {kp.window}")
    if image.dtype != torch.float32 or counter.dtype != torch.int32:
        raise TypeError(f"image must be float32 and counter int32, got "
                        f"{image.dtype} and {counter.dtype}")
    istr, cstr = image.stride(), counter.stride()
    if istr[-1] != 1 or cstr[-1] != 1:
        raise ValueError("image channels and counter rows must be dense")
    H, W = planes.shape[-2:]
    if image.shape[-3] < H or image.shape[-2] < W or (
            counter.shape[-2] < H or counter.shape[-1] < W):
        raise ValueError("image and counter must cover the respond planes")
    # one allocation for every map, viewed as the maps
    out = torch.empty((5 if extras else 2,) + planes.shape[:-3] + (H, W),
                      dtype=torch.float32, device=planes.device)
    maps = list(out.unbind(0))
    if extras:
        maps[3] = maps[3].view(torch.int32)
    ptr = [m.data_ptr() for m in maps] + [_NULL] * (5 - len(maps))
    img = image.data_ptr()         # z and range: float32 channels 2 and 4
    e = sensor.edge_filter
    _build.check(_build.kernel("caelo_keypoint_score")(
        planes.data_ptr(), counter.data_ptr(), 1, cstr[0] if batched else 0,
        cstr[-2], img + 8, img + 16, istr[0] if batched else 0, istr[-3],
        istr[-2], ptr[0], ptr[1], ptr[2], ptr[3], ptr[4],
        planes.shape[0] if batched else 1, CHANNELS, H, W,
        e, sensor.n_lines - e, e, sensor.model_w - e, kp.min_neighbors,
        kp.norm_diff_threshold, sensor.visible_bottom,
        int(kp.ground_z_max > -100.0), kp.ground_z_max, kp.ground_extent_m,
        _build.stream(planes.device)), "keypoint-score kernel")
    keypoint_score.launches += 1
    return KeypointScore(*maps)


def keypoint_score_bytes(planes: torch.Tensor) -> int:
    """The bytes :func:`keypoint_score` must move on ``planes`` (``(C, H,
    W)`` or ``(B, C, H, W)``), each once: the float32 planes and, per pixel,
    the int32 counter and the z and range channels read, score and
    saliency written."""
    n_pix = planes.numel() // planes.shape[-3]
    return planes.numel() * 4 + n_pix * (4 + 8 + 8)


def saliency_map(planes: torch.Tensor, occ: torch.Tensor):
    """K1's own function, :func:`saliency_map_plain` at the 5x5 window:
    ``(min_d2, n_occ)``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    of :func:`keypoint_score` without the image (no gates, no score) or
    raises.
    """
    _check_planes(planes)
    if occ.shape != planes.shape[:-3] + planes.shape[-2:]:
        raise ValueError(f"occ {tuple(occ.shape)} does not match planes "
                         f"{tuple(planes.shape)}")
    if occ.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"occ must be bool or uint8, got {occ.dtype}")
    if planes.device.type == "cpu":
        return saliency_map_plain(planes, occ.bool())
    _check_kernel_input(planes, occ)
    if not occ.is_contiguous():
        raise ValueError("occ must be contiguous")
    H, W = planes.shape[-2:]
    B = planes.shape[0] if planes.dim() == 4 else 1
    out = torch.empty((2,) + occ.shape, dtype=torch.float32,
                      device=planes.device)
    min_d2, n_occ = out[0], out[1].view(torch.int32)
    _build.check(_build.kernel("caelo_keypoint_score")(
        planes.data_ptr(), occ.data_ptr(), 0, H * W, W,
        _NULL, _NULL, 0, 0, 0,
        _NULL, _NULL, min_d2.data_ptr(), n_occ.data_ptr(), _NULL,
        B, CHANNELS, H, W, 0, 0, 0, 0, 0, 0.0, 0.0, 0, 0.0, 0.0,
        _build.stream(planes.device)), "saliency kernel")
    saliency_map.launches += 1
    return min_d2, n_occ


keypoint_score.launches = 0
saliency_map.launches = 0
