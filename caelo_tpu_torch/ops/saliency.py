"""K1: the keypoint-saliency stencil (port of ``caelo_tpu/ops/pallas_nms.py``).

``saliency_map`` launches the CUDA kernel ``csrc/saliency.cu`` on a CUDA
tensor and runs ``saliency_map_plain`` -- the shifted-slice loop of
``caelo_tpu/ops/nms.py:60-75`` -- only on a CPU tensor.  Both take the
respond map as channel planes ``(C, H, W)`` (or ``(B, C, H, W)``), the
layout the respond conv already produces.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

RADIUS = 2
CHANNELS = 8        # the only channel count the CUDA kernel instantiates


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
    min_d2 = torch.full(occ.shape, float("inf"), dtype=torch.float32,
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
                min_d2, torch.where(nocc, d2, float("inf")))
            n_occ += nocc
    return min_d2, n_occ


def saliency_map(planes: torch.Tensor, occ: torch.Tensor):
    """K1 wrapper: the 5x5 saliency stencil of :func:`saliency_map_plain`.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/saliency.cu`` on the current stream (one launch for all frames of
    a ``(B, C, H, W)`` batch) or raises.
    """
    if planes.dim() not in (3, 4) or occ.dim() != planes.dim() - 1:
        raise ValueError(f"planes {tuple(planes.shape)} / occ "
                         f"{tuple(occ.shape)}: want (B,)C,H,W and (B,)H,W")
    if occ.shape != planes.shape[:-3] + planes.shape[-2:]:
        raise ValueError(f"occ {tuple(occ.shape)} does not match planes "
                         f"{tuple(planes.shape)}")
    if planes.dtype != torch.float32:
        raise TypeError(f"planes must be float32, got {planes.dtype}")
    if occ.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"occ must be bool or uint8, got {occ.dtype}")
    if occ.device != planes.device:
        raise ValueError(f"planes on {planes.device}, occ on {occ.device}")
    if planes.device.type == "cpu":
        return saliency_map_plain(planes, occ.bool())
    if planes.device.type != "cuda":
        raise ValueError(f"no saliency kernel for device {planes.device}")
    if planes.shape[-3] != CHANNELS:
        raise ValueError(f"the kernel takes {CHANNELS} channels, got "
                         f"{planes.shape[-3]}")
    if not (planes.is_contiguous() and occ.is_contiguous()):
        raise ValueError("planes and occ must be contiguous")
    C, H, W = planes.shape[-3:]
    B = planes.shape[0] if planes.dim() == 4 else 1
    min_d2 = torch.empty(occ.shape, dtype=torch.float32, device=planes.device)
    n_occ = torch.empty(occ.shape, dtype=torch.int32, device=planes.device)
    lib = _build.load_library().lib
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    _build.check(lib.caelo_saliency_map(
        planes.data_ptr(), occ.data_ptr(), min_d2.data_ptr(),
        n_occ.data_ptr(), B, C, H, W, stream), "saliency kernel")
    saliency_map.launches += 1
    return min_d2, n_occ


saliency_map.launches = 0
