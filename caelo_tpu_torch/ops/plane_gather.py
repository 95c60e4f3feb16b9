"""K2: the bit-table plane gather (port of ``caelo_tpu/ops/pallas_patches.py``).

``gather_planes`` launches the CUDA kernel ``csrc/plane_gather.cu`` on a
CUDA tensor and runs ``gather_planes_plain`` (``table2[slot]``) only on a
CPU tensor.
"""
from __future__ import annotations

import torch

from .. import _build


def gather_planes_plain(table2: torch.Tensor, slot: torch.Tensor):
    """``table2 (S+1, P, P)``, ``slot (K, 2, 2, 2)`` -> ``(K, 2, 2, 2, P, P)``.

    Slots are clamped into ``[0, S]`` as JAX's gather clamps them."""
    return table2[slot.clamp(0, table2.shape[0] - 1).long()]


def gather_planes(table2: torch.Tensor, slot: torch.Tensor):
    """K2 wrapper: ``table2[slot]`` for int32 word planes.

    A CPU tensor takes :func:`gather_planes_plain`; a CUDA tensor launches
    ``csrc/plane_gather.cu`` on the current stream (one coalesced 1 KB copy
    per (keypoint, covering cell)) or raises.
    """
    if table2.dim() != 3 or slot.dim() != 4 or slot.shape[1:] != (2, 2, 2):
        raise ValueError(f"table2 {tuple(table2.shape)} / slot "
                         f"{tuple(slot.shape)}: want (S+1,P,P) and (K,2,2,2)")
    if table2.dtype != torch.int32 or slot.dtype != torch.int32:
        raise TypeError(f"table2 and slot must be int32, got {table2.dtype} "
                        f"and {slot.dtype}")
    if slot.device != table2.device:
        raise ValueError(f"table2 on {table2.device}, slot on {slot.device}")
    if table2.device.type == "cpu":
        return gather_planes_plain(table2, slot)
    if table2.device.type != "cuda":
        raise ValueError(f"no plane-gather kernel for device {table2.device}")
    words = table2.shape[1] * table2.shape[2]
    if words % 4:
        raise ValueError(f"a plane of {words} words is not a whole number of "
                         "16-byte vectors")
    if not (table2.is_contiguous() and slot.is_contiguous()):
        raise ValueError("table2 and slot must be contiguous")
    if table2.data_ptr() % 16:
        raise ValueError("table2 must be 16-byte aligned")
    out = torch.empty(slot.shape + table2.shape[1:], dtype=torch.int32,
                      device=table2.device)
    lib = _build.load_library().lib
    stream = torch.cuda.current_stream(table2.device).cuda_stream
    _build.check(lib.caelo_gather_planes(
        table2.data_ptr(), slot.data_ptr(), out.data_ptr(), slot.numel(),
        table2.shape[0] - 1, words, stream), "plane-gather kernel")
    gather_planes.launches += 1
    return out


gather_planes.launches = 0
