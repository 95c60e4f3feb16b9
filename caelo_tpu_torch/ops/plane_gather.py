"""K2: the bit-table plane gather that writes the finished patch (port of
``caelo_tpu/ops/pallas_patches.py`` and of the patch tail after it in
``caelo_tpu/voxel/grid.py::_patches_one_scale_bitgrid``).

``patches_from_planes`` launches the CUDA kernel ``csrc/plane_gather.cu`` on
CUDA tensors: one launch per scale from the word table, each keypoint's
covering-supercell slots and its window offset to the ``(K, 16, 16, 16)``
float32 occupancy patch.  On CPU tensors it takes its plain version,
``patches_from_planes_plain``: the gather ``gather_planes_plain``
(``table2[slot]``, the TPU kernel's function) and then the z-combine, the x
and y alignment and the bit unpack of ``caelo_tpu/voxel/grid.py:512-530``.
"""
from __future__ import annotations

import torch

from .. import _build


def gather_planes_plain(table2: torch.Tensor, slot: torch.Tensor):
    """``table2 (S+1, P, P)``, ``slot (K, 2, 2, 2)`` -> ``(K, 2, 2, 2, P, P)``.

    Slots are clamped into ``[0, S]`` as JAX's gather clamps them."""
    return table2[slot.clamp(0, table2.shape[0] - 1).long()]


def patches_from_planes_plain(table2: torch.Tensor, slot: torch.Tensor,
                              o: torch.Tensor) -> torch.Tensor:
    """``(K, P, P, P)`` float32 occupancy patches from the word table
    ``table2 (S+1, P, P)``, the covering slots ``slot (K, 2, 2, 2)`` and the
    window offsets ``o (K, 3)`` (``o = (kv - R) & (P - 1)``).

    Patch ``[k, a, b, c]`` is z-bit ``c`` of column ``(o_x + a, o_y + b)``
    of the 2x2 x/y supercells, its 16-bit z-window taken from the two
    z-adjacent planes at offset ``o_z``."""
    K = slot.shape[0]
    P = table2.shape[-1]
    planes = gather_planes_plain(table2, slot)        # (K, 2,2,2, P, P)
    # z: combine the two z-adjacent planes into 16-bit windows per column
    shift = o[:, 2][:, None, None, None, None]
    wA, wB = planes[:, :, :, 0], planes[:, :, :, 1]   # (K, 2, 2, P, P)
    win = ((wA >> shift) | torch.where(shift > 0, wB << (P - shift), 0)
           ) & ((1 << P) - 1)
    ar = torch.arange(P, device=table2.device)
    # x: concatenate the two x-supercells and take the window's 16 rows
    winx = torch.cat([win[:, 0], win[:, 1]], 2)       # (K, 2, 2P, P)
    ix = (o[:, 0, None] + ar).long()                  # (K, P)
    winx = winx.gather(2, ix[:, None, :, None].expand(K, 2, P, P))
    # y: the same along the ly axis
    winy = torch.cat([winx[:, 0], winx[:, 1]], 2)     # (K, P, 2P)
    iy = (o[:, 1, None] + ar).long()
    winy = winy.gather(2, iy[:, None, :].expand(K, P, P))
    return ((winy[..., None] >> ar.to(torch.int32)) & 1).to(torch.float32)


def patches_from_planes(table2: torch.Tensor, slot: torch.Tensor,
                        o: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: :func:`patches_from_planes_plain` in one kernel launch.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/plane_gather.cu`` on the current stream (one block per keypoint)
    or raises.  The kernel takes 16 x 16 planes only.
    """
    if (table2.dim() != 3 or slot.dim() != 4 or slot.shape[1:] != (2, 2, 2)
            or o.shape != (slot.shape[0], 3)):
        raise ValueError(f"table2 {tuple(table2.shape)} / slot "
                         f"{tuple(slot.shape)} / o {tuple(o.shape)}: want "
                         "(S+1,P,P), (K,2,2,2) and (K,3)")
    if (table2.dtype != torch.int32 or slot.dtype != torch.int32
            or o.dtype != torch.int32):
        raise TypeError(f"table2, slot and o must be int32, got "
                        f"{table2.dtype}, {slot.dtype} and {o.dtype}")
    if not (slot.device == o.device == table2.device):
        raise ValueError(f"table2 on {table2.device}, slot on {slot.device}, "
                         f"o on {o.device}")
    if table2.device.type == "cpu":
        return patches_from_planes_plain(table2, slot, o)
    if table2.device.type != "cuda":
        raise ValueError(f"no plane-gather kernel for device {table2.device}")
    if table2.shape[1:] != (16, 16):
        raise ValueError(f"the kernel takes 16 x 16 planes, got "
                         f"{tuple(table2.shape[1:])}")
    if not (table2.is_contiguous() and slot.is_contiguous()
            and o.is_contiguous()):
        raise ValueError("table2, slot and o must be contiguous")
    if table2.data_ptr() % 16:
        raise ValueError("table2 must be 16-byte aligned")
    K = slot.shape[0]
    out = torch.empty((K, 16, 16, 16), dtype=torch.float32,
                      device=table2.device)
    if K == 0:
        return out
    _build.check(_build.kernel("caelo_patches_from_planes")(
        table2.data_ptr(), slot.data_ptr(), o.data_ptr(), out.data_ptr(), K,
        table2.shape[0] - 1, _build.stream(table2.device)),
        "plane-gather kernel")
    patches_from_planes.launches += 1
    return out


patches_from_planes.launches = 0
