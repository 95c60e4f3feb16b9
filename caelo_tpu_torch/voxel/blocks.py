"""Block-sparse decomposition of the voxel grid, CSR-style (port of
``caelo_tpu/voxel/blocks.py``).

The reference organises scale-0 voxels into 64^3 blocks of 1.28 m over a
156 x 156 x 23 block grid, stored as ``avlBlocksList`` + ``cntVoxelsLength``
(CSR offsets) + ``AllVoxels`` (``Voxel.py:100-173``), and crops the
boundary blocks (``CropBlocks``, ``Voxel.py:41``; ``Match.py:76-96``).
The patch query does not use blocks; they are the spatial-partitioning
primitive of the map (x-slabs with a ``crop_blocks`` halo).

Every output has a fixed size plus a mask: voxels are sorted by block id
(stably, so a block's voxels keep their input order), the unique blocks
compacted and their CSR offsets found by binary search.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import VoxelConfig
from ..ops.masking import compact

_INT32_MAX = 2 ** 31 - 1


class BlockSparse(NamedTuple):
    block_ids: torch.Tensor     # (B, 3) int32 unique occupied blocks (padded)
    block_mask: torch.Tensor    # (B,) bool
    n_blocks: torch.Tensor      # () int32
    offsets: torch.Tensor       # (B + 1,) int32 CSR offsets into voxels
    voxels: torch.Tensor        # (M, 3) int32 voxel coords sorted by block
    voxel_mask: torch.Tensor    # (M,) bool


def build_blocks(vox: torch.Tensor, vox_mask: torch.Tensor,
                 cfg: VoxelConfig = VoxelConfig(),
                 max_blocks: int = 4096) -> BlockSparse:
    """Group scale-0 voxel coords into the reference's block layout.

    Args:
      vox: ``(M, 3)`` int32 scale-0 voxel coords (deduped, padded).
      vox_mask: ``(M,)`` bool validity.

    The offsets of the empty block slots point at the end of the valid
    voxels, so their runs are empty.
    """
    nb = cfg.n_blocks
    blk = vox // cfg.block_size
    key = (blk[:, 0] * nb[1] + blk[:, 1]) * nb[2] + blk[:, 2]
    key = torch.where(vox_mask, key, _INT32_MAX).to(torch.int32)
    order = torch.sort(key, stable=True).indices
    skey, svox, smask = key[order], vox[order], vox_mask[order]
    first = torch.ones_like(smask)
    first[1:] = skey[1:] != skey[:-1]
    ub_key, ub_mask, n_blocks = compact(skey, first & smask, max_blocks,
                                        fill=0)
    total = smask.sum(dtype=torch.int32)
    offsets = torch.searchsorted(skey, ub_key, side="left").to(torch.int32)
    offsets = torch.cat([torch.where(ub_mask, offsets, total), total[None]])
    block_ids = torch.stack([ub_key // (nb[1] * nb[2]),
                             (ub_key // nb[2]) % nb[1],
                             ub_key % nb[2]], 1) * ub_mask[:, None]
    return BlockSparse(block_ids=block_ids.to(torch.int32),
                       block_mask=ub_mask, n_blocks=n_blocks,
                       offsets=offsets, voxels=svox, voxel_mask=smask)


def interior_block_mask(block_ids: torch.Tensor, block_mask: torch.Tensor,
                        cfg: VoxelConfig = VoxelConfig()) -> torch.Tensor:
    """Boundary-block crop (``GetKeyVoxelsAroundKeyPts``,
    ``Match.py:94-97``): blocks within ``crop_blocks`` of the scene edge
    are excluded so every scale-2 patch window stays in bounds."""
    c = cfg.crop_blocks
    nb = torch.tensor(cfg.n_blocks, dtype=torch.int32,
                      device=block_ids.device)
    return ((block_ids >= c) & (block_ids < nb - c)).all(1) & block_mask


def partition_blocks(block_ids: torch.Tensor, block_mask: torch.Tensor,
                     n_parts: int, cfg: VoxelConfig = VoxelConfig(),
                     halo: int | None = None):
    """Spatial map partitioning: each block goes to one of ``n_parts``
    contiguous x-slabs, and blocks within ``halo`` (default
    ``crop_blocks``) of a slab's edges belong to that slab's halo too.

    Returns ``(owner, halo_mask)``: ``owner (B,)`` int32 in ``[0,
    n_parts)``, ``n_parts`` for an empty slot; ``halo_mask (B, n_parts)``
    bool, the block needed by partition p.
    """
    halo = cfg.crop_blocks if halo is None else halo
    slab = -(-cfg.n_blocks[0] // n_parts)
    x = block_ids[:, 0]
    owner = torch.clamp(x // slab, 0, n_parts - 1)
    parts = torch.arange(n_parts, device=block_ids.device)[None, :]
    halo_mask = ((x[:, None] >= parts * slab - halo)
                 & (x[:, None] < (parts + 1) * slab + halo)
                 & block_mask[:, None])
    return torch.where(block_mask, owner, n_parts).to(torch.int32), halo_mask
