"""Three-scale voxel pyramid and the bit-table patch query (port of
``caelo_tpu/voxel/grid.py``).

* :func:`voxelize`: per scale, one sort of a packed (16-aligned supercell
  id, 4-bit local coords) key, dedup and compaction -> padded occupied-voxel
  lists in supercell order.
* :func:`extract_patches`: per scale, a bit table of 16 z-bits per
  (supercell, x, y) column, the 2x2x2 covering supercells' table slots per
  keypoint, then the word planes gathered, aligned and unpacked into a 16^3
  patch (kernel K2, ``ops/plane_gather.py``, behind
  ``use_pallas_plane_gather``, the port's default).

Only the bit-table route is ported: the default ``bitgrid_slots`` sends all
three scales there, so the knn and window patch paths are never reached.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import VoxelConfig
from ..ops.masking import compact
from ..ops.plane_gather import (patches_from_planes,
                                patches_from_planes_plain)

_INT32_MAX = 2 ** 31 - 1
_INT64_MAX = 2 ** 63 - 1
_RANK_BLOCK = 16           # bitmap words per rank block (512 supercell ids)


class VoxelPyramid(NamedTuple):
    """Per-scale padded occupied-voxel lists (coords in voxel-index space)."""

    coords: tuple       # per scale: (M_s, 3) int32
    masks: tuple        # per scale: (M_s,) bool
    counts: tuple       # per scale: () int32 -- number of unique voxels


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor (PyTorch has no
    popcount).  Works on the word's unsigned value in int64, so bit 31
    (``1 << 31`` is INT_MIN in int32) counts once and every shift is
    logical."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _supercell_grid(cfg: VoxelConfig, scale: int):
    """``(sgx, sgy, sgz)``: supercells per axis at ``scale``."""
    P = cfg.patch_size
    return tuple(-(-g // P) for g in cfg.grid_shape(scale))


def _supercell_lin(vox: torch.Tensor, cfg: VoxelConfig, scale: int):
    """Linear id of each voxel's 16-aligned supercell, int32."""
    _, sgy, sgz = _supercell_grid(cfg, scale)
    sc = vox >> (cfg.patch_size.bit_length() - 1)
    return sc[:, 0] * (sgy * sgz) + sc[:, 1] * sgz + sc[:, 2]


def voxelize(pts: torch.Tensor, mask: torch.Tensor,
             cfg: VoxelConfig = VoxelConfig()) -> VoxelPyramid:
    """Build the 3-scale occupied-voxel pyramid from a padded scan.

    Args:
      pts: ``(N, >=3)`` float32 points.
      mask: ``(N,)`` bool validity.

    The lists come back sorted by (supercell id, packed local coords), the
    order the bit-table build needs.  The JAX version sorts one packed int32
    key where it fits and a two-key (id, local) row sort at scale 0 where
    it does not; here one int64 key ``id << 12 | local`` serves every scale
    with the same order and the same dedup.
    """
    p = pts[:, :3]
    half = torch.tensor([cfg.visible_length, cfg.visible_width,
                         cfg.visible_height], dtype=torch.float32,
                        device=pts.device)
    inb = mask & (p.abs() <= half).all(1)
    shifted = p + half
    P = cfg.patch_size
    pbits = P.bit_length() - 1
    pmask = P - 1
    lbits = 3 * pbits
    coords, masks, counts = [], [], []
    for s, vs in enumerate(cfg.voxel_sizes):
        c = torch.floor(shifted / vs).to(torch.int32)
        g = torch.tensor(cfg.grid_shape(s), dtype=torch.int32,
                         device=pts.device)
        ok = inb & ((c >= 0) & (c < g)).all(1)
        c = torch.where(ok[:, None], c, 0)
        _, sgy, sgz = _supercell_grid(cfg, s)
        lin = _supercell_lin(c, cfg, s).to(torch.int64)
        local = (((c[:, 0] & pmask) << (2 * pbits))
                 | ((c[:, 1] & pmask) << pbits) | (c[:, 2] & pmask))
        key = torch.where(ok, (lin << lbits) | local, _INT64_MAX)
        skey = torch.sort(key).values
        first = torch.ones_like(ok)
        first[1:] = skey[1:] != skey[:-1]
        ukey, m, n = compact(skey, first & (skey != _INT64_MAX),
                             cfg.max_voxels[s], fill=0)
        ulin = ukey >> lbits
        ulocal = ukey & ((1 << lbits) - 1)
        u = torch.stack([
            ((ulin // (sgy * sgz)) << pbits) | ((ulocal >> (2 * pbits)) & pmask),
            (((ulin // sgz) % sgy) << pbits) | ((ulocal >> pbits) & pmask),
            ((ulin % sgz) << pbits) | (ulocal & pmask),
        ], 1).to(torch.int32)
        coords.append(torch.where(m[:, None], u, 0))
        masks.append(m)
        counts.append(n)
    return VoxelPyramid(tuple(coords), tuple(masks), tuple(counts))


def keypoint_voxels(key_pts: torch.Tensor, scale: int,
                    cfg: VoxelConfig = VoxelConfig()) -> torch.Tensor:
    """Keypoint coordinates in scale-s voxel-index space, int32."""
    half = torch.tensor([cfg.visible_length, cfg.visible_width,
                         cfg.visible_height], dtype=torch.float32,
                        device=key_pts.device)
    return torch.floor((key_pts + half) / cfg.voxel_sizes[scale]
                       ).to(torch.int32)


def _first_of_run(lin: torch.Tensor):
    """``(is_first, slot_of_sorted)`` of a grouped-ascending id list whose
    padding rows hold INT32_MAX: the start of each id's run, and its rank."""
    is_first = torch.ones_like(lin, dtype=torch.bool)
    is_first[1:] = lin[1:] != lin[:-1]
    is_first &= lin != _INT32_MAX
    return is_first, (torch.cumsum(is_first, 0) - 1).to(torch.int32)


def bitgrid_scatter_plan(vox: torch.Tensor, vox_mask: torch.Tensor,
                         cfg: VoxelConfig, scale: int, slots: int):
    """Per-voxel scatter plan of the presorted bit-table build: ``(idx,
    bits)``, the word index clamped to the drop word ``slots*P*P`` and the
    voxel's z-bit."""
    P = cfg.patch_size
    pmask = P - 1
    lin = torch.where(vox_mask, _supercell_lin(vox, cfg, scale), _INT32_MAX)
    _, slot_of_sorted = _first_of_run(lin)
    vslot = torch.where(vox_mask & (slot_of_sorted < slots),
                        slot_of_sorted, slots)
    word_idx = (vslot * (P * P) + (vox[:, 0] & pmask) * P
                + (vox[:, 1] & pmask))
    bits = torch.where(vox_mask, 1 << (vox[:, 2] & pmask), 0).to(torch.int32)
    idx = torch.where(word_idx < slots * P * P, word_idx, slots * P * P)
    return idx, bits


def _slot_lookup(lin_sorted, is_first, slot_of_sorted, n_ids: int, slots: int):
    """``lookup(qid, ok)``: the table slot of supercell id ``qid``, or
    ``slots`` (the zero plane) where ``ok`` is false or the id is empty."""
    occ_first = is_first & (slot_of_sorted < slots)
    dev = lin_sorted.device
    if n_ids <= (1 << 22):
        # dense id -> slot map (scales 1-2); index n_ids is a trash slot
        slotmap = torch.full((n_ids + 1,), -1, dtype=torch.int32, device=dev)
        slotmap.scatter_(0, torch.where(occ_first, lin_sorted, n_ids).long(),
                         torch.where(is_first, slot_of_sorted, 0))

        def lookup(qid, ok):
            s = slotmap[torch.where(ok, qid, 0).clamp(0, n_ids - 1).long()]
            return torch.where(ok & (s >= 0), s, slots)
        return lookup

    # bitmap popcount-rank (scale 0, where a dense map would be 143 MB):
    # occupied ids set bits of a dense bitmap, and slot(qid) = the number of
    # occupied ids below qid = a block prefix + popcounts within the block
    n_words = -(-n_ids // 32)
    n_blocks = -(-n_words // _RANK_BLOCK)
    trash = n_blocks * _RANK_BLOCK
    wi = torch.where(occ_first, lin_sorted >> 5, trash).long()
    bit = torch.where(occ_first, 1 << (lin_sorted & 31), 0).to(torch.int32)
    bitmap = torch.zeros(trash + 1, dtype=torch.int32, device=dev)
    bitmap.index_add_(0, wi, bit)              # bits are unique: add == or
    words = bitmap[:trash].view(n_blocks, _RANK_BLOCK)
    pc = popcount32(words).sum(1)
    prefix = torch.cumsum(pc, 0) - pc
    lanes = torch.arange(_RANK_BLOCK, device=dev)

    def lookup(qid, ok):
        q = torch.where(ok, qid, 0)
        w = q >> 5
        b = (w // _RANK_BLOCK).long()
        widx = (w % _RANK_BLOCK).long()
        qbit = (q & 31).long()
        row = words[b]                                   # (..., 16)
        full = torch.where(lanes < widx[..., None], popcount32(row), 0).sum(-1)
        word = row.gather(-1, widx[..., None])[..., 0].long() & 0xFFFFFFFF
        part = popcount32((word & ((1 << qbit) - 1)).to(torch.int32))
        rank = prefix[b] + full + part
        hit = ok & (((word >> qbit) & 1) == 1)
        return torch.where(hit & (rank < slots), rank, slots).to(torch.int32)
    return lookup


def bitgrid_query(kv, key_mask, vox, vox_mask, cfg: VoxelConfig,
                  scale: int, slots: int):
    """The bit table of one scale and each keypoint's query into it:
    ``(table2, slot, o)``, the ``(slots + 1, P, P)`` int32 word table (its
    last row the zero plane), the ``(K, 2, 2, 2)`` int32 table rows of the
    keypoint's covering supercells, and the ``(K, 3)`` int32 offset of its
    patch window in the first of them.

    ``kv (K, 3)`` int32 keypoint voxels; ``vox (M, 3)`` the presorted
    occupied-voxel list.
    """
    if not cfg.presorted_pyramid:
        raise ValueError("the bit-table build takes voxelize()'s presorted "
                         "pyramid (presorted_pyramid=True)")
    P = cfg.patch_size
    R = cfg.patch_radius
    pbits = P.bit_length() - 1
    pmask = P - 1
    # P <= 16: z-bits fill the low half of one int32 word, so neither
    # `wB << (P - shift)` nor `(1 << P) - 1` reaches the sign bit
    if P > 16:
        raise ValueError(f"patch_size {P} > 16: z-bits must fit an int32 half")
    sgx, sgy, sgz = _supercell_grid(cfg, scale)
    dev = kv.device

    lin_sorted = torch.where(vox_mask, _supercell_lin(vox, cfg, scale),
                             _INT32_MAX)
    is_first, slot_of_sorted = _first_of_run(lin_sorted)
    lookup = _slot_lookup(lin_sorted, is_first, slot_of_sorted,
                          sgx * sgy * sgz, slots)

    # build: word = slot*P*P + lx*P + ly, bit = lz.  One buffer holds the
    # table, the zero plane (row `slots`) and a final drop word, so table2
    # is a view, not an 84 MB concatenation as in the JAX version.
    scatter_idx, bits = bitgrid_scatter_plan(vox, vox_mask, cfg, scale, slots)
    n_tab = slots * P * P
    buf = torch.zeros(n_tab + P * P + 1, dtype=torch.int32, device=dev)
    buf.index_add_(0, torch.where(scatter_idx == n_tab, n_tab + P * P,
                                  scatter_idx).long(), bits)
    table2 = buf[:-1].view(slots + 1, P, P)

    # query: the 2x2x2 covering supercells' whole word planes
    ox = kv - R                                       # (K, 3) window origin
    o = ox & pmask                                    # offset in cell A
    sA = ox >> pbits                                  # first supercell
    corner = torch.stack(torch.meshgrid(
        *[torch.arange(2, dtype=torch.int32, device=dev)] * 3,
        indexing="ij"), -1)                           # (2, 2, 2, 3)
    nb = sA[:, None, None, None, :] + corner          # (K, 2, 2, 2, 3)
    sgv = torch.tensor([sgx, sgy, sgz], dtype=torch.int32, device=dev)
    okb = ((nb >= 0) & (nb < sgv)).all(-1) & key_mask[:, None, None, None]
    nlin = nb[..., 0] * (sgy * sgz) + nb[..., 1] * sgz + nb[..., 2]
    slot = lookup(nlin, okb).to(torch.int32).contiguous()
    return table2, slot, o.contiguous()


def _patches_one_scale_bitgrid(kv, key_mask, vox, vox_mask, cfg: VoxelConfig,
                               scale: int, slots: int):
    """16^3 occupancy patches of one scale via the bit table: ``(K, P, P,
    P)`` float32."""
    query = bitgrid_query(kv, key_mask, vox, vox_mask, cfg, scale, slots)
    if cfg.use_pallas_plane_gather:
        # K2 (CPU: plain): gather, z-combine, x/y alignment and bit unpack
        # in one launch
        return patches_from_planes(*query)
    return patches_from_planes_plain(*query)


def extract_patches(key_pts: torch.Tensor, key_mask: torch.Tensor,
                    pyramid: VoxelPyramid, cfg: VoxelConfig = VoxelConfig()):
    """Multi-scale 16^3 occupancy patches around each keypoint: a tuple of
    three ``(K, 16, 16, 16)`` float32 tensors (scales 0.02 / 0.16 / 0.64 m).
    """
    if cfg.patch_method != "window" or 0 in cfg.bitgrid_slots:
        raise ValueError("only the bit-table patch route is ported "
                         "(patch_method='window', every bitgrid_slots > 0)")
    return tuple(
        _patches_one_scale_bitgrid(
            keypoint_voxels(key_pts, s, cfg), key_mask, pyramid.coords[s],
            pyramid.masks[s], cfg, s, cfg.bitgrid_slots[s])
        for s in range(len(cfg.scale_ratios)))
