"""Three-scale voxel pyramid and the patch queries (port of
``caelo_tpu/voxel/grid.py``).

* :func:`voxelize`: per scale, one sort of a packed (16-aligned supercell
  id, 4-bit local coords) key, dedup and compaction -> padded occupied-voxel
  lists in supercell order.
* :func:`extract_patches`: a 16^3 occupancy patch per keypoint and scale,
  by one of three routes, dispatched as the JAX function dispatches them:

  - ``patch_method="window"`` and ``bitgrid_slots[s] > 0`` (the default at
    every scale): a bit table of 16 z-bits per (supercell, x, y) column,
    the 2x2x2 covering supercells' table slots per keypoint, then the word
    planes gathered, aligned and unpacked into the patch (kernel K2,
    ``ops/plane_gather.py``, behind ``use_pallas_plane_gather``, the
    port's default);
  - ``patch_method="window"`` and ``bitgrid_slots[s] == 0``: a supercell
    range query, the candidates of the 8 covering supercells' runs under
    ``supercell_caps`` scattered into the patch;
  - any other ``patch_method``: the KNN route, a float32 distance matmul,
    the ``patch_knn`` nearest voxels and a box filter.

  ``presorted_pyramid=False`` makes the bit-table and window routes sort
  the voxel list themselves instead of taking ``voxelize``'s order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import VoxelConfig
from ..ops.masking import compact
from ..ops.plane_gather import (patches_from_planes,
                                patches_from_planes_plain)
from ..xlamath import mul_reciprocal

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
        c = torch.floor(mul_reciprocal(shifted, vs)).to(torch.int32)
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
    return torch.floor(mul_reciprocal(key_pts + half, cfg.voxel_sizes[scale])
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

    ``kv (K, 3)`` int32 keypoint voxels; ``vox (M, 3)`` the occupied-voxel
    list, in ``voxelize``'s supercell order unless
    ``cfg.presorted_pyramid`` is false: then the slot assignment sorts the
    supercell ids and each voxel finds its slot through the lookup
    (``caelo_tpu/voxel/grid.py:388, 469-479``).
    """
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

    lin = torch.where(vox_mask, _supercell_lin(vox, cfg, scale), _INT32_MAX)
    lin_sorted = lin if cfg.presorted_pyramid else torch.sort(lin).values
    is_first, slot_of_sorted = _first_of_run(lin_sorted)
    lookup = _slot_lookup(lin_sorted, is_first, slot_of_sorted,
                          sgx * sgy * sgz, slots)

    # build: word = slot*P*P + lx*P + ly, bit = lz.  One buffer holds the
    # table, the zero plane (row `slots`) and a final drop word, so table2
    # is a view, not an 84 MB concatenation as in the JAX version.
    n_tab = slots * P * P
    if cfg.presorted_pyramid:
        scatter_idx, bits = bitgrid_scatter_plan(vox, vox_mask, cfg, scale,
                                                 slots)
    else:
        word_idx = (lookup(lin, vox_mask) * (P * P) + (vox[:, 0] & pmask) * P
                    + (vox[:, 1] & pmask))
        bits = torch.where(vox_mask, 1 << (vox[:, 2] & pmask), 0
                           ).to(torch.int32)
        scatter_idx = torch.where(word_idx < n_tab, word_idx, n_tab)
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


def _patches_one_scale_window(kv, key_mask, vox, vox_mask, cfg: VoxelConfig,
                              scale: int):
    """16^3 occupancy patches of one scale by supercell range queries
    (``caelo_tpu/voxel/grid.py:199-311``): ``(K, P, P, P)`` float32.

    The voxels sorted by supercell id (``voxelize``'s order, or a stable
    sort of it when ``presorted_pyramid`` is false: which candidates a cap
    keeps depends on the order within a run), a keypoint's window overlaps
    at most 2x2x2 supercells, whose runs a binary search finds.  Up to
    ``supercell_caps[scale]`` voxels of each run are candidates, and the
    candidates inside the window are scattered into the patch.  Keypoints
    go ``patch_query_chunk`` at a time when that divides K, as in JAX,
    bounding the ``(k, 8, C)`` candidate tensors.  Integer work throughout:
    the result is JAX's bit for bit.
    """
    K = kv.shape[0]
    P = cfg.patch_size
    R = cfg.patch_radius
    M = vox.shape[0]
    C = min(cfg.supercell_caps[scale], M)
    sgx, sgy, sgz = _supercell_grid(cfg, scale)
    pbits = P.bit_length() - 1
    pmask = P - 1
    dev = kv.device

    lin = torch.where(vox_mask, _supercell_lin(vox, cfg, scale), _INT32_MAX)
    # packed 4-bit local coords of each voxel in its supercell
    local = (((vox[:, 0] & pmask) << (2 * pbits))
             | ((vox[:, 1] & pmask) << pbits) | (vox[:, 2] & pmask))
    if not cfg.presorted_pyramid:
        order = torch.sort(lin, stable=True).indices
        lin, local = lin[order], local[order]
    corner = torch.stack(torch.meshgrid(
        *[torch.arange(2, dtype=torch.int32, device=dev)] * 3,
        indexing="ij"), -1).view(8, 3)
    sgv = torch.tensor([sgx, sgy, sgz], dtype=torch.int32, device=dev)
    lanes = torch.arange(C, dtype=torch.int32, device=dev)

    def chunk(kvc, kmc):
        k = kvc.shape[0]
        nb = ((kvc - R) >> pbits)[:, None, :] + corner        # (k, 8, 3)
        ok_nb = ((nb >= 0) & (nb < sgv)).all(-1)
        qlin = torch.where(ok_nb, nb[..., 0] * (sgy * sgz) + nb[..., 1] * sgz
                           + nb[..., 2], -1)
        left = torch.searchsorted(lin, qlin, side="left")
        cnt = torch.searchsorted(lin, qlin, side="right") - left
        take = left[..., None] + lanes                         # (k, 8, C)
        loc = local[take.clamp(0, M - 1)]
        anchor = nb * P - kvc[:, None, :]                      # (k, 8, 3)
        off = [anchor[..., a:a + 1] + ((loc >> (sh * pbits)) & pmask)
               for a, sh in ((0, 2), (1, 1), (2, 0))]
        in_box = (lanes < cnt[..., None]) & kmc[:, None, None]
        for o in off:
            in_box &= (o >= -R) & (o < R)
        cell = (off[0] + R) * (P * P) + (off[1] + R) * P + (off[2] + R)
        # in-box candidates are distinct voxels, so distinct cells; the
        # dropped ones all go to one trash cell past the patches
        trash = k * P * P * P
        flat = torch.where(in_box, torch.arange(
            k, dtype=torch.int32, device=dev)[:, None, None] * (P * P * P)
            + cell, trash)
        occ = torch.zeros(trash + 1, dtype=torch.float32, device=dev)
        occ.index_fill_(0, flat.reshape(-1).long(), 1.0)
        return occ[:-1].view(k, P, P, P)

    kc = cfg.patch_query_chunk
    if kc and kc < K and K % kc == 0:
        return torch.cat([chunk(a, b) for a, b in
                          zip(kv.split(kc), key_mask.split(kc))])
    return chunk(kv, key_mask)


def _knn_topk(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores of each row, ties broken by the
    lower index as ``lax.top_k`` breaks them: one top-k on an int64 key
    that packs the score's order above the index's complement, so every
    key is distinct."""
    bits = score.contiguous().view(torch.int32).to(torch.int64)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # float order
    n = score.shape[-1]
    key = (order << 32) | (n - 1 - torch.arange(n, device=score.device))
    return torch.topk(key, k, dim=-1, sorted=False).indices


def knn_indices(kv, vox, vox_mask, cfg: VoxelConfig, chunk: int = 128):
    """``(K, knn)`` indices into ``vox`` of each keypoint voxel's
    ``patch_knn`` nearest occupied voxels, by the KNN route's score: per
    chunk of ``chunk`` keypoints, ``2 k.v - |v|^2 - |k|^2`` in float32
    (padded voxels at ``|v|^2 = 1e12``) and its largest.  The CPU's matmul
    rounds the score as JAX's does on the CPU; the card's may order
    near-equal neighbours differently."""
    knn = min(cfg.patch_knn, vox.shape[0])
    v = vox.to(torch.float32)
    v2 = torch.where(vox_mask, (v * v).sum(1), 1e12)
    idx = []
    for kc in kv.split(chunk):
        kcf = kc.to(torch.float32)
        score = 2.0 * (kcf @ v.T) - v2[None, :] - (kcf * kcf).sum(1)[:, None]
        idx.append(_knn_topk(score, knn))
    return torch.cat(idx)


def _patches_one_scale(kv, key_mask, vox, vox_mask, cfg: VoxelConfig,
                       chunk: int = 128):
    """16^3 occupancy patches of one scale by the KNN route
    (``caelo_tpu/voxel/grid.py:149-196``): ``(K, P, P, P)`` float32, the
    :func:`knn_indices` neighbours inside each keypoint's box."""
    return patches_from_neighbors(
        knn_indices(kv, vox, vox_mask, cfg, chunk), kv, key_mask, vox,
        vox_mask, cfg)


def patches_from_neighbors(idx, kv, key_mask, vox, vox_mask,
                           cfg: VoxelConfig):
    """The KNN route's tail: the neighbours ``idx (K, knn)`` of each
    keypoint voxel that lie inside its 16^3 box, scattered into its patch,
    ``(K, P, P, P)`` float32."""
    K = kv.shape[0]
    P = cfg.patch_size
    R = cfg.patch_radius
    off = vox[idx] - kv[:, None, :]                         # (K, knn, 3)
    in_box = (((off >= -R) & (off < R)).all(-1) & vox_mask[idx]
              & key_mask[:, None])
    cell = ((off[..., 0] + R) * (P * P) + (off[..., 1] + R) * P
            + (off[..., 2] + R))
    trash = K * P * P * P
    flat = torch.where(in_box, torch.arange(
        K, dtype=torch.int32, device=kv.device)[:, None] * (P * P * P) + cell,
        trash)
    occ = torch.zeros(trash + 1, dtype=torch.float32, device=kv.device)
    occ.index_fill_(0, flat.reshape(-1).long(), 1.0)
    return occ[:-1].view(K, P, P, P)


def decode_voxels(coords: torch.Tensor, scale: int,
                  cfg: VoxelConfig = VoxelConfig()) -> torch.Tensor:
    """Occupied-voxel coords (voxel-index space) -> world-space cell
    centers, ``(M, 3)`` float32: the inverse of :func:`voxelize`'s binning
    (the reference's ``RebuildPCFromVoxels`` family, ``Voxel.py:220-469``);
    pair with the pyramid's mask to drop padding."""
    f32 = dict(dtype=torch.float32, device=coords.device)
    origin = torch.tensor(cfg.origin, **f32)
    vs = torch.tensor(cfg.voxel_sizes[scale], **f32)
    return (coords.to(torch.float32) + 0.5) * vs + origin


def decode_patch(occ: torch.Tensor, key_pt: torch.Tensor, scale: int,
                 cfg: VoxelConfig = VoxelConfig()):
    """16^3 occupancy patch of ``key_pt`` at ``scale`` -> ``(P^3, 3)``
    world-space centers of its cells and the ``(P^3,)`` occupancy mask
    (the inverse of :func:`extract_patches` for one keypoint)."""
    P = cfg.patch_size
    kv = keypoint_voxels(key_pt[None], scale, cfg)[0]
    r = torch.arange(P, dtype=torch.int32, device=occ.device) - cfg.patch_radius
    cells = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1)
    return (decode_voxels(cells.reshape(-1, 3) + kv, scale, cfg),
            occ.reshape(-1) > 0.5)


def occupancy_stats(pyramid: VoxelPyramid,
                    cfg: VoxelConfig = VoxelConfig()) -> dict:
    """Saturation of the static patch-gather capacities, per scale
    ``{"scale<s>": {...}}`` of Python ints:

    * ``n_voxels`` -- unique occupied voxels (vs ``cfg.max_voxels``);
    * ``n_supercells`` -- occupied 16-aligned supercells (vs
      ``cfg.bitgrid_slots``: the bit table drops the ones beyond);
    * ``max_supercell_occupancy`` -- the densest supercell's voxel count
      (vs ``cfg.supercell_caps`` of the windowed route).
    """
    rows = []
    for s in range(len(cfg.scale_ratios)):
        vox, msk = pyramid.coords[s], pyramid.masks[s]
        lin = torch.sort(torch.where(msk, _supercell_lin(vox, cfg, s),
                                     _INT32_MAX)).values
        is_first, _ = _first_of_run(lin)
        # longest run of equal ids = the densest supercell
        pos = torch.arange(lin.shape[0], device=lin.device)
        start = torch.cummax(torch.where(is_first, pos, -1), 0).values
        run_len = torch.where(lin != _INT32_MAX, pos - start + 1, 0)
        rows.append(torch.stack([torch.as_tensor(pyramid.counts[s]).to(pos),
                                 is_first.sum(), run_len.max()]))
    return {f"scale{s}": dict(zip(("n_voxels", "n_supercells",
                                   "max_supercell_occupancy"), r))
            for s, r in enumerate(torch.stack(rows).tolist())}


def extract_patches(key_pts: torch.Tensor, key_mask: torch.Tensor,
                    pyramid: VoxelPyramid, cfg: VoxelConfig = VoxelConfig()):
    """Multi-scale 16^3 occupancy patches around each keypoint: a tuple of
    three ``(K, 16, 16, 16)`` float32 tensors (scales 0.02 / 0.16 / 0.64 m).

    Per scale, ``patch_method="window"`` takes the bit table where
    ``bitgrid_slots[s] > 0`` and the supercell window query where it is 0;
    any other method takes the KNN route (``caelo_tpu/voxel/grid.py:
    633-650``).
    """
    out = []
    for s in range(len(cfg.scale_ratios)):
        args = (keypoint_voxels(key_pts, s, cfg), key_mask,
                pyramid.coords[s], pyramid.masks[s], cfg)
        if cfg.patch_method != "window":
            out.append(_patches_one_scale(*args))
        elif cfg.bitgrid_slots[s] > 0:
            out.append(_patches_one_scale_bitgrid(*args, s,
                                                  cfg.bitgrid_slots[s]))
        else:
            out.append(_patches_one_scale_window(*args, s))
    return tuple(out)
