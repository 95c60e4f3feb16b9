"""The CAE-LO front end, plain: one padded scan -> keypoints and 3-scale
descriptors (CAE-LO, arXiv:2001.01354; reference ``SphericalRing.py``,
``Voxel.py``, ``Match.py``).

The patches are read straight from the set of occupied voxels (a sorted
key list and a binary search per patch cell), with the capacities the
configuration states: ``max_voxels`` keeps the first voxels in (supercell
id, local coordinate) order, and ``bitgrid_slots`` keeps the first
supercells in id order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .sizes import Sizes
from .xlamath import (asin_base, atan2, fma32, mul_reciprocal,
                      mul_reciprocal_add, sqrt32)

_INF = float("inf")
_INT32_MAX = 2 ** 31 - 1
_ACT = {"tanh": torch.tanh, "relu": torch.relu, "linear": lambda x: x,
        "sigmoid": torch.sigmoid}


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even), as the
    tensor cores read a float32 operand with TF32 on."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _ops(low: bool):
    return tf32 if low else (lambda x: x)


def conv(x, w, b, low=False, **kw):
    r = _ops(low)
    fn = F.conv2d if w.dim() == 4 else F.conv3d
    return fn(r(x), r(w), b, **kw)


def linear(x, w, b, low=False):
    r = _ops(low)
    return F.linear(r(x), r(w), b)


def matmul(a, b, low=False):
    r = _ops(low)
    return r(a) @ r(b)


# --- spherical ring ---------------------------------------------------------

def ring_image(pts, mask, S: Sizes):
    """``(image (H, W, 5), counter (H, W) int32)``: each cell holds its
    nearest point by 1/64 m range (the lowest index among equals), x, y,
    z, reflectance and the range."""
    H, W = S.img_h, S.img_w
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    r = sqrt32(fma32(z, z, fma32(x, x, y * y)))
    valid = mask & (r > 0)
    u = torch.clamp(z / torch.where(valid, r, 1.0), -1.0, 1.0)
    col = torch.floor(mul_reciprocal(torch.pi - atan2(y, x), S.az_res)
                      ).to(torch.int32).clamp(0, W - 1)
    a = atan2(u, asin_base(u))
    row = H - torch.floor(mul_reciprocal_add(
        a + a, S.vertical_res, S.vertical_pixel_offset)).to(torch.int32)
    inb = valid & (row >= 0) & (row < H)
    flat = torch.where(inb, row * W + col, H * W).long()
    n = pts.shape[0]
    bits = max(n - 1, 1).bit_length()
    rq = torch.clamp_max((r * 64.0).to(torch.int32), (1 << (30 - bits)) - 1)
    idx = torch.arange(n, dtype=torch.int32, device=pts.device)
    packed = torch.where(inb, (rq << bits) | idx, _INT32_MAX)
    best = torch.full((H * W + 1,), _INT32_MAX, dtype=torch.int32,
                      device=pts.device)
    best.scatter_reduce_(0, flat, packed, "amin")
    win = best[:H * W]
    occ = win != _INT32_MAX
    g = pts[torch.where(occ, win & ((1 << bits) - 1), 0).long(), :4]
    gx, gy, gz = g[:, 0], g[:, 1], g[:, 2]
    rw = sqrt32(fma32(gz, gz, fma32(gy, gy, gx * gx)))
    image = torch.where(occ[:, None], torch.cat([g, rw[:, None]], 1), 0.0)
    counter = torch.zeros(H * W + 1, dtype=torch.int32, device=pts.device)
    counter.scatter_add_(0, flat, inb.to(torch.int32))
    return image.reshape(H, W, 5), counter[:H * W].reshape(H, W)


def respond_planes(image, w: dict, S: Sizes, low=False):
    """The respond layer (3x3 conv to 32, relu, 1x1 conv to 8, relu) on the
    ring image's x, y, z over rows ``[0, n_lines)``, cols ``[0,
    model_w)``: ``(8, n_lines, model_w)``."""
    x = image[:S.n_lines, :S.model_w, 0:3].permute(2, 0, 1)[None]
    h = torch.relu(conv(x, w["conv1_1.weight"], w["conv1_1.bias"], low,
                        padding=1))
    return torch.relu(conv(h, w["conv1_1_2.weight"], w["conv1_1_2.bias"],
                           low))[0]


# --- saliency, gates, top-k ------------------------------------------------

def _shifted(x, r, dy, dx, H, W):
    return x[..., r + dy:r + dy + H, r + dx:r + dx + W]


def keypoint_score(planes, image, counter, S: Sizes):
    """Saliency (the least L2 respond difference to an occupied 5x5
    neighbour) where every gate passes, else ``-inf``: occupied, enough
    occupied neighbours, saliency over the threshold, range past
    ``visible_bottom``, inside the edge crop, and the ground-speckle
    z-extent gate."""
    kp = S.cfg["keypoint"]
    H, W = planes.shape[-2:]
    occ = counter[:H, :W] > 0
    r = kp["window"] // 2
    fpad = F.pad(planes, (r, r, r, r))
    opad = F.pad(occ.to(torch.uint8), (r, r, r, r)).bool()
    min_d2 = torch.full(occ.shape, _INF, device=planes.device)
    n_occ = torch.zeros(occ.shape, dtype=torch.int32, device=planes.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            nocc = _shifted(opad, r, dy, dx, H, W)
            d2 = ((_shifted(fpad, r, dy, dx, H, W) - planes) ** 2).sum(-3)
            min_d2 = torch.minimum(min_d2, torch.where(nocc, d2, _INF))
            n_occ += nocc
    finite = torch.isfinite(min_d2)
    sal = torch.sqrt(torch.where(finite, min_d2, 0.0))
    rows = torch.arange(H, device=planes.device)[:, None]
    cols = torch.arange(W, device=planes.device)[None, :]
    e = S.edge
    good = (occ & (n_occ >= kp["min_neighbors"])
            & (sal > kp["norm_diff_threshold"])
            & (image[:H, :W, 4] >= S.visible_bottom)
            & (rows >= e) & (rows < S.n_lines - e)
            & (cols >= e) & (cols < S.model_w - e) & finite)
    if kp["ground_z_max"] > -100.0:
        z = image[:H, :W, 2]
        zo = z * occ.to(z.dtype)
        zpad = F.pad(zo, (r, r, r, r))
        zmin = torch.full(z.shape, _INF, device=z.device)
        zmax = torch.full(z.shape, -_INF, device=z.device)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                no = _shifted(opad, r, dy, dx, H, W)
                nz = _shifted(zpad, r, dy, dx, H, W)
                zmin = torch.minimum(zmin, torch.where(no, nz, _INF))
                zmax = torch.maximum(zmax, torch.where(no, nz, -_INF))
        zext = torch.where(torch.isfinite(zmin) & torch.isfinite(zmax),
                           zmax - zmin, 0.0)
        good &= (z >= kp["ground_z_max"]) | (zext > kp["ground_extent_m"])
    return torch.where(good, sal, -_INF)


def top_k(x, k):
    """The ``k`` largest entries, value descending, the lower index first
    among equals."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(image, counter, planes, S: Sizes):
    """``(key_pts (K, 3), key_pixels (K, 2) int32, key_mask (K,))``."""
    W = planes.shape[-1]
    score = keypoint_score(planes, image, counter, S)
    vals, idx = top_k(score.reshape(-1), S.cfg["keypoint"]["n_keypoints"])
    key_mask = torch.isfinite(vals)
    r, c = idx // W, idx % W
    key_pts = torch.where(key_mask[:, None], image[r, c, 0:3], 0.0)
    return key_pts, torch.stack([r, c], -1).to(torch.int32), key_mask


# --- voxel pyramid and patches ---------------------------------------------

def _voxel_keys(c, S: Sizes, s: int):
    """int64 key of voxel coordinates ``c (..., 3)``: supercell id above
    the packed 4-bit local coordinates."""
    P = S.P
    pb = P.bit_length() - 1
    pm = P - 1
    _, sgy, sgz = S.supercells[s]
    c = c.to(torch.int64)
    sc = c >> pb
    lin = sc[..., 0] * (sgy * sgz) + sc[..., 1] * sgz + sc[..., 2]
    local = (((c[..., 0] & pm) << (2 * pb)) | ((c[..., 1] & pm) << pb)
             | (c[..., 2] & pm))
    return (lin << (3 * pb)) | local


def _voxel_index(x, S: Sizes, s: int):
    half = torch.tensor(S.half, dtype=torch.float32, device=x.device)
    return torch.floor(mul_reciprocal(x + half, S.voxel_sizes[s])
                       ).to(torch.int32)


def occupied_voxels(pts, mask, S: Sizes, s: int):
    """Sorted int64 keys of the occupied voxels of scale ``s`` that the
    configuration's capacities keep."""
    p = pts[:, :3]
    half = torch.tensor(S.half, dtype=torch.float32, device=pts.device)
    grid = torch.tensor(S.grids[s], dtype=torch.int32, device=pts.device)
    c = _voxel_index(p, S, s)
    ok = mask & (p.abs() <= half).all(1) & ((c >= 0) & (c < grid)).all(1)
    keys = torch.unique(_voxel_keys(c[ok], S, s))[:S.max_voxels[s]]
    # the bit table holds the first `slots` supercells by id
    lin = keys >> (3 * (S.P.bit_length() - 1))
    first = torch.ones_like(lin, dtype=torch.bool)
    first[1:] = lin[1:] != lin[:-1]
    return keys[torch.cumsum(first, 0) - 1 < S.slots[s]]


def patches(key_pts, key_mask, keys, S: Sizes, s: int):
    """``(K, P, P, P)`` float32: cell ``[a, b, c]`` of a keypoint's patch is
    1 where voxel ``kv - P/2 + (a, b, c)`` is in ``keys``, ``kv`` the
    keypoint's voxel."""
    P = S.P
    kv = _voxel_index(key_pts, S, s)
    r = torch.arange(P, dtype=torch.int32, device=key_pts.device) - P // 2
    off = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1)
    cells = kv[:, None, None, None, :] + off
    grid = torch.tensor(S.grids[s], dtype=torch.int32, device=key_pts.device)
    inside = ((cells >= 0) & (cells < grid)).all(-1)
    q = _voxel_keys(torch.where(inside[..., None], cells, 0), S, s)
    at = torch.searchsorted(keys, q.reshape(-1)).clamp_max(
        max(keys.numel() - 1, 0)).view(q.shape)
    hit = (keys[at] == q) if keys.numel() else torch.zeros_like(inside)
    return (hit & inside & key_mask[:, None, None, None]).to(torch.float32)


def encode(p, w: dict, act: str, code_act: str, low=False):
    """The patch encoder: three 3x3x3 convs (8, 16, 32) with 2x max pools
    between, flattened channels-last, dense 200, dense to the code."""
    a = _ACT[act]
    h = a(conv(p[:, None], w["conv1.weight"], w["conv1.bias"], low,
               padding=1))
    h = F.max_pool3d(h, 2)
    h = a(conv(h, w["conv2.weight"], w["conv2.bias"], low, padding=1))
    h = F.max_pool3d(h, 2)
    h = a(conv(h, w["conv3.weight"], w["conv3.bias"], low, padding=1))
    h = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)
    h = a(linear(h, w["fn1.weight"], w["fn1.bias"], low))
    return _ACT[code_act](linear(h, w["fn2.weight"], w["fn2.bias"], low))


def describe(pts, mask, key_pts, key_mask, enc_w: dict, S: Sizes,
             low=False):
    """``(K, 3 * code)`` descriptors, zero where ``key_mask`` is false."""
    cfg = S.cfg
    codes = []
    for s in range(len(S.voxel_sizes)):
        keys = occupied_voxels(pts, mask, S, s)
        codes.append(encode(patches(key_pts, key_mask, keys, S, s), enc_w,
                            cfg["encoder_activation"],
                            cfg["encoder_code_activation"], low))
    return torch.where(key_mask[:, None], torch.cat(codes, -1), 0.0)


@torch.no_grad()
def features(pts, mask, weights, S: Sizes, low=False):
    """One frame's ``(key_pts, descriptors, key_mask, key_pixels)``;
    ``weights = (respond, encoder)`` state dicts."""
    image, counter = ring_image(pts, mask, S)
    planes = respond_planes(image, weights[0], S, low)
    key_pts, key_pixels, key_mask = select_keypoints(image, counter, planes,
                                                     S)
    desc = describe(pts, mask, key_pts, key_mask, weights[1], S, low)
    return key_pts, desc, key_mask, key_pixels
