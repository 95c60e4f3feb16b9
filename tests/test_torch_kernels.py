"""The port's four kernels (K1 keypoint saliency and gates, K2 plane
gather to finished patches, K3 the batched 4x4 Jacobi eigen solve, K4 the
KNN's scores and selection): the plain PyTorch versions of K1 and K2
against the Pallas kernels in interpret mode, the JAX XLA code around them
and a numpy oracle (K3's plain version is held to JAX by
tests/test_torch_geometry.py, K4's by tests/test_torch_baselines.py), the
wrappers' CPU dispatch and refusals, K4's visiting order, and the ctypes
signatures against the C entry points.  The CUDA kernels themselves are
tested on the card by tests/test_torch_gpu.py."""
import ctypes
import dataclasses
import glob
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from caelo_tpu.config import tiny_test_config
from caelo_tpu.data.synthetic import synthetic_scan_pair
from caelo_tpu.ops.nms import select_keypoints as jselect
from caelo_tpu.ops.pallas_nms import saliency_map_pallas
from caelo_tpu.ops.pallas_patches import gather_planes_pallas
from caelo_tpu.projection.spherical import project_to_spherical_ring
from caelo_tpu_torch import _build
from caelo_tpu_torch.frontend import baselines as bl
from caelo_tpu_torch.geometry import se3
from caelo_tpu_torch.ops.nms import top_k
from caelo_tpu_torch.ops.plane_gather import (gather_planes_plain,
                                              patches_from_planes,
                                              patches_from_planes_plain)
from caelo_tpu_torch.ops.saliency import (keypoint_score,
                                          keypoint_score_plain, saliency_map,
                                          saliency_map_plain,
                                          window_z_extent)


def _oracle(resp, occ):
    """numpy min-neighbour-diff over the 5x5 window (the oracle of
    tests/test_pallas_kernels.py)."""
    H, W, _ = resp.shape
    rp = np.pad(resp, ((2, 2), (2, 2), (0, 0)))
    op = np.pad(occ, 2)
    md = np.full((H, W), np.inf, np.float32)
    cnt = np.zeros((H, W), np.int32)
    for dy in range(5):
        for dx in range(5):
            if dy == 2 and dx == 2:
                continue
            nb = rp[dy:dy + H, dx:dx + W]
            o = op[dy:dy + H, dx:dx + W]
            md = np.minimum(md, np.where(o, ((nb - resp) ** 2).sum(-1), np.inf))
            cnt += o
    return md, cnt


def _respond(rng, kind, H=16, W=256, C=8):
    if kind == "normal":
        return rng.normal(size=(H, W, C)).astype(np.float32)
    # realistic magnitude: relu'd respond values of ~0-50 (random-weight
    # respond maps of metre-scale xyz input), many exact zeros
    return np.maximum(rng.normal(0, 15, (H, W, C)), 0).astype(np.float32)


def _assert_saliency_close(md, cnt, md_ref, cnt_ref):
    np.testing.assert_array_equal(cnt, cnt_ref)
    fin = np.isfinite(md_ref)
    np.testing.assert_array_equal(np.isfinite(md), fin)
    np.testing.assert_allclose(md[fin], md_ref[fin], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("kind", ["normal", "realistic"])
def test_saliency_plain_matches_pallas_and_oracle(rng, kind):
    resp = _respond(rng, kind)
    occ = rng.uniform(size=resp.shape[:2]) < 0.6
    md_p, cnt_p = saliency_map_pallas(jnp.asarray(resp), jnp.asarray(occ),
                                      interpret=True)
    md_o, cnt_o = _oracle(resp, occ)
    md, cnt = saliency_map_plain(
        torch.from_numpy(resp).permute(2, 0, 1), torch.from_numpy(occ))
    md, cnt = md.numpy(), cnt.numpy()
    _assert_saliency_close(md, cnt, np.asarray(md_p), np.asarray(cnt_p))
    _assert_saliency_close(md, cnt, md_o, cnt_o)


def test_saliency_plain_batched_matches_per_frame(rng):
    planes = torch.from_numpy(rng.normal(size=(3, 8, 12, 40)).astype(np.float32))
    occ = torch.from_numpy(rng.uniform(size=(3, 12, 40)) < 0.5)
    md, cnt = saliency_map_plain(planes, occ)
    for b in range(3):
        md_b, cnt_b = saliency_map_plain(planes[b], occ[b])
        assert torch.equal(md[b], md_b) and torch.equal(cnt[b], cnt_b)


def test_saliency_wrapper_takes_plain_on_cpu(rng):
    planes = torch.from_numpy(rng.normal(size=(8, 10, 30)).astype(np.float32))
    occ = torch.from_numpy(rng.uniform(size=(10, 30)) < 0.5)
    before = saliency_map.launches
    md, cnt = saliency_map(planes, occ)
    md_ref, cnt_ref = saliency_map_plain(planes, occ)
    assert torch.equal(md, md_ref) and torch.equal(cnt, cnt_ref)
    assert saliency_map.launches == before      # counts kernel launches only
    with pytest.raises(TypeError):
        saliency_map(planes.double(), occ)
    with pytest.raises(ValueError):
        saliency_map(planes, occ[:, :-1])


def test_plane_gather_plain_matches_pallas(rng):
    S, P, K = 300, 16, 32
    table2 = rng.integers(-2**31, 2**31 - 1, (S + 1, P, P)).astype(np.int32)
    table2[S] = 0                       # zero plane for missing cells
    slot = rng.integers(0, S + 1, (K, 2, 2, 2)).astype(np.int32)
    ref = gather_planes_pallas(jnp.asarray(table2), jnp.asarray(slot),
                               interpret=True)
    out = gather_planes_plain(torch.from_numpy(table2), torch.from_numpy(slot))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), table2[slot])


def test_plane_gather_wrapper_takes_plain_on_cpu(rng):
    """patches_from_planes (K2's wrapper) takes its plain version on the
    CPU, launches nothing, clamps out-of-range slots into the table and
    checks its inputs."""
    S, P = 50, 16
    table2 = torch.from_numpy(
        rng.integers(0, 2**16, (S + 1, P, P)).astype(np.int32))
    table2[S] = 0
    slot = torch.from_numpy(rng.integers(0, S + 1, (5, 2, 2, 2)).astype(np.int32))
    slot[0, 0, 0, 0] = -4               # out of range: clamped like JAX
    slot[1, 1, 1, 1] = S + 7
    o = torch.from_numpy(rng.integers(0, P, (5, 3)).astype(np.int32))
    before = patches_from_planes.launches
    out = patches_from_planes(table2, slot, o)
    assert patches_from_planes.launches == before
    assert out.shape == (5, P, P, P) and out.dtype == torch.float32
    assert torch.equal(out, patches_from_planes_plain(table2, slot, o))
    assert torch.equal(gather_planes_plain(table2, slot)[0, 0, 0, 0],
                       table2[0])
    assert torch.equal(gather_planes_plain(table2, slot)[1, 1, 1, 1],
                       table2[S])
    with pytest.raises(TypeError):
        patches_from_planes(table2.long(), slot, o)
    with pytest.raises(ValueError):
        patches_from_planes(table2, slot, o[:, :2])


def _patches_oracle(table2, slot, o):
    """numpy: patch[k, a, b, c] = bit c of the 16-bit z-window of column
    (o_x + a, o_y + b) over the 2x2 x/y supercells, from the two z-adjacent
    planes at offset o_z."""
    K, P = slot.shape[0], table2.shape[-1]
    t = table2.astype(np.int64) & 0xFFFFFFFF
    s = np.clip(slot, 0, table2.shape[0] - 1)
    out = np.zeros((K, P, P, P), np.float32)
    for k in range(K):
        ox, oy, oz = o[k]
        for a in range(P):
            for b in range(P):
                X, Y = ox + a, oy + b
                i, j = X // P, Y // P
                wA = t[s[k, i, j, 0], X % P, Y % P]
                wB = t[s[k, i, j, 1], X % P, Y % P]
                win = ((wA >> oz) | (wB << (P - oz) if oz else 0)) & 0xFFFF
                out[k, a, b] = (win >> np.arange(P)) & 1
    return out


def test_patches_from_planes_plain_matches_oracle(rng):
    """Offsets 0 and 15 on each axis, the zero plane, clamped slots and
    full-range int32 words (bits above the 16 z-bits are masked)."""
    S, P, K = 40, 16, 12
    table2 = rng.integers(-2**31, 2**31 - 1, (S + 1, P, P)).astype(np.int32)
    table2[S] = 0
    slot = rng.integers(0, S + 1, (K, 2, 2, 2)).astype(np.int32)
    slot[0] = S
    slot[1, 0, 1, 0], slot[2, 1, 0, 1] = -3, S + 5
    o = rng.integers(0, P, (K, 3)).astype(np.int32)
    o[3], o[4], o[5] = (0, 0, 0), (15, 15, 15), (0, 15, 7)
    out = patches_from_planes_plain(torch.from_numpy(table2),
                                    torch.from_numpy(slot),
                                    torch.from_numpy(o))
    np.testing.assert_array_equal(out.numpy(),
                                  _patches_oracle(table2, slot, o))
    assert out[0].sum() == 0


def _scan_inputs(rng, ground_gate):
    """A tiny-config scan's ring image and counter (projected by JAX) and a
    realistic-magnitude respond map with exact ties (relu zeros)."""
    cfg = tiny_test_config()
    kp = cfg.keypoint if ground_gate else dataclasses.replace(
        cfg.keypoint, ground_z_max=-200.0)
    pts, mask = synthetic_scan_pair(0, cfg)[:2]
    image, counter = project_to_spherical_ring(jnp.asarray(pts),
                                               jnp.asarray(mask), cfg.sensor)
    H, W = cfg.sensor.model_h, cfg.sensor.model_w
    respond = np.maximum(rng.normal(0, 10, (H, W, 8)), 0).astype(np.float32)
    return cfg, kp, np.array(image), np.array(counter), respond


@pytest.mark.parametrize("ground_gate", [True, False])
def test_keypoint_score_plain_matches_jax(rng, ground_gate):
    """keypoint_score_plain then the top-k against the JAX select_keypoints
    (its XLA branch, as on the CPU): the same saliency within 1e-6, the same
    key mask, and key pixel sets equal up to ties at the k-th score (in
    lax.top_k's order where the sets agree)."""
    cfg, kp, image, counter, respond = _scan_inputs(rng, ground_gate)
    _, pix_j, m_j, sal_j = (np.asarray(x) for x in jselect(
        jnp.asarray(image), jnp.asarray(counter), jnp.asarray(respond),
        cfg.sensor, kp))
    planes = torch.from_numpy(respond).permute(2, 0, 1).contiguous()
    ks = keypoint_score_plain(planes, torch.from_numpy(image),
                              torch.from_numpy(counter), cfg.sensor, kp)
    np.testing.assert_allclose(ks.saliency.numpy(), sal_j, rtol=1e-6,
                               atol=1e-6)
    vals, idx = top_k(ks.score.reshape(-1), kp.n_keypoints)
    m_t = torch.isfinite(vals).numpy()
    W = planes.shape[-1]
    pix_t = torch.stack([idx // W, idx % W], -1).numpy()
    assert m_j.sum() > 20
    np.testing.assert_array_equal(m_t, m_j)
    set_j = {tuple(p) for p in pix_j[m_j].tolist()}
    set_t = {tuple(p) for p in pix_t[m_t].tolist()}
    kth = sal_j[pix_j[m_j][-1, 0], pix_j[m_j][-1, 1]]
    for p in set_j ^ set_t:
        assert np.isclose(sal_j[p], kth, rtol=1e-5), p
    if set_j == set_t:
        np.testing.assert_array_equal(pix_t, pix_j)


def test_keypoint_score_ground_gate_removes_low_flat_pixels(rng):
    """The ground gate drops only pixels below ground_z_max whose 5x5 window
    has a z-extent of at most ground_extent_m, and it drops some here."""
    cfg, kp, image, counter, respond = _scan_inputs(rng, True)
    planes = torch.from_numpy(respond).permute(2, 0, 1).contiguous()
    args = (planes, torch.from_numpy(image), torch.from_numpy(counter),
            cfg.sensor)
    on = keypoint_score_plain(*args, kp, extras=True)
    off = keypoint_score_plain(
        *args, dataclasses.replace(kp, ground_z_max=-200.0), extras=True)
    assert torch.equal(on.saliency, off.saliency)
    assert torch.equal(on.zext, off.zext)
    dropped = torch.isfinite(off.score) & ~torch.isfinite(on.score)
    assert int(dropped.sum()) > 0
    H, W = planes.shape[-2:]
    z = torch.from_numpy(image)[:H, :W, 2]
    assert bool((z[dropped] < kp.ground_z_max).all())
    assert bool((on.zext[dropped] <= kp.ground_extent_m).all())
    kept = torch.isfinite(on.score)
    assert torch.equal(on.score[kept], off.score[kept])


def test_keypoint_score_extras_and_batch(rng):
    """The extras are saliency_map_plain's min_d2 / n_occ and
    window_z_extent's zext; a (B, C, H, W) batch equals its frames one by
    one; keypoint_score takes the plain version on the CPU."""
    cfg, kp, image, counter, respond = _scan_inputs(rng, True)
    planes = torch.from_numpy(respond).permute(2, 0, 1).contiguous()
    img, cnt = torch.from_numpy(image), torch.from_numpy(counter)
    H, W = planes.shape[-2:]
    ks = keypoint_score_plain(planes, img, cnt, cfg.sensor, kp, extras=True)
    occ = cnt[:H, :W] > 0
    md, no = saliency_map_plain(planes, occ)
    assert torch.equal(ks.min_d2, md) and torch.equal(ks.n_occ, no)
    z = img[:H, :W, 2]
    assert torch.equal(ks.zext, window_z_extent(z * occ, occ, 2))
    before = keypoint_score.launches
    kw = keypoint_score(planes, img, cnt, cfg.sensor, kp, extras=True)
    assert keypoint_score.launches == before
    for a, b in zip(kw, ks):
        assert torch.equal(a, b)
    planes2 = torch.stack([planes, planes.flip(-1)])
    img2, cnt2 = torch.stack([img, img.flip(1)]), torch.stack([cnt, cnt.flip(1)])
    kb = keypoint_score_plain(planes2, img2, cnt2, cfg.sensor, kp,
                              extras=True)
    for b in range(2):
        kf = keypoint_score_plain(planes2[b], img2[b], cnt2[b], cfg.sensor,
                                  kp, extras=True)
        for x, y in zip(kb, kf):
            assert torch.equal(x[b], y)
    with pytest.raises(ValueError):
        keypoint_score(planes, img[None], cnt, cfg.sensor, kp)


def test_jacobi_wrapper_takes_plain_on_cpu(rng):
    """max_eigvec_sym4x4_lanes (K3's wrapper) takes its plain version on
    the CPU, float64 and strided lanes too, and launches nothing, nor do
    the Horn solve and rotmat_to_quat above it; it checks its shape and
    device."""
    A = rng.normal(size=(40, 4, 4)).astype(np.float32)
    A = torch.from_numpy(A + A.transpose(0, 2, 1))
    before = se3.max_eigvec_sym4x4_lanes.launches
    for lanes in (A.permute(1, 2, 0).contiguous(), A.permute(1, 2, 0),
                  A.permute(1, 2, 0).double(), A[:1].permute(1, 2, 0)):
        out = se3.max_eigvec_sym4x4_lanes(lanes)
        assert out.dtype == lanes.dtype and out.shape == (4, lanes.shape[2])
        assert torch.equal(out, se3.max_eigvec_sym4x4_lanes_plain(lanes))
    p1 = torch.from_numpy(rng.normal(size=(3, 20, 3)).astype(np.float32))
    se3.solve_rigid_horn(p1 + 1.0, p1)
    se3.rotmat_to_quat(torch.eye(3).repeat(2, 1, 1))
    assert se3.max_eigvec_sym4x4_lanes.launches == before
    with pytest.raises(ValueError):
        se3.max_eigvec_sym4x4_lanes(A.permute(1, 2, 0)[:3])
    with pytest.raises(ValueError):
        se3.max_eigvec_sym4x4_lanes(torch.zeros((4, 4, 2), device="meta"))


def _knn_scan():
    """The tiny config's synthetic scan: ``(pts (4096, 3), mask)``."""
    from caelo_tpu_torch.config import tiny_test_config as ttiny
    from caelo_tpu_torch.data.synthetic import (make_scene, range_filter,
                                                sample_scene_points)
    from caelo_tpu_torch.ops.masking import pad_points

    cfg = ttiny()
    world = sample_scene_points(make_scene(0, n_boxes=25, extent=30.0), 0,
                                cfg.max_points)
    pts, mask = pad_points(range_filter(world.astype(np.float32), cfg.sensor),
                           cfg.max_points)
    return torch.from_numpy(pts), torch.from_numpy(mask)


def _knn_before_k4(pts, mask, k, chunk=512):
    """``_knn_neighbors`` as it was before it had a kernel."""
    p2m = torch.where(mask, (pts * pts).sum(-1), 1e12)
    out = []
    for qc in pts.split(chunk):
        q2 = (qc * qc).sum(-1)
        score = 2.0 * (qc @ pts.T) - p2m[None, :] - q2[:, None]
        vals, idx = torch.topk(score, k, dim=-1)
        idx, perm = idx.sort(-1)
        order = vals.gather(-1, perm).sort(dim=-1, descending=True,
                                           stable=True).indices
        out.append(idx.gather(-1, order))
    return torch.cat(out)


def _no_kernel(*args, **kw):
    raise AssertionError("the KNN wrapper reached the kernel library")


def test_knn_wrapper_takes_plain_on_cpu(monkeypatch):
    """``_knn_neighbors`` (K4's wrapper) takes its plain version for a CPU
    tensor, equal to the function before K4 on the tiny scan, and neither
    builds nor launches."""
    pts, mask = _knn_scan()
    monkeypatch.setattr(_build, "kernel", _no_kernel)
    monkeypatch.setattr(_build, "load_library", _no_kernel)
    before = bl._knn_neighbors.launches
    got = bl._knn_neighbors(pts, mask, 64)
    assert bl._knn_neighbors.launches == before
    assert got.dtype == torch.int64 and got.shape == (len(pts), 64)
    assert torch.equal(got, bl._knn_neighbors_plain(pts, mask, 64))
    assert torch.equal(got, _knn_before_k4(pts, mask, 64))


@pytest.mark.parametrize("bad", ["k0", "k129", "float64", "n4", "flat",
                                 "meta"])
def test_knn_wrapper_refuses(monkeypatch, bad):
    """What K4 does not take raises before any build or launch: k outside
    1 to 128, another type than float32, a shape other than (N, 3), a
    device other than the CPU or a CUDA card."""
    pts, mask = _knn_scan()
    pts, mask = pts[:300], mask[:300]
    monkeypatch.setattr(_build, "kernel", _no_kernel)
    monkeypatch.setattr(_build, "load_library", _no_kernel)
    args, err = {"k0": ((pts, mask, 0), ValueError),
                 "k129": ((pts, mask, 129), ValueError),
                 "float64": ((pts.double(), mask, 8), TypeError),
                 "n4": ((torch.cat([pts, pts[:, :1]], 1), mask, 8),
                        ValueError),
                 "flat": ((pts.reshape(-1), mask, 8), ValueError),
                 "meta": ((pts.to("meta"), mask.to("meta"), 8),
                          ValueError)}[bad]
    before = bl._knn_neighbors.launches
    with pytest.raises(err):
        bl._knn_neighbors(*args)
    assert bl._knn_neighbors.launches == before


def test_knn_visit_order():
    """K4's visiting order is a permutation with the valid points first,
    along the Morton curve, and a first tile for each query block inside
    the scan; masked blocks start where their own coordinates sort."""
    pts, mask = _knn_scan()
    perm, start = bl._knn_visit_order(pts, mask)
    n = len(pts)
    assert torch.equal(perm.sort().values, torch.arange(n))
    n_valid = int(mask.sum())
    assert 0 < n_valid < n
    assert bool(mask[perm[:n_valid]].all())
    assert not bool(mask[perm[n_valid:]].any())
    n_tiles = -(-n // bl._KNN_TILE)
    assert start.dtype == torch.int32
    assert start.shape == (-(-n // bl._KNN_QUERIES),)
    assert int(start.min()) >= 0 and int(start.max()) < n_tiles
    # the padding sits at the origin: its blocks start among the valid
    # points, not at their own tiles at the end
    first_masked = n_valid // bl._KNN_QUERIES + 1
    assert int(start[first_masked:].max()) < n_valid // bl._KNN_TILE
    # the curve's bit interleave, and neighbours along it lie near each other
    v = torch.arange(1 << bl._MORTON_BITS)
    assert torch.equal(bl._morton_spread(v), torch.tensor(
        [sum(((x >> b) & 1) << (3 * b) for b in range(bl._MORTON_BITS))
         for x in v.tolist()]))
    step = (pts[perm[1:n_valid]] - pts[perm[:n_valid - 1]]).norm(dim=1)
    shuffle = torch.randperm(n_valid - 1,
                             generator=torch.Generator().manual_seed(0))
    jump = (pts[perm[1:n_valid]] - pts[perm[shuffle]]).norm(dim=1)
    assert float(step.median()) < 0.2 * float(jump.median())


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def _c_entry_points():
    """``{name: [ctypes type of each parameter]}`` of every ``extern "C"
    int`` function in ``csrc/*.cu``."""
    found = {}
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src):
            types = [re.sub(r"\s*\w+$", "", p.strip())
                     for p in params.split(",")]
            found[name] = [_C_TYPES[t] for t in types]
    return found


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_ctypes_signature_matches_the_c_entry_point(name):
    """Each entry point the library binds is declared in ``csrc/`` with
    the parameters ``_build._SIGNATURES`` gives ctypes: a pointer or a
    64-bit count passed as a 32-bit int would be cut on the card."""
    assert _c_entry_points()[name] == _build._SIGNATURES[name]


def test_every_c_entry_point_is_bound():
    """The K3 source is there, and every entry point in ``csrc/`` has its
    ctypes signature, so none is called with ctypes' default int
    arguments."""
    assert os.path.exists(os.path.join(_build.CSRC, "sym4_jacobi.cu"))
    assert set(_c_entry_points()) == set(_build._SIGNATURES)
    assert "caelo_max_eigvec_sym4x4" in _build._SIGNATURES
