"""The port's three patch routes against the JAX package on the CPU, at
``small_test_config()`` on a synthetic scan: the KNN route, the supercell
window route and the bit-table route with ``presorted_pyramid=False`` (on
a shuffled pyramid), each scale alone and through ``extract_patches``.
Every comparison is exact: the window and bit-table routes are integer
work, and the KNN route's float32 score rounds on the CPU as JAX's does
(the same matmul result; ties at the k-th place broken by the lower
index, as ``lax.top_k`` breaks them)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from caelo_tpu.config import small_test_config
from caelo_tpu.data.synthetic import synthetic_scan_pair
from caelo_tpu.voxel import grid as jgrid
from caelo_tpu_torch.voxel import grid as tgrid

CFG = small_test_config()
VC = CFG.voxel
K = 256


@pytest.fixture(scope="module")
def scene():
    """The scan's pyramid (JAX's; the port's voxelize is held equal to it in
    tests/test_torch_voxel.py), the same pyramid with its rows shuffled,
    and K keypoints near scan points, some masked out."""
    pts, mask = synthetic_scan_pair(0, CFG)[:2]
    pyr = jgrid.voxelize(jnp.asarray(pts[:, :3]), jnp.asarray(mask), VC)
    rng = np.random.default_rng(0)
    idx = rng.choice(np.nonzero(mask)[0], K, replace=False)
    kp = (pts[idx, :3] + rng.normal(0, 0.05, (K, 3))).astype(np.float32)
    km = rng.uniform(size=K) < 0.9
    kp[~km] = 0.0
    coords = [np.array(c) for c in pyr.coords]
    masks = [np.array(m) for m in pyr.masks]
    perms = [rng.permutation(len(c)) for c in coords]
    shuffled = ([c[p] for c, p in zip(coords, perms)],
                [m[p] for m, p in zip(masks, perms)])
    return kp, km, (coords, masks), shuffled


def _kv(kp, s, vcfg):
    return np.array(jgrid.keypoint_voxels(jnp.asarray(kp), s, vcfg))


@functools.lru_cache(maxsize=None)
def _jax_route(name, vcfg, *static):
    fn = getattr(jgrid, name)
    return jax.jit(lambda kv, km, v, vm: fn(kv, km, v, vm, vcfg, *static))


def _both(name, kp, km, coords, masks, s, vcfg, *static):
    """The JAX route and the port's on the same inputs at scale ``s``."""
    kv = _kv(kp, s, vcfg)
    ref = np.asarray(_jax_route(name, vcfg, *static)(
        jnp.asarray(kv), jnp.asarray(km), jnp.asarray(coords[s]),
        jnp.asarray(masks[s])))
    out = getattr(tgrid, name)(
        torch.from_numpy(kv), torch.from_numpy(km),
        torch.from_numpy(coords[s]), torch.from_numpy(masks[s]), vcfg,
        *static)
    return out.numpy(), ref


@pytest.mark.parametrize("s", [0, 1, 2])
def test_knn_route_matches_jax(scene, s):
    """_patches_one_scale at each scale (patch_knn 128 of 16384 / 8192 /
    2048 padded voxels, two 128-keypoint chunks): patches equal."""
    kp, km, (coords, masks), _ = scene
    out, ref = _both("_patches_one_scale", kp, km, coords, masks, s, VC)
    np.testing.assert_array_equal(out, ref)
    assert ref[km].sum() > 0 and ref[~km].sum() == 0


def test_knn_topk_breaks_ties_by_lower_index():
    """_knn_topk on rows full of exact ties (integer distances) and signed
    scores takes lax.top_k's set: the k largest, the lower index first
    among equals."""
    rng = np.random.default_rng(3)
    score = rng.integers(-6, 6, (8, 300)).astype(np.float32) * 2.5
    score[0, :] = -3.0
    for k in (1, 17, 64):
        got = tgrid._knn_topk(torch.from_numpy(score), k).numpy()
        want = np.asarray(jax.lax.top_k(jnp.asarray(score), k)[1])
        for a, b in zip(got, want):
            assert set(a.tolist()) == set(b.tolist())


def test_neighbor_ties_takes_keypoint_queries(scene):
    """eval/keypoint_flips.py's neighbor_ties on the patch KNN's lists
    (keypoint voxels against scale-0 voxels): equal lists pass with no row
    counted; swapping a row's k-th-place neighbour for the nearest voxel
    outside its list, within the bound of the k-th score, passes as a tie;
    a swap for a far voxel raises."""
    from caelo_tpu_torch.eval.keypoint_flips import neighbor_ties

    kp, km, (coords, masks), _ = scene
    kv = torch.from_numpy(_kv(kp, 0, VC))
    vox, vm = torch.from_numpy(coords[0]), torch.from_numpy(masks[0])
    idx = tgrid.knn_indices(kv, vox, vm, VC)
    kw = dict(queries=kv, query_mask=torch.from_numpy(km))
    assert neighbor_ties(vox, vm, idx, idx.clone(), **kw) == 0
    v, q = vox.double(), kv.double()
    i = int(np.nonzero(km)[0][0])
    d2 = ((v - q[i]) ** 2).sum(1)
    outside = torch.ones(len(v), dtype=torch.bool)
    outside[idx[i]] = False
    near = int(torch.argmin(torch.where(vm & outside, d2, np.inf)))
    assert abs(d2[near] - d2[idx[i]].max()) <= 1e-6 * (
        (q[i] ** 2).sum() + (v[near] ** 2).sum())
    swapped = idx.clone()
    swapped[i, int(torch.argmax(d2[idx[i]]))] = near
    assert neighbor_ties(vox, vm, idx, swapped, **kw) == 1
    far = idx.clone()
    far[i, 0] = int(torch.argmax(torch.where(vm & outside, d2, -1.0)))
    with pytest.raises(AssertionError, match="beyond a tie"):
        neighbor_ties(vox, vm, idx, far, **kw)


@pytest.mark.parametrize("shuffled", [False, True])
def test_window_route_matches_jax(scene, shuffled):
    """_patches_one_scale_window at each scale: on voxelize's order
    (presorted_pyramid True) and on the shuffled pyramid with
    presorted_pyramid False (a stable sort in both packages); 256
    keypoints in two chunks of patch_query_chunk 128.  Patches equal."""
    kp, km, base, shuf = scene
    coords, masks = shuf if shuffled else base
    vcfg = dataclasses.replace(VC, presorted_pyramid=not shuffled)
    for s in range(3):
        out, ref = _both("_patches_one_scale_window", kp, km, coords, masks,
                         s, vcfg, s)
        np.testing.assert_array_equal(out, ref, err_msg=f"scale {s}")
        assert ref[km].sum() > 0 and ref[~km].sum() == 0


def test_window_route_caps_and_unchunked_match_jax(scene):
    """Supercell runs longer than their cap (caps 4 / 6 / 8, far below the
    runs' lengths: the cap keeps the first voxels of each run, in the
    stable sort's order on the shuffled pyramid): patches equal, and the
    caps cut voxels out of the patches.  (A keypoint count that
    patch_query_chunk does not divide, one unchunked query, runs in
    test_extract_patches_dispatch_matches_jax.)"""
    kp, km, base, (coords, masks) = scene
    vcfg = dataclasses.replace(VC, presorted_pyramid=False,
                               supercell_caps=(4, 6, 8))
    full = dataclasses.replace(VC, presorted_pyramid=False)
    for s in range(3):
        out, ref = _both("_patches_one_scale_window", kp, km, coords, masks,
                         s, vcfg, s)
        np.testing.assert_array_equal(out, ref, err_msg=f"scale {s}")
        uncapped = getattr(tgrid, "_patches_one_scale_window")(
            torch.from_numpy(_kv(kp, s, full)), torch.from_numpy(km),
            torch.from_numpy(coords[s]), torch.from_numpy(masks[s]), full, s)
        assert out.sum() < uncapped.sum()


@pytest.mark.parametrize("s", [0, 1])
def test_bitgrid_unsorted_pyramid_matches_jax(scene, s):
    """The bit-table route with presorted_pyramid False on the shuffled
    pyramid, at the rank-bitmap scale (0) and a dense-map scale (1), K2's
    plain version on the CPU: patches equal to JAX's, and to the port's
    presorted route on voxelize's order."""
    kp, km, (coords, masks), (sc, sm) = scene
    vcfg = dataclasses.replace(VC, presorted_pyramid=False)
    slots = VC.bitgrid_slots[s]
    out, ref = _both("_patches_one_scale_bitgrid", kp, km, sc, sm, s, vcfg,
                     s, slots)
    np.testing.assert_array_equal(out, ref)
    sorted_out = tgrid._patches_one_scale_bitgrid(
        torch.from_numpy(_kv(kp, s, VC)), torch.from_numpy(km),
        torch.from_numpy(coords[s]), torch.from_numpy(masks[s]), VC, s,
        slots)
    np.testing.assert_array_equal(out, sorted_out.numpy())
    assert ref[km].sum() > 0


@pytest.mark.parametrize("route,n", [
    (dict(bitgrid_slots=(0, 6144, 0)), K),
    (dict(bitgrid_slots=(0, 6144, 0), presorted_pyramid=False), 200),
    (dict(patch_method="knn"), K),
])
def test_extract_patches_dispatch_matches_jax(scene, route, n):
    """extract_patches dispatches per scale as JAX does: mixed
    bitgrid_slots (the window route at scales 0 and 2, the bit table at
    scale 1), the same on the shuffled pyramid for 200 keypoints (which
    patch_query_chunk does not divide: one unchunked query), and the KNN
    route for any other patch_method.  Patches equal at all three
    scales."""
    kp, km, base, shuf = scene
    kp, km = kp[:n], km[:n]
    vcfg = dataclasses.replace(VC, **route)
    coords, masks = base if vcfg.presorted_pyramid else shuf
    jpyr = jgrid.VoxelPyramid(tuple(jnp.asarray(c) for c in coords),
                              tuple(jnp.asarray(m) for m in masks),
                              (0, 0, 0))
    tpyr = tgrid.VoxelPyramid(tuple(torch.from_numpy(c) for c in coords),
                              tuple(torch.from_numpy(m) for m in masks),
                              (0, 0, 0))
    ref = jgrid.extract_patches(jnp.asarray(kp), jnp.asarray(km), jpyr, vcfg)
    out = tgrid.extract_patches(torch.from_numpy(kp), torch.from_numpy(km),
                                tpyr, vcfg)
    for s in range(3):
        np.testing.assert_array_equal(out[s].numpy(), np.asarray(ref[s]),
                                      err_msg=f"scale {s}")
