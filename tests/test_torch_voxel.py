"""Port parity: the voxel pyramid and the 3-scale bit-table patch query
(dense slot map at scales 1-2, bitmap popcount-rank at scale 0), bit-exact
against the JAX package, plus the popcount helper."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from caelo_tpu.config import tiny_test_config
from caelo_tpu.data.synthetic import synthetic_scan_pair
from caelo_tpu.voxel import grid as jgrid
from caelo_tpu_torch.voxel import grid as tgrid

CFG = tiny_test_config()


@pytest.fixture(scope="module")
def scan():
    pts, mask = synthetic_scan_pair(0, CFG)[:2]
    return pts, mask


def _keypoints(pts, mask, rng, K=128):
    idx = rng.choice(np.nonzero(mask)[0], K, replace=False)
    kp = (pts[idx, :3] + rng.normal(0, 0.05, (K, 3))).astype(np.float32)
    km = rng.uniform(size=K) < 0.9
    kp[~km] = 0.0
    return kp, km


def test_popcount32_matches_numpy(rng):
    words = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    words[:6] = [0, -1, -2**31, 2**31 - 1, 1, -2**31 + 1]   # bit 31 set
    ref = np.array([bin(int(w) & 0xFFFFFFFF).count("1") for w in words])
    out = tgrid.popcount32(torch.from_numpy(words))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_voxelize_matches_jax(scan):
    pts, mask = scan
    ref = jgrid.voxelize(jnp.asarray(pts[:, :3]), jnp.asarray(mask), CFG.voxel)
    out = tgrid.voxelize(torch.from_numpy(pts[:, :3]), torch.from_numpy(mask),
                         CFG.voxel)
    for s in range(3):
        np.testing.assert_array_equal(out.coords[s].numpy(),
                                      np.asarray(ref.coords[s]))
        np.testing.assert_array_equal(out.masks[s].numpy(),
                                      np.asarray(ref.masks[s]))
        assert int(out.counts[s]) == int(ref.counts[s]) > 0


def test_bitgrid_scatter_plan_matches_jax(scan):
    pts, mask = scan
    pyr = jgrid.voxelize(jnp.asarray(pts[:, :3]), jnp.asarray(mask), CFG.voxel)
    for s, slots in enumerate((CFG.voxel.bitgrid_slots[0], 3)):
        idx_j, bits_j = jgrid.bitgrid_scatter_plan(
            pyr.coords[s], pyr.masks[s], CFG.voxel, s, slots)
        idx_t, bits_t = tgrid.bitgrid_scatter_plan(
            torch.from_numpy(np.array(pyr.coords[s])),
            torch.from_numpy(np.array(pyr.masks[s])), CFG.voxel, s, slots)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))


@pytest.mark.parametrize("plane_gather", [False, True])
def test_extract_patches_matches_jax(scan, rng, plane_gather):
    pts, mask = scan
    kp, km = _keypoints(pts, mask, rng)
    vcfg = dataclasses.replace(CFG.voxel, use_pallas_plane_gather=plane_gather)
    pyr = jgrid.voxelize(jnp.asarray(pts[:, :3]), jnp.asarray(mask), vcfg)
    ref = jgrid.extract_patches(jnp.asarray(kp), jnp.asarray(km), pyr, vcfg)
    tpyr = tgrid.voxelize(torch.from_numpy(pts[:, :3]), torch.from_numpy(mask),
                          vcfg)
    out = tgrid.extract_patches(torch.from_numpy(kp), torch.from_numpy(km),
                                tpyr, vcfg)
    for s in range(3):
        r = np.asarray(ref[s])
        np.testing.assert_array_equal(out[s].numpy(), r)
        assert r[km].sum() > 0 and r[~km].sum() == 0


def test_slot_lookup_saturates_like_jax(scan, rng):
    """Past the slot capacity, supercells drop to the zero plane in both the
    popcount-rank (scale 0) and the dense-map (scale 1) lookups."""
    pts, mask = scan
    kp, km = _keypoints(pts, mask, rng)
    vcfg = dataclasses.replace(CFG.voxel, bitgrid_slots=(40, 3, 512))
    pyr = jgrid.voxelize(jnp.asarray(pts[:, :3]), jnp.asarray(mask), vcfg)
    ref = jgrid.extract_patches(jnp.asarray(kp), jnp.asarray(km), pyr, vcfg)
    tpyr = tgrid.voxelize(torch.from_numpy(pts[:, :3]), torch.from_numpy(mask),
                          vcfg)
    out = tgrid.extract_patches(torch.from_numpy(kp), torch.from_numpy(km),
                                tpyr, vcfg)
    for s in range(3):
        np.testing.assert_array_equal(out[s].numpy(), np.asarray(ref[s]))
