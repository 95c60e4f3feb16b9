"""The port's front end against the jitted JAX package at the full default
config, ``PipelineConfig()`` (131,072 points, 1,024 keypoints), where
points fall within an ulp of bin edges every frame: (a) the features of
both frames of ``synthetic_scan_pair(0)``, keypoints exact and descriptors
to rtol / atol 1e-5; (b) on seeds 0 and 1, ``voxelize``'s lists,
``keypoint_voxels`` of every in-bounds point at each scale and the ring
image (its range channel too) and counter, all exact; on a ray-cast pair,
where every beam sits on a row edge, the ring image and the ScanContext
signature exact; (c) the pair through ``register_pair`` with JAX's own
RANSAC draws injected, ``success`` and ``n_inliers`` equal and R, t
within 1e-5.  Same random Flax parameters as
``tests/test_torch_slice.py``; stage comparisons from
``tests/parity_pairs.py``."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from caelo_tpu.backend.scancontext import scan_context as jscan_context
from caelo_tpu.data.synthetic import synthetic_scan_pair
from caelo_tpu.models.patch_encoder import PatchEncoder as JEncoder
from caelo_tpu.models.respond_net import RespondLayer as JRespond
from caelo_tpu.projection.spherical import (
    project_to_spherical_ring as jproject)
from caelo_tpu.voxel import grid as jgrid
from caelo_tpu_torch.backend.scancontext import scan_context as tscan_context
from caelo_tpu_torch.config import PipelineConfig
from caelo_tpu_torch.data.hard_synthetic import generate_benchmark
from caelo_tpu_torch.models.weights_io import build_models
from caelo_tpu_torch.projection.spherical import (
    project_to_spherical_ring as tproject)
from caelo_tpu_torch.voxel import grid as tgrid
from parity_pairs import features_stage, pair_stages

CFG = PipelineConfig()
VC = CFG.voxel


@pytest.fixture(scope="module")
def features():
    """Both frames of ``synthetic_scan_pair(0)`` through
    ``extract_frame_features`` of both packages: ``[(stage, port
    FrameFeatures, JAX FrameFeatures)] * 2``.  The parameters are
    ``tests/test_torch_slice.py``'s (the same modules, key and
    initialisers), made faster: a convolution's parameters do not depend
    on its input's size, and ``init`` under jit gives the same values."""
    key = jax.random.key(0)
    f32 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
    rp = f32(JRespond().init(key, jnp.zeros((1, 8, 8, 3), jnp.float32)))
    ep = f32(jax.jit(JEncoder().init)(key, jnp.zeros((1, 16, 16, 16),
                                                     jnp.float32)))
    nets = build_models(rp, ep, "cpu", CFG)
    s0, m0, s1, m1 = synthetic_scan_pair(0, CFG)[:4]
    with torch.no_grad():
        return [features_stage(rp, ep, nets, s, m, CFG)
                for s, m in ((s0, m0), (s1, m1))]


def test_frame_features_match_jitted_jax(features):
    for (name, ok, detail), ft, fj in features:
        assert int(ft.mask.sum()) == CFG.keypoint.n_keypoints
        assert ok, f"{name}: {detail}"
        np.testing.assert_allclose(ft.descriptors.numpy(),
                                   np.asarray(fj.descriptors), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_binning_matches_jitted_jax(seed):
    half = np.array([VC.visible_length, VC.visible_width, VC.visible_height],
                    np.float32)
    kv = jax.jit(jgrid.keypoint_voxels, static_argnums=(1, 2))
    scans = synthetic_scan_pair(seed, CFG)[:4]
    for pts, mask in (scans[:2], scans[2:]):
        pj, pt = jnp.asarray(pts), torch.from_numpy(pts)
        mj, mt = jnp.asarray(mask), torch.from_numpy(mask)
        pyr_j = jgrid.voxelize(pj[:, :3], mj, VC)
        pyr_t = tgrid.voxelize(pt[:, :3], mt, VC)
        inside = pts[mask & (np.abs(pts[:, :3]) <= half).all(1), :3]
        for s in range(3):
            np.testing.assert_array_equal(pyr_t.coords[s].numpy(),
                                          np.asarray(pyr_j.coords[s]))
            np.testing.assert_array_equal(pyr_t.masks[s].numpy(),
                                          np.asarray(pyr_j.masks[s]))
            assert int(pyr_t.counts[s]) == int(pyr_j.counts[s]) > 0
            np.testing.assert_array_equal(
                tgrid.keypoint_voxels(torch.from_numpy(inside), s,
                                      VC).numpy(),
                np.asarray(kv(jnp.asarray(inside), s, VC)))
        img_j, cnt_j = jproject(pj, mj, CFG.sensor)
        img_t, cnt_t = tproject(pt, mt, CFG.sensor)
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
        np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))


def test_ray_cast_binning_matches_jitted_jax():
    """A ray-cast pair of the 520-frame circuit (seed 0, frames 100-101):
    every beam's elevation sits on a ring-image row edge, where asin's
    rounding decides the row.  The ring image and counter, and the
    ScanContext signature (hypot, atan2), exact."""
    ((s0, m0), (s1, m1)), _ = generate_benchmark(
        n_frames=520, seed=0, cfg=CFG, frame_range=(100, 102))
    for pts, mask in ((s0, m0), (s1, m1)):
        pj, pt = jnp.asarray(pts), torch.from_numpy(pts)
        mj, mt = jnp.asarray(mask), torch.from_numpy(mask)
        img_j, cnt_j = jproject(pj, mj, CFG.sensor)
        img_t, cnt_t = tproject(pt, mt, CFG.sensor)
        np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
        np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))
        np.testing.assert_array_equal(
            tscan_context(pt[:, :3], mt).numpy(),
            np.asarray(jscan_context(pj[:, :3], mj)))


def test_register_pair_with_jax_draws(features):
    (_, ft0, fj0), (_, ft1, fj1) = features
    with torch.no_grad():
        stages, rt, rj = pair_stages(ft0, ft1, fj0, fj1, CFG,
                                    jax.random.key(0))
    for name, ok, detail in stages:
        assert ok, f"{name}: {detail}"
    assert bool(rt.success)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), rtol=1e-5,
                               atol=1e-5)
