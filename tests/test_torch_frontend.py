"""Port parity: keypoint selection (saliency, gates, top-k) and RANSAC fed the
exact ``jax.random.categorical`` draw, against the JAX package."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from caelo_tpu.config import RansacConfig, tiny_test_config
from caelo_tpu.data.synthetic import synthetic_scan_pair
from caelo_tpu.frontend.ransac import ransac_rigid as jransac
from caelo_tpu.ops.nms import select_keypoints as jselect
from caelo_tpu.projection.spherical import project_to_spherical_ring
from caelo_tpu_torch.frontend import ransac as tr
from caelo_tpu_torch.ops.nms import select_keypoints as tselect


@pytest.mark.parametrize("pallas_nms", [True, False])
def test_select_keypoints_matches_jax(rng, pallas_nms):
    cfg = tiny_test_config()
    kp = dataclasses.replace(cfg.keypoint, use_pallas_nms=pallas_nms)
    pts, mask = synthetic_scan_pair(0, cfg)[:2]
    image, counter = project_to_spherical_ring(jnp.asarray(pts),
                                               jnp.asarray(mask), cfg.sensor)
    H, W = cfg.sensor.model_h, cfg.sensor.model_w
    # realistic-magnitude respond map, with exact ties as neighbours share
    # values (relu zeros)
    respond = np.maximum(rng.normal(0, 10, (H, W, 8)), 0).astype(np.float32)
    ref = jselect(image, counter, jnp.asarray(respond), cfg.sensor, kp)
    out = tselect(torch.from_numpy(np.array(image)),
                  torch.from_numpy(np.array(counter)),
                  torch.from_numpy(respond), cfg.sensor, kp)
    pts_j, pix_j, m_j, sal_j = (np.asarray(x) for x in ref)
    pts_t, pix_t, m_t, sal_t = (x.numpy() for x in out)
    np.testing.assert_allclose(sal_t, sal_j, rtol=1e-6, atol=1e-6)
    assert m_j.sum() > 20
    np.testing.assert_array_equal(m_t, m_j)
    # index sets equal except ties at the k-th score; lax.top_k's order
    # (value descending, lower index first) elsewhere
    set_j = {tuple(p) for p in pix_j[m_j].tolist()}
    set_t = {tuple(p) for p in pix_t[m_t].tolist()}
    kth = sal_j[pix_j[m_j][-1, 0], pix_j[m_j][-1, 1]]
    for p in set_j ^ set_t:
        assert np.isclose(sal_j[p], kth, rtol=1e-5), p
    if set_j == set_t:
        np.testing.assert_array_equal(pix_t, pix_j)
        np.testing.assert_array_equal(pts_t, pts_j)


def _pairs(rng, K=128, outliers=0.4):
    a = 0.05
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                  [0, 0, 1]])
    t = np.array([1.0, 0.2, 0.0])
    p1 = rng.uniform(-30, 30, (K, 3))
    p0 = p1 @ R.T + t + rng.normal(0, 0.05, (K, 3))
    out = rng.uniform(size=K) < outliers
    p0[out] += rng.uniform(-5, 5, (out.sum(), 3))
    mask = rng.uniform(size=K) < 0.95
    dist = rng.uniform(0, 1, K)
    return (p0.astype(np.float32), p1.astype(np.float32), mask,
            dist.astype(np.float32))


def _jax_samples(key, mask, dist, cfg: RansacConfig):
    """The draw of caelo_tpu/frontend/ransac.py:91-101, made here so the
    same (H, S) indices can be fed to the port."""
    K = mask.shape[0]
    n_valid = jnp.sum(mask)
    n_top = jnp.maximum((cfg.sample_top_frac * n_valid).astype(jnp.int32),
                        4 * cfg.sample_size)
    d = jnp.where(mask, dist, jnp.inf)
    cutoff = jnp.sort(d)[jnp.clip(n_top - 1, 0, K - 1)]
    logits = jnp.where(mask & (d <= cutoff), 0.0, -jnp.inf)
    return np.array(jax.random.categorical(
        key, logits, shape=(cfg.n_hypotheses, cfg.sample_size)))


@pytest.mark.parametrize("seed,outliers", [(0, 0.4), (1, 0.7), (2, 0.97)])
def test_ransac_with_injected_samples_matches_jax(seed, outliers):
    rng = np.random.default_rng(seed)
    cfg = RansacConfig(n_hypotheses=256, min_inlier_abs=20)
    p0, p1, mask, dist = _pairs(rng, outliers=outliers)
    key = jax.random.key(seed)
    ref = jransac(key, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(mask),
                  cfg, pair_dist=jnp.asarray(dist))
    samples = _jax_samples(key, jnp.asarray(mask), jnp.asarray(dist), cfg)
    out = tr.ransac_rigid(torch.from_numpy(p0), torch.from_numpy(p1),
                          torch.from_numpy(mask), cfg,
                          pair_dist=torch.from_numpy(dist),
                          samples=torch.from_numpy(samples))
    assert bool(out.success) == bool(ref.success)
    assert int(out.n_inliers) == int(ref.n_inliers)
    np.testing.assert_array_equal(out.inlier_mask.numpy(),
                                  np.asarray(ref.inlier_mask))
    np.testing.assert_allclose(out.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(ref.t), atol=1e-4)
    assert float(out.threshold) == float(ref.threshold)


def test_ransac_batched_equals_per_pair(rng):
    cfg = RansacConfig(n_hypotheses=128, min_inlier_abs=20)
    batch = [_pairs(rng) for _ in range(3)]
    p0, p1, m, d = (torch.from_numpy(np.stack(x)) for x in zip(*batch))
    sok = tr.sample_candidates(m, d, cfg)
    samples = tr.draw_samples(sok, cfg, torch.Generator().manual_seed(0))
    assert sok.gather(1, samples.view(3, -1)).all()    # only candidates drawn
    res = tr.ransac_rigid(p0, p1, m, cfg, pair_dist=d, samples=samples)
    for b in range(3):
        one = tr.ransac_rigid(p0[b], p1[b], m[b], cfg, pair_dist=d[b],
                              samples=samples[b])
        for a, e in zip(one, res):
            torch.testing.assert_close(a, e[b], atol=1e-5, rtol=1e-5)
