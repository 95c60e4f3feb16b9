"""The port's frame-by-frame odometry and its windowed drivers against the
JAX package (split from ``tests/test_torch_cli.py``, whose helpers it
uses): ``run_odometry`` fed JAX's RANSAC draws, and the generator input
and ``progress`` of ``run_odometry_windowed`` and ``preprocess_to_store``.

Tolerances: ``run_odometry`` with JAX's draws: the same success flags,
inlier counts and inlier pairs, rels within 1e-3 deg and 1e-3 m (as the
window test of tests/test_torch_slice.py).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from caelo_tpu.frontend.odometry import run_odometry as jrun_odometry
from caelo_tpu.models.patch_encoder import PatchEncoder as JEncoder
from caelo_tpu.models.respond_net import RespondLayer as JRespond
from caelo_tpu_torch.data.artifacts import ArtifactStore
from caelo_tpu_torch.frontend.odometry import (run_odometry,
                                               run_odometry_windowed)
from caelo_tpu_torch.models import weights_io
from caelo_tpu_torch.pipeline import preprocess_to_store
from test_torch_cli import CFG, CFG_RETRY, _jax_sequential_samples
from test_torch_slice import _chordal_deg, _scans


@pytest.fixture(scope="module")
def params():
    key = jax.random.key(0)
    f32 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
    rp = JRespond().init(key, jnp.zeros(
        (1, CFG.sensor.model_h, CFG.sensor.model_w, 3), jnp.float32))
    ep = JEncoder().init(key, jnp.zeros((1, 16, 16, 16), jnp.float32))
    return f32(rp), f32(ep)


def test_run_odometry_matches_jax(params):
    """The frame-by-frame driver with JAX's draws injected: the same
    success flags, inlier counts and inlier pairs, and per-pair rels within
    1e-3 deg / 1e-3 m, with the motion-prior retry running."""
    rp, ep = params
    scans = _scans(4)
    cfg = CFG_RETRY
    jres = jrun_odometry(iter(scans), rp, ep, cfg=cfg, seed=0)
    samples, retried = _jax_sequential_samples(scans, rp, ep, cfg, 0)
    assert retried.any()                   # the retry pass runs
    net, enc = weights_io.build_models(rp, ep, "cpu", cfg)
    seen = []
    tres = run_odometry(iter(scans), net, enc, cfg=cfg, seed=0,
                        samples=samples, progress=seen.append)
    assert seen == [0, 1, 2, 3]
    np.testing.assert_array_equal(tres.successes, jres.successes)
    assert tres.successes.any()
    np.testing.assert_array_equal(tres.n_inliers, jres.n_inliers)
    assert _chordal_deg(tres.rel_Rs, jres.rel_Rs).max() < 1e-3
    assert np.linalg.norm(tres.rel_ts - jres.rel_ts, axis=1).max() < 1e-3
    np.testing.assert_allclose(tres.poses, jres.poses, atol=1e-3)
    for (a0, a1), (b0, b1) in zip(tres.inlier_pairs, jres.inlier_pairs):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)


def test_windowed_drivers_take_generators_and_report_progress(tmp_path):
    """run_odometry_windowed and preprocess_to_store take a generator (as
    the CLI passes KittiOdometry.iter_scans) with the same result as a
    list, and call progress with the last frame of each window, as JAX's
    do."""
    net, enc = weights_io.build_models(*weights_io.random_flax_params(0),
                                       "cpu", CFG)
    scans = _scans(4)
    ref, _ = run_odometry_windowed(scans, net, enc, cfg=CFG, window=3)
    seen = []
    got, _ = run_odometry_windowed((s for s in scans), net, enc, cfg=CFG,
                                   window=3, progress=seen.append)
    assert seen == [2, 3]
    np.testing.assert_array_equal(got.poses, ref.poses)
    np.testing.assert_array_equal(got.successes, ref.successes)
    seen.clear()
    store = ArtifactStore(str(tmp_path / "art"))
    odo = preprocess_to_store((s for s in scans), net, enc, np.eye(3),
                              np.zeros(3), CFG, store, "00", window=3,
                              progress=seen.append)
    assert seen == [2, 3]
    np.testing.assert_array_equal(odo.poses, ref.poses)
    assert store.frames_done("features", "00") == 4
