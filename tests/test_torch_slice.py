"""The port's main path against the JAX package: per-frame features, and a
4-frame windowed odometry run fed JAX's own RANSAC draws; plus import
hygiene (the port never imports JAX)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from caelo_tpu.config import tiny_test_config
from caelo_tpu.data.synthetic import (make_scene, range_filter,
                                      sample_scene_points, synthetic_scan_pair)
from caelo_tpu.frontend import registration as jreg
from caelo_tpu.frontend.matching import match_descriptors as jmatch
from caelo_tpu.frontend.odometry import run_odometry_windowed as jrun
from caelo_tpu.models.patch_encoder import PatchEncoder as JEncoder
from caelo_tpu.models.respond_net import RespondLayer as JRespond
from caelo_tpu.ops.masking import pad_points
from caelo_tpu_torch.frontend import registration as treg
from caelo_tpu_torch.frontend.odometry import run_odometry_windowed as trun
from caelo_tpu_torch.frontend.odometry import window_starts
from caelo_tpu_torch.models.weights_io import build_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = tiny_test_config()
# a stricter inlier floor than tiny_test_config's makes one pass-1
# registration fail, so the motion-prior retry runs too
CFG_RETRY = dataclasses.replace(
    CFG, ransac=dataclasses.replace(CFG.ransac, min_inlier_abs=40))


@pytest.fixture(scope="module")
def params():
    key = jax.random.key(0)
    f32 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
    rp = JRespond().init(key, jnp.zeros(
        (1, CFG.sensor.model_h, CFG.sensor.model_w, 3), jnp.float32))
    ep = JEncoder().init(key, jnp.zeros((1, 16, 16, 16), jnp.float32))
    return f32(rp), f32(ep)


def _assert_features_match(ft, fj):
    """Keypoints (order included) exact, descriptors to rtol/atol 1e-5."""
    np.testing.assert_array_equal(ft.mask.numpy(), np.asarray(fj.mask))
    np.testing.assert_array_equal(ft.key_pixels.numpy(),
                                  np.asarray(fj.key_pixels))
    np.testing.assert_array_equal(ft.key_pts.numpy(), np.asarray(fj.key_pts))
    np.testing.assert_allclose(ft.descriptors.numpy(),
                               np.asarray(fj.descriptors), rtol=1e-5, atol=1e-5)


def test_extract_frame_features_matches_jax(params):
    rp, ep = params
    s0, m0, s1, m1 = synthetic_scan_pair(0, CFG)[:4]
    respond_net, encoder = build_models(rp, ep, "cpu", CFG)
    for pts, mask in ((s0, m0), (s1, m1)):
        fj = jreg.extract_frame_features(rp, ep, jnp.asarray(pts),
                                         jnp.asarray(mask), CFG)
        ft = treg.extract_frame_features(respond_net, encoder,
                                         torch.from_numpy(pts),
                                         torch.from_numpy(mask), CFG)
        assert int(ft.mask.sum()) > 50
        _assert_features_match(ft, fj)


def _scans(n=4):
    scene = make_scene(seed=0, n_boxes=25, extent=30.0)
    world = sample_scene_points(scene, seed=0, n_points=CFG.max_points)
    rng = np.random.default_rng(0)
    scans = []
    for i in range(n):
        t = np.array([0.8 * i, 0.05 * i, 0.0])
        local = range_filter((world - t).astype(np.float32), CFG.sensor)
        local = local + rng.normal(0, 0.005, local.shape).astype(np.float32)
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        scans.append(pad_points(np.concatenate([local, refl], 1),
                                CFG.max_points))
    return scans


def _jax_window_samples(feats, n, window, seed, cfg):
    """The (H, S) draws the JAX window program makes for every pair of both
    passes: keys from jax.random.split per window and per pair
    (parallel/pipeline.py:110), fold_in(key, 1) for the retry (:130), and
    the logits of frontend/ransac.py:91-100 from JAX's own matches.  Also
    returns JAX's pass-1 success per pair."""
    H, S = cfg.ransac.n_hypotheses, cfg.ransac.sample_size

    def draw(key, f0, f1, prior=None):
        kw = {}
        if prior is not None:
            kw = dict(pts0=f0.key_pts, pts1=f1.key_pts, prior_R=prior[0],
                      prior_t=prior[1], gate_m=cfg.prior_gate_m)
        _, pm, pd = jmatch(f0.descriptors, f0.mask, f1.descriptors, f1.mask,
                           ratio=cfg.match_ratio, **kw)
        n_top = jnp.maximum(
            (cfg.ransac.sample_top_frac * jnp.sum(pm)).astype(jnp.int32), 4 * S)
        d = jnp.where(pm, pd, jnp.inf)
        cutoff = jnp.sort(d)[jnp.clip(n_top - 1, 0, pm.shape[0] - 1)]
        logits = jnp.where(pm & (d <= cutoff), 0.0, -jnp.inf)
        return np.array(jax.random.categorical(key, logits, shape=(H, S)))

    frame = lambda j: jreg.FrameFeatures(*(jnp.asarray(x[j]) for x in feats))
    s1 = np.zeros((n - 1, H, S), np.int64)
    s2 = np.zeros((n - 1, H, S), np.int64)
    ok1 = np.zeros(n - 1, bool)
    key = jax.random.key(seed)
    eye = (jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32))
    for start in window_starts(n, window):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, window - 1)
        prev = None
        for k in range(min(start + window, n) - start - 1):
            g = start + k
            f0, f1 = frame(g), frame(g + 1)
            s1[g] = draw(keys[k], f0, f1)
            prior = eye if prev is None or not bool(prev.success) else (
                prev.R, prev.t)
            s2[g] = draw(jax.random.fold_in(keys[k], 1), f0, f1, prior)
            prev = jreg.register_pair(keys[k], f0, f1, cfg)
            ok1[g] = bool(prev.success)
    return (s1, s2), ok1


def _chordal_deg(Ra, Rb):
    """Angle between rotations from their Frobenius distance (stable near
    zero, unlike arccos of the trace)."""
    d = np.linalg.norm(Ra - Rb, axis=(-2, -1)) / (2.0 * np.sqrt(2.0))
    return np.degrees(2.0 * np.arcsin(np.clip(d, 0.0, 1.0)))


def test_odometry_window_matches_jax(params):
    rp, ep = params
    scans = _scans(4)
    n, window, cfg = len(scans), 3, CFG_RETRY
    jres, jfeats = jrun(scans, rp, ep, cfg=cfg, window=window, seed=0,
                        keep_features=True)
    jfeats = jax.tree.map(np.asarray, jfeats)
    samples, ok1 = _jax_window_samples(jfeats, n, window, 0, cfg)
    assert not ok1.all()                 # the retry pass runs
    respond_net, encoder = build_models(rp, ep, "cpu", cfg)
    tres, tfeats = trun(scans, respond_net, encoder, cfg=cfg, window=window,
                        seed=0, keep_features=True, samples=samples)
    _assert_features_match(tfeats, jfeats)
    np.testing.assert_array_equal(tres.successes, jres.successes)
    assert tres.successes.any()
    np.testing.assert_array_equal(tres.n_inliers, jres.n_inliers)
    # per pair: the two estimates within 1e-3 deg / 1e-3 m of each other,
    # and so their errors against the true motion too
    assert _chordal_deg(tres.rel_Rs, jres.rel_Rs).max() < 1e-3
    assert np.linalg.norm(tres.rel_ts - jres.rel_ts, axis=1).max() < 1e-3
    true_t = np.array([0.8, 0.05, 0.0])
    rre = lambda r: _chordal_deg(r.rel_Rs, np.eye(3))
    rte = lambda r: np.linalg.norm(r.rel_ts - true_t, axis=1)
    assert np.abs(rre(tres) - rre(jres)).max() < 1e-3
    assert np.abs(rte(tres) - rte(jres)).max() < 1e-3
    np.testing.assert_allclose(tres.poses, jres.poses, atol=1e-3)
    for (a0, a1), (b0, b1) in zip(tres.inlier_pairs, jres.inlier_pairs):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)


_HYGIENE = """
import sys
import numpy as np
import torch
from caelo_tpu_torch.config import tiny_test_config
from caelo_tpu_torch.data.synthetic import (make_scene, range_filter,
                                            sample_scene_points)
from caelo_tpu_torch.frontend.registration import extract_frame_features
from caelo_tpu_torch.models.weights_io import build_models, random_flax_params
from caelo_tpu_torch.ops.masking import pad_points

cfg = tiny_test_config()
local = range_filter(sample_scene_points(make_scene(0), 0, cfg.max_points),
                     cfg.sensor)
pts, mask = pad_points(np.concatenate(
    [local, np.full((len(local), 1), 0.5, np.float32)], 1), cfg.max_points)
net, enc = build_models(*random_flax_params(0), "cpu", cfg)
f = extract_frame_features(net, enc, torch.from_numpy(pts),
                           torch.from_numpy(mask), cfg)
assert f.descriptors.shape == (128, 60) and bool(f.mask.any())

from caelo_tpu_torch.backend.refine_runner import (extract_refinement_features,
                                                   refine_pairs_batched,
                                                   stack_features)
from caelo_tpu_torch.pipeline import run_full_pipeline

rf = extract_refinement_features(net, torch.from_numpy(pts),
                                 torch.from_numpy(mask), cfg)
res = refine_pairs_batched(stack_features([rf, rf], [0, 1]),
                           stack_features([rf, rf], [1, 0]),
                           torch.eye(3)[None].repeat(2, 1, 1),
                           torch.zeros(2, 3), cfg)
assert bool(res.success.all()), res
from caelo_tpu_torch.backend.burst import burst_map_icp, rescue_bursts
from caelo_tpu_torch.backend.loopclosure import detect_and_close
from caelo_tpu_torch.backend.posegraph import (concat_graphs, odometry_graph,
                                               optimize, optimize_host)
from caelo_tpu_torch.backend.scancontext import scan_context
from caelo_tpu_torch.data.hard_synthetic import generate_benchmark
from caelo_tpu_torch.eval.metrics import absolute_trajectory_error
from caelo_tpu_torch.pipeline import load_stage_inputs, stage_loop_closure

sc = scan_context(rf.ext_pts, rf.ext_mask)
assert sc.shape == (16, 64) and float(sc.max()) > 0
g = odometry_graph(np.tile(np.eye(3), (3, 1, 1)), np.tile([1.0, 0, 0], (3, 1)))
R0 = torch.eye(3, dtype=torch.float64).repeat(4, 1, 1)
t0 = torch.zeros(4, 3, dtype=torch.float64)
R, t, _ = optimize_host(R0, t0, g)
Rd, td, _ = optimize(R0, t0, g, n_iters=2)
assert np.allclose(t[:, 0], [0, 1, 2, 3]) and np.allclose(td[:, 0], t[:, 0])
from caelo_tpu_torch.utils.telemetry import StageTimer

timer = StageTimer(sync=True)
with timer.stage("solve"):
    optimize_host(R0, t0, g)
assert timer.summary()["solve"]["count"] == 1
import caelo_tpu_torch.cli
import caelo_tpu_torch.data.kitti
import caelo_tpu_torch.data.scancache
import caelo_tpu_torch.training.drivers
bad =[m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax")]
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    """A fresh interpreter imports the port, pipeline, burst rescue, loop
    closure, pose graph, metrics, benchmark generator, stage timer, command
    line, KITTI and scan-cache readers and trainers included, and runs one
    tiny frame, a tiny batched ICP, a scan context, both pose-graph solves
    and a timed stage on the CPU without JAX, Flax or optax ever entering
    sys.modules."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok")
