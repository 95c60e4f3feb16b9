"""The port's refinement back end against the JAX package on the CPU, at
``tiny_test_config()`` sizes: extended keypoints, planar points, nearest
neighbours, batched hybrid ICP, the refinement features and ICP callables,
``stage_refinement`` and ``run_full_pipeline`` through refinement.  Each
test states its tolerance."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from caelo_tpu import pipeline as jpipe
from caelo_tpu.backend import icp as jicp
from caelo_tpu.backend import refine_runner as jrr
from caelo_tpu.config import IcpConfig, PipelineConfig, tiny_test_config
from caelo_tpu.data.synthetic import (make_scene, range_filter,
                                      sample_scene_points)
from caelo_tpu.frontend import registration as jreg
from caelo_tpu.models.patch_encoder import PatchEncoder as JEncoder
from caelo_tpu.models.respond_net import RespondLayer as JRespond
from caelo_tpu.ops.masking import pad_points
from caelo_tpu.projection import normals as jnorm
from caelo_tpu.projection import spherical as jsph
from caelo_tpu_torch import pipeline as tpipe
from caelo_tpu_torch.backend import icp as ticp
from caelo_tpu_torch.backend import refine_runner as trr
from caelo_tpu_torch.frontend import registration as treg
from caelo_tpu_torch.models.weights_io import build_models
from caelo_tpu_torch.projection import normals as tnorm
from caelo_tpu_torch.projection import spherical as tsph
from test_torch_slice import _jax_window_samples

CFG = tiny_test_config()
STEP = np.array([0.8, 0.05, 0.0])          # true motion between scans
# a KITTI-like camera-lidar calibration: x_cam = R_TR x_lidar + T_TR
R_TR = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
T_TR = np.array([0.01, -0.07, -0.27])


@pytest.fixture(scope="module")
def params():
    key = jax.random.key(0)
    f32 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
    rp = JRespond().init(key, jnp.zeros(
        (1, CFG.sensor.model_h, CFG.sensor.model_w, 3), jnp.float32))
    ep = JEncoder().init(key, jnp.zeros((1, 16, 16, 16), jnp.float32))
    return f32(rp), f32(ep)


@pytest.fixture(scope="module")
def nets(params):
    return build_models(*params, "cpu", CFG)


def _scans(n, thin=(), keep=0.4, cfg=CFG):
    """The sensor translating by STEP per scan through one scene; scans in
    ``thin`` keep a ``keep`` share of their points (unhealthy frames)."""
    scene = make_scene(seed=0, n_boxes=25, extent=30.0)
    world = sample_scene_points(scene, seed=0, n_points=cfg.max_points)
    rng = np.random.default_rng(0)
    scans = []
    for i in range(n):
        local = range_filter((world - STEP * i).astype(np.float32),
                             cfg.sensor)
        local = local + rng.normal(0, 0.005, local.shape).astype(np.float32)
        if i in thin:
            local = local[rng.uniform(size=len(local)) < keep]
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        scans.append(pad_points(np.concatenate([local, refl], 1),
                                cfg.max_points))
    return scans


def _np(tree):
    return type(tree)(*(np.asarray(x) for x in tree))


def _assert_planar_match(pt, mt, pj, mj):
    """Planar rows: same mask, positions within 1e-5 m, normals within
    1e-4, row by row (so the lax.top_k order too)."""
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(pt[:, :3], pj[:, :3], atol=1e-5, rtol=0)
    np.testing.assert_allclose(pt[:, 3:], pj[:, 3:], atol=1e-4, rtol=0)


def test_pixel_to_point_and_extend_keypoints_match_jax(rng):
    """pixel_to_point within 2e-5 m at ranges up to 60 m (a few float32
    ulps: the two libraries' sin and cos differ in the last bit);
    extend_keypoints exact, with overlapping windows, windows past the
    image edge and masked keypoints (which own nothing)."""
    pts, mask = _scans(1)[0]
    image, counter = tsph.project_to_spherical_ring(
        torch.from_numpy(pts), torch.from_numpy(mask), CFG.sensor)
    H, W = CFG.sensor.img_h, CFG.sensor.img_w
    rows = rng.uniform(0, H, 50).astype(np.float32)
    cols = rng.uniform(0, W, 50).astype(np.float32)
    vals = rng.uniform(1, 60, 50).astype(np.float32)
    np.testing.assert_allclose(
        tsph.pixel_to_point(*(torch.from_numpy(a) for a in (rows, cols, vals)),
                            CFG.sensor).numpy(),
        np.asarray(jsph.pixel_to_point(jnp.asarray(rows), jnp.asarray(cols),
                                       jnp.asarray(vals), CFG.sensor)),
        atol=2e-5, rtol=0)

    K = 40
    kp = np.stack([rng.integers(0, H, K), rng.integers(0, W, K)], 1
                  ).astype(np.int32)
    kp[1] = kp[0] + [1, 2]                     # overlapping windows
    kp[2] = [0, W - 1]                         # past two edges
    km = rng.uniform(size=K) < 0.8
    km[3] = False
    kp[3] = kp[0]                              # masked, on a shared window
    for radius in (2, 6):
        out_t = tsph.extend_keypoints(image, counter, torch.from_numpy(kp),
                                      torch.from_numpy(km), CFG.sensor,
                                      radius=radius)
        out_j = jsph.extend_keypoints(jnp.asarray(image.numpy()),
                                      jnp.asarray(counter.numpy()),
                                      jnp.asarray(kp), jnp.asarray(km),
                                      CFG.sensor, radius=radius)
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert out_t[1].any() and not out_t[1][~torch.from_numpy(km)].any()


def test_extract_planar_points_matches_jax():
    """At the full sensor size with max_planar=128, below the candidate
    count, so the top-k cut bites: see _assert_planar_match."""
    cfg = PipelineConfig()
    pts, mask = _scans(1, cfg=cfg)[0]
    image, counter = tsph.project_to_spherical_ring(
        torch.from_numpy(pts), torch.from_numpy(mask), cfg.sensor)
    sal = np.random.default_rng(1).uniform(
        0, 0.6, (cfg.sensor.model_h, cfg.sensor.model_w)).astype(np.float32)
    pt, mt = tnorm.extract_planar_points(image, counter, torch.from_numpy(sal),
                                         cfg.sensor, max_planar=128)
    pj, mj = jnorm.extract_planar_points(
        jnp.asarray(image.numpy()), jnp.asarray(counter.numpy()),
        jnp.asarray(sal), cfg.sensor, max_planar=128)
    assert mt.all()
    _assert_planar_match(pt.numpy(), mt.numpy(), np.asarray(pj),
                         np.asarray(mj))


def test_nearest_neighbors_matches_jax(rng):
    """Batched over 3 clouds, tiled by 128 queries: indices equal wherever
    the best and second-best distances differ by more than 1e-5 m;
    distances within 1e-6 m."""
    S, N, M = 3, 300, 700
    q = rng.uniform(-20, 20, (S, N, 3)).astype(np.float32)
    r = rng.uniform(-20, 20, (S, M, 3)).astype(np.float32)
    qm = rng.uniform(size=(S, N)) < 0.9
    rm = rng.uniform(size=(S, M)) < 0.9
    it, dt = ticp.nearest_neighbors(*(torch.from_numpy(a)
                                      for a in (q, qm, r, rm)), chunk=128)
    for s in range(S):
        ij, dj = jicp.nearest_neighbors(jnp.asarray(q[s]), jnp.asarray(qm[s]),
                                        jnp.asarray(r[s]), jnp.asarray(rm[s]),
                                        chunk=128)
        d = np.linalg.norm(q[s, :, None].astype(np.float64)
                           - r[s][rm[s]][None], axis=-1)
        d.sort(axis=1)
        clear = (d[:, 1] - d[:, 0] > 1e-5) & qm[s]
        assert clear.sum() > 0.9 * qm[s].sum()
        np.testing.assert_array_equal(it[s].numpy()[clear],
                                      np.asarray(ij)[clear])
        np.testing.assert_allclose(dt[s].numpy(), np.asarray(dj), atol=1e-6,
                                   rtol=0)


def _structured_spans(rng, S=3, n=512, p=128):
    """Per span: two walls and the ground, a known small motion, planar
    ground rows with +z normals, and padding rows masked out."""
    pc0, pc1, pl0, pl1, motions = [], [], [], [], []
    for s in range(S):
        g = rng.uniform([-10, -10, 0], [10, 10, 0.01], (n // 2, 3))
        w1 = rng.uniform([-10, 7.99, 0], [10, 8.01, 5], (n // 4, 3))
        w2 = rng.uniform([6.99, -10, 0], [7.01, 10, 5],
                         (n - n // 2 - n // 4, 3))
        c0 = np.concatenate([g, w1, w2])
        R = Rotation.from_euler("xyz", rng.uniform(-1, 1, 3),
                                degrees=True).as_matrix()
        t = rng.uniform(-0.3, 0.3, 3)
        c1 = (c0 - t) @ R                       # R c1 + t = c0
        q0 = np.concatenate([rng.uniform([-10, -10, 0], [10, 10, 0], (p, 3)),
                             np.tile([0, 0, 1.0], (p, 1))], 1)
        q1 = np.concatenate([(q0[:, :3] - t) @ R, q0[:, 3:] @ R], 1)
        pc0.append(c0)
        pc1.append(c1)
        pl0.append(q0)
        pl1.append(q1)
        motions.append((R, t))
    f = lambda a: np.asarray(a, np.float32)
    m = lambda k: np.arange(k) < k - 7 * np.arange(1, S + 1)[:, None]
    return (f(pc0), m(n), f(pc1), m(n), f(pl0), m(p), f(pl1), m(p)), motions


def _assert_icp_match(rt, rj, r0_tol=1e-5):
    """Same success and trip counts, R and t within 1e-4, the residuals
    within 1e-5 m."""
    np.testing.assert_array_equal(rt.success.numpy(), np.asarray(rj.success))
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4,
                               rtol=0)
    for a, b in ((rt.init_res, rj.init_res), (rt.final_res, rj.final_res)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=r0_tol,
                                   rtol=0)


@pytest.mark.parametrize("thr_scale", [1.0, 4.0])
def test_icp_batched_matches_jax(rng, thr_scale):
    """icp_point_to_point and icp_hybrid over 3 spans against JAX vmapped
    over the same spans: see _assert_icp_match; both recover the motions."""
    args, motions = _structured_spans(rng)
    cfg = CFG.icp
    ta = [torch.from_numpy(a) for a in args]
    ja = [jnp.asarray(a) for a in args]
    rt = ticp.icp_hybrid(*ta, cfg, thr_scale=thr_scale)
    rj = jax.vmap(lambda *a: jicp.icp_hybrid(*a, cfg, thr_scale=thr_scale))(
        *ja)
    _assert_icp_match(rt, rj)
    assert rt.success.all()
    for s, (R, t) in enumerate(motions):
        np.testing.assert_allclose(rt.R[s].numpy(), R, atol=2e-3)
        np.testing.assert_allclose(rt.t[s].numpy(), t, atol=2e-2)
    rt = ticp.icp_point_to_point(*ta[:4], cfg)
    rj = jax.vmap(lambda *a: jicp.icp_point_to_point(*a, cfg))(*ja[:4])
    _assert_icp_match(rt, rj)


def test_icp_early_exit_equals_full_trips(rng, monkeypatch):
    """Stopping once every lane is frozen returns exactly what all
    max_iters trips return, in fewer trips."""
    args = [torch.from_numpy(a) for a in _structured_spans(rng)[0]]
    cfg = dataclasses.replace(CFG.icp, max_iters=16)
    calls = []
    nn = ticp.nearest_neighbors
    monkeypatch.setattr(ticp, "nearest_neighbors",
                        lambda *a: calls.append(1) or nn(*a))
    full = ticp.icp_hybrid(*args, cfg, early_exit=False)
    n_full = len(calls)
    early = ticp.icp_hybrid(*args, cfg)
    assert n_full == 2 * cfg.max_iters and len(calls) - n_full < n_full
    assert int(full.iters.max()) < cfg.max_iters
    for a, b in zip(early, full):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def ref_feats(params, nets):
    """Refinement features of 5 scans (scan 3 thinned to 40 %) from the
    port's full-feature path, stacked, as host numpy."""
    scans = _scans(5, thin=(3,))
    net, enc = nets
    fr = [treg.extract_frame_features_full(net, enc, torch.from_numpy(p),
                                           torch.from_numpy(m), CFG)[1]
          for p, m in scans]
    return trr.RefinementFeatures(*(torch.stack(x).numpy()
                                    for x in zip(*fr)))


def test_refinement_features_match_jax(params, nets):
    """extract_refinement_features on a healthy scan and on one thinned
    below max_points (raw fill with deduplication): extended points and
    masks exact, planar rows as _assert_planar_match.  The full-feature
    path and extract_refinement_features_batched give the same refinement
    features, and the full path unchanged frame features."""
    rp, ep = params
    net, enc = nets
    scans = _scans(2, thin=(1,), keep=0.05)
    assert scans[1][1].sum() < CFG.icp.max_points
    for pts, mask in scans:
        tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
        ft = trr.extract_refinement_features(net, tp, tm, CFG)
        fj = jrr.extract_refinement_features(rp, jnp.asarray(pts),
                                             jnp.asarray(mask), CFG)
        np.testing.assert_array_equal(ft.ext_mask.numpy(),
                                      np.asarray(fj.ext_mask))
        np.testing.assert_array_equal(ft.ext_pts.numpy(),
                                      np.asarray(fj.ext_pts))
        assert int(ft.ext_mask.sum()) > 50
        _assert_planar_match(ft.planar.numpy(), ft.planar_mask.numpy(),
                             np.asarray(fj.planar), np.asarray(fj.planar_mask))
        feats, ref = treg.extract_frame_features_full(net, enc, tp, tm, CFG)
        (batched,) = tpipe.extract_refinement_features_batched(
            [(pts, mask)], net, CFG)
        for a, b, c in zip(ref, batched, ft):
            assert torch.equal(a, c) and torch.equal(b, c)
        for a, b in zip(feats, treg.extract_frame_features(net, enc, tp, tm,
                                                           CFG)):
            assert torch.equal(a, b)


def _perturbed_rels(idx_i, idx_j, rng):
    """Lidar-frame relative poses of the spans, the true motion perturbed
    by up to 0.1 m and 0.5 deg."""
    relRs, relTs = [], []
    for i, j in zip(idx_i, idx_j):
        relRs.append(Rotation.from_euler(
            "xyz", rng.uniform(-0.5, 0.5, 3), degrees=True).as_matrix())
        relTs.append(STEP * (j - i) + rng.uniform(-0.1, 0.1, 3))
    return np.stack(relRs), np.stack(relTs)


def test_batched_icp_fn_matches_jax(ref_feats, rng):
    """make_batched_icp_fn (4 spans in chunks of 3, the last padded) on the
    same features: success equal, corrections within 1e-4, residuals
    within 1e-5 m.  make_icp_fn's single-pair solve agrees with the batch
    to 1e-6."""
    idx_i = np.array([0, 1, 2, 0], np.int32)
    idx_j = np.array([1, 2, 4, 2], np.int32)
    relRs, relTs = _perturbed_rels(idx_i, idx_j, rng)
    feats_t = trr.RefinementFeatures(*(torch.from_numpy(x) for x in ref_feats))
    feats_j = jrr.RefinementFeatures(*(jnp.asarray(x) for x in ref_feats))
    for thr_scale in (2.0, 1.0):
        out_t = trr.make_batched_icp_fn(feats_t, CFG, chunk=3)(
            idx_i, idx_j, relRs, relTs, thr_scale=thr_scale)
        out_j = jrr.make_batched_icp_fn(feats_j, CFG, chunk=3)(
            idx_i, idx_j, relRs, relTs, thr_scale=thr_scale)
        np.testing.assert_array_equal(out_t[2], out_j[2])
        for k, tol in ((0, 1e-4), (1, 1e-4), (3, 1e-5), (4, 1e-5)):
            np.testing.assert_allclose(out_t[k], out_j[k], atol=tol, rtol=0)
    assert out_t[2].any()
    icp_fn = trr.make_icp_fn(feats_t, CFG)
    for s in range(len(idx_i)):
        dR, dt, ok = icp_fn(int(idx_i[s]), int(idx_j[s]), relRs[s], relTs[s])
        assert ok == out_t[2][s]
        np.testing.assert_allclose(dR, out_t[0][s], atol=1e-6, rtol=0)
        np.testing.assert_allclose(dt, out_t[1][s], atol=1e-6, rtol=0)


@pytest.mark.parametrize("batched", [True, False])
def test_stage_refinement_matches_jax(ref_feats, rng, batched):
    """stage_refinement, batched and sequential, on the same odometry input
    (perturbed poses, chained inlier tracks, scan 3 unhealthy so pairs 2
    and 3 are untrusted) against the JAX stage: equal RefineStats, refined
    poses within 1e-4."""
    n = ref_feats.ext_pts.shape[0]
    rels = [(Rotation.from_euler("z", d, degrees=True).as_matrix(),
             STEP + e) for d, e in zip(rng.uniform(-1, 1, n - 1),
                                       rng.uniform(-0.2, 0.2, (n - 1, 3)))]
    from caelo_tpu_torch.geometry.kitti_pose import chain_poses
    poses = chain_poses(np.stack([r for r, _ in rels]),
                        np.stack([t for _, t in rels]), R_TR, T_TR)
    track = np.arange(20)
    pairs = [(track, track)] * (n - 1)
    trusted = np.array([True, True, False, False])
    feats_t = trr.RefinementFeatures(*(torch.from_numpy(x) for x in ref_feats))
    feats_j = jrr.RefinementFeatures(*(jnp.asarray(x) for x in ref_feats))
    pt, st = tpipe.stage_refinement(poses, feats_t, pairs, R_TR, T_TR, CFG,
                                    batched=batched, pair_trusted=trusted)
    pj, sj = jpipe.stage_refinement(poses, feats_j, pairs, R_TR, T_TR, CFG,
                                    batched=batched, pair_trusted=trusted)
    assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    assert st.refined + st.failed + st.rejected
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)


def test_run_full_pipeline_matches_jax(params, nets):
    """6 scans, scan 3 thinned to 40 % (unhealthy), loop closure off, with
    JAX's own RANSAC draws: poses_raw, poses_dejumped and poses_refined
    within 1e-3; equal de-jumped frames and refinement stats."""
    rp, ep = params
    net, enc = nets
    scans = _scans(6, thin=(3,))
    jres = jpipe.run_full_pipeline(scans, rp, ep, R_tr=R_TR, t_tr=T_TR,
                                   cfg=CFG, enable_loop_closure=False)
    jfeats = [_np(jreg.extract_frame_features(
        rp, ep, jnp.asarray(p), jnp.asarray(m), CFG)) for p, m in scans]
    jfeats = jreg.FrameFeatures(*(np.stack(x) for x in zip(*jfeats)))
    samples, _ = _jax_window_samples(jfeats, len(scans), len(scans), 0, CFG)
    tres = tpipe.run_full_pipeline(scans, net, enc, R_tr=R_TR, t_tr=T_TR,
                                   cfg=CFG, enable_loop_closure=False,
                                   samples=samples)
    np.testing.assert_array_equal(tres.odometry.successes,
                                  jres.odometry.successes)
    for name in ("poses_raw", "poses_dejumped", "poses_refined",
                 "poses_final"):
        np.testing.assert_allclose(getattr(tres, name), getattr(jres, name),
                                   atol=1e-3, rtol=0, err_msg=name)
    assert tres.dejumped_frames == jres.dejumped_frames
    st, sj = tres.refine_stats, jres.refine_stats
    assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    assert st.refined + st.failed + st.rejected        # ICP really ran
    assert tres.burst_stats.spans == jres.burst_stats.spans == []
