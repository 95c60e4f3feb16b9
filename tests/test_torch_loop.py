"""The port's loop closure and pose graph against the JAX package on the
CPU: the se3 additions, the pose graph (``optimize``, ``cg``,
``optimize_host``), ScanContext, the candidate searches,
``detect_and_close`` with injected registration, ``stage_loop_closure``
on a revisiting scene with JAX's RANSAC draws injected, and the eval
metrics.  Each test states its tolerance."""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from caelo_tpu import pipeline as jpipe
from caelo_tpu.backend import loopclosure as jlc
from caelo_tpu.backend import posegraph as jpg
from caelo_tpu.backend import scancontext as jsc
from caelo_tpu.config import tiny_test_config
from caelo_tpu.data.synthetic import (make_scene, range_filter,
                                      sample_scene_points)
from caelo_tpu.eval import metrics as jmet
from caelo_tpu.frontend import registration as jreg
from caelo_tpu.frontend.matching import match_descriptors as jmatch
from caelo_tpu.geometry import se3 as jse3
from caelo_tpu.models.patch_encoder import PatchEncoder as JEncoder
from caelo_tpu.models.respond_net import RespondLayer as JRespond
from caelo_tpu.ops.masking import pad_points
from caelo_tpu_torch import pipeline as tpipe
from caelo_tpu_torch.backend import loopclosure as tlc
from caelo_tpu_torch.backend import posegraph as tpg
from caelo_tpu_torch.backend import scancontext as tsc
from caelo_tpu_torch.eval import metrics as tmet
from caelo_tpu_torch.frontend import registration as treg
from caelo_tpu_torch.geometry import se3 as tse3
from caelo_tpu_torch.models.weights_io import build_models
from test_posegraph import chain, make_square_trajectory, rels_from
from test_scancontext import _cloud

CFG = tiny_test_config()
T = torch.from_numpy


# ----------------------------------------------------------------- se3
def test_se3_additions_match_jax(rng):
    """skew, exp_so3 (including the Taylor branch), log_so3 and
    project_so3 on float32 inputs within 1e-6 of JAX; exp/log round trip."""
    w = (rng.normal(size=(64, 3)) * 0.8).astype(np.float32)
    w[:4] *= 1e-7                               # Taylor branch of exp_so3
    R = np.asarray(jse3.exp_so3(jnp.asarray(w)))
    noisy = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    for name, arg in (("skew", w), ("exp_so3", w), ("log_so3", R),
                      ("project_so3", noisy)):
        got = getattr(tse3, name)(T(arg)).numpy()
        want = np.asarray(getattr(jse3, name)(jnp.asarray(arg)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_allclose(tse3.log_so3(tse3.exp_so3(T(w[4:]))).numpy(),
                               w[4:], atol=1e-5)
    P = tse3.project_so3(T(noisy)).double().numpy()
    np.testing.assert_allclose(P @ np.swapaxes(P, -1, -2),
                               np.broadcast_to(np.eye(3), P.shape), atol=1e-6)


# ----------------------------------------------------------- pose graph
def _loop_problem(rng, n_side=2, noise_rot=0.01, noise_t=0.05, weight=10.0):
    """A noisy square odometry chain and one exact loop edge, as
    tests/test_posegraph.py builds them; graphs for both packages."""
    Rs, ts = make_square_trajectory(n_side=n_side)
    rel_R, rel_t = rels_from(Rs, ts, noise_rot=noise_rot, noise_t=noise_t,
                             rng=rng)
    R0, t0 = chain(rel_R, rel_t)
    n = len(R0)
    loop = dict(edge_i=np.array([0], np.int32),
                edge_j=np.array([n - 1], np.int32),
                rel_R=(Rs[0].T @ Rs[-1])[None], rel_t=(
                    Rs[0].T @ (ts[-1] - ts[0]))[None],
                weight=np.array([weight]), rot_info=np.array([100.0]))
    gj = jpg.concat_graphs(jpg.odometry_graph(rel_R, rel_t), jpg.PoseGraph(
        **{k: jnp.asarray(v) for k, v in loop.items()}))
    gt = tpg.concat_graphs(tpg.odometry_graph(rel_R, rel_t), tpg.PoseGraph(
        **{k: T(v) for k, v in loop.items()}))
    return R0, t0, gj, gt, ts


def test_cg_matches_jax_cg(rng):
    """cg on a random SPD system stops where jax.scipy.sparse.linalg.cg
    stops (tolerance rule, not maxiter): solutions within 1e-10."""
    A = rng.normal(size=(40, 40))
    A = A @ A.T + 40 * np.eye(40)
    b = rng.normal(size=40)
    for maxiter in (5, 200):
        got = tpg.cg(lambda v: T(A) @ v, T(b), maxiter=maxiter).numpy()
        want, _ = jax.scipy.sparse.linalg.cg(
            lambda v: jnp.asarray(A) @ v, jnp.asarray(b), maxiter=maxiter)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-10, rtol=0)
    assert np.linalg.norm(A @ got - b) < 1e-4 * np.linalg.norm(b)


def test_optimize_matches_jax(rng):
    """The matrix-free Gauss-Newton solve (jvp/vjp products, CG) in float64
    on a square with one loop edge: R, t and the cost within 1e-4 of
    JAX's ``optimize``; the loop gap shrinks."""
    R0, t0, gj, gt, ts = _loop_problem(rng)
    Rj, tj, cj = jpg.optimize(jnp.asarray(R0), jnp.asarray(t0), gj,
                              n_iters=10, cg_iters=200)
    Rt, tt, ct = tpg.optimize(T(R0), T(t0), gt, n_iters=10, cg_iters=200)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(ct), float(cj), atol=1e-4, rtol=0)
    assert (np.linalg.norm(tt.numpy()[-1] - ts[-1])
            < 0.35 * np.linalg.norm(t0[-1] - ts[-1]))


def test_optimize_host_matches_jax(rng):
    """The host float64 sparse solve from torch-tensor graphs against the
    JAX function on the same graph: R, t and cost within 1e-12."""
    R0, t0, gj, gt, _ = _loop_problem(rng, n_side=5, noise_rot=0.004,
                                      noise_t=0.03, weight=50.0)
    Rj, tj, cj = jpg.optimize_host(R0, t0, gj)
    Rt, tt, ct = tpg.optimize_host(R0, t0, gt)
    np.testing.assert_allclose(Rt, Rj, atol=1e-12, rtol=0)
    np.testing.assert_allclose(tt, tj, atol=1e-12, rtol=0)
    assert abs(ct - cj) <= 1e-12


# ------------------------------------------------------------ scancontext
def _bin_edge_cells(pts, mask, n_rings=16, n_sectors=64, max_range=80.0,
                    eps=1e-4):
    """Flat (ring, sector) cells a point could fall into when its float64
    ring or sector coordinate lies within ``eps`` of a bin edge."""
    r = np.hypot(pts[:, 0].astype(np.float64), pts[:, 1])
    u = r / max_range * n_rings
    v = (np.arctan2(pts[:, 1], pts[:, 0].astype(np.float64)) + np.pi) / (
        2 * np.pi) * n_sectors
    cells = set()
    for ui, vi, m in zip(u, v, mask):
        if not m:
            continue
        near_u = abs(ui - round(ui)) < eps
        near_v = abs(vi - round(vi)) < eps
        if not (near_u or near_v):
            continue
        for du in ((-eps, eps) if near_u else (0.0,)):
            for dv in ((-eps, eps) if near_v else (0.0,)):
                rr = int(np.clip(np.floor(ui + du), 0, n_rings - 1))
                ss = int(np.clip(np.floor(vi + dv), 0, n_sectors - 1))
                cells.add(rr * n_sectors + ss)
    return cells


def test_scan_context_matches_jax(rng):
    """scan_context of 6 clouds at once (batched) against JAX per cloud:
    exact in every cell off the bin edges (mismatched cells counted and
    each shown to hold a point on a ring or sector edge); ring_key exact
    wherever the contexts agree."""
    clouds = np.stack([_cloud(seed=s) for s in range(6)])
    clouds[0, :8, :2] = [[5 * np.cos(a), 5 * np.sin(a)]   # on a ring edge
                         for a in np.linspace(-3, 3, 8)]
    clouds[1, :8, 0] = 0.0                                # on a sector edge
    masks = rng.uniform(size=clouds.shape[:2]) < 0.8
    got = tsc.scan_context(T(clouds), T(masks)).numpy()
    mismatched = 0
    for k in range(len(clouds)):
        want = np.asarray(jsc.scan_context(jnp.asarray(clouds[k]),
                                           jnp.asarray(masks[k])))
        bad = set(np.nonzero((got[k] != want).ravel())[0].tolist())
        mismatched += len(bad)
        assert bad <= _bin_edge_cells(clouds[k], masks[k]), k
        if not bad:
            np.testing.assert_array_equal(
                tsc.ring_key(T(got[k])).numpy(),
                np.asarray(jsc.ring_key(jnp.asarray(want))))
    assert mismatched < 10


def _contexts(n=6, seed=8):
    """Scan contexts of clouds, two of them yaw-rotated copies."""
    pts = [_cloud(seed=seed + k) for k in range(n)]
    for k, yaw in ((2, 135.0), (4, -60.0)):
        R = np.asarray(jsc.yaw_rotation(np.radians(yaw)))
        pts[k] = (pts[0] @ R.T).astype(np.float32)
    m = jnp.ones(512, bool)
    return np.stack([np.asarray(jsc.scan_context(jnp.asarray(p), m))
                     for p in pts])


def _best_shift_margin(a, b):
    """align_score's per-shift scores in float64; the lead of the best
    over the runner-up."""
    S = a.shape[-1]
    na, nb = np.linalg.norm(a, axis=0), np.linalg.norm(b, axis=0)
    M = (a / np.maximum(na, 1e-9)).T @ (b / np.maximum(nb, 1e-9))
    ok = (na > 1e-9)[:, None] & (nb > 1e-9)[None, :]
    j = np.arange(S)
    idx = (j[None, :] + j[:, None]) % S
    scores = (np.where(ok, M, 0.0)[j[None, :], idx].sum(-1)
              / np.maximum(ok[j[None, :], idx].sum(-1), 1))
    top = np.sort(scores)
    return top[-1] - top[-2]


def test_align_and_correlation_match_jax():
    """align_score (pairwise and batched) and sc_correlation_matrix on the
    same scan contexts: scores within 1e-5, the same best shifts (yaws
    within 1e-6) wherever JAX's best score leads its runner-up by 1e-5."""
    scs = _contexts()
    n = len(scs)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    s_t, y_t = tlc._align_score_pairs(T(scs), ii.ravel(), jj.ravel())
    s_j, y_j = jlc._align_score_pairs(jnp.asarray(scs), jnp.asarray(ii.ravel()),
                                      jnp.asarray(jj.ravel()))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    clear = [k for k in range(n * n)
             if _best_shift_margin(scs[ii.ravel()[k]], scs[jj.ravel()[k]])
             > 1e-5]
    assert len(clear) >= n * n // 2
    np.testing.assert_allclose(y_t.numpy()[clear], np.asarray(y_j)[clear],
                               atol=1e-6)
    sb, yb = tsc.align_score_batch(T(scs[0]), T(scs))
    np.testing.assert_allclose(sb.numpy(), s_t.numpy()[:n], atol=1e-6)
    score_t, yaw_t = tsc.sc_correlation_matrix(T(scs))
    score_j, yaw_j = jsc.sc_correlation_matrix(jnp.asarray(scs))
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j),
                               atol=1e-5)
    np.testing.assert_allclose(yaw_t.numpy()[0, [2, 4]],
                               np.asarray(yaw_j)[0, [2, 4]], atol=1e-6)
    np.testing.assert_allclose(tsc.yaw_rotation(yaw_t[0]).numpy(),
                               np.asarray(jax.vmap(jsc.yaw_rotation)(
                                   yaw_j[0])), atol=1e-6)


# ------------------------------------------------------- loop candidates
def _fake_features(rng, n_frames=250, K=64, loop=(0, 240), rotate=None):
    """tests/test_loopclosure.py's frames: random descriptors and polar
    keypoint clouds; frames ``loop`` share a signature (frame loop[1]
    rotated by ``rotate`` degrees of yaw)."""
    base = rng.normal(size=(K, 60)).astype(np.float32)
    cloud = None
    kp, desc = [], []
    for i in range(n_frames):
        r = rng.uniform(10, 60, K)
        th = rng.uniform(-np.pi, np.pi, K)
        pts = np.stack([r * np.cos(th), r * np.sin(th),
                        rng.uniform(-1.5, 4.0, K)], 1).astype(np.float32)
        d = rng.normal(size=(K, 60)).astype(np.float32)
        if i == loop[0]:
            cloud, d = pts, base
        elif i == loop[1]:
            if rotate is not None:
                R = np.asarray(jsc.yaw_rotation(np.radians(rotate)))
                pts = (cloud @ R).astype(np.float32)
            d = base + rng.normal(0, 0.01, (K, 60)).astype(np.float32)
        kp.append(pts)
        desc.append(d)
    kp, desc = np.stack(kp), np.stack(desc)
    mask = np.ones((n_frames, K), bool)
    mask[5, :] = False                       # one empty frame
    pix = np.zeros((n_frames, K, 2), np.int32)
    return ((kp, desc, mask, pix),
            jreg.FrameFeatures(*(jnp.asarray(x) for x in (kp, desc, mask,
                                                          pix))),
            treg.FrameFeatures(*(T(x) for x in (kp, desc, mask, pix))))


def test_loop_candidates_match_jax(rng):
    """Global descriptors within 1e-5; loop_candidates,
    loop_candidates_per_frame and loop_candidates_scancontext give the same
    pairs in the same order, with scores within rtol 1e-4 plus the float32
    rounding of each score (atol from the signatures' squared norms) and
    the same masks."""
    _, fj, ft = _fake_features(rng, rotate=90.0)
    valid = np.ones(250, bool)
    valid[7] = False
    gd_j, v_j, scs_j = jlc._build_signatures(fj.descriptors, fj.mask,
                                             fj.key_pts, with_sc=True)
    gd_t, v_t, scs_t = tlc._build_signatures(ft.descriptors, ft.mask,
                                             ft.key_pts, with_sc=True)
    np.testing.assert_allclose(gd_t.numpy(), np.asarray(gd_j), atol=1e-5)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(scs_t.numpy(), np.asarray(scs_j))
    vj, vt = jnp.asarray(valid) & v_j, T(valid) & v_t
    # Absolute float32 rounding of each score, from the squared norms of the
    # signatures it compares.  A descriptor score is a squared distance from
    # the expansion |a|^2 + |b|^2 - 2 a.b: its rounding error is absolute
    # and scales with the norms, not with the result, so the true revisit's
    # near-zero distance moves by ~1e-5 between two BLAS (rtol alone fails
    # it).  8 eps32 max(|a|^2 + |b|^2) bounds that rounding.  A ScanContext
    # score is a cosine of unit-norm signatures: the same bound with
    # |a|^2 = |b|^2 = 1.
    eps32 = float(np.finfo(np.float32).eps)
    sq = (gd_t.double() ** 2).sum(-1)[vt]
    atol_desc = 8 * eps32 * 2 * float(sq.max())
    atol_sc = 8 * eps32 * 2
    for fn, args_j, args_t, atol in (
            ("loop_candidates", (gd_j, vj), (gd_t, vt), atol_desc),
            ("loop_candidates_per_frame", (gd_j, vj), (gd_t, vt), atol_desc),
            ("loop_candidates_scancontext", (scs_j, vj), (scs_t, vt),
             atol_sc)):
        oj = getattr(jlc, fn)(*args_j, min_gap=100, max_candidates=48)
        ot = getattr(tlc, fn)(*args_t, min_gap=100, max_candidates=48)
        mj = np.asarray(oj[-1])
        np.testing.assert_array_equal(ot[-1].numpy(), mj, err_msg=fn)
        for a, b in zip(ot[:2], oj[:2]):
            np.testing.assert_array_equal(a.numpy()[mj], np.asarray(b)[mj],
                                          err_msg=fn)
        np.testing.assert_allclose(ot[2].numpy()[mj], np.asarray(oj[2])[mj],
                                   rtol=1e-4, atol=atol, err_msg=fn)
        assert mj.sum() > 10
    assert (0, 240) in zip(ot[0].tolist(), ot[1].tolist())


@pytest.mark.parametrize("source", ["descriptor", "scancontext"])
def test_detect_and_close_matches_jax(rng, source):
    """detect_and_close with the same injected batched registration (the
    true revisit and every third other candidate verify) and an edge gate
    that refuses every fifth: the same registration calls, edges, weights,
    checked count and rejects."""
    _, fj, ft = _fake_features(rng, rotate=180.0)

    def make(log):
        def register_batch_fn(idx_i, idx_j, yaws):
            log.append((list(map(int, idx_i)), list(map(int, idx_j)),
                        np.round(np.asarray(yaws), 5).tolist()))
            n = len(idx_i)
            ok = np.array([(i, j) == (0, 240) or (i + j) % 3 == 0
                           for i, j in zip(idx_i, idx_j)])
            Rs = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
            ts = np.stack([[float(i), float(j), 0.0]
                           for i, j in zip(idx_i, idx_j)]).astype(np.float32)
            return Rs, ts, ok, np.arange(100, 100 + n)
        return register_batch_fn

    gate = lambda i, j, R, t: (i + 2 * j) % 5 != 1
    calls_j, calls_t = [], []
    kw = dict(min_gap=100, max_candidates=32, max_accept=6,
              use_scan_context=True, edge_gate_fn=gate,
              frame_valid=np.arange(250) != 9, candidate_source=source)
    out_j = jlc.detect_and_close(fj, register_batch_fn=make(calls_j), **kw)
    out_t = tlc.detect_and_close(ft, register_batch_fn=make(calls_t), **kw)
    assert [c[:2] for c in calls_t] == [c[:2] for c in calls_j]
    np.testing.assert_allclose(calls_t[0][2], calls_j[0][2], atol=1e-5)
    assert out_t.n_accepted == out_j.n_accepted >= 1
    assert out_t.candidates_checked == out_j.candidates_checked
    assert out_t.rejects == out_j.rejects
    for a, b in zip(out_t.edges, out_j.edges):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)


# ----------------------------------------------------- stage_loop_closure
@pytest.fixture(scope="module")
def nets():
    key = jax.random.key(0)
    f32 = lambda t: jax.tree.map(lambda x: np.asarray(x, np.float32), t)
    rp = f32(JRespond().init(key, jnp.zeros(
        (1, CFG.sensor.model_h, CFG.sensor.model_w, 3), jnp.float32)))
    ep = f32(JEncoder().init(key, jnp.zeros((1, 16, 16, 16), jnp.float32)))
    return (rp, ep), build_models(rp, ep, "cpu", CFG)


def revisit_positions(n=12):
    """Out and back along x (0.8 m per scan), the way back 0.3 m to the
    side: frame n-1-k revisits frame k."""
    x = 0.8 * np.minimum(np.arange(n), n - 1 - np.arange(n))
    y = np.where(np.arange(n) >= n // 2, 0.3, 0.0)
    return np.stack([x, y, np.zeros(n)], 1)


def revisit_scans(n=12, thin=(), keep=0.4):
    """Scans of one synthetic scene along ``revisit_positions``; scans in
    ``thin`` keep a ``keep`` share of their points (unhealthy)."""
    scene = make_scene(seed=0, n_boxes=25, extent=30.0)
    world = sample_scene_points(scene, seed=0, n_points=CFG.max_points)
    rng = np.random.default_rng(0)
    scans = []
    for i, p in enumerate(revisit_positions(n)):
        local = range_filter((world - p).astype(np.float32), CFG.sensor)
        local = local + rng.normal(0, 0.005, local.shape).astype(np.float32)
        if i in thin:
            local = local[rng.uniform(size=len(local)) < keep]
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        scans.append(pad_points(np.concatenate([local, refl], 1),
                                CFG.max_points))
    return scans


def jax_draw(key, f0, f1, cfg, prior=None, gate_m=0.0):
    """The (H, S) RANSAC draw JAX's registration makes with ``key`` on the
    pair (f0, f1): its own matches (with the prior gate), the logits of
    caelo_tpu/frontend/ransac.py:91-100."""
    H, S = cfg.ransac.n_hypotheses, cfg.ransac.sample_size
    kw = {}
    if prior is not None:
        kw = dict(pts0=f0.key_pts, pts1=f1.key_pts, prior_R=prior[0],
                  prior_t=prior[1], gate_m=gate_m)
    _, pm, pd = jmatch(f0.descriptors, f0.mask, f1.descriptors, f1.mask,
                       ratio=cfg.match_ratio, **kw)
    n_top = jnp.maximum(
        (cfg.ransac.sample_top_frac * jnp.sum(pm)).astype(jnp.int32), 4 * S)
    d = jnp.where(pm, pd, jnp.inf)
    cutoff = jnp.sort(d)[jnp.clip(n_top - 1, 0, pm.shape[0] - 1)]
    logits = jnp.where(pm & (d <= cutoff), 0.0, -jnp.inf)
    return np.array(jax.random.categorical(key, logits, shape=(H, S)))


def jax_loop_samples(feats, cfg, seed=0):
    """``loop_samples`` seam of the port: the draws of JAX's
    _verify_loop_candidates for a batch, fold_in(key(seed + 7), k) per pair
    and fold_in(., 1) for the yaw-prior pass (caelo_tpu/pipeline.py:
    154-164), from JAX-side features ``feats`` (numpy, stacked)."""
    lcfg = dataclasses.replace(cfg, match_ratio=max(cfg.match_ratio, 0.85))
    frame = lambda k: jreg.FrameFeatures(*(jnp.asarray(x[k]) for x in feats))

    def samples(idx_i, idx_j, yaws):
        key = jax.random.key(seed + 7)
        s1, s2 = [], []
        for k, (i, j, y) in enumerate(zip(idx_i, idx_j, yaws)):
            kk = jax.random.fold_in(key, k)
            s1.append(jax_draw(kk, frame(i), frame(j), lcfg))
            prior = (jsc.yaw_rotation(jnp.float32(y)),
                     jnp.zeros(3, jnp.float32))
            s2.append(jax_draw(jax.random.fold_in(kk, 1), frame(i), frame(j),
                               lcfg, prior, gate_m=15.0))
        return np.stack(s1), np.stack(s2)

    return samples


def test_stage_loop_closure_matches_jax(nets):
    """stage_loop_closure on 12 out-and-back scans (frame 11-k revisits
    frame k), the same front-end features in both packages, a drifted
    trajectory (0.5 deg of yaw and 1 % of scale per step), JAX's draws
    injected: JAX accepts the closures (0, 11) and (1, 10) (min_loop_gap
    8), and the port gives the same edges and poses_final within 1e-3; the
    graph solve pulls the drifted trajectory toward the truth."""
    (rp, ep), (net, enc) = nets
    scans = revisit_scans()
    feats = [treg.extract_frame_features(net, enc, T(p), T(m), CFG)
             for p, m in scans]
    feats = treg.FrameFeatures(*(torch.stack(x) for x in zip(*feats)))
    fnp = [x.numpy() for x in feats]
    pos = revisit_positions()
    rels_R, rels_t = [], []
    for k in range(len(pos) - 1):
        rels_R.append(Rotation.from_euler("z", 0.5, degrees=True).as_matrix())
        rels_t.append((pos[k + 1] - pos[k]) * 1.01)
    from caelo_tpu_torch.geometry.kitti_pose import chain_poses
    poses = chain_poses(np.stack(rels_R), np.stack(rels_t), np.eye(3),
                        np.zeros(3))
    kw = dict(min_loop_gap=8, seed=0,
              frame_healthy=np.ones(len(scans), bool))
    pj, nj, eij, ejj = jpipe.stage_loop_closure(
        poses, jreg.FrameFeatures(*(jnp.asarray(x) for x in fnp)), None,
        None, np.eye(3), np.zeros(3), CFG, **kw)
    pt, nt, eit, ejt = tpipe.stage_loop_closure(
        poses, feats, None, None, np.eye(3), np.zeros(3), CFG,
        samples=jax_loop_samples(fnp, CFG), **kw)
    assert nj >= 1 and {(0, 11), (1, 10)} & set(zip(eij.tolist(),
                                                    ejj.tolist()))
    assert nt == nj
    np.testing.assert_array_equal(eit, eij)
    np.testing.assert_array_equal(ejt, ejj)
    np.testing.assert_allclose(pt, pj, atol=1e-3, rtol=0)
    ate = lambda p: tmet.absolute_trajectory_error(
        np.concatenate([np.tile(np.eye(3), (len(pos), 1, 1)),
                        pos[:, :, None]], 2).reshape(-1, 12), p)["ate_rmse"]
    assert ate(pt) < ate(poses)


# ---------------------------------------------------------------- metrics
def test_metrics_match_jax(rng):
    """Every metric of eval/metrics.py on the same trajectories and
    keypoints: pose metrics within 1e-12, keypoint histograms within
    1e-6, loop precision/recall equal."""
    n = 60
    Rs, ts = make_square_trajectory(n_side=14, step=6.0)
    gt = np.concatenate([Rs, ts[:, :, None]], 2).reshape(-1, 12)[:n]
    noise = [Rotation.from_rotvec(rng.normal(0, 0.01, 3)).as_matrix()
             for _ in range(n)]
    est = np.concatenate([np.stack(noise) @ Rs[:n],
                          ts[:n, :, None] + rng.normal(0, 0.3, (n, 3, 1))],
                         2).reshape(-1, 12)
    R_tr = Rotation.from_euler("xyz", [90, 0, 90], degrees=True).as_matrix()
    t_tr = np.array([0.01, -0.07, -0.27])
    et = tmet.relative_pose_errors(gt, est, R_tr, t_tr)
    ej = jmet.relative_pose_errors(gt, est, R_tr, t_tr)
    for a, b in zip(et, ej):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-12)
    n_inl = rng.integers(50, 300, n - 1)
    th = rng.choice([0.4, 0.8, 1.6], n - 1)
    assert (tmet.registration_summary(et, n_inliers=n_inl, n_keypoints=1024,
                                      thresholds=th)
            == jmet.registration_summary(ej, n_inliers=n_inl,
                                         n_keypoints=1024, thresholds=th))
    for fn in ("absolute_trajectory_error", "kitti_drift"):
        got, want = getattr(tmet, fn)(gt, est), getattr(jmet, fn)(gt, est)
        assert got.keys() == want.keys()
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   atol=1e-12)
    assert np.isfinite(tmet.kitti_drift(gt, est)["t_rel_pct"])
    pos = ts[:n]
    ei, ej_ = np.array([0, 3, 20, 55]), np.array([56, 58, 40, 1])
    assert (tmet.loop_closure_pr(ei, ej_, pos, min_gap=40)
            == jmet.loop_closure_pr(ei, ej_, pos, min_gap=40))
    kp0 = rng.uniform(-20, 20, (128, 3)).astype(np.float32)
    kp1 = (kp0 + rng.normal(0, 0.3, kp0.shape)).astype(np.float32)
    m0, m1 = rng.uniform(size=128) < 0.9, rng.uniform(size=128) < 0.9
    R01 = np.eye(3, dtype=np.float32)
    t01 = np.zeros(3, np.float32)
    for got, want in (
            (tmet.keypoint_repeatability(T(kp0), T(m0), T(kp1), T(m1), R01,
                                         t01),
             jmet.keypoint_repeatability(jnp.asarray(kp0), jnp.asarray(m0),
                                         jnp.asarray(kp1), jnp.asarray(m1),
                                         R01, t01)),
            (tmet.keypoint_dispersion(T(kp0), T(m0)),
             jmet.keypoint_dispersion(kp0, m0))):
        assert got["bins_m"] == want["bins_m"]
        np.testing.assert_allclose(got["fraction_within"],
                                   want["fraction_within"], atol=1e-6)
        np.testing.assert_allclose(got["median_m"], want["median_m"],
                                   atol=1e-6)


# ------------------------------------------------------- full pipeline
def jax_anchor_samples(feats, cfg, seed=0):
    """``anchor_samples`` seam of the port: the draw of JAX's burst anchor
    registration, fold_in(key(seed + 31), i) (caelo_tpu/pipeline.py:
    690-707), with the caller's prior and the 5 m gate."""
    acfg = dataclasses.replace(
        cfg, ransac=dataclasses.replace(cfg.ransac, min_inlier_abs=60))
    frame = lambda k: jreg.FrameFeatures(*(jnp.asarray(x[k]) for x in feats))

    def samples(i, j, R_prior, t_prior):
        prior = (jnp.asarray(R_prior, jnp.float32),
                 jnp.asarray(t_prior, jnp.float32))
        return jax_draw(jax.random.fold_in(jax.random.key(seed + 31), i),
                        frame(i), frame(j), acfg, prior, gate_m=5.0)

    return samples


BURST = (3, 4, 5, 6)        # thinned to 40 %: one burst, span (2, 7)


def test_run_full_pipeline_matches_jax(nets):
    """12 out-and-back scans, scans 3-6 thinned to 40 % (a 4-frame burst
    through the turn-around), loop closure on (min_loop_gap 8), with JAX's
    RANSAC draws injected at every stage: all four pose arrays within
    1e-3; equal de-jumped frames, refinement stats, burst stats (spans,
    accepted, rejected, closure sources) and loop edges.  Every stage
    runs: the burst span is solved, a closure is accepted and the graph
    solved."""
    from test_torch_slice import _jax_window_samples

    (rp, ep), (net, enc) = nets
    scans = revisit_scans(thin=BURST)
    R_tr = Rotation.from_euler("xyz", [90, 0, 90], degrees=True).as_matrix()
    t_tr = np.array([0.01, -0.07, -0.27])
    kw = dict(R_tr=R_tr, t_tr=t_tr, cfg=CFG, enable_loop_closure=True,
              min_loop_gap=8, seed=0)
    jres = jpipe.run_full_pipeline(scans, rp, ep, **kw)
    jfeats = [jreg.extract_frame_features(rp, ep, jnp.asarray(p),
                                          jnp.asarray(m), CFG)
              for p, m in scans]
    jfeats = [np.stack([np.asarray(f[k]) for f in jfeats]) for k in range(4)]
    samples, _ = _jax_window_samples(jfeats, len(scans), len(scans), 0, CFG)
    tres = tpipe.run_full_pipeline(
        scans, net, enc, samples=samples,
        loop_samples=jax_loop_samples(jfeats, CFG),
        anchor_samples=jax_anchor_samples(jfeats, CFG), **kw)
    np.testing.assert_array_equal(tres.odometry.successes,
                                  jres.odometry.successes)
    for name in ("poses_raw", "poses_dejumped", "poses_refined",
                 "poses_final"):
        np.testing.assert_allclose(getattr(tres, name), getattr(jres, name),
                                   atol=1e-3, rtol=0, err_msg=name)
    assert tres.dejumped_frames == jres.dejumped_frames
    assert (dataclasses.asdict(tres.refine_stats)
            == dataclasses.asdict(jres.refine_stats))
    bt, bj = tres.burst_stats, jres.burst_stats
    assert bt.spans == bj.spans == [(2, 7)]
    assert bt.accepted == bj.accepted and bt.rejected == bj.rejected
    assert bt.accepted + bt.rejected == [(2, 7)] and bt.gains
    src = lambda s: [(a, b, c.split("(")[0]) for a, b, c in s.closures]
    assert src(bt) == src(bj)
    np.testing.assert_allclose(bt.gains, bj.gains, atol=1e-4)
    assert tres.n_loop_closures == jres.n_loop_closures >= 1
    np.testing.assert_array_equal(tres.loop_edge_i, jres.loop_edge_i)
    np.testing.assert_array_equal(tres.loop_edge_j, jres.loop_edge_j)
    assert np.abs(tres.poses_final - tres.poses_refined).max() > 1e-6


def test_run_full_pipeline_keeps_burst_pairs_out_of_refinement(nets,
                                                               monkeypatch):
    """Pairs inside a burst span reach the pairwise refinement marked
    trusted (so it skips them; stage 3b owns them), as the JAX pipeline's
    ``refine_trusted`` does; every other pair keeps the front end's
    ``success & healthy`` trust.  Refinement and rescue are stubbed: this
    checks what the pipeline hands them."""
    from caelo_tpu_torch.backend.burst import BurstStats

    _, (net, enc) = nets
    seen = {}

    def stage_refinement(poses_dj, *a, pair_trusted=None, **k):
        seen["trusted"] = pair_trusted
        return poses_dj, tpipe.refine.RefineStats()

    def rescue_bursts(poses, ref_feats, healthy, *a, **k):
        seen["healthy"] = healthy
        return poses, BurstStats(spans=[(2, 7)])

    monkeypatch.setattr(tpipe, "stage_refinement", stage_refinement)
    monkeypatch.setattr(tpipe, "rescue_bursts", rescue_bursts)
    res = tpipe.run_full_pipeline(revisit_scans(thin=BURST), net, enc,
                                  cfg=CFG, enable_loop_closure=False)
    healthy = seen["healthy"]
    assert not healthy[list(BURST)].any() and healthy.sum() == 8
    want = res.odometry.successes & healthy[:-1] & healthy[1:]
    want[2:7] = True
    np.testing.assert_array_equal(seen["trusted"], want)
    assert res.burst_stats.spans == [(2, 7)]


def test_stage_outputs_round_trip(nets, tmp_path):
    """preprocess_to_store on 3 scans, then load_stage_inputs: the features
    and refinement features as the front end returned them (bit-equal),
    the same inlier pairs, rels, successes and calibration; the JAX
    package's load_stage_inputs reads the same store to the same arrays."""
    from caelo_tpu_torch.data.artifacts import ArtifactStore
    from caelo_tpu_torch.frontend.odometry import run_odometry_windowed

    _, (net, enc) = nets
    scans = revisit_scans()[:3]
    store = ArtifactStore(str(tmp_path / "artifacts"))
    odo = tpipe.preprocess_to_store(scans, net, enc, np.eye(3), np.zeros(3),
                                    CFG, store, "00", seed=0)
    ref = run_odometry_windowed(scans, net, enc, cfg=CFG, window=3, seed=0,
                                keep_refine_features=True)
    # the port's entry points default to the card; this test runs on the CPU
    data = tpipe.load_stage_inputs(store, "00", device="cpu")
    jdata = jpipe.load_stage_inputs(store, "00")
    assert data["n_frames"] == jdata["n_frames"] == 3
    for got, want, jgot in ((data["feats"], ref[1], jdata["feats"]),
                            (data["ref_feats"], ref[2], jdata["ref_feats"])):
        for a, b, c in zip(got, want, jgot):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(np.asarray(c), b.numpy())
    np.testing.assert_array_equal(data["rel_Rs"], odo.rel_Rs)
    np.testing.assert_array_equal(data["rel_ts"], odo.rel_ts)
    np.testing.assert_array_equal(data["successes"], odo.successes)
    for (a0, a1), (b0, b1) in zip(data["inlier_pairs"], odo.inlier_pairs):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)
    np.testing.assert_array_equal(data["R_tr"], np.eye(3))


def test_generate_benchmark_matches_jax():
    """The port's generate_benchmark against the JAX one on 3 frames of the
    CI circuit with the degradation burst (frames 29-31 of 88, two of them
    degraded): scans, masks and ground truth bit-equal."""
    from caelo_tpu.data.hard_synthetic import generate_benchmark as jgen
    from caelo_tpu_torch.data.hard_synthetic import generate_benchmark as tgen

    kw = dict(n_frames=88, seed=0, cfg=CFG, side=30.0, yaw_rate_deg=6.0,
              n_cars=3, degraded_spans=[(30, 42, 0.8, 140.0)],
              frame_range=(29, 32))
    (st, gt_t), (sj, gt_j) = tgen(**kw), jgen(**kw)
    np.testing.assert_array_equal(gt_t, gt_j)
    assert len(st) == len(sj) == 3
    for (pt, mt), (pj, mj) in zip(st, sj):
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(mt, mj)
    assert st[0][1].sum() > st[1][1].sum() > 0       # frame 30 degraded
