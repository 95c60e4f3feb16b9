"""The port's keypoint baselines (``frontend/baselines.py``) and keypoint-source
ablation (``frontend/ablation.py``) against the JAX package on the CPU.

Inputs: a structured scene (ground, three boxes, a wall, a ramp; 4,096
points, 64 masked) dense enough, and free of lines, that all but a few of
its covariances at Harris's 1 m radius have a well-defined smallest
eigenvector, and a tiny-config synthetic scan (3,005 of 4,096 points
valid), both from numpy seeds.

Tolerances:
- ``_knn_neighbors``: neighbour sets equal per row, except where JAX's
  scores at the k-th place tie within 1e-6 relative;
- given JAX's neighbour lists: ``_neighbor_cov`` within 1e-5; eigenvalues
  within 1e-4 of each matrix's largest (the float32 solvers' error is
  relative to the matrix norm, so a near-zero eigenvalue carries no
  relative digits); Harris's ``C`` and response within 1e-4 relative (of
  each matrix's largest entry; of the frame's largest response); SIFT's
  DoG within 1e-5; ``_radius_nms`` keypoints equal;
- each detector end to end: keypoint sets equal except counted flips, each
  within a stated distance of one of its decision thresholds (a gate, an
  NMS comparison, the k-th score), or, for Harris, next to a point whose
  normal is undefined (the two smallest eigenvalues within 1e-2 of the
  largest: LAPACK builds pick different vectors of that plane), or next to
  the k-th place that another flip moved (``eval/keypoint_flips.py``).
  The distances: ISS's gamma ratios 1e-4, its scores 1e-6 of the frame's
  largest eigenvalue (about twice a float32 eigen solver's bound, 3 eps
  |C|); Harris's response 1e-4 of the frame's largest; SIFT's DoG
  comparisons and contrast gate 1e-5;
- ``random_keypoints`` fed JAX's draw: equal; ``features_from_keypoints``:
  patches bit-equal, descriptors within 1e-4.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from caelo_tpu.config import tiny_test_config as jtiny
from caelo_tpu.frontend import ablation as jabl
from caelo_tpu.frontend import baselines as jb
from caelo_tpu.voxel import grid as jgrid
from caelo_tpu_torch.config import tiny_test_config
from caelo_tpu_torch.eval.keypoint_flips import explain_flips
from caelo_tpu_torch.frontend import ablation as tabl
from caelo_tpu_torch.frontend import baselines as tb
from caelo_tpu_torch.models import weights_io
from caelo_tpu_torch.voxel import grid as tgrid
from test_torch_slice import _scans

CFG = tiny_test_config()
K = 64


def structured_scene(seed=0, n=4096, n_masked=64):
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, m: rng.uniform(lo, hi, (m, 3))
    parts = [u([-8, -8, 0], [8, 8, 0.02], 2400),              # ground
             u([2, 2, 1.5], [4, 4, 1.52], 250),               # box tops
             u([-5, 1, 0.8], [-2, 3, 0.82], 250),
             u([-3, -6, 2.5], [-1, -4, 2.52], 250),
             u([2, 2, 0], [2.02, 4, 1.5], 200),               # box sides
             u([-5, 1, 0], [-2, 1.02, 0.8], 150),
             u([6, -8, 0], [6.02, 8, 3], 450)]                # wall
    ramp = u([-7, -7, 0], [-5, -3, 0.02], 146)
    ramp[:, 2] += 0.5 * (ramp[:, 0] + 7)                      # ramp
    parts.append(ramp)
    pts = np.concatenate(parts).astype(np.float32)
    assert len(pts) == n
    mask = np.ones(n, bool)
    mask[rng.choice(n, n_masked, replace=False)] = False
    return pts, mask


def synthetic_scan():
    pts, mask = _scans(1)[0]
    return np.ascontiguousarray(pts[:, :3]), mask


SCENES = {"structured": structured_scene, "scan": synthetic_scan}


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    """``(name, pts, mask, jax_idx)`` with JAX's neighbour lists."""
    pts, mask = SCENES[request.param]()
    idx = np.asarray(jb._knn_neighbors(jnp.asarray(pts), jnp.asarray(mask), K))
    return request.param, pts, mask, idx


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def test_knn_neighbors_match_jax(scene):
    """Equal sets per valid row except at k-th-place ties; rows that agree
    come in JAX's order."""
    _, pts, mask, jidx = scene
    tidx = tb._knn_neighbors(_t(pts), _t(mask), K).numpy()
    assert tidx.shape == jidx.shape == (len(pts), K)
    p2m = np.where(mask, (pts.astype(np.float64) ** 2).sum(1), 1e12)
    n_tied = 0
    for i in np.nonzero(mask)[0]:
        a, b = set(jidx[i]), set(tidx[i])
        if a == b:
            np.testing.assert_array_equal(tidx[i], jidx[i])
            continue
        n_tied += 1
        # JAX's score of every point in either set but not both lies within
        # 1e-6 relative of its k-th score
        q = pts[i].astype(np.float64)
        score = 2.0 * pts.astype(np.float64) @ q - p2m - q @ q
        kth = score[jidx[i][-1]]
        for j in a ^ b:
            assert abs(score[j] - kth) <= 1e-6 * abs(kth) + 1e-9, (i, j)
    assert n_tied <= 3


def test_neighbor_cov_and_eigenvalues_match_jax(scene):
    _, pts, mask, jidx = scene
    jcov, jn = jb._neighbor_cov(_j(pts), _j(mask), _j(jidx), 2.0)
    tcov, tn = tb._neighbor_cov(_t(pts), _t(mask), _t(jidx), 2.0)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), atol=1e-5,
                               rtol=0)
    # ISS's eigenvalues, each solver on its own package's covariance
    je = np.asarray(jnp.linalg.eigh(jcov)[0])
    te = tb._eigh(tcov)[0].numpy()
    scale = np.maximum(je[:, 2:], 1e-12)
    assert (np.abs(te - je) <= 1e-4 * scale).all()


def test_eigh_in_batches_equals_one_call(scene, monkeypatch):
    """``_eigh`` splits the matrices into solver batches; the pieces equal
    one call over all of them."""
    _, pts, mask, idx = scene
    cov, _ = tb._neighbor_cov(_t(pts), _t(mask), _t(idx), 2.0)
    monkeypatch.setattr(tb, "_EIGH_BATCH", 1000)
    for a, b in zip(tb._eigh(cov), torch.linalg.eigh(cov)):
        assert torch.equal(a, b)


def _jax_harris_parts(pts, mask, idx, radius=1.0, harris_k=0.04):
    """caelo_tpu/frontend/baselines.py:117-133 on JAX's lists: ``(C, resp,
    n_nbr, gap)``, ``gap`` each covariance's (l2 - l3) / l1."""
    jp, jm, ji = _j(pts), _j(mask), _j(idx)
    cov, n_nbr = jb._neighbor_cov(jp, jm, ji, radius)
    evals, evecs = jnp.linalg.eigh(cov)
    nbr_n = evecs[:, :, 0][ji]
    ok = jm[ji] & (jnp.linalg.norm(jp[ji] - jp[:, None, :], axis=-1) <= radius)
    C = jnp.einsum("nki,nkj->nij", nbr_n * ok.astype(jnp.float32)[..., None],
                   nbr_n)
    tr = C[:, 0, 0] + C[:, 1, 1] + C[:, 2, 2]
    resp = jnp.linalg.det(C) - harris_k * tr * tr
    ev = np.asarray(evals)
    gap = (ev[:, 1] - ev[:, 0]) / np.maximum(ev[:, 2], 1e-30)
    return np.asarray(C), np.asarray(resp), np.asarray(n_nbr), gap


def _torch_harris_parts(pts, mask, idx, radius=1.0, harris_k=0.04):
    tp, tm, ti = _t(pts), _t(mask), _t(idx)
    cov, _ = tb._neighbor_cov(tp, tm, ti, radius)
    nbr_n = tb._eigh(cov)[1][:, :, 0][ti]
    ok = tm[ti] & (torch.linalg.norm(tp[ti] - tp[:, None, :], dim=-1)
                   <= radius)
    C = torch.einsum("nki,nkj->nij", nbr_n * ok.float()[..., None], nbr_n)
    tr = C[:, 0, 0] + C[:, 1, 1] + C[:, 2, 2]
    return C.numpy(), (torch.linalg.det(C) - harris_k * tr * tr).numpy()


def test_harris_c_and_response_match_jax():
    """On the structured scene all but two valid covariances have a
    well-defined normal, and C and the response agree given JAX's
    lists."""
    pts, mask = structured_scene()
    idx = np.asarray(jb._knn_neighbors(_j(pts), _j(mask), K))
    jC, jresp, _, gap = _jax_harris_parts(pts, mask, idx)
    assert (gap[mask] < 1e-2).sum() <= 2
    tC, tresp = _torch_harris_parts(pts, mask, idx)
    scale = np.abs(jC).max((1, 2), keepdims=True)
    assert (np.abs(tC - jC) <= 1e-4 * np.maximum(scale, 1e-12)).all()
    assert (np.abs(tresp - jresp) <= 1e-4 * np.abs(jresp).max()).all()


def _jax_dog(pts, mask, idx, min_scale=0.5, n_octaves=4, n_scales=8):
    """caelo_tpu/frontend/baselines.py:163-179 on JAX's lists: ``(dog,
    sigmas, d2, okn)``."""
    jp, jm, ji = _j(pts), _j(mask), _j(idx)
    nbr = jp[ji]
    d2 = jnp.sum((nbr - jp[:, None, :]) ** 2, axis=-1)
    okn = jm[ji] & jm[:, None]
    zn = jnp.where(okn, nbr[..., 2], 0.0)
    wv = okn.astype(jnp.float32)
    n_levels = n_octaves * n_scales + 1
    sigmas = min_scale * 2.0 ** (jnp.arange(n_levels, dtype=jnp.float32)
                                 / n_scales)

    def smooth(sig):
        w = jnp.exp(-d2 / (2.0 * sig * sig)) * wv
        return jnp.sum(w * zn, axis=-1) / jnp.maximum(jnp.sum(w, axis=-1),
                                                      1e-12)

    smoothed = jax.lax.map(smooth, sigmas)
    return [np.asarray(x) for x in (smoothed[1:] - smoothed[:-1], sigmas, d2,
                                    okn)]


def test_sift_scale_space_matches_jax(scene):
    _, pts, mask, idx = scene
    jdog, jsig, jd2, jokn = _jax_dog(pts, mask, idx)
    tdog, tsig, td2, tokn = tb._sift_scale_space(_t(pts), _t(mask), _t(idx),
                                                 0.5, 4, 8)
    np.testing.assert_array_equal(tokn.numpy(), jokn)
    np.testing.assert_allclose(tsig.numpy(), jsig, rtol=1e-6)
    np.testing.assert_allclose(td2.numpy(), jd2, rtol=1e-6, atol=1e-6)
    assert tdog.shape == jdog.shape == (32, len(pts))
    np.testing.assert_allclose(tdog.numpy(), jdog, atol=1e-5, rtol=0)


def test_radius_nms_matches_jax(scene):
    """The same score (ISS's l3, from JAX) through both NMS: equal
    keypoints, in order, with and without a top-k cut."""
    _, pts, mask, idx = scene
    cov, _ = jb._neighbor_cov(_j(pts), _j(mask), _j(idx), 2.0)
    l3 = np.asarray(jnp.linalg.eigh(cov)[0])[:, 0]
    score = np.where(mask & (np.arange(len(pts)) % 3 > 0), l3, -np.inf
                     ).astype(np.float32)
    for n_kp in (16, 1024):
        jk, jm = jb._radius_nms(_j(pts), _j(mask), _j(score), 2.0, n_kp,
                                _j(idx))
        tk, tm = tb._radius_nms(_t(pts), _t(mask), _t(score), 2.0, n_kp,
                                _t(idx))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 16 < int(np.asarray(jm).sum()) < 1024


DETECTORS = {"iss": (jb.iss_keypoints, tb.iss_keypoints),
             "harris": (jb.harris3d_keypoints, tb.harris3d_keypoints),
             "sift": (jb.sift3d_keypoints, tb.sift3d_keypoints)}


@pytest.mark.parametrize("name", list(DETECTORS))
@pytest.mark.parametrize("n_kp", [16, 1024])
def test_detectors_match_jax_end_to_end(scene, name, n_kp):
    """Each detector end to end: keypoint sets equal except counted flips,
    each within 1 unit of tolerance of a decision threshold or next to the
    k-th place another flip moved (``eval/keypoint_flips.py``, on the
    port's CPU values; the distances in the module docstring).  At 16
    keypoints the k-th score cuts; at 1024 nothing does.  Without a flip
    the keypoints come in the same order."""
    sname, pts, mask, _ = scene
    jf, tf = DETECTORS[name]
    jr = jf(_j(pts), _j(mask), n_keypoints=n_kp)
    tr = tf(_t(pts), _t(mask), n_keypoints=n_kp)
    got = explain_flips(name, _t(pts), _t(mask), _t(jr.key_pts),
                        _t(jr.key_mask), tr.key_pts, tr.key_mask, n_kp)
    assert got["unexplained"] == 0, (sname, name, n_kp, got)
    if not got["flips"]:
        np.testing.assert_array_equal(tr.key_mask.numpy(),
                                      np.asarray(jr.key_mask))
        np.testing.assert_array_equal(tr.key_pts.numpy(),
                                      np.asarray(jr.key_pts))
    if name != "sift" or sname == "scan":
        assert got["a"] > 0


def test_random_keypoints_fed_jax_draw_and_own_draw():
    """Fed JAX's categorical draw the port picks the same points; its own
    draw takes valid points only, with replacement, and make_ablation_
    feature_fn's 'random' gives every frame the same draw, as JAX's does."""
    pts, mask = structured_scene()
    key = jax.random.key(3)
    jres = jb.random_keypoints(key, _j(pts), _j(mask), n_keypoints=256)
    draw = jax.random.categorical(key, jnp.where(_j(mask), 0.0, -jnp.inf),
                                  shape=(256,))
    tres = tb.random_keypoints(None, _t(pts), _t(mask), 256,
                               idx=_t(np.asarray(draw)))
    np.testing.assert_array_equal(tres.key_pts.numpy(), np.asarray(jres.key_pts))
    np.testing.assert_array_equal(tres.key_mask.numpy(),
                                  np.asarray(jres.key_mask))
    few = np.zeros(len(pts), bool)
    few[:10] = True
    own = tb.random_keypoints(torch.Generator().manual_seed(0), _t(pts),
                              _t(few), 256)
    assert own.key_mask.all()
    assert len(np.unique(own.key_pts.numpy(), axis=0)) <= 10   # repeats
    assert tb.random_keypoints(None, _t(pts), _t(np.zeros_like(few)),
                               8).key_mask.sum() == 0


@pytest.fixture(scope="module")
def models():
    rp, ep = weights_io.random_flax_params(0)
    return (rp, ep), weights_io.build_models(rp, ep, "cpu", CFG)


def test_features_from_keypoints_match_jax(models):
    """The tiny scan's first 128 points as external keypoints (16 masked):
    patches bit-equal at every scale, descriptors within 1e-4, key_pixels
    int32 zeros."""
    (_, ep), (_, enc) = models
    pts, mask = _scans(1)[0]
    kp = pts[:128, :3].copy()
    km = np.arange(128) % 8 > 0
    jf = jabl.features_from_keypoints(ep, _j(pts), _j(mask), _j(kp), _j(km),
                                      jtiny())
    tf = tabl.features_from_keypoints(enc, _t(pts), _t(mask), _t(kp), _t(km),
                                      CFG)
    jpyr = jgrid.voxelize(_j(pts)[:, :3], _j(mask), jtiny().voxel)
    tpyr = tgrid.voxelize(_t(pts)[:, :3], _t(mask), CFG.voxel)
    for a, b in zip(tgrid.extract_patches(_t(kp), _t(km), tpyr, CFG.voxel),
                    jgrid.extract_patches(_j(kp), _j(km), jpyr,
                                          jtiny().voxel)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(tf.descriptors.numpy(),
                               np.asarray(jf.descriptors), atol=1e-4, rtol=0)
    assert not tf.descriptors[~_t(km)].any()
    assert tf.key_pixels.dtype == torch.int32 and not tf.key_pixels.any()
    assert tf.descriptors.shape == (128, 60)


@pytest.mark.parametrize("source", ["iss", "harris", "sift", "random"])
def test_ablation_feature_fns(models, source):
    """tests/test_ablation_scaling.py::test_ablation_sources against the
    port: (K, 3) keypoints, (K, 60) finite descriptors, zero where masked;
    'random' repeats its draw frame after frame."""
    _, (net, enc) = models
    fn = tabl.make_ablation_feature_fn(source, net, enc, CFG, seed=1)
    pts, mask = _scans(1)[0]
    f = fn(pts, mask)
    assert f.key_pts.shape == (CFG.keypoint.n_keypoints, 3)
    assert f.descriptors.shape == (CFG.keypoint.n_keypoints, 60)
    assert torch.isfinite(f.descriptors).all()
    assert not f.descriptors[~f.mask].any()
    if source == "random":
        g = fn(pts, mask)
        assert torch.equal(g.key_pts, f.key_pts) and f.mask.all()
    else:
        assert f.mask.any()
    with pytest.raises(ValueError):
        tabl.make_ablation_feature_fn("usip", net, enc, CFG)


# ---- tests/test_baselines.py's behaviour tests against the port


def corner_scene(rng, n=3000):
    g = rng.uniform([-20, -20, 0], [20, 20, 0.02], (n - 600, 3))
    w1 = rng.uniform([5, 5, 0], [5.02, 10, 3], (300, 3))
    w2 = rng.uniform([5, 5, 0], [10, 5.02, 3], (300, 3))
    return torch.from_numpy(np.concatenate([g, w1, w2]).astype(np.float32))


def test_iss_prefers_structure(rng):
    pts = corner_scene(rng)
    res = tb.iss_keypoints(pts, torch.ones(len(pts), dtype=torch.bool),
                           n_keypoints=128)
    kp = res.key_pts[res.key_mask].numpy()
    assert kp.shape[0] > 10
    near_wall = (
        (np.abs(kp[:8, 0] - 5) < 2) & (kp[:8, 1] > 3) & (kp[:8, 1] < 12)
    ) | (
        (np.abs(kp[:8, 1] - 5) < 2) & (kp[:8, 0] > 3) & (kp[:8, 0] < 12)
    ) | (kp[:8, 2] > 0.1)
    assert near_wall.mean() >= 0.6


def test_harris_prefers_corner(rng):
    pts = corner_scene(rng)
    res = tb.harris3d_keypoints(pts, torch.ones(len(pts), dtype=torch.bool),
                                n_keypoints=128)
    kp = res.key_pts[res.key_mask].numpy()
    assert kp.shape[0] >= 1
    d_corner = np.linalg.norm(kp[:, :2] - [5, 5], axis=1)
    on_walls = (np.abs(kp[:, 0] - 5) < 1.5) | (np.abs(kp[:, 1] - 5) < 1.5)
    assert (on_walls | (d_corner < 8)).mean() > 0.7


def test_sift_fires_on_height_structure_not_flat(rng):
    n = 2000
    flat = rng.uniform([-20, -20, 0], [20, 20, 0.01], (n, 3)).astype(
        np.float32)
    mask = torch.ones(n, dtype=torch.bool)
    res = tb.sift3d_keypoints(torch.from_numpy(flat), mask, n_keypoints=64)
    assert int(res.key_mask.sum()) == 0
    box = rng.uniform([4, 4, 1.9], [8, 8, 2.0], (400, 3)).astype(np.float32)
    pts = torch.from_numpy(np.concatenate([flat[:-400], box]))
    res = tb.sift3d_keypoints(pts, mask, n_keypoints=64)
    kp = res.key_pts[res.key_mask].numpy()
    assert kp.shape[0] > 5
    near_box = ((kp[:, 0] > 2) & (kp[:, 0] < 10) & (kp[:, 1] > 2)
                & (kp[:, 1] < 10))
    assert near_box.mean() > 0.8


def test_sift_respects_mask(rng):
    n = 1000
    pts = rng.uniform([-20, -20, 0], [20, 20, 0.01], (n, 3)).astype(
        np.float32)
    pts[500:] += [0.0, 0.0, 100.0]
    mask = torch.zeros(n, dtype=torch.bool)
    mask[:500] = True
    res = tb.sift3d_keypoints(torch.from_numpy(pts), mask, n_keypoints=64)
    assert int(res.key_mask.sum()) == 0


def test_random_keypoints_masked(rng):
    pts = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    mask = torch.zeros(500, dtype=torch.bool)
    mask[:50] = True
    res = tb.random_keypoints(torch.Generator().manual_seed(0),
                              torch.from_numpy(pts), mask, n_keypoints=64)
    assert res.key_mask.all()
    assert res.key_pts.abs().max() <= np.abs(pts[:50]).max() + 1e-6
