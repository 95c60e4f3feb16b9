"""Port parity: spherical-ring projection, the two models through the
Flax-params converter, and descriptor matching, against the JAX package."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from caelo_tpu.config import PipelineConfig, SensorConfig, tiny_test_config
from caelo_tpu.data.synthetic import synthetic_scan_pair
from caelo_tpu.frontend.matching import match_descriptors as jmatch
from caelo_tpu.models.patch_encoder import PatchEncoder as JEncoder
from caelo_tpu.models.respond_net import RespondLayer as JRespond
from caelo_tpu.projection import spherical as jsph
from caelo_tpu_torch.frontend.matching import match_descriptors as tmatch
from caelo_tpu_torch.models import weights_io
from caelo_tpu_torch.projection import spherical as tsph


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _edge_cells(pts, cfg: SensorConfig, eps=1e-4):
    """Cells next to a bin edge of some point: the azimuth/elevation bins
    (atan2/asin in float32 may land either side) and the 1/64 m range
    buckets of the winner election."""
    x, y, z = (pts[:, i].astype(np.float64) for i in range(3))
    r = np.sqrt(x * x + y * y + z * z)
    colf = (np.pi - np.arctan2(y, x)) / cfg.azimuth_res
    rowf = (np.arcsin(np.clip(z / np.maximum(r, 1e-9), -1, 1))
            / cfg.vertical_res + cfg.vertical_pixel_offset)
    near = lambda f: np.abs(f - np.round(f)) < eps * np.maximum(1, np.abs(f))
    edge = (r > 0) & (near(colf) | near(rowf) | near(r * 64.0))
    cells = set()
    for cf, rf in zip(colf[edge], rowf[edge]):
        for dc in (-eps, eps):
            for dr in (-eps, eps):
                c = min(max(int(np.floor(cf + dc * max(1, cf))), 0),
                        cfg.img_w - 1)
                cells.add((cfg.img_h - int(np.floor(rf + dr * max(1, rf))), c))
    return cells


@pytest.mark.parametrize("which", ["tiny", "default"])
def test_projection_matches_jax(rng, which):
    if which == "tiny":
        cfg = tiny_test_config()
        pts, mask = synthetic_scan_pair(0, cfg)[:2]
        sensor = cfg.sensor
    else:
        sensor = SensorConfig()
        n = 20000
        r = rng.uniform(2, 80, n)
        az = rng.uniform(-np.pi, np.pi, n)
        el = rng.uniform(np.radians(sensor.vertical_view_down_deg),
                         np.radians(sensor.vertical_view_up_deg), n)
        pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                        r * np.sin(el), rng.uniform(0, 1, n)], 1).astype(np.float32)
        mask = rng.uniform(size=n) < 0.95
    img_j, cnt_j = jsph.project_to_spherical_ring(jnp.asarray(pts),
                                                  jnp.asarray(mask), sensor)
    img_t, cnt_t = tsph.project_to_spherical_ring(torch.from_numpy(pts),
                                                  torch.from_numpy(mask), sensor)
    img_j, cnt_j = np.array(img_j), np.asarray(cnt_j)
    img_t, cnt_t = img_t.numpy(), cnt_t.numpy()
    edges = _edge_cells(pts[mask], sensor)
    # the winner (x, y, z, reflectance) and the count: exact off bin edges
    bad = (cnt_t != cnt_j) | (img_t[..., :4] != img_j[..., :4]).any(-1)
    for cell in zip(*np.nonzero(bad)):
        assert cell in edges, cell
    # the range channel: XLA's CPU codegen contracts x*x+y*y+z*z into FMAs,
    # so it may differ from the winner's plain float32 norm by one ulp
    ok = ~bad
    np.testing.assert_allclose(img_t[..., 4][ok], img_j[..., 4][ok], rtol=2e-7)
    crop_t = tsph.model_input(torch.from_numpy(img_j), sensor).numpy()
    np.testing.assert_array_equal(crop_t, np.asarray(
        jsph.model_input(jnp.asarray(img_j), sensor)))


def test_respond_layer_through_converter_matches_flax(rng):
    x = rng.uniform(-40, 40, (2, 16, 96, 3)).astype(np.float32)
    params = _f32(JRespond().init(jax.random.key(0), jnp.asarray(x)))
    ref = np.asarray(JRespond().apply(params, jnp.asarray(x)))
    net, _ = weights_io.build_models(params, weights_io.random_flax_params(0)[1],
                                     "cpu")
    with torch.no_grad():
        out = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act,code_act", [("tanh", "tanh"),
                                          ("relu", "linear")])
def test_patch_encoder_through_converter_matches_flax(rng, act, code_act):
    x = (rng.uniform(size=(6, 16, 16, 16)) < 0.15).astype(np.float32)
    jm = JEncoder(activation=act, code_activation=code_act)
    params = _f32(jm.init(jax.random.key(1), jnp.asarray(x)))
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    cfg = PipelineConfig(encoder_activation=act,
                         encoder_code_activation=code_act)
    _, enc = weights_io.build_models(weights_io.random_flax_params(0)[0],
                                     params, "cpu", cfg)
    with torch.no_grad():
        out = enc(torch.from_numpy(x)).numpy()
        out5 = enc(torch.from_numpy(x[..., None])).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out5, out)


def test_random_flax_params_match_flax_layout():
    """The numpy params chip_smoke.py feeds the converter have the shapes
    Flax's own init gives both models."""
    rp, ep = weights_io.random_flax_params(0)
    fr = JRespond().init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)))
    fe = JEncoder().init(jax.random.key(0), jnp.zeros((1, 16, 16, 16)))
    shape = lambda t: jax.tree.map(np.shape, t)
    assert shape(rp) == shape(fr) and shape(ep) == shape(fe)


def test_ae_params_from_torch_round_trip():
    """``*_ae_params_from_torch`` invert the converters bit for bit, both
    ways, and give the tree of both auto-encoders' Flax init (its shapes,
    traced without running it)."""
    from caelo_tpu.models.patch_encoder import VoxelPatchAE as JVoxelAE
    from caelo_tpu.models.respond_net import SphericalRingAE as JRingAE
    from caelo_tpu_torch.models.patch_encoder import VoxelPatchAE
    from caelo_tpu_torch.models.respond_net import SphericalRingAE

    key = jax.random.key(0)
    sph, vox = weights_io.random_ae_params(0)
    for params, to, back, module, flax in (
            (sph, weights_io.spherical_ae_params_to_torch,
             weights_io.spherical_ae_params_from_torch, SphericalRingAE(),
             jax.eval_shape(JRingAE().init, key, jnp.zeros((1, 8, 8, 3)))),
            (vox, weights_io.voxel_ae_params_to_torch,
             weights_io.voxel_ae_params_from_torch, VoxelPatchAE(),
             jax.eval_shape(JVoxelAE().init, key,
                            jnp.zeros((1, 16, 16, 16))))):
        got = back(to(params))
        assert jax.tree.structure(got) == jax.tree.structure(params)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (jax.tree.map(np.shape, got)
                == jax.tree.map(lambda x: x.shape, flax))
        module.load_state_dict(to(params))
        sd = module.state_dict()
        again = to(back(sd))
        assert again.keys() == sd.keys()
        for k in sd:
            assert torch.equal(again[k], sd[k]), k



def test_load_trained_reads_the_study_checkpoints(tmp_path):
    """``load_trained`` gives the respond layer and encoder of the two
    auto-encoders saved where the study saves them, exactly, ready for
    ``build_models_from_state_dicts``."""
    from caelo_tpu_torch.models.patch_encoder import VoxelPatchAE
    from caelo_tpu_torch.models.respond_net import SphericalRingAE

    sph, vox = weights_io.random_ae_params(0)
    ring, patch = SphericalRingAE(), VoxelPatchAE()
    ring.load_state_dict(weights_io.spherical_ae_params_to_torch(sph))
    patch.load_state_dict(weights_io.voxel_ae_params_to_torch(vox))
    weights_io.save_checkpoint(str(tmp_path / "respond_ae"),
                               ring.state_dict())
    weights_io.save_checkpoint(str(tmp_path / "patch_ae"), patch.state_dict())
    r, e = weights_io.load_trained(str(tmp_path))
    for got, want in ((r, ring.respond.state_dict()),
                      (e, patch.encoder.state_dict())):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for net, sd in zip(weights_io.build_models_from_state_dicts(r, e, "cpu"),
                       (r, e)):
        for k, v in net.state_dict().items():
            assert torch.equal(v, sd[k]), k

def test_match_descriptors_exact_duplicates(rng):
    """Exact duplicate descriptors are at distance exactly 0, whatever the
    matmul's rounding: frame 1 repeats ten frame-0 descriptors, five of
    them twice in frame 0 (an argmin tie at 0, won by the lower index),
    and all ten pass the Lowe gate.  Batched over two pairs.  Given a d2
    that is 1 everywhere, exactly the pairs of equal rows within their own
    pair are set to 0: not a row one ulp off, a row of the other pair or a
    permuted row; also when every fingerprint collides and the
    lexicographic unique decides."""
    from caelo_tpu_torch.frontend import matching

    K0, K1, D = 60, 50, 60
    c0 = rng.normal(size=(2, K0, D)).astype(np.float32)
    c1 = rng.normal(size=(2, K1, D)).astype(np.float32)
    c0[:, 10:15] = c0[:, 5:10]
    c1[:, :10] = c0[:, :10]
    c1[:, 10] = np.nextafter(c0[:, 20], np.float32(np.inf))
    c1[1, 11] = c0[0, 21]                   # a row of the other pair
    c1[:, 12] = c0[:, 22, ::-1]             # a permuted row
    m0 = np.ones((2, K0), bool)
    m1 = np.ones((2, K1), bool)
    it, mt, dt = tmatch(torch.from_numpy(c0), torch.from_numpy(m0),
                        torch.from_numpy(c1), torch.from_numpy(m1),
                        ratio=0.9)
    assert mt[:, :10].all() and not dt[:, :10].any()
    np.testing.assert_array_equal(it[:, :10].numpy(),
                                  np.tile(np.arange(10), (2, 1)))

    same = (c0[:, :, None] == c1[:, None]).all(-1)
    assert same.sum() == 2 * 15
    for golden in (matching._GOLDEN, 0):    # 0: all fingerprints collide
        matching._GOLDEN, keep = golden, matching._GOLDEN
        try:
            got = matching._zero_exact_duplicates(
                torch.ones((2, K0, K1)), torch.from_numpy(c0),
                torch.from_numpy(c1))
        finally:
            matching._GOLDEN = keep
        np.testing.assert_array_equal(got.numpy() == 0, same)


@pytest.mark.parametrize("mode", ["plain", "prior", "ratio"])
def test_match_descriptors_matches_jax(rng, mode):
    K0, K1, D = 60, 50, 60
    c0 = rng.normal(size=(K0, D)).astype(np.float32)
    c1 = rng.normal(size=(K1, D)).astype(np.float32)
    m0 = rng.uniform(size=K0) < 0.9
    m1 = rng.uniform(size=K1) < 0.9
    kw = {}
    if mode == "prior":
        a = 0.1
        R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]], np.float32)
        kw = dict(pts0=rng.uniform(-5, 5, (K0, 3)).astype(np.float32),
                  pts1=rng.uniform(-5, 5, (K1, 3)).astype(np.float32),
                  prior_R=R, prior_t=np.array([0.5, 0, 0], np.float32),
                  gate_m=3.0)
    if mode == "ratio":
        kw = dict(ratio=0.9)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ij, mj, dj = jmatch(jnp.asarray(c0), jnp.asarray(m0), jnp.asarray(c1),
                        jnp.asarray(m1), **jkw)
    it, mt, dt = tmatch(torch.from_numpy(c0), torch.from_numpy(m0),
                        torch.from_numpy(c1), torch.from_numpy(m1), **tkw)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(it.numpy()[mt.numpy()],
                                  np.asarray(ij)[np.asarray(mj)])
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-5)
