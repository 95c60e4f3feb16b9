"""The port's training slice against the JAX package: both auto-encoders'
forward passes, losses and gradients on converted Flax params, three Adam
steps against optax's, the loss-decrease checks of tests/test_training.py,
the trained submodels driving the front end, checkpoints, the ``.h5``
readers, the respond and patch batch pipelines on the same scans and seed,
and both training mains for two steps on the CPU.

Tolerances, all float32:
- forward passes and losses: rtol/atol 1e-5 (sums of at most ~1000
  products at unit scale);
- gradients, per parameter: rtol 1e-4 and atol 1e-5 of the parameter's
  largest gradient (a weight gradient sums ~2,000-65,000 products, so
  elements that cancel to near zero keep only rounding);
- parameters after 3 Adam steps at lr 1e-3: atol 3e-5, 1 % of 3 lr, the
  most 3 steps move an element (an Adam update is ~lr in size whatever the
  gradient's scale).  The two Adams round the bias correction in different
  places and see gradients that agree to ~1e-4 relative, so their updates
  agree to ~1e-4 of lr, except on elements whose gradient is near the
  rounding floor of its sum, where the relative gradient error, and so the
  update's, grows (measured: 4.1e-6 on 1 of 409,600 elements of fn1);
- batches: ring-image inputs exact off the projection's bin edges,
  patches exact.
"""
import os
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from caelo_tpu.config import tiny_test_config as jtiny
from caelo_tpu.frontend.registration import (
    extract_frame_features as jextract)
from caelo_tpu.models import weights_io as jw
from caelo_tpu.models.patch_encoder import VoxelPatchAE as JVoxelAE
from caelo_tpu.models.respond_net import RespondLayer as JRespond
from caelo_tpu.models.respond_net import SphericalRingAE as JSphericalAE
from caelo_tpu.training import drivers as jdrv
from caelo_tpu.training.train import patch_loss as jpatch_loss
from caelo_tpu.training.train import respond_loss as jrespond_loss
from caelo_tpu_torch.config import tiny_test_config
from caelo_tpu_torch.data.synthetic import synthetic_scan_pair
from caelo_tpu_torch.frontend.registration import extract_frame_features
from caelo_tpu_torch.models import weights_io as tw
from caelo_tpu_torch.models.patch_encoder import VoxelPatchAE
from caelo_tpu_torch.models.respond_net import RespondLayer, SphericalRingAE
from caelo_tpu_torch.training import drivers as tdrv
from caelo_tpu_torch.training.train import (adam, create_train_state,
                                            make_train_step, patch_loss,
                                            respond_loss)
from test_torch_models import _edge_cells

LR = 1e-3


def _f32(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _nhwc(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _respond_case(rng, shape=(2, 16, 64, 3)):
    x = rng.normal(size=shape).astype(np.float32)
    params = _f32(JSphericalAE().init(jax.random.key(0), jnp.asarray(x)))
    model = SphericalRingAE()
    model.load_state_dict(tw.spherical_ae_params_to_torch(params))
    return JSphericalAE(), params, model, x, _nhwc(x)


def _voxel_case(rng, act="relu", code_act="linear"):
    x = (rng.uniform(size=(4, 16, 16, 16)) < 0.15).astype(np.float32)
    jm = JVoxelAE(activation=act, code_activation=code_act)
    params = _f32(jm.init(jax.random.key(1), jnp.asarray(x)))
    model = VoxelPatchAE(activation=act, code_activation=code_act)
    model.load_state_dict(tw.voxel_ae_params_to_torch(params))
    return jm, params, model, x, torch.from_numpy(x)


@pytest.mark.parametrize("shape", [(2, 16, 64, 3), (2, 15, 63, 3)])
def test_spherical_ae_forward_matches_flax(rng, shape):
    """Odd sides pool to ceil(s / 2) in both (Flax SAME padding, torch
    ceil_mode), so the output is 16 x 64 for both shapes."""
    jm, params, model, x, xt = _respond_case(rng, shape)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        out = model(xt).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 16, 64, 3)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act,code_act", [("relu", "linear"),
                                          ("tanh", "tanh")])
def test_voxel_ae_forward_matches_flax(rng, act, code_act):
    jm, params, model, x, xt = _voxel_case(rng, act, code_act)
    ref = np.asarray(jm.apply(params, jnp.asarray(x)))[..., 0]
    with torch.no_grad():
        out = model(xt).numpy()
        out5 = model(xt[..., None]).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out5, out)


def _grads_match(jgrads_sd, model):
    for name, p in model.named_parameters():
        want = jgrads_sd[name].numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("which", ["respond", "patch"])
def test_loss_and_grads_match_jax(rng, which):
    if which == "respond":
        jm, params, model, x, xt = _respond_case(rng)
        jloss, tloss, conv = (jrespond_loss, respond_loss,
                              tw.spherical_ae_params_to_torch)
    else:
        jm, params, model, x, xt = _voxel_case(rng)
        jloss, tloss, conv = (jpatch_loss, patch_loss,
                              tw.voxel_ae_params_to_torch)
    lj, gj = jax.value_and_grad(lambda p: jloss(p, jm, jnp.asarray(x)))(params)
    lt = tloss(model, xt)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    _grads_match(conv(_f32(gj)), model)


@pytest.mark.parametrize("which", ["respond", "patch"])
def test_three_adam_steps_match_optax(rng, which):
    if which == "respond":
        jm, params, model, x, xt = _respond_case(rng)
        jloss, tloss, conv = (jrespond_loss, respond_loss,
                              tw.spherical_ae_params_to_torch)
    else:
        jm, params, model, x, xt = _voxel_case(rng)
        jloss, tloss, conv = (jpatch_loss, patch_loss,
                              tw.voxel_ae_params_to_torch)
    opt = optax.adam(LR)
    jp, js = params, opt.init(params)
    state = create_train_state(model, adam(model.parameters(), LR))
    step = make_train_step(tloss)
    for _ in range(3):
        g = jax.grad(lambda p: jloss(p, jm, jnp.asarray(x)))(jp)
        upd, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        state, _ = step(state, xt)
    assert state.step == 3
    want = conv(_f32(jp))
    moved = 0.0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=3e-5, err_msg=name)
        moved = max(moved, float(np.abs(want[name].numpy()
                                        - conv(params)[name].numpy()).max()))
    assert moved > 2 * LR          # the parameters did move


def test_patch_ae_loss_decreases(rng):
    batch = torch.from_numpy(
        (rng.uniform(size=(16, 16, 16, 16)) < 0.15).astype(np.float32))
    model = VoxelPatchAE()
    model.load_state_dict(tw.voxel_ae_params_to_torch(tw.random_ae_params(0)[1]))
    state = create_train_state(model, adam(model.parameters(), 3e-3))
    step = make_train_step(patch_loss)
    losses = []
    for _ in range(20):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < 0.8 * losses[0], losses[::5]


def test_respond_ae_loss_decreases(rng):
    batch = _nhwc(rng.normal(size=(2, 16, 64, 3)).astype(np.float32))
    model = SphericalRingAE()
    model.load_state_dict(
        tw.spherical_ae_params_to_torch(tw.random_ae_params(0)[0]))
    state = create_train_state(model, adam(model.parameters(), 3e-3))
    step = make_train_step(respond_loss)
    losses = []
    for _ in range(20):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert losses[-1] < 0.95 * losses[0], losses[::5]


def test_trained_submodels_drive_the_front_end():
    """The respond and encoder submodules of both AEs, taken from their
    state dicts, are the JAX package's respond_params_from_ae /
    encoder_params_from_ae, and at the training recipe's activations
    (relu / linear) drive extract_frame_features to JAX's features:
    keypoints exact, descriptors to rtol/atol 1e-5."""
    import dataclasses

    cfg_t = dataclasses.replace(tiny_test_config(), encoder_activation="relu",
                                encoder_code_activation="linear")
    cfg_j = dataclasses.replace(jtiny(), encoder_activation="relu",
                                encoder_code_activation="linear")
    ae2 = _f32(JSphericalAE().init(jax.random.key(0), jnp.zeros(
        (1, cfg_j.sensor.model_h, cfg_j.sensor.model_w, 3), jnp.float32)))
    ae3 = _f32(JVoxelAE().init(jax.random.key(1),
                               jnp.zeros((1, 16, 16, 16), jnp.float32)))
    sph, vox = SphericalRingAE(), VoxelPatchAE()
    sph.load_state_dict(tw.spherical_ae_params_to_torch(ae2))
    vox.load_state_dict(tw.voxel_ae_params_to_torch(ae3))
    rsd = tw.respond_params_from_ae(sph.state_dict())
    esd = tw.encoder_params_from_ae(vox.state_dict())
    rp, ep = jw.respond_params_from_ae(ae2), jw.encoder_params_from_ae(ae3)
    for got, want in ((rsd, tw.respond_params_to_torch(rp)),
                      (esd, tw.encoder_params_to_torch(ep))):
        assert got.keys() == want.keys()
        for k in got:
            assert torch.equal(got[k], want[k]), k
    net, enc = tw.build_models_from_state_dicts(rsd, esd, "cpu", cfg_t)
    scan, mask = synthetic_scan_pair(0, cfg_t)[:2]
    f = extract_frame_features(net, enc, torch.from_numpy(scan),
                               torch.from_numpy(mask), cfg_t)
    fj = jextract(rp, ep, jnp.asarray(scan), jnp.asarray(mask), cfg_j)
    assert bool(f.mask.any()) and bool(torch.isfinite(f.descriptors).all())
    np.testing.assert_array_equal(f.key_pixels.numpy(),
                                  np.asarray(fj.key_pixels))
    np.testing.assert_allclose(f.descriptors.numpy(), np.asarray(fj.descriptors),
                               rtol=1e-5, atol=1e-5)


def test_checkpoint_roundtrip(tmp_path):
    model = VoxelPatchAE()
    model.load_state_dict(tw.voxel_ae_params_to_torch(tw.random_ae_params(3)[1]))
    sd = model.state_dict()
    f = tw.save_checkpoint(str(tmp_path / "ck"), sd, step=7)
    assert f == str(tmp_path / "ck" / "7" / "state_dict.pt")
    back = tw.load_checkpoint(str(tmp_path / "ck"), step=7)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    VoxelPatchAE().load_state_dict(back)


def _write_keras_h5(path, layers):
    """A Keras-layout .h5: model_weights/<layer>/<layer>/{kernel,bias}:0."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        g.attrs["layer_names"] = [n.encode() for n, _ in layers]
        g.create_group("flatten_1")          # a layer without weights
        for name, ws in layers:
            lg = g.create_group(name)
            names = [f"{name}/{w}:0" for w in ("kernel", "bias")][:len(ws)]
            lg.attrs["weight_names"] = [n.encode() for n in names]
            for n, w in zip(names, ws):
                lg.create_dataset(n, data=w)


def test_h5_readers_match_jax(tmp_path, rng):
    """The port's copies of the four .h5 readers return the JAX package's
    params from the same Keras files."""
    pytest.importorskip("h5py")
    layer = lambda *s: [rng.normal(size=s).astype(np.float32),
                        rng.normal(size=s[-1:]).astype(np.float32)]
    conv2 = [("conv2d_%d" % i, layer(3, 3, 4, 4)) for i in range(1, 7)]
    conv3 = [("conv3d_%d" % i, layer(3, 3, 3, 2, 2)) for i in range(1, 7)]
    dense = [("dense_%d" % i, layer(5, 5)) for i in range(1, 5)]
    files = {"AE4SphericalRingPC.h5": conv2,
             "AutoencoderModel4VoxelPatch.h5": conv3 + dense,
             "SphericalRingPCRespondLayer.h5": conv2[:2],
             "EncoderModel4VoxelPatch.h5": conv3[:3] + dense[:2]}
    for name, layers in files.items():
        _write_keras_h5(str(tmp_path / name), layers)
    readers = ("load_spherical_ae_params", "load_voxel_ae_params",
               "load_respond_layer_params", "load_patch_encoder_params")
    for fn, name in zip(readers, files):
        path = str(tmp_path / name)
        got, want = getattr(tw, fn)(path), getattr(jw, fn)(path)
        gl, gt = jax.tree_util.tree_flatten_with_path(got)
        wl, wt = jax.tree_util.tree_flatten_with_path(want)
        assert gt == wt, fn
        for (_, a), (_, b) in zip(gl, wl):
            np.testing.assert_array_equal(a, b)


def _tiny_stream(n):
    cfg = tiny_test_config()
    ts, js = tdrv.synthetic_scan_stream(cfg, 0), jdrv.synthetic_scan_stream(
        jtiny(), 0)
    scans = []
    for _ in range(n):
        (pt, mt), (pj, mj) = next(ts), next(js)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(mt, mj)
        scans.append((pt, mt))
    return scans


def test_respond_batches_match_jax():
    """The synthetic scan streams are bit-equal; their respond batches
    agree exactly off the projection's bin edges (NCHW here, NHWC there)."""
    cfg = tiny_test_config()
    scans = _tiny_stream(4)
    got = list(tdrv.respond_batches(iter(scans), cfg, 2, device="cpu"))
    want = list(jdrv.respond_batches(iter(scans), jtiny(), 2))
    assert len(got) == len(want) == 2
    for g, w, pair in zip(got, want, (scans[:2], scans[2:])):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape == (2, cfg.sensor.model_h,
                                      cfg.sensor.model_w, 3)
        for b, (pts, mask) in enumerate(pair):
            bad = np.nonzero((g[b] != w[b]).any(-1))
            edges = _edge_cells(pts[mask], cfg.sensor)
            for cell in zip(*bad):
                assert cell in edges, cell


def test_patch_batches_first_batch_matches_jax():
    """Same scans, respond weights and seed: the first patch batch of the
    port (K1 and K2 through their plain versions on the CPU) equals the JAX
    package's, patch for patch."""
    cfg = tiny_test_config()
    scans = _tiny_stream(2)
    rp = _f32(JRespond().init(jax.random.key(0), jnp.zeros(
        (1, cfg.sensor.model_h, cfg.sensor.model_w, 3), jnp.float32)))
    net = RespondLayer()
    net.load_state_dict(tw.respond_params_to_torch(rp))
    got = next(tdrv.patch_batches(iter(scans), cfg, 64, respond_net=net,
                                  seed=0, device="cpu"))
    want = next(jdrv.patch_batches(iter(scans), jtiny(), 64,
                                   respond_params=rp, seed=0))
    assert got.shape == want.shape == (64, 16, 16, 16)
    assert float(got.sum()) > 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("which", ["respond", "patch"])
def test_train_mains_two_steps_on_cpu(tmp_path, which):
    """train_respond_main / train_patch_main at the default config on
    synthetic scans, two steps on the CPU: a loadable checkpoint, a finite
    loss, and a train record with both stage times."""
    main = {"respond": tdrv.train_respond_main,
            "patch": tdrv.train_patch_main}[which]
    out = str(tmp_path / which)
    args = types.SimpleNamespace(
        data=None, out=out, epochs=1, batch=2 if which == "respond" else 16,
        lr=1e-3, synthetic=True, steps=2, platform="cpu")
    assert main(args) == 0
    model = SphericalRingAE() if which == "respond" else VoxelPatchAE()
    model.load_state_dict(tw.load_checkpoint(out))
    rec = [r for r in tdrv.MetricsLog(
        os.path.join(out, "train_metrics.jsonl")).read()
        if r["event"] == "train"][-1]
    assert rec["model"] == which and rec["steps"] == 2
    assert np.isfinite(rec["final_loss"])
    assert rec["data_ms"] > 0 and rec["step_ms"] > 0
