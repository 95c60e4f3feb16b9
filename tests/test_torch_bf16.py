"""The port's bfloat16 front end (``compute_dtype="bfloat16"``) against the
JAX package's on the CPU, at ``small_test_config()`` with
``random_flax_params(0)`` in both packages, and against the port's own
float32 with the gates of ``tests/test_bf16.py``.

Tolerances, each measured on this scan (the measurement in brackets):

* respond map: every element within one bfloat16 unit in the last place of
  JAX's value, and under 1e-4 of the elements not equal [1 of 917,504
  differs]: both round the same float32 convolution to bfloat16, summed in
  another order;
* keypoints: at least 99 % of JAX's keypoint pixels shared [100 %];
* descriptors of the shared keypoints: within 2^-7 (two bfloat16 units of
  a tanh code in [0.5, 1)) [2^-9].
"""
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from caelo_tpu.config import small_test_config
from caelo_tpu.data.synthetic import synthetic_scan_pair
from caelo_tpu.frontend import registration as jreg
from caelo_tpu.models.respond_net import RespondLayer as JRespond
from caelo_tpu.projection.spherical import (model_input,
                                            project_to_spherical_ring)
from caelo_tpu_torch import config as tconfig
from caelo_tpu_torch.data.synthetic import synthetic_scan_pair as tscan_pair
from caelo_tpu_torch.frontend import registration as treg
from caelo_tpu_torch.frontend.odometry import run_odometry_windowed
from caelo_tpu_torch.geometry import se3 as tse3
from caelo_tpu_torch.models.weights_io import build_models, random_flax_params

CFG16 = dataclasses.replace(small_test_config(), compute_dtype="bfloat16")
T32 = tconfig.small_test_config()
T16 = dataclasses.replace(T32, compute_dtype="bfloat16")
BF16_ULP_HALF = 2.0 ** -8           # one bfloat16 unit in [0.5, 1)


@pytest.fixture(scope="module")
def run():
    """One scan pair (test_bf16.py's), JAX's bfloat16 features of frame 0,
    and the port's bfloat16 features of both frames and float32 of frame
    0."""
    rp, ep = random_flax_params(0)
    s0, m0, s1, m1, R_gt, t_gt = synthetic_scan_pair(
        seed=0, cfg=small_test_config(), angle_deg=1.5,
        translation=(1.2, 0.15, 0.02))
    fj = jreg.extract_frame_features(rp, ep, jnp.asarray(s0),
                                     jnp.asarray(m0), CFG16)
    net, enc = build_models(rp, ep, "cpu", T32)
    T = torch.from_numpy
    f0 = treg.extract_frame_features(net, enc, T(s0), T(m0), T16)
    f1 = treg.extract_frame_features(net, enc, T(s1), T(m1), T16)
    f0_32 = treg.extract_frame_features(net, enc, T(s0), T(m0), T32)
    return dict(params=(rp, ep), nets=(net, enc), scan0=(s0, m0),
                jax=jreg.FrameFeatures(*(np.asarray(x) for x in fj)),
                bf16=(f0, f1), f32=f0_32, gt=(R_gt, t_gt))


def _shared(fa, fb):
    """Pixels of the valid keypoints both features hold, and each one's
    row in ``fa`` and in ``fb``."""
    rows = lambda f: {tuple(p): i for i, p in
                      enumerate(np.asarray(f.key_pixels).tolist())
                      if bool(f.mask[i])}
    ra, rb = rows(fa), rows(fb)
    common = sorted(set(ra) & set(rb))
    return common, [ra[p] for p in common], [rb[p] for p in common], len(rb)


def test_respond_map_matches_jax(run):
    """The respond net in bfloat16 on frame 0's ring image, cast back to
    float32: within one bfloat16 unit of JAX's, element by element, and
    equal in all but under 1e-4 of the elements."""
    rp, _ = run["params"]
    net, _ = run["nets"]
    s0, m0 = run["scan0"]
    cfg = small_test_config()
    image, _ = project_to_spherical_ring(jnp.asarray(s0), jnp.asarray(m0),
                                         cfg.sensor)
    net_in = model_input(image, cfg.sensor)[None]
    bf = lambda tree: jax.tree.map(
        lambda x: jnp.asarray(x).astype(jnp.bfloat16), tree)
    ref = np.asarray(JRespond().apply(bf(rp), net_in.astype(jnp.bfloat16))[0]
                     .astype(jnp.float32))                     # (H, W, 8)
    got = treg.run_in(net, torch.from_numpy(np.array(net_in)).permute(
        0, 3, 1, 2), torch.bfloat16)[0].permute(1, 2, 0).numpy()
    assert got.dtype == np.float32
    ulp = np.where(ref == 0, 2.0 ** -133,
                   2.0 ** (np.floor(np.log2(np.abs(ref) + 1e-38)) - 7))
    assert (np.abs(got - ref) <= ulp).all()
    assert (got != ref).mean() < 1e-4
    assert ref.max() > 1.0                   # a live map, not all zeros


def test_bf16_features_match_jax(run):
    """extract_frame_features in bfloat16: float32 outputs; at least 99 %
    of JAX's keypoint pixels shared, each at the same point; descriptors of
    the shared keypoints within two bfloat16 units (2^-7)."""
    fj = run["jax"]
    f0 = run["bf16"][0]
    assert f0.descriptors.dtype == torch.float32
    assert f0.key_pts.dtype == torch.float32
    common, it, ij, n_jax = _shared(f0, fj)
    assert len(common) >= 0.99 * n_jax and n_jax > 500
    np.testing.assert_array_equal(f0.key_pts.numpy()[it], fj.key_pts[ij])
    d = np.abs(f0.descriptors.numpy()[it] - fj.descriptors[ij])
    assert d.max() <= 2 * BF16_ULP_HALF, d.max()


def test_bf16_within_float32_gates(run):
    """The port's bfloat16 against its own float32, with test_bf16.py's
    gates: keypoint overlap above 0.7, the shared keypoints' descriptors
    (64 of them) within 0.1, and the pair registers within 1 deg / 0.5 m
    of the true motion."""
    f0, f1 = run["bf16"]
    common, i16, i32, _ = _shared(f0, run["f32"])
    assert len(common) / int(run["f32"].mask.sum()) > 0.7
    d = np.abs(f0.descriptors.numpy()[i16[:64]]
               - run["f32"].descriptors.numpy()[i32[:64]])
    assert d.max() < 0.1, d.max()
    reg = treg.register_pair(f0, f1, T16,
                             generator=torch.Generator().manual_seed(0))
    R_gt, t_gt = run["gt"]
    assert bool(reg.success)
    assert float(tse3.rotation_geodesic_deg(
        reg.R, torch.as_tensor(R_gt, dtype=torch.float32))) < 1.0
    assert float(np.linalg.norm(reg.t.numpy() - t_gt)) < 0.5


def test_bf16_copies_leave_the_modules_alone(run):
    """The modules stay float32; their bfloat16 copies are made once and
    made again after the module's parameters are loaded anew."""
    net, enc = run["nets"]
    for m in (net, enc):
        assert all(p.dtype == torch.float32 for p in m.parameters())
    a = treg._low_precision_params(enc, torch.bfloat16)
    assert treg._low_precision_params(enc, torch.bfloat16) is a
    assert all(v.dtype == torch.bfloat16 for v in a.values())
    enc.load_state_dict(enc.state_dict())
    b = treg._low_precision_params(enc, torch.bfloat16)
    assert b is not a
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_bf16_window_equals_per_frame(run):
    """run_odometry_windowed takes compute_dtype through cfg: at the tiny
    config, a 2-frame window's bfloat16 features equal the per-frame
    extract_frame_features in bfloat16, and differ from float32's."""
    tiny16 = dataclasses.replace(tconfig.tiny_test_config(),
                                 compute_dtype="bfloat16")
    net, enc = build_models(*random_flax_params(0), "cpu", tiny16)
    pairs = list(zip(*[iter(tscan_pair(seed=0, cfg=tiny16)[:4])] * 2))
    _, feats = run_odometry_windowed(pairs, net, enc, cfg=tiny16, window=2,
                                     keep_features=True)
    T = torch.from_numpy
    for j, (p, m) in enumerate(pairs):
        f = treg.extract_frame_features(net, enc, T(p), T(m), tiny16)
        for a, b in zip(f, feats):
            assert torch.equal(a, b[j])
    f32 = treg.extract_frame_features(net, enc, T(pairs[0][0]),
                                      T(pairs[0][1]),
                                      tconfig.tiny_test_config())
    assert not torch.equal(f32.descriptors, feats.descriptors[0])
