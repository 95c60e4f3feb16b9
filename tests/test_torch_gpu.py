"""The port on a CUDA device: both CUDA kernels against their plain versions
at the main path's shapes, one frame's features and registration, the
batched hybrid ICP and the burst map ICP, on the card against the CPU
path.  Every test skips without a CUDA device.

Imports torch and the port only, so the file also runs where JAX is absent
(the repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from caelo_tpu_torch import setup_device
from caelo_tpu_torch.backend.burst import burst_map_icp
from caelo_tpu_torch.backend.icp import icp_hybrid
from caelo_tpu_torch.config import IcpConfig, tiny_test_config
from caelo_tpu_torch.data.synthetic import (make_scene, range_filter,
                                            sample_scene_points)
from caelo_tpu_torch.frontend.ransac import draw_samples
from caelo_tpu_torch.frontend.registration import (extract_frame_features,
                                                   register_pair,
                                                   stack_features)
from caelo_tpu_torch.models.weights_io import build_models, random_flax_params
from caelo_tpu_torch.ops.masking import pad_points
from caelo_tpu_torch.ops.plane_gather import gather_planes, gather_planes_plain
from caelo_tpu_torch.ops.saliency import saliency_map, saliency_map_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return setup_device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("batch", [None, 4])
def test_saliency_kernel_matches_plain(cuda, rng, batch):
    shape = (8, 64, 1792) if batch is None else (batch, 8, 64, 1792)
    planes = torch.from_numpy(
        np.maximum(rng.normal(0, 15, shape), 0).astype(np.float32)).to(cuda)
    occ = torch.from_numpy(rng.uniform(size=shape[:-3] + shape[-2:]) < 0.6
                           ).to(cuda)
    before = saliency_map.launches
    md, cnt = saliency_map(planes, occ)
    torch.cuda.synchronize()
    assert saliency_map.launches == before + 1
    md_ref, cnt_ref = saliency_map_plain(planes, occ)
    assert torch.equal(cnt, cnt_ref)
    fin = torch.isfinite(md_ref)
    assert torch.equal(torch.isfinite(md), fin)
    torch.testing.assert_close(md[fin], md_ref[fin], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("slots", [81920, 6144, 512])
def test_plane_gather_kernel_matches_plain(cuda, rng, slots):
    P = 16
    table2 = torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, (slots + 1, P, P)).astype(np.int32)).to(cuda)
    table2[slots] = 0
    slot = torch.from_numpy(
        rng.integers(-2, slots + 3, (1024, 2, 2, 2)).astype(np.int32)).to(cuda)
    before = gather_planes.launches
    out = gather_planes(table2, slot)
    torch.cuda.synchronize()
    assert gather_planes.launches == before + 1
    assert torch.equal(out, gather_planes_plain(table2, slot))


def _scan(cfg, shift):
    world = sample_scene_points(make_scene(0, n_boxes=25, extent=30.0), 0,
                                cfg.max_points)
    local = range_filter((world - np.array([shift, 0.0, 0.0])
                          ).astype(np.float32), cfg.sensor)
    refl = np.full((len(local), 1), 0.5, np.float32)
    return pad_points(np.concatenate([local, refl], 1), cfg.max_points)


def test_frame_and_pair_on_card_match_cpu(cuda):
    """Both kernels on the card against the all-plain CPU path: the same
    keypoints, descriptors to rtol/atol 1e-5, and the same registration
    from the same injected RANSAC samples."""
    cfg = tiny_test_config()
    cfg_k = dataclasses.replace(cfg, voxel=dataclasses.replace(
        cfg.voxel, use_pallas_plane_gather=True))
    params = random_flax_params(0)
    nets = {d: build_models(*params, d, cfg) for d in ("cpu", cuda)}
    feats = {d: [] for d in nets}
    for shift in (0.0, 0.8):
        pts, mask = (torch.from_numpy(a) for a in _scan(cfg, shift))
        for d, (net, enc) in nets.items():
            feats[d].append(extract_frame_features(
                net, enc, pts.to(d), mask.to(d), cfg_k))
    f_cpu, f_gpu = (stack_features(feats[d]) for d in nets)
    assert torch.equal(f_gpu.key_pixels.cpu(), f_cpu.key_pixels)
    assert torch.equal(f_gpu.key_pts.cpu(), f_cpu.key_pts)
    torch.testing.assert_close(f_gpu.descriptors.cpu(), f_cpu.descriptors,
                               rtol=1e-5, atol=1e-5)
    split = lambda f: [type(f)(*(x[i] for x in f)) for i in (0, 1)]
    samples = draw_samples(f_cpu.mask[1:], cfg.ransac,
                           torch.Generator().manual_seed(0))[0]
    reg_cpu = register_pair(*split(f_cpu), cfg, samples=samples)
    reg_gpu = register_pair(*split(f_gpu), cfg, samples=samples.to(cuda))
    assert bool(reg_gpu.success) == bool(reg_cpu.success)
    assert int(reg_gpu.n_inliers) == int(reg_cpu.n_inliers)
    torch.testing.assert_close(reg_gpu.R.cpu(), reg_cpu.R, atol=1e-4, rtol=0)
    torch.testing.assert_close(reg_gpu.t.cpu(), reg_cpu.t, atol=1e-4, rtol=0)


def _rot_z(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def test_icp_hybrid_on_card_matches_cpu(cuda, rng):
    """Hybrid ICP over 4 spans of two walls and the ground (2048 points,
    512 planar rows, each span its own small motion), TF32 off: the same
    success and trip counts, R and t within 1e-4, residuals within 1e-5 m,
    as the CPU parity tests hold the port to JAX."""
    S, n, p = 4, 2048, 512
    args = [[] for _ in range(8)]
    for s in range(S):
        g = rng.uniform([-10, -10, 0], [10, 10, 0.01], (n // 2, 3))
        w1 = rng.uniform([-10, 7.99, 0], [10, 8.01, 5], (n // 4, 3))
        w2 = rng.uniform([6.99, -10, 0], [7.01, 10, 5], (n // 4, 3))
        c0 = np.concatenate([g, w1, w2])
        R, t = _rot_z(rng.uniform(-1, 1)), rng.uniform(-0.3, 0.3, 3)
        q0 = np.concatenate([rng.uniform([-10, -10, 0], [10, 10, 0], (p, 3)),
                             np.tile([0, 0, 1.0], (p, 1))], 1)
        q1 = np.concatenate([(q0[:, :3] - t) @ R, q0[:, 3:] @ R], 1)
        for k, a in enumerate((c0, np.arange(n) < n - 9 * s, (c0 - t) @ R,
                               np.ones(n, bool), q0, np.ones(p, bool), q1,
                               np.arange(p) < p - 5 * s)):
            args[k].append(a)
    host = [torch.from_numpy(a if a.dtype == bool else a.astype(np.float32))
            for a in map(np.stack, args)]
    cfg = IcpConfig()
    res_cpu = icp_hybrid(*host, cfg)
    res_gpu = icp_hybrid(*(a.to(cuda) for a in host), cfg)
    assert bool(res_cpu.success.all())
    assert torch.equal(res_gpu.success.cpu(), res_cpu.success)
    assert torch.equal(res_gpu.iters.cpu(), res_cpu.iters)
    torch.testing.assert_close(res_gpu.R.cpu(), res_cpu.R, atol=1e-4, rtol=0)
    torch.testing.assert_close(res_gpu.t.cpu(), res_cpu.t, atol=1e-4, rtol=0)
    for a, b in ((res_gpu.init_res, res_cpu.init_res),
                 (res_gpu.final_res, res_cpu.final_res)):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)


def _turn_span(rng, E=2048, n_frames=8):
    """A structured world (ground, two walls, posts) seen from 8 poses
    through a 6 deg/frame turn, the interior frames through a 90 deg
    wedge; straight-line initial rels."""
    world = np.concatenate([
        rng.uniform([-30, -30, -1.8], [30, 30, -1.75], (2000, 3)),
        rng.uniform([12, -25, -1.8], [12.3, 25, 2.5], (1000, 3)),
        rng.uniform([-25, 14, -1.8], [25, 14.3, 2.5], (500, 3)),
        rng.uniform([-20, -20, -1.8], [20, 20, 3.0], (500, 3))])
    pts = np.zeros((n_frames, E, 3), np.float32)
    msk = np.zeros((n_frames, E), bool)
    R, t = np.eye(3), np.zeros(3)
    for k in range(n_frames):
        local = (world - t) @ R
        if 0 < k < n_frames - 1:
            az = np.degrees(np.arctan2(local[:, 1], local[:, 0]))
            local = local[np.abs(az) < 45.0]
        local = local + rng.normal(0, 0.01, local.shape)
        m = min(len(local), E)
        pts[k, :m], msk[k, :m] = local[:m], True
        t = t + R @ np.array([0.8, 0.0, 0.0])
        R = R @ _rot_z(6.0)
    init_R = np.tile(np.eye(3, dtype=np.float32), (n_frames - 1, 1, 1))
    init_t = np.tile(np.float32([0.8, 0.0, 0.0]), (n_frames - 1, 1))
    return pts, msk, init_R, init_t


def test_burst_map_icp_on_card_matches_cpu(cuda, rng):
    """burst_map_icp over a 7-pair wedge span through a turn, TF32 off: the
    same per-frame and closure success; rel rotations and the closure
    within 1e-3, rel translations within 5e-3 m, residuals within 5e-4 m,
    the bounds the CPU parity test holds the port to JAX with (the span's
    own float32 conditioning, tests/test_torch_burst.py::
    test_jax_burst_map_icp_conditioning)."""
    args = [torch.from_numpy(a) for a in _turn_span(rng)]
    cfg = IcpConfig(max_points=2048, max_iters=20, min_inliers=60)
    kw = dict(icp_cfg=cfg, frame_budget=512, thr_scale=2.0)
    cpu = burst_map_icp(*args, 7, **kw)
    gpu = burst_map_icp(*(a.to(cuda) for a in args), 7, **kw)
    assert cpu[2].all() and cpu[7]
    np.testing.assert_array_equal(gpu[2], cpu[2])
    assert gpu[7] == cpu[7]
    for k, tol in ((0, 1e-3), (1, 5e-3), (5, 1e-3), (6, 1e-3)):
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], atol=tol, rtol=0)
    for k in (3, 4):
        np.testing.assert_allclose(gpu[k], cpu[k], atol=5e-4, rtol=0)
    assert abs(gpu[8] - cpu[8]) < 5e-4
