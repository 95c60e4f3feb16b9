"""The port on a CUDA device: the three CUDA kernels against their plain
versions at the main path's shapes and at the edges (borders, odd widths,
pixels with no occupied neighbour, all-masked keypoints, clamped slots;
K3's Jacobi bit for bit on random, diagonal, zero, repeated-eigenvalue and
Horn matrices at 1 to 129,024 lanes, the norm in torch's order, and a
pair registered through it against the plain route), one
frame's features and registration, the batched hybrid ICP, the burst map
ICP, a full-width train step of each auto-encoder and the patch trainer's
data path, the keypoint baselines and ``features_from_keypoints`` (K2 at
each scale), on the card against the CPU path; the binning products on
the card against the CPU's at bin edges; every sharded path in a NCCL
world of one rank (``dryrun_multigpu(1, "cuda")``); ``cli selftest``
on the card; and ``examples.hard_benchmark`` on 12 ray-cast frames on the
card.  Every test skips without a CUDA device.

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
from caelo_tpu_torch.config import (IcpConfig, KeypointConfig, SensorConfig,
                                    tiny_test_config)
from caelo_tpu_torch.data.synthetic import (make_scene, range_filter,
                                            sample_scene_points)
from caelo_tpu_torch.frontend import ransac
from caelo_tpu_torch.frontend.ransac import draw_samples
from caelo_tpu_torch.frontend.registration import (extract_frame_features,
                                                   register_pair,
                                                   stack_features)
from caelo_tpu_torch.geometry import se3
from caelo_tpu_torch.models.weights_io import build_models, random_flax_params
from caelo_tpu_torch.ops.masking import pad_points
from caelo_tpu_torch.ops.plane_gather import (patches_from_planes,
                                              patches_from_planes_plain)
from caelo_tpu_torch.ops.saliency import (keypoint_score,
                                          keypoint_score_plain, saliency_map,
                                          saliency_map_plain)
from caelo_tpu_torch.xlamath import (asin, atan2, hypot, mul_reciprocal,
                                     mul_reciprocal_add)

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


def _random_query(rng, slots, K=1024, P=16):
    """A full-range int32 word table whose last row is the zero plane, and
    slots and offsets for K keypoints: zero-plane rows, clamped slots below
    0 and above ``slots``, and offsets 0 and 15 on each axis."""
    table2 = rng.integers(-2**31, 2**31 - 1, (slots + 1, P, P)).astype(np.int32)
    table2[slots] = 0
    slot = rng.integers(0, slots + 1, (K, 2, 2, 2)).astype(np.int32)
    slot[::7] = slots
    slot[1, 0, 0, 0], slot[2, 1, 1, 1] = -3, slots + 9
    o = rng.integers(0, P, (K, 3)).astype(np.int32)
    o[3], o[4], o[5], o[6] = (0, 0, 0), (15, 15, 15), (15, 0, 15), (0, 15, 0)
    return table2, slot, o


@pytest.mark.parametrize("slots", [81920, 6144, 512])
def test_plane_gather_kernel_matches_plain(cuda, rng, slots):
    """K2 (the plane gather writing finished patches) bit-identical to its
    plain version at the three table sizes, one launch."""
    args = [torch.from_numpy(a).to(cuda) for a in _random_query(rng, slots)]
    before = patches_from_planes.launches
    out = patches_from_planes(*args)
    torch.cuda.synchronize()
    assert patches_from_planes.launches == before + 1
    assert torch.equal(out, patches_from_planes_plain(*args))


def test_plane_gather_kernel_all_masked_and_empty(cuda, rng):
    """Keypoints whose 8 slots all name the zero plane give all-zero patches;
    no keypoints give an empty patch tensor and no launch."""
    table2, slot, o = _random_query(rng, 512, K=32)
    slot[:] = 512
    args = [torch.from_numpy(a).to(cuda) for a in (table2, slot, o)]
    out = patches_from_planes(*args)
    torch.cuda.synchronize()
    assert out.shape == (32, 16, 16, 16) and not bool(out.any())
    before = patches_from_planes.launches
    empty = patches_from_planes(args[0], args[1][:0], args[2][:0])
    assert empty.shape == (0, 16, 16, 16)
    assert patches_from_planes.launches == before


def _sensor(H, W):
    """A sensor whose model image is (H, W): 9 deg azimuth steps (40 ring
    columns), W of them kept, 2 spare rows on top."""
    return SensorConfig(n_lines=H, azimuth_res_deg=9.0, safe_edge_top=2,
                        crop_width=40 - W, edge_filter=2, visible_bottom=5.0)


def _score_inputs(rng, shape, sensor, occupied=0.6):
    """Relu'd respond planes ``shape`` (.., 8, H, W), and a ring image and
    counter of the sensor's (ImgH, ImgW) with random z and range."""
    lead, (H, W) = shape[:-3], shape[-2:]
    ih, iw = sensor.img_h, sensor.img_w
    planes = np.maximum(rng.normal(0, 15, shape), 0).astype(np.float32)
    image = np.zeros(lead + (ih, iw, 5), np.float32)
    image[..., 2] = rng.uniform(-3.0, 2.0, lead + (ih, iw))
    image[..., 4] = rng.uniform(0.0, 40.0, lead + (ih, iw))
    counter = (rng.uniform(size=lead + (ih, iw)) < occupied) * rng.integers(
        1, 4, lead + (ih, iw))
    return planes, image, counter.astype(np.int32)


def _assert_scores_match(got, want, thr):
    """K1 against its plain version: n_occ, finiteness of min_d2 and zext
    exact; min_d2 within atol 1e-4 / rtol 1e-5 (8-term float32 sums); the
    good mask exact except where saliency lies within 1e-5 of the
    threshold; score within atol 1e-4 where both pass."""
    assert torch.equal(got.n_occ, want.n_occ)
    fin = torch.isfinite(want.min_d2)
    assert torch.equal(torch.isfinite(got.min_d2), fin)
    torch.testing.assert_close(got.min_d2[fin], want.min_d2[fin], atol=1e-4,
                               rtol=1e-5)
    assert torch.equal(got.zext, want.zext)
    good, good_ref = torch.isfinite(got.score), torch.isfinite(want.score)
    near = (want.saliency - thr).abs() <= 1e-5
    assert torch.equal(good & ~near, good_ref & ~near)
    both = good & good_ref
    torch.testing.assert_close(got.score[both], want.score[both], atol=1e-4,
                               rtol=0)
    torch.testing.assert_close(got.saliency, want.saliency, atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("ground_gate", [True, False])
def test_keypoint_score_kernel_matches_plain(cuda, rng, batch, ground_gate):
    """K1 (saliency and gates in one pass) at the default config's frame
    shape, one frame and a batch, with and without the ground gate."""
    sensor = SensorConfig()
    kp = KeypointConfig() if ground_gate else KeypointConfig(
        ground_z_max=-200.0)
    lead = () if batch is None else (batch,)
    arrs = _score_inputs(rng, lead + (8, sensor.model_h, sensor.model_w),
                         sensor)
    planes, image, counter = (torch.from_numpy(a).to(cuda) for a in arrs)
    before = keypoint_score.launches
    got = keypoint_score(planes, image, counter, sensor, kp, extras=True)
    torch.cuda.synchronize()
    assert keypoint_score.launches == before + 1
    want = keypoint_score_plain(planes, image, counter, sensor, kp,
                                extras=True)
    _assert_scores_match(got, want, kp.norm_diff_threshold)
    assert int(torch.isfinite(want.score).sum()) > 100


@pytest.mark.parametrize("W", [37, 40])
def test_keypoint_score_kernel_borders(cuda, rng, W):
    """K1 on a 13-row frame narrower than a tile, at a width that takes the
    scalar loads (37) and one that takes the 16-byte copies (40), with
    sparse occupancy so that many pixels have no occupied neighbour: the
    zero padding outside the image, the crop and the empty windows agree
    with the plain version.  saliency_map (no gates) agrees too."""
    sensor = _sensor(13, W)
    kp = KeypointConfig(min_neighbors=1, norm_diff_threshold=0.0)
    arrs = _score_inputs(rng, (8, 13, W), sensor, occupied=0.15)
    planes, image, counter = (torch.from_numpy(a).to(cuda) for a in arrs)
    got = keypoint_score(planes, image, counter, sensor, kp, extras=True)
    want = keypoint_score_plain(planes, image, counter, sensor, kp,
                                extras=True)
    torch.cuda.synchronize()
    _assert_scores_match(got, want, kp.norm_diff_threshold)
    assert not bool(torch.isfinite(want.min_d2).all())      # empty windows
    assert bool(torch.isfinite(want.score).any())
    occ = counter[:13, :W] > 0
    md, cnt = saliency_map(planes, occ)
    md_ref, cnt_ref = saliency_map_plain(planes, occ)
    assert torch.equal(cnt, cnt_ref)
    fin = torch.isfinite(md_ref)
    assert torch.equal(torch.isfinite(md), fin)
    torch.testing.assert_close(md[fin], md_ref[fin], atol=1e-4, rtol=1e-5)


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


def _quat_left(q):
    """``(B, 4)`` unit quaternions -> their orthogonal ``(B, 4, 4)``
    left-product matrices."""
    w, x, y, z = q.unbind(-1)
    rows = [[w, -x, -y, -z], [x, w, -z, y], [y, z, w, -x], [z, -y, x, w]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _sym4_lanes(kind, B, dev, g):
    """``(4, 4, B)`` float32 symmetric matrices of one kind."""
    rand = lambda *shape: torch.randn(shape, generator=g, device=dev)
    if kind == "random":
        X = rand(B, 4, 4)
        A = X + X.transpose(1, 2)
    elif kind == "diagonal":
        # every fourth lane's diagonal ties at its largest value
        d = rand(B, 4)
        d[::4, 2] = d[::4, 0] = d[::4].max(1).values + 1.0
        A = torch.diag_embed(d)
    elif kind == "zero":
        A = torch.zeros((B, 4, 4), device=dev)
    elif kind == "repeated":
        # Q diag(3, 3, 1, -2) Q^T: the largest eigenvalue twice
        Q = _quat_left(torch.nn.functional.normalize(rand(B, 4), dim=1))
        D = torch.tensor([3.0, 3.0, 1.0, -2.0], device=dev)
        A = (Q * D) @ Q.transpose(1, 2)
        A = (A + A.transpose(1, 2)) * 0.5
    else:
        return _horn_lanes(g, dev, B)
    return A.permute(1, 2, 0).contiguous()


def _horn_lanes(g, dev, B, n=4, spread=10.0, tilt=None):
    """``(4, 4, B)`` Horn matrices of ``B`` sets of ``n`` points under
    random motions (turns of about ``tilt`` radians where it is given) with
    5 cm of noise: RANSAC's hypotheses at ``n = 4``, its refits at
    hundreds."""
    rand = lambda *shape: torch.randn(shape, generator=g, device=dev)
    q = rand(B, 4) if tilt is None else (
        rand(B, 4) * tilt + torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev))
    R = se3.quat_to_rotmat(torch.nn.functional.normalize(q, dim=1))
    p1 = rand(B, n, 3) * spread
    p0 = se3.apply(R, rand(B, 3), p1) + rand(B, n, 3) * 0.05
    q0, q1 = p0 - p0.mean(1, keepdim=True), p1 - p1.mean(1, keepdim=True)
    M = torch.einsum("bni,bnj->bij", q1, q0)
    return se3._horn_N(M).permute(1, 2, 0).contiguous()


@pytest.mark.parametrize("kind", ["random", "diagonal", "zero", "repeated",
                                  "horn"])
@pytest.mark.parametrize("B", [1, 7, 2048, 129024])
def test_jacobi_kernel_matches_plain(cuda, kind, B):
    """K3 against its plain version on the card, bit for bit, at the live
    refit's 1 lane, the live hypotheses' 2,048 and an offline window's
    63 x 2,048, one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(B)
    A = _sym4_lanes(kind, B, cuda, g)
    before = se3.max_eigvec_sym4x4_lanes.launches
    out = se3.max_eigvec_sym4x4_lanes(A)
    torch.cuda.synchronize()
    assert se3.max_eigvec_sym4x4_lanes.launches == before + 1
    ref = se3.max_eigvec_sym4x4_lanes_plain(A)
    assert out.shape == ref.shape == (4, B)
    assert torch.equal(out, ref)


# Horn matrices of live refits on which torch.linalg.vector_norm's
# single-lane order (a tree) and its batched order (serial) part by an ulp
_REFIT_LANES = [
    [[721632.625, -26.138671875, -175.1884765625, 21487.875],
     [-26.138671875, 203696.8125, 373491.71875, 7287.587890625],
     [-175.1884765625, 373491.71875, -204191.8125, 7862.201171875],
     [21487.875, 7287.587890625, 7862.201171875, -721137.6875]],
    [[764020.5625, -177.880859375, -68.95733642578125, 22839.8125],
     [-177.880859375, 456477.3125, 193569.671875, 1555.1494140625],
     [-68.95733642578125, 193569.671875, -457050.75, 3982.66064453125],
     [22839.8125, 1555.1494140625, 3982.66064453125, -763447.1875]],
    [[424154.46875, -32.32879638671875, -8.51708984375, 12790.03125],
     [-32.32879638671875, 144505.15625, 142941.90625, -229.4757537841797],
     [-8.51708984375, 142941.90625, -144748.03125, 1203.474853515625],
     [12790.03125, -229.4757537841797, 1203.474853515625, -423911.5625]],
]


def test_jacobi_kernel_sums_the_norm_as_torch(cuda):
    """The eigenvector's norm summed in torch's order on the card: a tree
    for a single lane, serially for a batch.  Live refit matrices whose
    two orders differ, and 210 refit-like Horn matrices (500 points each,
    entries ~1e5) alone and in batches of 2 to 7, bit for bit the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(1)
    known = torch.tensor(_REFIT_LANES, device=cuda).permute(1, 2, 0)
    lanes = _horn_lanes(g, cuda, 210, n=500, spread=20.0, tilt=0.02)
    calls = [known[:, :, i:i + 1] for i in range(3)] + [known]
    for n in (1, 2, 3, 5, 7):
        calls += [lanes[:, :, i:i + n] for i in range(0, 210, n)]
    for A in calls:
        assert torch.equal(se3.max_eigvec_sym4x4_lanes(A),
                           se3.max_eigvec_sym4x4_lanes_plain(A))


def test_jacobi_kernel_layouts_sweeps_and_callers(cuda, monkeypatch):
    """K3 on the strided lanes that ``max_eigvec_sym4x4`` hands it, at 0
    and 3 sweeps, and under ``solve_rigid_horn`` and ``rotmat_to_quat``,
    against the plain route on the card, bit for bit; a non-float32 or a
    differentiated input raises."""
    g = torch.Generator(device=cuda).manual_seed(0)
    A = _sym4_lanes("random", 300, cuda, g)
    strided = A.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    assert not strided.is_contiguous()
    for sweeps in (0, 3, 8):
        assert torch.equal(se3.max_eigvec_sym4x4_lanes(strided, sweeps),
                           se3.max_eigvec_sym4x4_lanes_plain(strided, sweeps))
    p1 = torch.randn((5, 50, 3), generator=g, device=cuda) * 5
    R = se3.quat_to_rotmat(torch.nn.functional.normalize(
        torch.randn((5, 4), generator=g, device=cuda), dim=1))
    p0 = se3.apply(R, torch.randn((5, 3), generator=g, device=cuda), p1)
    w = (torch.rand((5, 50), generator=g, device=cuda) < 0.7).float()
    calls = [lambda: (se3.max_eigvec_sym4x4(A.permute(2, 0, 1).reshape(
                 3, 100, 4, 4)),),
             lambda: se3.solve_rigid_horn(p0, p1, w),
             lambda: se3.solve_rigid_horn(p0[0], p1[0]),
             lambda: (se3.rotmat_to_quat(R),)]
    before = se3.max_eigvec_sym4x4_lanes.launches
    got = [fn() for fn in calls]
    assert se3.max_eigvec_sym4x4_lanes.launches == before + len(calls)
    monkeypatch.setattr(se3, "max_eigvec_sym4x4_lanes",
                        se3.max_eigvec_sym4x4_lanes_plain)
    for out, fn in zip(got, calls):
        for a, b in zip(out, fn()):
            assert torch.equal(a, b)
    monkeypatch.undo()
    with pytest.raises(TypeError):
        se3.max_eigvec_sym4x4_lanes(A.double())
    with pytest.raises(TypeError):
        se3.max_eigvec_sym4x4_lanes(A.half())
    with pytest.raises(ValueError):
        se3.max_eigvec_sym4x4_lanes(A.clone().requires_grad_())


def test_pair_through_jacobi_kernel_matches_plain_route(cuda, monkeypatch):
    """One pair at the tiny config registered on the card through K3 and
    through the plain Jacobi, from the same draws: the same success,
    inliers, inlier mask and threshold, R and t within 1e-6; four launches
    (the hypotheses, the refit, its two tightenings), and each of the four
    Horn matrices of the pair solved bit for bit as the plain version."""
    cfg = tiny_test_config()
    params = random_flax_params(0)
    net, enc = build_models(*params, cuda, cfg)
    feats = []
    for shift in (0.0, 0.8):
        pts, mask = (torch.from_numpy(a).to(cuda) for a in _scan(cfg, shift))
        feats.append(extract_frame_features(net, enc, pts, mask, cfg))
    f0, f1 = feats
    samples = draw_samples(f1.mask[None].cpu(), cfg.ransac,
                           torch.Generator().manual_seed(0))[0].to(cuda)
    # the Jacobi's inputs, recorded where RANSAC and the Horn solve build
    # them: (4, 4, H) lanes, then (1, 4, 4) matrices
    seen = []

    def recorder(build):
        def record(M):
            seen.append(build(M))
            return seen[-1]
        return record

    for module, name in ((ransac, "_horn_N_lanes"), (se3, "_horn_N")):
        monkeypatch.setattr(module, name, recorder(getattr(module, name)))
    kernel = se3.max_eigvec_sym4x4_lanes
    before = kernel.launches
    reg_k = register_pair(f0, f1, cfg, samples=samples)
    torch.cuda.synchronize()
    assert cfg.ransac.refit_iters == 2 and kernel.launches == before + 4
    assert len(seen) == 4 and seen[0].shape == (4, 4, cfg.ransac.n_hypotheses)
    monkeypatch.undo()
    monkeypatch.setattr(se3, "max_eigvec_sym4x4_lanes",
                        se3.max_eigvec_sym4x4_lanes_plain)
    reg_p = register_pair(f0, f1, cfg, samples=samples)
    assert kernel.launches == before + 4
    assert bool(reg_k.success) == bool(reg_p.success)
    assert int(reg_k.n_inliers) == int(reg_p.n_inliers)
    assert torch.equal(reg_k.inlier_mask, reg_p.inlier_mask)
    assert torch.equal(reg_k.threshold, reg_p.threshold)
    torch.testing.assert_close(reg_k.R, reg_p.R, atol=1e-6, rtol=0)
    torch.testing.assert_close(reg_k.t, reg_p.t, atol=1e-6, rtol=0)
    monkeypatch.undo()
    for A in [seen[0]] + [N.reshape(-1, 4, 4).permute(1, 2, 0)
                          for N in seen[1:]]:
        assert torch.equal(kernel(A), se3.max_eigvec_sym4x4_lanes_plain(A))


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


def _ae_case(which, rng):
    """A full-width batch and the AE at ``random_ae_params(0)``: the respond
    AE on 16 (3, 64, 1792) ring images at the coordinates' scale, the patch
    AE on 256 (16, 16, 16) occupancy patches (the trainers' default
    batches)."""
    from caelo_tpu_torch.models import weights_io
    from caelo_tpu_torch.models.patch_encoder import VoxelPatchAE
    from caelo_tpu_torch.models.respond_net import SphericalRingAE
    from caelo_tpu_torch.training.train import patch_loss, respond_loss

    sph, vox = weights_io.random_ae_params(0)
    if which == "respond":
        model = SphericalRingAE()
        model.load_state_dict(weights_io.spherical_ae_params_to_torch(sph))
        batch = rng.normal(0, 20, (16, 3, 64, 1792)).astype(np.float32)
        return model, torch.from_numpy(batch), respond_loss
    model = VoxelPatchAE()
    model.load_state_dict(weights_io.voxel_ae_params_to_torch(vox))
    batch = (rng.uniform(size=(256, 16, 16, 16)) < 0.15).astype(np.float32)
    return model, torch.from_numpy(batch), patch_loss


@pytest.mark.parametrize("which", ["respond", "patch"])
def test_train_step_full_width_on_card(cuda, rng, which):
    """One Adam step of each AE at full width on the card, TF32 off: the
    loss to rtol 1e-4 and every gradient to rtol 1e-3 / atol 1e-4 of its
    parameter's largest against the CPU (the weight gradients sum up to
    ~1.8 M products, in another order on cuDNN); the step moves every
    parameter tensor and leaves it finite."""
    from caelo_tpu_torch.training.train import (adam, create_train_state,
                                                make_train_step)

    model, batch, loss_fn = _ae_case(which, rng)
    gpu = type(model)().to(cuda)
    gpu.load_state_dict(model.state_dict())
    loss_cpu = loss_fn(model, batch)
    loss_cpu.backward()
    loss_gpu = loss_fn(gpu, batch.to(cuda))
    loss_gpu.backward()
    torch.testing.assert_close(loss_gpu.detach().cpu(), loss_cpu.detach(),
                               rtol=1e-4, atol=0)
    for (name, p), q in zip(model.named_parameters(), gpu.parameters()):
        scale = float(p.grad.abs().max())
        torch.testing.assert_close(q.grad.cpu(), p.grad, rtol=1e-3,
                                   atol=1e-4 * scale, msg=name)
    before = {k: v.clone() for k, v in gpu.state_dict().items()}
    state = create_train_state(gpu, adam(gpu.parameters()))
    state, loss = make_train_step(loss_fn)(state, batch.to(cuda))
    assert state.step == 1 and bool(torch.isfinite(loss))
    for k, v in gpu.state_dict().items():
        assert bool(torch.isfinite(v).all()), k
        assert not torch.equal(v, before[k]), k


def test_patch_batches_on_card_match_cpu(cuda):
    """The patch trainer's data path on the card -- projection, respond
    net, K1, voxelize, K2 at all three scales -- launches K1 once and K2
    three times for one scan, and its first batch equals the CPU route's
    (the plain versions), patch for patch, at the tiny config.  The scan is
    test_frame_and_pair_on_card_match_cpu's, whose keypoints the card and
    the CPU select alike (elsewhere a pixel whose saliency sits within
    rounding of the gate's threshold may change the count of valid
    keypoints, and with it every draw)."""
    from caelo_tpu_torch.models.respond_net import RespondLayer
    from caelo_tpu_torch.models.weights_io import respond_params_to_torch
    from caelo_tpu_torch.training.drivers import patch_batches

    cfg = tiny_test_config()
    assert cfg.voxel.use_pallas_plane_gather
    scan = _scan(cfg, 0.0)
    batches = {}
    for d in ("cpu", cuda):
        net = RespondLayer()
        net.load_state_dict(respond_params_to_torch(random_flax_params(0)[0]))
        k1, k2 = keypoint_score.launches, patches_from_planes.launches
        batches[d] = next(patch_batches(iter([scan]), cfg, 64,
                                        respond_net=net, seed=0, device=d))
        if d != "cpu":
            assert keypoint_score.launches - k1 == 1
            assert patches_from_planes.launches - k2 == 3
    assert batches[cuda].is_cuda and float(batches["cpu"].sum()) > 0
    assert torch.equal(batches[cuda].cpu(), batches["cpu"])


@pytest.mark.parametrize("name", ["iss", "harris", "sift"])
def test_detectors_on_card_match_cpu(cuda, monkeypatch, name):
    """Each baseline detector on the card against the CPU on the tiny
    config's scan (3,005 of 4,096 points valid): neighbour lists equal but
    for ties at the k-th place (``neighbor_ties``); given the CPU's lists,
    keypoint sets equal but for flips at a decision threshold
    (``explain_flips``), and keypoints found (128 / 17 / 82 on the CPU)."""
    import caelo_tpu_torch.frontend.baselines as bl
    from caelo_tpu_torch.eval.keypoint_flips import (explain_flips,
                                                     neighbor_ties)

    cfg = tiny_test_config()
    n_kp = cfg.keypoint.n_keypoints
    pts, mask = (torch.from_numpy(np.ascontiguousarray(a))
                 for a in _scan(cfg, 0.0))
    pts = pts[:, :3].contiguous()
    idx = bl._knn_neighbors(pts, mask, 64)
    neighbor_ties(pts, mask, idx,
                  bl._knn_neighbors(pts.to(cuda), mask.to(cuda), 64))
    monkeypatch.setattr(bl, "_knn_neighbors",
                        lambda p, m, k, chunk=512: idx.to(p.device))
    fn = {"iss": bl.iss_keypoints, "harris": bl.harris3d_keypoints,
          "sift": bl.sift3d_keypoints}[name]
    res_c = fn(pts, mask, n_keypoints=n_kp)
    res_g = fn(pts.to(cuda), mask.to(cuda), n_keypoints=n_kp)
    assert res_g.key_pts.is_cuda
    got = explain_flips(name, pts, mask, res_c.key_pts, res_c.key_mask,
                        res_g.key_pts.cpu(), res_g.key_mask.cpu(), n_kp,
                        idx=idx)
    assert got["unexplained"] == 0 and got["a"] > 0, got


def test_random_keypoints_on_card(cuda):
    """The card's draw takes valid points only; fed one draw, the card and
    the CPU pick the same points."""
    from caelo_tpu_torch.frontend.baselines import random_keypoints

    pts, mask = (torch.from_numpy(np.ascontiguousarray(a))
                 for a in _scan(tiny_test_config(), 0.0))
    own = random_keypoints(torch.Generator(cuda).manual_seed(0),
                           pts.to(cuda), mask.to(cuda), 256)
    assert own.key_mask.all() and own.key_pts.is_cuda
    draw = torch.nonzero(mask)[:, 0][::7][:256]
    a = random_keypoints(None, pts.to(cuda), mask.to(cuda), 256, idx=draw)
    b = random_keypoints(None, pts, mask, 256, idx=draw)
    assert torch.equal(a.key_pts.cpu(), b.key_pts)


def test_features_from_keypoints_on_card(cuda):
    """``features_from_keypoints`` on the card launches K2 once per scale
    and gives the same patches and descriptors as the plain gather
    (``use_pallas_plane_gather=False``) on the card, and descriptors
    within 1e-5 of the CPU's: the scan's first 128 points as keypoints,
    every 8th masked."""
    from caelo_tpu_torch.frontend.ablation import features_from_keypoints
    from caelo_tpu_torch.voxel.grid import extract_patches, voxelize

    cfg = tiny_test_config()
    assert cfg.voxel.use_pallas_plane_gather
    cfg_plain = dataclasses.replace(cfg, voxel=dataclasses.replace(
        cfg.voxel, use_pallas_plane_gather=False))
    pts, mask = (torch.from_numpy(np.ascontiguousarray(a))
                 for a in _scan(cfg, 0.0))
    kp, km = pts[:128, :3].contiguous(), torch.arange(128) % 8 > 0
    nets = {d: build_models(*random_flax_params(0), d, cfg)
            for d in ("cpu", cuda)}
    k2 = patches_from_planes.launches
    f_gpu = features_from_keypoints(nets[cuda][1], pts.to(cuda),
                                    mask.to(cuda), kp.to(cuda), km.to(cuda),
                                    cfg)
    assert patches_from_planes.launches - k2 == 3
    f_plain = features_from_keypoints(nets[cuda][1], pts.to(cuda),
                                      mask.to(cuda), kp.to(cuda),
                                      km.to(cuda), cfg_plain)
    assert patches_from_planes.launches - k2 == 3
    assert torch.equal(f_gpu.descriptors, f_plain.descriptors)
    pyr = voxelize(pts[:, :3].to(cuda), mask.to(cuda), cfg.voxel)
    for a, b in zip(extract_patches(kp.to(cuda), km.to(cuda), pyr, cfg.voxel),
                    extract_patches(kp.to(cuda), km.to(cuda), pyr,
                                    cfg_plain.voxel)):
        assert torch.equal(a, b) and float(a.sum()) > 0
    f_cpu = features_from_keypoints(nets["cpu"][1], pts, mask, kp, km, cfg)
    torch.testing.assert_close(f_gpu.descriptors.cpu(), f_cpu.descriptors,
                               rtol=1e-5, atol=1e-5)
    assert f_gpu.key_pixels.dtype == torch.int32
    assert not f_gpu.key_pixels.any()


def test_cli_selftest_on_card(cuda, capsys):
    """``selftest`` at the default config and the default platform (the
    card): registration within 1 deg / 0.5 m of the known motion."""
    import json

    from caelo_tpu_torch import cli

    assert cli.main(["selftest"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["success"] and out["device"].startswith("cuda")


@pytest.mark.parametrize("d", [0.02, 0.16, 0.64, np.radians(0.2),
                               np.radians(26.9) / 63, 80.0, 2 * np.pi])
def test_mul_reciprocal_on_card_bins_as_cpu(cuda, rng, d):
    """10^5 float32 coordinates within 2 units of a bin edge: the card's
    product with the divisor's reciprocal, and the ring image's fused
    ``x / d + offset``, equal the CPU's bit for bit."""
    x = (rng.integers(-5000, 5000, 100_000) * np.float32(d)).astype(np.float32)
    for _ in range(2):
        step = rng.integers(-1, 2, x.shape)
        x = np.where(step > 0, np.nextafter(x, np.float32(np.inf)),
                     np.where(step < 0, np.nextafter(x, np.float32(-np.inf)),
                              x)).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(mul_reciprocal(xt.to(cuda), d).cpu().numpy(),
                                  mul_reciprocal(xt, d).numpy())
    off = SensorConfig().vertical_pixel_offset
    np.testing.assert_array_equal(
        mul_reciprocal_add(xt.to(cuda), d, off).cpu().numpy(),
        mul_reciprocal_add(xt, d, off).numpy())


def test_angle_and_range_functions_on_card_as_cpu(cuda, rng):
    """``xlamath``'s ``atan2``, ``asin`` and ``hypot`` (plain float32 and
    float64 ops, XLA's CPU rounding) give on the card the CPU's bits, on
    10^5 values over 12 decades."""
    n = 100_000
    y, x = ((rng.normal(size=n) * 10.0 ** rng.uniform(-6, 6, n)).astype(
        np.float32) for _ in range(2))
    u = rng.uniform(-1, 1, n).astype(np.float32)
    for fn, args in ((atan2, (y, x)), (hypot, (y, x)), (asin, (u,))):
        ts = [torch.from_numpy(a) for a in args]
        np.testing.assert_array_equal(
            fn(*(t.to(cuda) for t in ts)).cpu().numpy(), fn(*ts).numpy())


def test_sharded_paths_in_a_nccl_world_of_one(cuda):
    """``dryrun_multigpu(1, "cuda")``: one spawned rank in a NCCL world
    runs every sharded path on the card at the tiny config, each checked
    against its one-device function (a failed check raises)."""
    from caelo_tpu_torch.parallel.dryrun import dryrun_multigpu

    out = dryrun_multigpu(1, device_type="cuda")
    assert out["ranks"] == 1 and out["window_successes"] > 0
    assert np.isfinite(out["sharded_gn_cost"])


def test_hard_benchmark_on_card(cuda, monkeypatch, tmp_path, capsys):
    """``examples.hard_benchmark`` at the default platform (the card) on 12
    ray-cast frames at the tiny config without loop closure, the ``.h5``
    loaders answering random_flax_params(0): the JSON's values finite, the
    exit code its ``gates_pass``, K1 and K2 on every frame."""
    import json
    import math

    from caelo_tpu_torch.examples import hard_benchmark
    from caelo_tpu_torch.models import weights_io

    rp, ep = random_flax_params(0)
    monkeypatch.setattr(weights_io, "load_respond_layer_params",
                        lambda path=None: rp)
    monkeypatch.setattr(weights_io, "load_patch_encoder_params",
                        lambda path=None: ep)
    args = hard_benchmark.parser().parse_args([
        "--frames", "12", "--no-loop", "--json-out", str(tmp_path / "hb.json")])
    k1, k2 = keypoint_score.launches, patches_from_planes.launches
    rc = hard_benchmark.run(args, tiny_test_config())
    out = json.loads((tmp_path / "hb.json").read_text())
    assert json.loads(capsys.readouterr().out) == out
    assert rc == (0 if out["gates_pass"] else 1)
    assert len(out["per_pair_rte_m"]) == 11
    assert all(math.isfinite(v) for v in out.values() if isinstance(v, float))
    assert keypoint_score.launches - k1 >= 12
    assert patches_from_planes.launches - k2 >= 36
