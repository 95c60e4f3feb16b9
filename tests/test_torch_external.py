"""The port's external keypoint loaders (``data/external.py``, a host copy),
voxel decoders and capacity statistics (``voxel/grid.py``) and
visualisation (``eval/viz.py``) against the JAX package.

The loaders read the same synthesized binary files as JAX's and return
equal arrays (tests/test_external.py's 11 tests, mirrored); the decoders
are exact up to XLA's FMA contraction: on the same coords, ``decode_voxels``
and ``decode_patch``'s centres within 2e-5 m of JAX's (XLA's CPU codegen
fuses the multiply-add into an FMA in some lanes and not in others, and the
sum with the -100 m origin rounds at float32's 7.6e-6 spacing near 100),
their re-binning and ``decode_patch``'s mask exact; ``occupancy_stats``
equal, as Python ints (tests/test_decode_dispersion.py mirrored).  The PLY
exports are byte-equal to JAX's; the plots are drawn where matplotlib is
installed.
"""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import caelo_tpu.data.external as jext
from caelo_tpu.config import VoxelConfig as JVoxelConfig
from caelo_tpu.eval import viz as jviz
from caelo_tpu.voxel import grid as jgrid
import caelo_tpu_torch.data.external as text
from caelo_tpu_torch.config import VoxelConfig, small_test_config
from caelo_tpu_torch.eval import viz as tviz
from caelo_tpu_torch.frontend.registration import FrameFeatures, register_pair
from caelo_tpu_torch.voxel import grid as tgrid

CFG = VoxelConfig(max_voxels=(4096, 2048, 512))
JCFG = JVoxelConfig(max_voxels=(4096, 2048, 512))


def _write_bin(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.asarray(arr, np.float32).tofile(path)


def _assert_same(a, b):
    """Equal nested outputs of the two loaders: arrays bit-equal, tuples and
    FrameFeatures field by field, None to None."""
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, tuple):
        assert len(a) == len(b) and isinstance(b, tuple)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_r90_matches_reference_chain():
    np.testing.assert_array_equal(text.R90, jext.R90)
    np.testing.assert_allclose(text.R90 @ text.R90.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(
        text.R90, np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], float)
        @ np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], float), atol=1e-12)


def test_load_point_bin_shape_and_error(tmp_path, rng):
    p = str(tmp_path / "a.bin")
    data = rng.normal(size=(17, 35)).astype(np.float32)
    _write_bin(p, data)
    out = text.load_point_bin(p, 35)
    np.testing.assert_array_equal(out, data)
    _assert_same(out, jext.load_point_bin(p, 35))
    with pytest.raises(ValueError, match="not divisible"):
        text.load_point_bin(p, 34)


def test_load_3dfeatnet_layout(tmp_path, rng):
    kp = rng.uniform(-50, 50, (64, 3)).astype(np.float32)
    desc = rng.normal(size=(64, 32)).astype(np.float32)
    p = str(tmp_path / "000000.bin")
    _write_bin(p, np.concatenate([kp, desc], 1))
    kp2, desc2 = text.load_3dfeatnet(p)
    np.testing.assert_array_equal(kp2, kp)
    np.testing.assert_array_equal(desc2, desc)
    _assert_same((kp2, desc2), jext.load_3dfeatnet(p))


def test_load_usip_r90_roundtrip(tmp_path, rng):
    kp_velo = rng.uniform(-50, 50, (40, 3)).astype(np.float32)
    kp_usip = (text.R90.T @ kp_velo.T).T.astype(np.float32)
    p = str(tmp_path / "000000.bin")
    _write_bin(p, kp_usip)
    out = text.load_usip_keypoints(p, apply_r90=True)
    np.testing.assert_allclose(out, kp_velo, atol=1e-5)
    _assert_same(out, jext.load_usip_keypoints(p, apply_r90=True))
    out_raw = text.load_usip_keypoints(p, apply_r90=False)
    np.testing.assert_array_equal(out_raw, kp_usip)


def test_load_xyzdesc_and_desc_only(tmp_path, rng):
    kp = rng.uniform(-50, 50, (10, 3)).astype(np.float32)
    desc = rng.normal(size=(10, 16)).astype(np.float32)
    p1 = str(tmp_path / "x.bin")
    _write_bin(p1, np.concatenate([kp, desc], 1))
    kp2, d2 = text.load_xyz_descriptors(p1, 16)
    np.testing.assert_array_equal(kp2, kp)
    np.testing.assert_array_equal(d2, desc)
    _assert_same((kp2, d2), jext.load_xyz_descriptors(p1, 16))
    p2 = str(tmp_path / "d.bin")
    _write_bin(p2, desc)
    np.testing.assert_array_equal(text.load_descriptors_only(p2, 16), desc)


def _make_tree(tmp_path, rng, fmt, n_frames=3, n_kp=50, desc_dim=32):
    root = str(tmp_path / fmt)
    desc_root = str(tmp_path / (fmt + "_desc"))
    kps, descs = [], []
    for f in range(n_frames):
        kp = rng.uniform(-50, 50, (n_kp, 3)).astype(np.float32)
        desc = rng.normal(size=(n_kp, desc_dim)).astype(np.float32)
        kps.append(kp)
        descs.append(desc)
        p = os.path.join(root, "00", f"{f:06d}.bin")
        if fmt in ("3dfeatnet", "xyzdesc"):
            _write_bin(p, np.concatenate([kp, desc], 1))
        else:
            _write_bin(p, (text.R90.T @ kp.T).T)
            _write_bin(os.path.join(desc_root, "00", f"{f:06d}.bin"), desc)
    return root, desc_root, kps, descs


@pytest.mark.parametrize("fmt,kw", [
    ("3dfeatnet", {}), ("xyzdesc", {"desc_dim": 16}),
    ("usip", {}), ("usip", {"desc_dim": 16, "with_desc": True}),
    ("3dfeatnet", {"apply_r90": True, "n_slots": 16})])
def test_external_sequences_equal_jax(tmp_path, rng, fmt, kw):
    """Both ExternalSequence classes over the same tree: equal load() and
    features() on every frame, and the same frame count."""
    kw = dict(kw)
    with_desc = kw.pop("with_desc", False)
    root, desc_root, _, _ = _make_tree(tmp_path, rng, fmt,
                                       desc_dim=kw.get("desc_dim", 32))
    if with_desc:
        kw["desc_root"] = desc_root
    t = text.ExternalSequence(root, seq="00", fmt=fmt, **kw)
    j = jext.ExternalSequence(root, seq="00", fmt=fmt, **kw)
    assert t.n_frames() == j.n_frames() == 3
    for f in range(3):
        _assert_same(t.load(f), j.load(f))
        ft, fj = t.features(f), j.features(f)
        assert isinstance(ft, FrameFeatures) == hasattr(fj, "_fields")
        _assert_same(tuple(ft), tuple(fj))


def test_external_sequence_3dfeatnet(tmp_path, rng):
    root, _, kps, descs = _make_tree(tmp_path, rng, "3dfeatnet")
    ext = text.ExternalSequence(root, seq="00", fmt="3dfeatnet", n_slots=64)
    assert ext.n_frames() == 3
    f = ext.features(1)
    assert isinstance(f, FrameFeatures)
    assert f.key_pts.shape == (64, 3)
    assert f.descriptors.shape == (64, 32)
    assert f.mask.sum() == 50
    np.testing.assert_array_equal(f.key_pts[:50], kps[1])
    np.testing.assert_array_equal(f.descriptors[:50], descs[1])
    assert not f.mask[50:].any()


def test_external_sequence_usip_with_desc_tree(tmp_path, rng):
    root, desc_root, kps, descs = _make_tree(tmp_path, rng, "usip",
                                             desc_dim=16)
    ext = text.ExternalSequence(root, seq="00", fmt="usip",
                                desc_root=desc_root, desc_dim=16, n_slots=64)
    f = ext.features(2)
    np.testing.assert_allclose(f.key_pts[:50], kps[2], atol=1e-5)
    np.testing.assert_array_equal(f.descriptors[:50], descs[2])


def test_external_sequence_usip_keypoints_only(tmp_path, rng):
    root, _, kps, _ = _make_tree(tmp_path, rng, "usip")
    ext = text.ExternalSequence(root, seq="00", fmt="usip", n_slots=64)
    out = ext.features(0)
    assert isinstance(out, tuple) and not isinstance(out, FrameFeatures)
    kp, mask = out
    np.testing.assert_allclose(kp[:50], kps[0], atol=1e-5)
    assert mask.sum() == 50


def test_external_sequence_count_mismatch(tmp_path, rng):
    root, desc_root, *_ = _make_tree(tmp_path, rng, "usip", desc_dim=16)
    p = os.path.join(desc_root, "00", "000000.bin")
    np.fromfile(p, np.float32).reshape(-1, 16)[:-1].tofile(p)
    ext = text.ExternalSequence(root, seq="00", fmt="usip",
                                desc_root=desc_root, desc_dim=16, n_slots=64)
    with pytest.raises(ValueError, match="keypoints vs"):
        ext.load(0)


def test_external_truncation_beyond_slots(tmp_path, rng):
    root, _, kps, _ = _make_tree(tmp_path, rng, "3dfeatnet", n_kp=50)
    ext = text.ExternalSequence(root, seq="00", fmt="3dfeatnet", n_slots=16)
    f = ext.features(0)
    assert f.mask.all() and f.key_pts.shape == (16, 3)
    np.testing.assert_array_equal(f.key_pts, kps[0][:16])


def test_external_registration_end_to_end(tmp_path, rng):
    """Two frames of shared external keypoints with 32-dim descriptors under
    a known rigid motion register through the port's front end."""
    cfg = small_test_config()
    n = 200
    kp1 = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    desc = rng.normal(size=(n, 32)).astype(np.float32)
    R_gt = np.array([[np.cos(0.1), -np.sin(0.1), 0],
                     [np.sin(0.1), np.cos(0.1), 0],
                     [0, 0, 1]], np.float32)
    t_gt = np.array([1.0, 0.3, 0.0], np.float32)
    kp0 = (kp1 @ R_gt.T) + t_gt
    root = str(tmp_path / "ext")
    _write_bin(os.path.join(root, "00", "000000.bin"),
               np.concatenate([kp0, desc], 1))
    _write_bin(os.path.join(root, "00", "000001.bin"),
               np.concatenate([kp1, desc], 1))
    ext = text.ExternalSequence(root, seq="00", fmt="3dfeatnet", n_slots=256)
    f0, f1 = (FrameFeatures(*map(torch.from_numpy, ext.features(i)))
              for i in (0, 1))
    reg = register_pair(f0, f1, cfg, generator=torch.Generator().manual_seed(0))
    assert bool(reg.success)
    np.testing.assert_allclose(reg.R.numpy(), R_gt, atol=1e-3)
    np.testing.assert_allclose(reg.t.numpy(), t_gt, atol=1e-2)


# ---- voxel decoders and capacity statistics


def _cloud(rng, n=2000):
    return np.stack([rng.uniform(-40, 40, n), rng.uniform(-40, 40, n),
                     rng.uniform(-2, 5, n)], 1).astype(np.float32)


@pytest.fixture
def pyramids(rng):
    pts = _cloud(rng)
    mask = np.ones(len(pts), bool)
    mask[::17] = False
    return (pts, tgrid.voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                                CFG),
            jgrid.voxelize(jnp.asarray(pts), jnp.asarray(mask), JCFG))


def test_decode_voxels_roundtrip_and_equal_jax(pyramids):
    """decode -> re-bin reproduces the coords exactly, and on JAX's coords
    the centres lie within 2e-5 m of JAX's."""
    _, tpyr, jpyr = pyramids
    for s in range(3):
        jc = np.array(jpyr.coords[s])
        np.testing.assert_allclose(
            tgrid.decode_voxels(torch.from_numpy(jc), s, CFG).numpy(),
            np.asarray(jgrid.decode_voxels(jpyr.coords[s], s, JCFG)),
            atol=2e-5, rtol=0)
        centers = tgrid.decode_voxels(tpyr.coords[s], s, CFG)
        assert centers.dtype == torch.float32
        m = tpyr.masks[s]
        rebinned = tgrid.keypoint_voxels(centers, s, CFG)
        assert torch.equal(rebinned[m], tpyr.coords[s][m])


def test_decode_patch_matches_extraction_and_jax(pyramids):
    """decode_patch inverts extract_patches: the occupied centres re-bin into
    occupied voxels of the pyramid; the mask equals JAX's, the centres lie
    within 2e-5 m of JAX's."""
    pts, tpyr, jpyr = pyramids
    kp = torch.from_numpy(pts[1:5])         # valid points (0 is masked)
    patches = tgrid.extract_patches(kp, torch.ones(4, dtype=torch.bool), tpyr,
                                    CFG)
    for s in range(3):
        occ = patches[s][0]
        centers, occ_mask = tgrid.decode_patch(occ, kp[0], s, CFG)
        jc, jm = jgrid.decode_patch(jnp.asarray(occ.numpy()),
                                    jnp.asarray(pts[1]), s, JCFG)
        np.testing.assert_allclose(centers.numpy(), np.asarray(jc), atol=2e-5,
                                   rtol=0)
        np.testing.assert_array_equal(occ_mask.numpy(), np.asarray(jm))
        assert centers.shape == (CFG.patch_size ** 3, 3)
        assert int(occ_mask.sum()) == int(occ.sum()) > 0
        vox = set(map(tuple, tpyr.coords[s][tpyr.masks[s]].tolist()))
        reb = tgrid.keypoint_voxels(centers[occ_mask], s, CFG)
        assert all(tuple(v) in vox for v in reb.tolist())


def _jax_stats(jpyr):
    st = jgrid.occupancy_stats(jpyr, JCFG)
    return {k: {f: int(v) for f, v in d.items()} for k, d in st.items()}


def test_occupancy_stats_equal_jax(pyramids):
    _, tpyr, jpyr = pyramids
    st = tgrid.occupancy_stats(tpyr, CFG)
    assert st == _jax_stats(jpyr)
    assert all(type(v) is int for d in st.values() for v in d.values())
    assert st["scale0"]["n_voxels"] > st["scale2"]["n_voxels"] > 0


def test_occupancy_stats_counts():
    """tests/test_decode_dispersion.py::test_occupancy_stats_counts: 40
    distinct voxels in one supercell at scale 0, one voxel at scale 2."""
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(3),
                             indexing="ij"), -1).reshape(-1, 3)[:40]
    pts = (g * 0.02 + np.array([5.0, 5.0, 1.0]) + 0.01).astype(np.float32)
    pyr = tgrid.voxelize(torch.from_numpy(pts),
                         torch.ones(len(pts), dtype=torch.bool), CFG)
    st = tgrid.occupancy_stats(pyr, CFG)
    assert st["scale0"] == {"n_voxels": 40, "n_supercells": 1,
                            "max_supercell_occupancy": 40}
    assert st["scale2"]["n_voxels"] == 1
    assert st["scale2"]["max_supercell_occupancy"] == 1
    jpyr = jgrid.voxelize(jnp.asarray(pts), jnp.ones(len(pts), bool), JCFG)
    assert st == _jax_stats(jpyr)


# ---- visualisation


def test_ply_exports_byte_equal_jax(tmp_path, rng, pyramids):
    _, tpyr, jpyr = pyramids
    kp0 = rng.normal(size=(64, 3))
    cols = np.full((64, 3), 128, np.uint8)
    fuse = ([kp0, kp0 + 1], [(np.eye(3), np.zeros(3)),
                             (np.eye(3), np.ones(3))])
    for name, t_call, j_call in (
            ("cloud", lambda p: tviz.export_ply(p, kp0, colors=cols),
             lambda p: jviz.export_ply(p, kp0, colors=cols)),
            ("plain", lambda p: tviz.export_ply(p, kp0),
             lambda p: jviz.export_ply(p, kp0)),
            ("fused", lambda p: tviz.export_fused_ply(p, *fuse),
             lambda p: jviz.export_fused_ply(p, *fuse)),
            ("vox1", lambda p: tviz.export_voxels_ply(p, tpyr, 1, CFG),
             lambda p: jviz.export_voxels_ply(p, jpyr, 1, JCFG))):
        pt = t_call(str(tmp_path / "t" / f"{name}.ply"))
        pj = j_call(str(tmp_path / "j" / f"{name}.ply"))
        with open(pt, "rb") as a, open(pj, "rb") as b:
            assert a.read() == b.read(), name
    head = open(str(tmp_path / "t" / "vox1.ply")).read(200)
    assert f"element vertex {int(tpyr.masks[1].sum())}" in head


def test_plots(tmp_path, rng):
    pytest.importorskip("matplotlib")
    poses = np.tile(np.eye(3, 4).reshape(12), (20, 1))
    poses[:, 3] = np.arange(20)
    kp0 = rng.normal(size=(64, 3))
    for p in (tviz.plot_trajectories(str(tmp_path / "traj.png"),
                                     {"gt": poses, "est": poses + 0.1}),
              tviz.plot_matches(str(tmp_path / "m.png"), kp0, kp0 + 0.5,
                                rng.uniform(size=64) < 0.3),
              tviz.plot_saliency(str(tmp_path / "sal.png"),
                                 rng.uniform(size=(64, 256)))):
        assert os.path.getsize(p) > 100
