"""The port's data I/O and command line against the JAX package: KITTI
scans, calibration, the native loader and its numpy fallback, the scan
caches, the ``evaluate`` and ``refine`` commands on the same files,
``selftest`` and ``full`` on the CPU and
the preprocess -> refine -> loop chain.  ``run_odometry`` and the drivers'
generator input are in ``tests/test_torch_cli_odometry.py`` (a file of
their own, so the suite's workers can take them apart from this one),
``odometry --keypoints`` with the other sources in
``tests/test_torch_cli_keypoints.py``, ``scaling`` in
``tests/test_torch_multigpu_train.py``, ``bench`` in
``tests/test_torch_bench.py``.

Tolerances: scans, calibration, scan caches, ``evaluate``'s JSON and the
de-jumped poses bit-equal.  ``_jax_sequential_samples`` (JAX's draws of
``run_odometry``) serves the split-off file and the keypoint sources'.
"""
import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from caelo_tpu import cli as jcli
from caelo_tpu.config import tiny_test_config as jtiny
from caelo_tpu.data import kitti as jkitti
from caelo_tpu.data import scancache as jcache
from caelo_tpu.frontend import registration as jreg
from caelo_tpu_torch import cli
from caelo_tpu_torch.config import ci_config, tiny_test_config
from caelo_tpu_torch.data import kitti as tkitti
from caelo_tpu_torch.data import native_loader as tnative
from caelo_tpu_torch.data import scancache as tcache
from caelo_tpu_torch.models import weights_io
from caelo_tpu_torch.pipeline import run_full_pipeline
from caelo_tpu_torch.utils.telemetry import trace

CFG = tiny_test_config()
CFG_RETRY = dataclasses.replace(
    CFG, ransac=dataclasses.replace(CFG.ransac, min_inlier_abs=40))
N_FRAMES = 5
SEQ = "99"


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """A 5-frame sequence of ground and walls in the KITTI layout, with a
    nontrivial calibration (tests/test_kitti_io.py's tree)."""
    root = tmp_path_factory.mktemp("kitti")
    seq_dir = root / "sequences" / SEQ / "velodyne"
    seq_dir.mkdir(parents=True)
    (root / "poses").mkdir()
    rng = np.random.default_rng(0)
    g = rng.uniform([-40, -40, -1.8], [40, 40, -1.78], (4000, 3))
    w = rng.uniform([10, -20, -1.8], [10.2, 20, 2], (1500, 3))
    w2 = rng.uniform([-20, 15, -1.8], [20, 15.2, 2], (1500, 3))
    world = np.concatenate([g, w, w2]).astype(np.float32)
    R_tr = Rotation.from_euler("xyz", [-90, 0, -90], degrees=True).as_matrix()
    t_tr = np.array([0.05, -0.1, -0.3])
    with open(root / "sequences" / SEQ / "calib.txt", "w") as f:
        for k in ("P0", "P1", "P2", "P3"):
            f.write(f"{k}: " + " ".join(["0"] * 12) + "\n")
        Tr = np.hstack([R_tr, t_tr[:, None]]).reshape(-1)
        f.write("Tr: " + " ".join(f"{v:.9f}" for v in Tr) + "\n")
    poses_cam, Rl, tl = [], np.eye(3), np.zeros(3)
    for i in range(N_FRAMES):
        Rc = R_tr @ Rl @ R_tr.T
        tc = R_tr @ (Rl @ (-R_tr.T @ t_tr) + tl) + t_tr
        poses_cam.append(np.hstack([Rc, tc[:, None]]).reshape(12))
        local = (world - tl) @ Rl
        local = local[np.linalg.norm(local, axis=1) < 60]
        refl = rng.uniform(0, 1, (local.shape[0], 1))
        np.concatenate([local, refl], 1).astype(np.float32).tofile(
            str(seq_dir / f"{i:06d}.bin"))
        tl = tl + Rl @ np.array([1.0, 0.05, 0.0])
        Rl = Rl @ Rotation.from_euler("z", 0.6, degrees=True).as_matrix()
    np.savetxt(root / "poses" / f"{SEQ}.txt", np.array(poses_cam))
    return str(root)


@pytest.mark.parametrize("beam_deg", [0.0, 0.22])
def test_kitti_scans_bit_equal_to_jax(kitti_tree, beam_deg):
    """load_scan, iter_scans (native prefetch), n_frames, the calibration
    and the GT poses equal the JAX package's, bit for bit, with and without
    the beam-angle fix."""
    sens = lambda c: dataclasses.replace(
        c, sensor=dataclasses.replace(c.sensor, beam_correction_deg=beam_deg))
    dt = tkitti.KittiOdometry(kitti_tree, sens(CFG))
    dj = jkitti.KittiOdometry(kitti_tree, sens(jtiny()))
    assert dt.n_frames(SEQ) == dj.n_frames(SEQ) == N_FRAMES
    for i in (0, 3):
        for a, b in zip(dt.load_scan(SEQ, i), dj.load_scan(SEQ, i)):
            np.testing.assert_array_equal(a, b)
    st, sj = list(dt.iter_scans(SEQ, 1)), list(dj.iter_scans(SEQ, 1))
    assert len(st) == len(sj) == N_FRAMES - 1
    for (pt, mt), (pj, mj) in zip(st, sj):
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(st[2][0], dt.load_scan(SEQ, 3)[0])
    for a, b in zip(dt.load_calib(SEQ), dj.load_calib(SEQ)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(dt.load_poses(SEQ), dj.load_poses(SEQ))
    if beam_deg:       # the fix moved the points
        raw = tkitti.KittiOdometry(kitti_tree, CFG).load_scan(SEQ, 0)[0]
        assert not np.array_equal(raw, st[0][0])


@pytest.fixture
def scan_files(tmp_path):
    paths = []
    for i in range(6):
        a = (np.arange(40, dtype=np.float32) + i * 100).reshape(10, 4)
        p = tmp_path / f"{i:06d}.bin"
        a.tofile(str(p))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("native", [True, False])
def test_native_loader_and_fallback(scan_files, monkeypatch, native):
    """tests/test_native_loader.py's contract, on the native library
    (built under caelo_tpu_torch/_build/, not beside its source) and on the
    numpy fallback."""
    if native:
        assert tnative.native_available()
        lib = tnative._library_path()
        assert os.path.exists(lib)
        assert os.path.dirname(os.path.dirname(lib)) == tnative.BUILD_ROOT
    else:
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    out, mask = tnative.load_scan(scan_files[3], 16)
    assert out.shape == (16, 4) and mask.sum() == 10
    assert out[0, 0] == 300.0 and not out[10:].any()
    out, mask = tnative.load_scan(scan_files[0], 4)
    assert mask.all()
    np.testing.assert_array_equal(out[:, 0], [0, 4, 8, 12])
    with pytest.raises(FileNotFoundError):
        tnative.load_scan("/nonexistent/file.bin", 8)
    pf = tnative.ScanPrefetcher(scan_files, max_points=16, depth=2,
                                n_threads=3)
    seen = []
    for out, mask in pf:
        assert mask.sum() == 10
        seen.append(float(out[0, 0]))
    pf.close()
    assert seen == [0, 100, 200, 300, 400, 500]


def test_scan_cache_matches_jax(tmp_path):
    """write_benchmark_cache in chunks writes the JAX package's files bit
    for bit, and NpyScanReader reads the same frames and masks from
    either."""
    kw = dict(n_frames=5, cfg=CFG, seed=1, chunk=2)
    seen = []
    gt_t = tcache.write_benchmark_cache(str(tmp_path / "t" / "c"),
                                        progress=seen.append, **kw)
    gt_j = jcache.write_benchmark_cache(str(tmp_path / "j" / "c"),
                                        **dict(kw, cfg=jtiny()))
    assert seen == [2, 4, 5]
    np.testing.assert_array_equal(gt_t, gt_j)
    for suffix in (".pts.npy", ".msk.npy", ".gt.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "t" / f"c{suffix}"),
                                      np.load(tmp_path / "j" / f"c{suffix}"))
    rt = tcache.NpyScanReader(str(tmp_path / "t" / "c"))
    rj = jcache.NpyScanReader(str(tmp_path / "j" / "c"))
    assert len(rt) == len(rj) == 5
    for i in (0, 4, -1):
        for a, b in zip(rt[i], rj[i]):
            np.testing.assert_array_equal(a, b)
    for i in (0, 4):
        np.testing.assert_array_equal(rt.mask(i), rj.mask(i))
    assert int(rt[1][1].sum()) > 100
    with pytest.raises(IndexError):
        rt[5]
    assert len(list(rt)) == 5


def _jax_sequential_samples(scans, rp, ep, cfg, seed, feature_fn=None):
    """The (H, S) draws JAX's run_odometry makes, per pair, for the plain
    pass and (where pass 1 fails) the motion-prior retry: the key split
    sequence of caelo_tpu/frontend/odometry.py:60-79 and the logits of
    frontend/ransac.py:91-100, replayed with the same gate and fallback,
    on the features of ``feature_fn`` (default: CAE-LO's)."""
    from caelo_tpu.frontend.matching import match_descriptors as jmatch

    H, S = cfg.ransac.n_hypotheses, cfg.ransac.sample_size
    n = len(scans)

    def draw(key, f0, f1, prior=None):
        kw = {}
        if prior is not None:
            kw = dict(pts0=f0.key_pts, pts1=f1.key_pts, prior_R=prior[0],
                      prior_t=prior[1], gate_m=cfg.prior_gate_m)
        _, pm, pd = jmatch(f0.descriptors, f0.mask, f1.descriptors, f1.mask,
                           ratio=cfg.match_ratio, **kw)
        n_top = jnp.maximum(
            (cfg.ransac.sample_top_frac * jnp.sum(pm)).astype(jnp.int32),
            4 * S)
        d = jnp.where(pm, pd, jnp.inf)
        cutoff = jnp.sort(d)[jnp.clip(n_top - 1, 0, pm.shape[0] - 1)]
        logits = jnp.where(pm & (d <= cutoff), 0.0, -jnp.inf)
        return np.array(jax.random.categorical(key, logits, shape=(H, S)))

    if feature_fn is None:
        feature_fn = lambda p, m: jreg.extract_frame_features(
            rp, ep, jnp.asarray(p), jnp.asarray(m), cfg)
    feats = [feature_fn(p, m) for p, m in scans]
    s1 = np.zeros((n - 1, H, S), np.int64)
    s2 = np.zeros((n - 1, H, S), np.int64)
    retried = np.zeros(n - 1, bool)
    key = jax.random.key(seed)
    prevR, prevT = np.eye(3), np.zeros(3)
    for k in range(n - 1):
        f0, f1 = feats[k], feats[k + 1]
        key, sub = jax.random.split(key)
        s1[k] = draw(sub, f0, f1)
        reg = jreg.register_pair(sub, f0, f1, cfg)
        ok = bool(reg.success)
        if not ok:
            key, sub = jax.random.split(key)
            prior = (jnp.asarray(prevR, jnp.float32),
                     jnp.asarray(prevT, jnp.float32))
            s2[k] = draw(sub, f0, f1, prior)
            retried[k] = True
            reg = jreg.register_pair_with_prior(sub, f0, f1, *prior, cfg)
            ok = bool(reg.success)
        R, t = np.asarray(reg.R, np.float64), np.asarray(reg.t, np.float64)
        ang = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
        if ok and (ang > cfg.max_rel_rot_deg
                   or np.linalg.norm(t) > cfg.max_rel_trans_m):
            ok = False
        if ok:
            prevR, prevT = R, t
    return (s1, s2), retried


def _jumpy_trajectory(n=30):
    rng = np.random.default_rng(0)
    poses, R, t = [], np.eye(3), np.zeros(3)
    for k in range(n):
        poses.append(np.concatenate([R, t[:, None]], 1).reshape(12))
        step = np.array([1.0, 0.05, 0.0]) + rng.normal(0, 0.01, 3)
        if k in (9, 21):
            step = step + np.array([1.5, -0.8, 0.1])
        t = t + R @ step
        c, s = np.cos(np.radians(0.5)), np.sin(np.radians(0.5))
        R = R @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return np.stack(poses)


def test_evaluate_and_refine_equal_the_jax_cli(kitti_tree, tmp_path, capsys):
    """``evaluate`` prints the JAX CLI's JSON, and ``refine`` (de-jump)
    writes the JAX CLI's poses, on the same files."""
    gt = os.path.join(kitti_tree, "poses", f"{SEQ}.txt")
    calib = os.path.join(kitti_tree, "sequences", SEQ, "calib.txt")
    est = _jumpy_trajectory(N_FRAMES)
    for name in ("t", "j"):
        os.makedirs(tmp_path / name / "poses_")
        np.savetxt(tmp_path / name / "poses_" / "00.txt", est)
    capsys.readouterr()
    assert cli.main(["evaluate", "--gt", gt, "--est",
                     str(tmp_path / "t" / "poses_" / "00.txt"),
                     "--calib", calib, "--platform", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jcli.cmd_evaluate(argparse.Namespace(
        gt=gt, est=str(tmp_path / "j" / "poses_" / "00.txt"), calib=calib,
        platform=None)) == 0
    want = json.loads(capsys.readouterr().out)
    assert got == want and got["rte_m"] > 0

    traj = _jumpy_trajectory()
    for name in ("t", "j"):
        np.savetxt(tmp_path / name / "poses_" / "00.txt", traj)
    assert cli.main(["refine", "--poses",
                     str(tmp_path / "t" / "poses_" / "00.txt"),
                     "--platform", "cpu"]) == 0
    assert jcli.cmd_refine(argparse.Namespace(
        poses=str(tmp_path / "j" / "poses_" / "00.txt"), out=None,
        artifacts=None, seq="00", platform=None)) == 0
    out = capsys.readouterr().out
    assert "de-jumped 2 frames" in out, out
    got, want = (np.loadtxt(tmp_path / n / "poses__" / "00.txt")
                 for n in ("t", "j"))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, traj)


def test_selftest_small_on_cpu(capsys):
    assert cli.main(["selftest", "--small", "--platform", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["success"] and out["device"] == "cpu"


@pytest.fixture
def random_weights(monkeypatch):
    """The CLI's .h5 loaders answer with random_flax_params(0)."""
    rp, ep = weights_io.random_flax_params(0)
    monkeypatch.setattr(weights_io, "load_respond_layer_params",
                        lambda path=None: rp)
    monkeypatch.setattr(weights_io, "load_patch_encoder_params",
                        lambda path=None: ep)
    return rp, ep


def test_full_ci_on_cpu_equals_run_full_pipeline(kitti_tree, tmp_path,
                                                 random_weights, capsys):
    """``full --ci --platform cpu`` on the KITTI tree writes the four
    trajectories of run_full_pipeline called directly on the same scans."""
    out = str(tmp_path / "runs")
    assert cli.main(["full", "--data", kitti_tree, "--seq", SEQ, "--out",
                     out, "--ci", "--platform", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == N_FRAMES
    cfg = ci_config()
    ds = tkitti.KittiOdometry(kitti_tree, cfg)
    net, enc = weights_io.build_models(*random_weights, "cpu", cfg)
    direct = run_full_pipeline(list(ds.iter_scans(SEQ)), net, enc,
                               *ds.load_calib(SEQ), cfg)
    for name, poses in (("poses_", direct.poses_raw),
                        ("poses__", direct.poses_dejumped),
                        ("poses___", direct.poses_refined),
                        ("poses____", direct.poses_final)):
        np.testing.assert_array_equal(
            np.loadtxt(os.path.join(out, name, f"{SEQ}.txt")), poses)
    assert os.path.exists(os.path.join(out, f"metrics_{SEQ}.jsonl"))


def test_cli_stage_chain_on_cpu(kitti_tree, tmp_path, random_weights,
                                monkeypatch, capsys):
    """odometry, preprocess, refine --artifacts and loop --artifacts at the
    tiny config on the CPU: each writes its (N, 12) trajectory; the front
    end of odometry and preprocess agree."""
    monkeypatch.setattr(cli, "PipelineConfig", tiny_test_config)
    out, art = str(tmp_path / "runs"), str(tmp_path / "art")
    common = ["--data", kitti_tree, "--seq", SEQ, "--out", out,
              "--platform", "cpu"]
    assert cli.main(["odometry", *common]) == 0
    odo = np.loadtxt(os.path.join(out, "poses_", f"{SEQ}.txt"))
    assert cli.main(["preprocess", *common, "--artifacts", art]) == 0
    np.testing.assert_array_equal(
        np.loadtxt(os.path.join(out, "poses_", f"{SEQ}.txt")), odo)
    assert os.path.exists(os.path.join(out, f"odom_{SEQ}.npz"))
    p1 = os.path.join(out, "poses_", f"{SEQ}.txt")
    assert cli.main(["refine", "--poses", p1, "--artifacts", art, "--seq",
                     SEQ, "--platform", "cpu"]) == 0
    p3 = os.path.join(out, "poses___", f"{SEQ}.txt")
    assert cli.main(["loop", "--poses", p3, "--artifacts", art, "--seq", SEQ,
                     "--min-gap", "2", "--platform", "cpu"]) == 0
    for name in ("poses_", "poses__", "poses___", "poses____"):
        P = np.loadtxt(os.path.join(out, name, f"{SEQ}.txt"))
        assert P.shape == (N_FRAMES, 12) and np.isfinite(P).all(), name


def test_cuda_default_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--platform cpu"):
        cli.main(["selftest", "--small"])


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None, "region"):
        torch.ones(4).sum()
    with trace(str(tmp_path / "tr"), "block"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "block.trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "block" for e in events)
