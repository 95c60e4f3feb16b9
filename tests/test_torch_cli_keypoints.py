"""``odometry --keypoints`` with every source but cae-lo, through the port's
command line on the CPU at the tiny config, on test_torch_cli.py's 5-frame
KITTI tree (its first 3 frames): the ISS / Harris3D / SIFT3D / random
detectors and external 3DFeatNet / USIP trees written from the port's own
features; the missing ``--external-dir``; ``tools/eval_matrix.py``'s seven
rows; and the ISS row held to JAX's run_odometry.

Tolerances: the detector rows' poses equal run_odometry with the same
feature function; the ISS row against JAX (JAX's ISS keypoints described by
the port, fed JAX's RANSAC draws): descriptors within 1e-4, the same
success flags, inlier counts and inlier pairs, rels within 1e-3 deg /
1e-3 m, poses within 1e-3.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from caelo_tpu.config import tiny_test_config as jtiny
from caelo_tpu.frontend.odometry import run_odometry as jrun_odometry
from caelo_tpu_torch import cli
from caelo_tpu_torch.config import tiny_test_config
from caelo_tpu_torch.data import kitti as tkitti
from caelo_tpu_torch.frontend.odometry import run_odometry
from caelo_tpu_torch.models import weights_io
from test_torch_cli import (CFG, CFG_RETRY, SEQ, _jax_sequential_samples,
                            kitti_tree, random_weights)
from test_torch_slice import _chordal_deg


def jtiny_retry():
    c = jtiny()
    return dataclasses.replace(
        c, ransac=dataclasses.replace(c.ransac, min_inlier_abs=40))


KP_FRAMES = 3          # frames of the tree the keypoint-source rows run


@pytest.fixture(scope="module")
def external_trees(kitti_tree, tmp_path_factory):
    """The port's CAE-LO features of the tree's first KP_FRAMES scans
    (random_flax_params(0)) as a 3DFeatNet tree (35 columns: xyz and the
    first 32 descriptor dimensions) and a USIP tree (keypoints stored
    rotated by R90^T), as examples/eval_matrix.py:68-91 writes them."""
    from caelo_tpu_torch.data.external import R90
    from caelo_tpu_torch.frontend.registration import extract_frame_features

    root = str(tmp_path_factory.mktemp("ext"))
    net, enc = weights_io.build_models(*weights_io.random_flax_params(0),
                                       "cpu", CFG)
    ds = tkitti.KittiOdometry(kitti_tree, CFG)
    for fmt in ("3dfeatnet", "usip"):
        os.makedirs(os.path.join(root, fmt, SEQ))
    for i, (pts, mask) in enumerate(ds.iter_scans(SEQ, 0, KP_FRAMES)):
        f = extract_frame_features(net, enc, torch.from_numpy(pts),
                                   torch.from_numpy(mask), CFG)
        kp = f.key_pts[f.mask].numpy()
        desc = f.descriptors[f.mask].numpy()[:, :32]
        np.concatenate([kp, desc], 1).astype(np.float32).tofile(
            os.path.join(root, "3dfeatnet", SEQ, f"{i:06d}.bin"))
        (R90.T @ kp.T).T.astype(np.float32).tofile(
            os.path.join(root, "usip", SEQ, f"{i:06d}.bin"))
    return root


@pytest.mark.parametrize("source", ["iss", "harris", "sift", "random",
                                    "external-3dfeatnet", "external-usip"])
def test_odometry_keypoint_sources_on_cpu(kitti_tree, external_trees,
                                          tmp_path, random_weights,
                                          monkeypatch, capsys, source):
    """``odometry --keypoints X --platform cpu --frames 3`` at the tiny
    config for every source but cae-lo: exit 0, a (3, 12) trajectory,
    finite and on SO(3), and the odom npz; the detector rows equal
    run_odometry with the same feature function, the external rows read
    the trees written from the port's own features (USIP's through its R90
    fix, described by the encoder; 3DFeatNet's with the file's 32-dim
    descriptors)."""
    from caelo_tpu_torch.frontend.ablation import make_ablation_feature_fn

    monkeypatch.setattr(cli, "PipelineConfig", tiny_test_config)
    out = str(tmp_path / "runs")
    argv = ["odometry", "--data", kitti_tree, "--seq", SEQ, "--out", out,
            "--platform", "cpu", "--frames", str(KP_FRAMES)]
    net, enc = weights_io.build_models(*random_weights, "cpu", CFG)
    if source.startswith("external"):
        fmt = source.split("-")[1]
        argv += ["--keypoints", "external", "--external-dir",
                 os.path.join(external_trees, fmt), "--external-fmt", fmt]
    else:
        argv += ["--keypoints", source]
    capsys.readouterr()
    assert cli.main(argv) == 0
    assert "pair success" in capsys.readouterr().out
    P = np.loadtxt(os.path.join(out, "poses_", f"{SEQ}.txt"))
    assert P.shape == (KP_FRAMES, 12) and np.isfinite(P).all()
    R = P.reshape(-1, 3, 4)[:, :, :3]
    np.testing.assert_allclose(np.einsum("nji,njk->nik", R, R),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-6)
    odo = np.load(os.path.join(out, f"odom_{SEQ}.npz"))
    assert odo["successes"].shape == (KP_FRAMES - 1,)
    if not source.startswith("external"):
        ds = tkitti.KittiOdometry(kitti_tree, CFG)
        direct = run_odometry(ds.iter_scans(SEQ, 0, KP_FRAMES), net, enc,
                              *ds.load_calib(SEQ), CFG,
                              feature_fn=make_ablation_feature_fn(
                                  source, net, enc, CFG))
        np.testing.assert_array_equal(P, direct.poses)


def test_odometry_external_needs_a_directory(kitti_tree, capsys):
    assert cli.main(["odometry", "--data", kitti_tree, "--seq", SEQ,
                     "--keypoints", "external", "--platform", "cpu"]) == 2
    assert ("--keypoints external requires --external-dir"
            in capsys.readouterr().err)


def test_eval_matrix_tool_on_cpu(tmp_path, random_weights, monkeypatch):
    """tools/eval_matrix.py at the tiny config on the CPU, 3 frames of the
    smooth scene: every one of the seven rows scored (finite RRE / RTE /
    ATE, per-scenario counts over the 2 pairs), the win/loss matrix over
    the other six rows, the JSON written where --out says."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "eval_matrix", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "eval_matrix.py"))
    em = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(em)
    monkeypatch.setattr(cli, "PipelineConfig", tiny_test_config)
    out = str(tmp_path / "m.json")
    assert em.main(["--frames", "3", "--weights-random", "--platform", "cpu",
                    "--out", out, "--workdir", str(tmp_path / "w")]) == 0
    with open(out) as f:
        got = json.load(f)
    assert list(got["rows"]) == list(em.ROWS)
    for row, r in got["rows"].items():
        assert all(np.isfinite(r[k]) for k in ("rre_deg", "rte_m",
                                               "ate_rmse")), row
        assert sum(v["pairs"] for v in r["per_scenario"].values()) == 2
    assert all(len(v) == 6 for v in got["win_loss"].values())
    assert got["device"] == "cpu" and got["seconds"] > 0


def test_iss_odometry_matches_jax(kitti_tree, random_weights):
    """The ISS row: the port's run_odometry with ISS keypoints and CAE-LO
    descriptors, fed JAX's RANSAC draws, against JAX's run_odometry with
    JAX's ISS feature function on the tree's scans.  RANSAC samples name
    keypoint positions, so the port describes JAX's ISS keypoints (its own
    detector differs from JAX's at the 128th place and at NMS near-ties,
    tests/test_torch_baselines.py; here it shares at least 80 % of them):
    descriptors within 1e-4, the same success flags, inlier counts and
    inlier pairs, rels within 1e-3 deg / 1e-3 m."""
    from caelo_tpu.frontend.ablation import (make_ablation_feature_fn as
                                             jmake_fn)
    from caelo_tpu_torch.frontend.ablation import (features_from_keypoints,
                                                   make_ablation_feature_fn)

    rp, ep = random_weights                  # Flax-layout numpy params
    cfg, jcfg = CFG_RETRY, jtiny_retry()
    scans = list(tkitti.KittiOdometry(kitti_tree, cfg).iter_scans(
        SEQ, 0, KP_FRAMES))
    jfeats = {id(p): jmake_fn("iss", rp, ep, jcfg)(p, m) for p, m in scans}
    jfn = lambda p, m: jfeats[id(p)]            # one JAX ISS run per scan
    jres = jrun_odometry(iter(scans), rp, ep, cfg=jcfg, seed=0,
                         feature_fn=jfn)
    samples, _ = _jax_sequential_samples(scans, rp, ep, jcfg, 0,
                                         feature_fn=jfn)
    net, enc = weights_io.build_models(rp, ep, "cpu", cfg)
    own = make_ablation_feature_fn("iss", net, enc, cfg)
    t = lambda a: torch.from_numpy(np.array(a))

    def tfn(p, m):
        jf = jfn(p, m)
        f = features_from_keypoints(enc, t(p), t(m), t(jf.key_pts),
                                    t(jf.mask), cfg)
        np.testing.assert_allclose(f.descriptors.numpy(),
                                   np.asarray(jf.descriptors), atol=1e-4,
                                   rtol=0)
        mine = own(p, m)
        kp = lambda x, k: {tuple(r) for r in np.asarray(x)[np.asarray(k)]
                           .tolist()}
        shared = kp(mine.key_pts, mine.mask) & kp(jf.key_pts, jf.mask)
        assert len(shared) >= 0.8 * int(np.asarray(jf.mask).sum()) > 20
        return f

    tres = run_odometry(iter(scans), net, enc, cfg=cfg, seed=0,
                        feature_fn=tfn, samples=samples)
    np.testing.assert_array_equal(tres.successes, jres.successes)
    assert tres.successes.any()
    np.testing.assert_array_equal(tres.n_inliers, jres.n_inliers)
    assert _chordal_deg(tres.rel_Rs, jres.rel_Rs).max() < 1e-3
    assert np.linalg.norm(tres.rel_ts - jres.rel_ts, axis=1).max() < 1e-3
    np.testing.assert_allclose(tres.poses, jres.poses, atol=1e-3)
    for (a0, a1), (b0, b1) in zip(tres.inlier_pairs, jres.inlier_pairs):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)
