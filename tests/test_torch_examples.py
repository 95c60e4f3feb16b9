"""The port's example drivers (``caelo_tpu_torch/examples``) against the JAX
scripts of ``examples/``, imported by path (nothing there changes):

(a) the study's plateau loop stops at the same step with the same losses,
    fed one scripted loss sequence through a stub step;
(b) its ray-cast hard pairs are equal arrays;
(c) its ``evaluate`` agrees with JAX's on 2 easy pairs, RANSAC fed JAX's
    own draws: success and the inlier ratio exact, the mean rotation and
    translation errors within 1e-3 deg and 1e-3 m (the tolerance of
    ``tests/test_torch_slice.py``'s window parity test), on
    ``random_flax_params(0)`` and on auto-encoders the port trained for 3
    steps on the CPU (carried to JAX by ``weights_io.*_params_from_torch``).
    At ``tiny_test_config``: at ``small_test_config`` the 1,024-keypoint
    cut of the second frame of both pairs falls among near-equal
    saliencies, which the packages order otherwise (``ROADMAP.md``: top-k
    tie order), so the injected draws index other matches there.  Both
    cases use the trained recipe's encoder activations (relu, linear
    code), so JAX compiles the two programs once;
(d) ``hard_benchmark``'s JSON (floats to 1e-12) and exit code equal the
    JAX script's on canned pipeline results in every gate branch;
(e) its degraded spans at 88 and 520 frames, and its scan caches read by
    the other package both ways;
(f) ``collect_validation``'s rows;
(g) the port alone on the CPU: the pair demo at ``small_test_config`` and
    ``hard_benchmark`` on 12 ray-cast frames at ``tiny_test_config``;
(h) every device driver refuses to run on the CPU unasked.
"""
import argparse
import dataclasses
import importlib.util
import json
import math
import os
import sys
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import caelo_tpu.config as jcfg
import caelo_tpu.data.hard_synthetic as jhard
import caelo_tpu.models.weights_io as jweights
import caelo_tpu.pipeline as jpipe
import caelo_tpu.utils.compcache as jcompcache
from caelo_tpu.data.synthetic import synthetic_scan_pair as jpair
from caelo_tpu.frontend import registration as jreg
from caelo_tpu.frontend.matching import match_descriptors as jmatch
from caelo_tpu_torch import config as tcfg
from caelo_tpu_torch.examples import (collect_validation, hard_benchmark,
                                      kitti_golden, loop_closure_demo,
                                      register_pair_demo, seq_scale)
from caelo_tpu_torch.examples import train_from_scratch_study as study
from caelo_tpu_torch.models import weights_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 88


def _jax_script(name):
    """``examples/<name>.py`` as a module (not registered in sys.modules);
    the compilation cache the scripts enable is left off."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcompcache, "enable_compilation_cache", lambda *a: "")
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the suite runs six workers on the
    host's cores, where an op's threads wait on each other (the CPU runs of
    the front end took 30-50x their time alone with the default threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jstudy():
    return _jax_script("train_from_scratch_study")


@pytest.fixture(scope="module")
def jhb():
    return _jax_script("hard_benchmark")


# ------------------------------------------------------------ (a) plateau
def _scripted(losses):
    it = iter(losses)
    return lambda state, batch: (state + 1, next(it))


LOSSES = {
    # falls, then flat with a little noise: a plateau at a window check
    "plateau": np.concatenate([np.linspace(1.0, 0.3, 30),
                               0.3 + 0.002 * np.sin(np.arange(90))]),
    # falls 3 % a step: no plateau, the step cap ends it
    "falling": 0.97 ** np.arange(120),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_train_loop_plateau_matches_jax(jstudy, name):
    seq = [float(x) for x in LOSSES[name]]
    kw = dict(plateau_window=10, plateau_tol=0.01, min_steps=20)
    sj, lj = jstudy._train_loop(0, _scripted(seq), range(len(seq)), 100,
                                "t", **kw)
    st, lt = study._train_loop(0, _scripted(seq), range(len(seq)), 100,
                               "t", **kw)
    assert (st, lt) == (sj, lj)
    assert len(lt) == (100 if name == "falling" else st) and st <= 100
    if name == "plateau":
        assert st < 100


# -------------------------------------------------------- (b) hard pairs
@pytest.mark.parametrize("span", [3, 5])
def test_hard_pairs_match_jax(jstudy, span):
    got = study._hard_pairs(2, tcfg.tiny_test_config(), span=span)
    want = jstudy._hard_pairs(2, jcfg.tiny_test_config(), span=span)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- (c) evaluate
def _jax_draws(rp, ep, cfg, n_pairs, seed0=900):
    """JAX's RANSAC draws of ``evaluate``'s pairs: ``jax.random.key(i)``
    over the logits of caelo_tpu/frontend/ransac.py:91-100 from JAX's own
    features and matches."""
    H, S = cfg.ransac.n_hypotheses, cfg.ransac.sample_size
    draws = []
    for i in range(n_pairs):
        s0, m0, s1, m1 = jpair(
            seed=seed0 + i, cfg=cfg,
            angle_deg=float(np.random.default_rng(i).uniform(0.5, 3.0)))[:4]
        f0 = jreg.extract_frame_features(rp, ep, jnp.asarray(s0),
                                         jnp.asarray(m0), cfg)
        f1 = jreg.extract_frame_features(rp, ep, jnp.asarray(s1),
                                         jnp.asarray(m1), cfg)
        _, pm, pd = jmatch(f0.descriptors, f0.mask, f1.descriptors, f1.mask,
                           ratio=cfg.match_ratio)
        n_top = jnp.maximum(
            (cfg.ransac.sample_top_frac * jnp.sum(pm)).astype(jnp.int32),
            4 * S)
        d = jnp.where(pm, pd, jnp.inf)
        cutoff = jnp.sort(d)[jnp.clip(n_top - 1, 0, pm.shape[0] - 1)]
        logits = jnp.where(pm & (d <= cutoff), 0.0, -jnp.inf)
        draws.append(np.array(jax.random.categorical(
            jax.random.key(i), logits, shape=(H, S))))
    return draws


def _assert_evaluate_matches(jstudy, rp, ep, nets):
    """``evaluate`` of the port (``nets(cfg)``) against JAX's (Flax ``rp``,
    ``ep``) on 2 easy pairs at tiny_test_config with the relu / linear
    encoder."""
    kw = dict(encoder_activation="relu", encoder_code_activation="linear")
    cfg_j = dataclasses.replace(jcfg.tiny_test_config(), **kw)
    cfg_t = dataclasses.replace(tcfg.tiny_test_config(), **kw)
    want = jstudy.evaluate("e", rp, ep, cfg_j, 2)
    draws = _jax_draws(rp, ep, cfg_j, 2)
    got = study.evaluate("e", *nets(cfg_t), cfg_t, 2,
                         samples=lambda i: draws[i])
    assert got["tag"] == want["tag"] and got["n_pairs"] == 2
    assert got["success_rate"] == want["success_rate"]
    assert got["inlier_ratio_mean"] == want["inlier_ratio_mean"]
    assert abs(got["rot_err_deg_mean"] - want["rot_err_deg_mean"]) < 1e-3
    assert abs(got["t_err_m_mean"] - want["t_err_m_mean"]) < 1e-3


def test_evaluate_matches_jax(jstudy):
    rp, ep = weights_io.random_flax_params(0)
    _assert_evaluate_matches(
        jstudy, rp, ep,
        lambda cfg: weights_io.build_models(rp, ep, "cpu", cfg))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both AEs trained by the port for 3 steps on the CPU (tiny config:
    the weights' shapes do not depend on it)."""
    out = str(tmp_path_factory.mktemp("scratch"))
    r, e, l2, l3 = study.train_both(tcfg.tiny_test_config(), 3, 3, out,
                                    device="cpu")
    assert len(l2) == len(l3) == 3 and np.isfinite(l2 + l3).all()
    return r, e, out


def test_evaluate_on_port_trained_weights_matches_jax(jstudy, trained):
    r, e, out = trained
    sph = weights_io.spherical_ae_params_from_torch(
        weights_io.load_checkpoint(os.path.join(out, "respond_ae")))
    vox = weights_io.voxel_ae_params_from_torch(
        weights_io.load_checkpoint(os.path.join(out, "patch_ae")))
    _assert_evaluate_matches(
        jstudy, jweights.respond_params_from_ae(sph),
        jweights.encoder_params_from_ae(vox),
        lambda cfg: weights_io.build_models_from_state_dicts(r, e, "cpu",
                                                             cfg))


# ------------------------------------------------------- (d) the gates
def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _poses(n, radius=14.0, bend=0.0, noise=0.0, seed=0):
    """(n, 12) poses once around a circle (the last frame back beside the
    first), pushed outwards by ``bend`` metres at the lap's middle and
    jittered by ``noise``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        r = radius + bend * np.sin(np.pi * i / (n - 1)) ** 2
        t = np.array([r * np.cos(a), r * np.sin(a), 0.0]) + rng.normal(
            0, noise, 3)
        R = _rz(a + np.pi / 2 + rng.normal(0, noise * 0.01))
        out.append(np.hstack([R, t[:, None]]).reshape(12))
    return np.array(out)


def _rels(poses):
    P = poses.reshape(-1, 3, 4)
    R = np.einsum("nji,njk->nik", P[:-1, :, :3], P[1:, :, :3])
    t = np.einsum("nji,nj->ni", P[:-1, :, :3], P[1:, :, 3] - P[:-1, :, 3])
    return R, t


# (raw, dejumped, refined, final) as _poses kwargs, loop edges, refined
# spans, burst stats (spans, accepted, gains) or None
CASES = {
    "clean_pass": ([], dict(noise=0.02), dict(noise=0.02),
                   dict(noise=0.02), dict(noise=0.002), [(0, 87)], [],
                   None),
    "clean_fail": ([], dict(noise=0.6, seed=1), dict(noise=0.6, seed=1),
                   dict(noise=0.6, seed=1), dict(noise=0.5, seed=1),
                   [(0, 87), (3, 60)], [], None),
    "degraded_damaged": (["--degraded"], dict(bend=12.0, noise=0.02),
                         dict(bend=12.0, noise=0.02),
                         dict(bend=2.0, noise=0.02), dict(noise=0.002),
                         [(0, 87)], [(25, 32)],
                         ([(25, 32), (58, 63)], [(25, 32)],
                          [(1.23456, 0.54321), (0.5, 0.49)])),
    "degraded_undamaged": (["--degraded"], dict(bend=1.0, noise=0.02),
                           dict(bend=1.0, noise=0.02),
                           dict(bend=0.5, noise=0.02), dict(noise=0.002),
                           [(0, 87)], [], None),
    "degraded_turn": (["--degraded-turn"], dict(bend=12.0, noise=0.02),
                      dict(bend=12.0, noise=0.02),
                      dict(bend=9.0, noise=0.02), dict(noise=0.002),
                      [(0, 87)], [(14, 20)],
                      ([(14, 22)], [], [(2.0, 1.9)])),
    "no_loop": (["--no-loop"], dict(noise=0.02), dict(noise=0.02),
                dict(noise=0.02), dict(noise=0.02), [], [], None),
}
EXIT = {"clean_pass": 0, "clean_fail": 1, "degraded_damaged": 0,
        "degraded_undamaged": 0, "degraded_turn": 1, "no_loop": 0}


def _canned(case, frames=FRAMES):
    """One canned run: ``(gt, result)``, the result as run_full_pipeline's
    fields (numpy), the same object for both packages."""
    _, raw, dj, ref, fin, edges, refined, burst = CASES[case]
    gt = _poses(frames)
    poses = [_poses(frames, **kw) for kw in (raw, dj, ref, fin)]
    rel_R, rel_t = _rels(poses[0])
    result = types.SimpleNamespace(
        poses_raw=poses[0], poses_dejumped=poses[1], poses_refined=poses[2],
        poses_final=poses[3],
        odometry=types.SimpleNamespace(
            rel_Rs=rel_R, rel_ts=rel_t,
            successes=np.arange(frames - 1) % 29 != 5),
        dejumped_frames=[7, 40], n_loop_closures=len(edges),
        loop_edge_i=np.array([a for a, _ in edges], np.int32),
        loop_edge_j=np.array([b for _, b in edges], np.int32),
        refine_stats=types.SimpleNamespace(refined=refined, failed=[(50, 51)]),
        burst_stats=None if burst is None else types.SimpleNamespace(
            spans=burst[0], accepted=burst[1], gains=burst[2]))
    return gt, result


def _scans(frames):
    rng = np.random.default_rng(frames)
    return [(rng.normal(size=(16, 4)).astype(np.float32),
             rng.uniform(size=16) < 0.8) for _ in range(frames)]


class _Pipeline:
    """Stand-ins for generate_benchmark and run_full_pipeline that record
    their arguments and answer the canned run."""

    def __init__(self, case, frames=FRAMES, generate=True):
        self.gt, self.result = _canned(case, frames)
        self.frames, self.generate = frames, generate
        self.spans, self.scans = [], []

    def generate_benchmark(self, n_frames, seed, cfg, degraded_spans=None):
        assert self.generate, "the scans should come from the cache"
        assert n_frames == self.frames
        self.spans.append(degraded_spans)
        return _scans(n_frames), self.gt

    def run_full_pipeline(self, scans, *a, **kw):
        self.scans.append([(np.array(p), np.array(m)) for p, m in scans])
        return self.result


def _run_jax(jhb, monkeypatch, pipe, flags, json_out):
    monkeypatch.setattr(jcompcache, "enable_compilation_cache",
                        lambda *a: "")
    monkeypatch.setattr(jhard, "generate_benchmark", pipe.generate_benchmark)
    monkeypatch.setattr(jpipe, "run_full_pipeline", pipe.run_full_pipeline)
    for name in ("load_respond_layer_params", "load_patch_encoder_params"):
        monkeypatch.setattr(jweights, name, lambda path=None: None)
    monkeypatch.setattr(sys, "argv", ["hard_benchmark.py", "--frames",
                                      str(pipe.frames), *flags,
                                      "--json-out", str(json_out)])
    return jhb.main()


def _run_port(monkeypatch, pipe, flags, json_out):
    rp, ep = weights_io.random_flax_params(0)
    monkeypatch.setattr(weights_io, "load_respond_layer_params",
                        lambda path=None: rp)
    monkeypatch.setattr(weights_io, "load_patch_encoder_params",
                        lambda path=None: ep)
    monkeypatch.setattr(hard_benchmark, "generate_benchmark",
                        pipe.generate_benchmark)
    monkeypatch.setattr(hard_benchmark, "run_full_pipeline",
                        pipe.run_full_pipeline)
    return hard_benchmark.main(["--frames", str(pipe.frames), *flags,
                                "--json-out", str(json_out),
                                "--platform", "cpu"])


def _assert_same(got, want, where="out"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(got, bool):
        assert isinstance(got, (int, float)), where
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=1e-12), (
            where, got, want)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_gates_match_jax(jhb, monkeypatch, tmp_path, case):
    flags = CASES[case][0]
    rc_j = _run_jax(jhb, monkeypatch, _Pipeline(case), flags,
                    tmp_path / "j.json")
    rc_t = _run_port(monkeypatch, _Pipeline(case), flags, tmp_path / "t.json")
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    _assert_same(got, want)
    assert rc_t == rc_j == EXIT[case]
    assert got["gates_pass"] == (rc_t == 0)
    if "--degraded" in flags:
        damage = got["rescue_damage_m"]
        assert (damage > 2.0) == (case != "degraded_undamaged")


# ------------------------------------------------ (e) spans and caches
@pytest.mark.parametrize("frames", [FRAMES, 520])
def test_degraded_spans_match_jax(jhb, monkeypatch, tmp_path, frames):
    for flags in ([], ["--degraded"], ["--degraded-turn"],
                  ["--degraded", "--degraded-turn"]):
        pipe = _Pipeline("clean_pass", frames)
        _run_jax(jhb, monkeypatch, pipe, flags, tmp_path / "j.json")
        want = pipe.spans[0]
        got = hard_benchmark.degraded_spans(frames, "--degraded" in flags,
                                            "--degraded-turn" in flags)
        assert got == want, flags
        assert (got is None) == (not flags)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_scan_cache_read_by_the_other_package(jhb, monkeypatch, tmp_path,
                                              writer):
    cache = str(tmp_path / "cache")
    flags = ["--scan-cache", cache, "--degraded-turn"]
    runs = [lambda pipe: _run_port(monkeypatch, pipe, flags,
                                   tmp_path / "t.json"),
            lambda pipe: _run_jax(jhb, monkeypatch, pipe, flags,
                                  tmp_path / "j.json")]
    if writer == "jax":
        runs.reverse()
    first = _Pipeline("degraded_turn")
    runs[0](first)
    assert os.listdir(cache) == [f"hb_{FRAMES}_0_degturn2.npz"]
    second = _Pipeline("degraded_turn", generate=False)
    runs[1](second)
    (a,), (b,) = first.scans, second.scans
    assert len(a) == len(b) == FRAMES
    for (pa, ma), (pb, mb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ma, mb)


# --------------------------------------------- (f) collect_validation
def test_collect_validation_matches_jax(monkeypatch, tmp_path):
    runs = tmp_path / "runs"
    runs.mkdir()
    rng = np.random.default_rng(0)
    for i, name in enumerate(["hb_deg_w64_s0", "hb_deg_w64_s1",
                              "hb_deg_w64_s0_sc", "hb_degturn_w64_s3",
                              "hb_clean_w64", "hb_clean_w64_sc"]):
        d = {k: float(rng.uniform()) for k in collect_validation.KEYS
             if rng.uniform() < 0.8}
        d["gates_pass"] = bool(i % 4)
        d["per_pair_rre_deg"] = [0.1, 0.2]
        d["stage_seconds"] = {"frontend": {"total_s": 12.3456, "count": 1},
                              "refine": {"total_s": 1.04, "count": 1}}
        (runs / f"{name}.json").write_text(json.dumps(d))
    jcv = _jax_script("collect_validation")
    monkeypatch.setattr(sys, "argv", [
        "collect_validation.py", "--runs-dir", str(runs), "--json-out",
        str(tmp_path / "j.json")])
    assert jcv.main() == 0
    assert collect_validation.main(["--runs-dir", str(runs), "--json-out",
                                    str(tmp_path / "t.json")]) == 0
    want = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == want
    assert len(want["degraded_w64"]) == 2 and want["candidate_ab"]


# ------------------------------------------- (g) the port on the CPU
@pytest.fixture
def random_h5(monkeypatch):
    """The ``.h5`` loaders answer random_flax_params(0) (the shipped files
    are not in the repository)."""
    rp, ep = weights_io.random_flax_params(0)
    monkeypatch.setattr(weights_io, "load_respond_layer_params",
                        lambda path=None: rp)
    monkeypatch.setattr(weights_io, "load_patch_encoder_params",
                        lambda path=None: ep)


def test_register_pair_demo_on_cpu(random_h5, capsys):
    rc = register_pair_demo.run(argparse.Namespace(platform="cpu"),
                                tcfg.small_test_config())
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "success=True" in out and out.rstrip().endswith(
        "(RRE<1deg, RTE<0.5m)")


def test_hard_benchmark_on_cpu(random_h5, tmp_path, capsys):
    args = hard_benchmark.parser().parse_args([
        "--frames", "12", "--no-loop", "--platform", "cpu",
        "--json-out", str(tmp_path / "hb.json")])
    rc = hard_benchmark.run(args, tcfg.tiny_test_config())
    out = json.loads((tmp_path / "hb.json").read_text())
    assert json.loads(capsys.readouterr().out) == out
    assert rc == (0 if out["gates_pass"] else 1)
    assert out["frames"] == 12 and len(out["per_pair_rre_deg"]) == 11
    assert {"frontend", "dejump", "refine"} <= out["stage_seconds"].keys()
    assert all(math.isfinite(v) for v in out.values()
               if isinstance(v, float))
    assert out["pair_success_frontend"] > 0.5


# -------------------------------------------------- (h) the device
@pytest.mark.parametrize("driver,argv", [
    (register_pair_demo, []), (study, []), (hard_benchmark, []),
    (loop_closure_demo, []), (kitti_golden, ["--data", "unused"]),
    (seq_scale, [])])
def test_drivers_refuse_the_cpu_unasked(monkeypatch, driver, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--platform cpu"):
        driver.main(argv)
