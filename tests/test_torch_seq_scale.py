"""The port's sequence-scale driver (``caelo_tpu_torch/examples/seq_scale``)
and its parallel scan-cache writer on the CPU:

(a) the driver's JSON and exit code equal those of the JAX script
    ``examples/seq_scale.py`` (imported by path; nothing there changes) on
    a pre-written scan cache and one canned pipeline result, timings
    aside: a run that passes, one for each of the five gates failing, and
    ``--frames`` below the cache's length (the ``_Slice`` view);
(b) ``data.scancache.write_benchmark_cache_parallel``, 2 processes on 6
    frames, writes the three files of ``write_benchmark_cache`` byte for byte, and leaves no
    temporary file;
(c) ``run_full_pipeline(threaded_staging=True)`` over an ``NpyScanReader``
    gives every pose array of the default run bit for bit.
"""
import filecmp
import importlib.util
import json
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

import caelo_tpu.models.weights_io as jweights
import caelo_tpu.pipeline as jpipe
import caelo_tpu.utils.compcache as jcompcache
from caelo_tpu_torch.config import tiny_test_config
from caelo_tpu_torch.data.scancache import (
    NpyScanReader, write_benchmark_cache, write_benchmark_cache_parallel)
from caelo_tpu_torch.examples import seq_scale
from caelo_tpu_torch.models import weights_io
from caelo_tpu_torch.models.weights_io import build_models, random_flax_params
from caelo_tpu_torch.pipeline import run_full_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHED = 130        # frames in the canned cache
LAP = 60            # the canned trajectory: a 10 m circle of 60 frames
# measured in the run, not computed from its inputs; the port's own fields
TIMINGS = {"gen_seconds", "pipeline_seconds", "frames_per_s_e2e",
           "peak_rss_gb", "stage_seconds"}
PORT_ONLY = {"peak_device_mib", "device"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jss():
    """``examples/seq_scale.py`` as a module (not registered)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_example_seq_scale", os.path.join(REPO, "examples",
                                               "seq_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pose_rows(yaw, xyz):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros((len(yaw), 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, -s, s, c
    R[:, 2, 2] = 1.0
    return np.concatenate([R, xyz[:, :, None]], 2).reshape(-1, 12)


def _gt(n):
    a = 2 * np.pi * np.arange(n) / LAP
    return _pose_rows(a + np.pi / 2, np.stack(
        [10 * np.cos(a), 10 * np.sin(a), np.zeros(n)], 1))


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """``CACHED`` frames of small placeholder scans and the circle's ground
    truth: the pipeline is canned, so only the reads and ``gt`` matter."""
    base = str(tmp_path_factory.mktemp("cache") / "seq")
    rng = np.random.default_rng(0)
    np.save(base + ".pts.npy",
            rng.normal(size=(CACHED, 16, 4)).astype(np.float32))
    np.save(base + ".msk.npy", rng.uniform(size=(CACHED, 16)) < 0.8)
    np.save(base + ".gt.npy", _gt(CACHED))
    return base


# case: (frames, what differs from the passing run)
CASES = {
    "pass": (CACHED, None),
    "pass_slice": (120, None),
    "fail_success": (CACHED, "success"),
    "fail_fps": (CACHED, "fps"),
    "fail_rss": (CACHED, "rss"),
    "fail_precision": (CACHED, "precision"),
    "fail_ate": (CACHED, "ate"),
}


def _canned(frames, fault):
    """A pipeline result over the first ``frames`` frames of the circle:
    raw poses drifting 2 cm a frame along x, the final poses a tenth of
    that, three true loop edges one lap apart."""
    gt = _gt(frames).reshape(-1, 3, 4)
    drift = np.zeros((frames, 3))
    drift[:, 0] = 0.02 * np.arange(frames)

    def with_drift(scale):
        p = gt.copy()
        p[:, :, 3] += scale * drift
        return p.reshape(-1, 12)

    raw = with_drift(1.0)
    if fault == "success":        # 3 pairs of 119-129 off by 1 m
        for k in (30, 70, 90):
            raw.reshape(-1, 3, 4)[k + 1:, 0, 3] += 1.0
    edges = [(5, 65), (20, 80), (40, 100)]
    if fault == "precision":      # half a lap apart: no revisit
        edges += [(5, 35), (10, 40), (50, 80)]
    final = raw if fault == "ate" else with_drift(0.1)
    return types.SimpleNamespace(
        poses_raw=raw, poses_dejumped=raw, poses_refined=with_drift(0.5),
        poses_final=final, n_loop_closures=len(edges),
        loop_edge_i=np.array([a for a, _ in edges], np.int32),
        loop_edge_j=np.array([b for _, b in edges], np.int32),
        dejumped_frames=[7], refine_stats=types.SimpleNamespace(
            refined=[(3, 4), (9, 10)]))


class _Pipeline:
    """Stand-in for run_full_pipeline: answers the canned result and
    records how many frames it was given and its keywords."""

    def __init__(self, frames, fault):
        self.result = _canned(frames, fault)
        self.calls = []

    def __call__(self, scans, *a, **kw):
        self.calls.append((len(scans), kw))
        return self.result


class _Clock:
    """A ``time`` module whose clock advances 10 s a call: 13 frames/s."""

    def __init__(self):
        self.t = 0.0

    def time(self):
        self.t += 10.0
        return self.t


def _patch(monkeypatch, module, fault):
    if fault == "fps":
        monkeypatch.setattr(module, "time", _Clock())
    if fault == "rss":
        monkeypatch.setattr(module, "rss_gb", lambda: 9.0)


def _run_jax(jss, monkeypatch, cache, frames, fault, json_out):
    monkeypatch.setattr(jcompcache, "enable_compilation_cache",
                        lambda *a: "")
    for name in ("load_respond_layer_params", "load_patch_encoder_params"):
        monkeypatch.setattr(jweights, name, lambda path=None: None)
    pipe = _Pipeline(frames, fault)
    monkeypatch.setattr(jpipe, "run_full_pipeline", pipe)
    _patch(monkeypatch, jss, fault)
    monkeypatch.setattr(sys, "argv", [
        "seq_scale.py", "--frames", str(frames), "--scan-cache", cache,
        "--json-out", str(json_out)])
    return jss.main(), pipe


def _run_port(monkeypatch, cache, frames, fault, json_out):
    rp, ep = random_flax_params(0)
    monkeypatch.setattr(weights_io, "load_respond_layer_params",
                        lambda path=None: rp)
    monkeypatch.setattr(weights_io, "load_patch_encoder_params",
                        lambda path=None: ep)
    pipe = _Pipeline(frames, fault)
    monkeypatch.setattr(seq_scale, "run_full_pipeline", pipe)
    _patch(monkeypatch, seq_scale, fault)
    return seq_scale.main([
        "--frames", str(frames), "--scan-cache", cache, "--json-out",
        str(json_out), "--platform", "cpu"]), pipe


def _same(got, want):
    """Equal JSON values, NaN equal to NaN."""
    if isinstance(want, float) and math.isnan(want):
        return isinstance(got, float) and math.isnan(got)
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _same(got[k], want[k]) for k in want)
    if isinstance(want, list):
        return len(got) == len(want) and all(map(_same, got, want))
    return type(got) is type(want) and got == want


@pytest.mark.parametrize("case", list(CASES))
def test_json_and_exit_match_jax(jss, monkeypatch, tmp_path, cache, case):
    frames, fault = CASES[case]
    rc_j, pipe_j = _run_jax(jss, monkeypatch, cache, frames, fault,
                            tmp_path / "j.json")
    rc_t, pipe_t = _run_port(monkeypatch, cache, frames, fault,
                             tmp_path / "t.json")
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert got.keys() == want.keys() | PORT_ONLY
    assert got["peak_device_mib"] is None and got["device"] == "cpu"
    for k in want.keys() - TIMINGS:
        assert _same(got[k], want[k]), (k, got[k], want[k])
    assert rc_t == rc_j == (0 if fault is None else 1)
    # the pipeline saw the first --frames frames, at the same keywords
    assert [n for n, _ in pipe_t.calls] == [n for n, _ in pipe_j.calls] \
        == [frames]
    (_, kw_t), (_, kw_j) = pipe_t.calls[0], pipe_j.calls[0]
    assert {k: kw_t[k] for k in ("enable_loop_closure", "seed",
                                 "candidate_source")} == {
        k: kw_j[k] for k in ("enable_loop_closure", "seed",
                             "candidate_source")}
    # the gate the case breaks is the only one that fails
    failed = {g for g, ok in seq_scale.gates(got).items() if not ok}
    assert failed == ({fault} if fault else set())


# --------------------------------------------------------- (b) the writer
def test_parallel_cache_writer_equals_serial(tmp_path):
    cfg = tiny_test_config()
    serial, parallel = str(tmp_path / "s" / "seq"), str(tmp_path / "p" / "seq")
    gt_s = write_benchmark_cache(serial, 6, cfg, seed=3, lap_frames=4)
    gt_p = write_benchmark_cache_parallel(parallel, 6, cfg, seed=3,
                                          lap_frames=4, procs=2)
    np.testing.assert_array_equal(gt_p, gt_s)
    for suffix in (".pts.npy", ".msk.npy", ".gt.npy"):
        assert filecmp.cmp(serial + suffix, parallel + suffix,
                           shallow=False), suffix
    assert sorted(os.listdir(tmp_path / "p")) == [
        "seq.gt.npy", "seq.msk.npy", "seq.pts.npy"]
    assert NpyScanReader(parallel)[5][1].any()


def test_driver_writes_a_missing_cache_in_parallel(tmp_path, monkeypatch):
    calls = []

    def writer(*a, **kw):
        calls.append(a[:2])
        return write_benchmark_cache_parallel(*a, procs=2, **kw)

    monkeypatch.setattr(seq_scale, "write_benchmark_cache_parallel", writer)
    cfg = tiny_test_config()
    base, serial = str(tmp_path / "p" / "seq"), str(tmp_path / "s" / "seq")
    args = types.SimpleNamespace(scan_cache=base, frames=3, seed=1)
    scans, gt, _ = seq_scale.load_scans(args, cfg)
    assert calls == [(base, 3)]
    gt_s = write_benchmark_cache(serial, 3, cfg, seed=1,
                                 lap_frames=seq_scale.LAP_FRAMES)
    np.testing.assert_array_equal(gt, gt_s)
    for suffix in (".pts.npy", ".msk.npy", ".gt.npy"):
        assert filecmp.cmp(serial + suffix, base + suffix,
                           shallow=False), suffix
    assert len(scans) == 3
    # a cache that is there is read, never written again
    seq_scale.load_scans(args, cfg)
    assert len(calls) == 1


# -------------------------------------------------------- (c) staging
def test_threaded_staging_pipeline_bit_identical(tmp_path):
    cfg = tiny_test_config()
    base = str(tmp_path / "seq")
    write_benchmark_cache(base, 7, cfg, seed=0, lap_frames=6)
    net, enc = build_models(*random_flax_params(0), "cpu", cfg)
    runs = [run_full_pipeline(NpyScanReader(base), net, enc, cfg=cfg,
                              window=3, threaded_staging=threaded)
            for threaded in (False, True)]
    assert runs[0].odometry.successes.any()
    for name in ("poses_raw", "poses_dejumped", "poses_refined",
                 "poses_final"):
        np.testing.assert_array_equal(getattr(runs[1], name),
                                      getattr(runs[0], name), err_msg=name)
    np.testing.assert_array_equal(runs[1].odometry.successes,
                                  runs[0].odometry.successes)
