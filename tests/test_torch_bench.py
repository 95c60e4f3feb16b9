"""The port's benchmark (``caelo_tpu_torch/bench.py``, ``cli bench``) on the
CPU at ``tiny_test_config()``, and the blocked loop-closure scoring:

(a) ``make_window`` bit-equal to the root ``bench.py``'s window recipe built
    from the JAX package's ``data.synthetic`` and ``ops.masking``;
(b) ``cli.main(["bench", "--platform", "cpu"])`` at the tiny config,
    ``BENCH_FRAMES=3`` and ``BENCH_REPS=1`` (one ``run``, shared by (b)-(d)
    and (f)): one JSON line with every key, a finite positive frames/s,
    ``mfu`` and ``costmodel_hbm_frac`` null on the CPU, and the run log;
(c) its FLOP count equal to one made by hand from the layer shapes: the
    respond and encoder convolutions and the encoder's linear layers,
    matching's distance matmul and RANSAC's batched products, and the
    motion-prior pass where one ran;
(d) the windows it timed give the features of ``make_sequence_processor``
    called directly on the same inputs, bit for bit;
(e) the peak lookup stops on a device name it does not know;
(f) without a CUDA device ``cli bench``'s default platform stops;
(h) the byte count adds a kernel's bytes for each launch it sees, and stops
    on a launch made through a call site it does not wrap;
(g) ``eval/metrics.py::loop_closure_pr``, now built a block of rows at a
    time, equal to the unblocked formula on a looped trajectory, and its
    peak numpy allocation at 4,541 frames under 100 MB.
"""
import contextlib
import dataclasses
import io
import json
import math
import tracemalloc

import numpy as np
import pytest
import torch

from caelo_tpu.config import tiny_test_config as jtiny
from caelo_tpu.data.synthetic import make_scene as jmake_scene
from caelo_tpu.data.synthetic import range_filter as jrange_filter
from caelo_tpu.data.synthetic import sample_scene_points as jsample
from caelo_tpu.ops.masking import pad_points as jpad_points
from caelo_tpu_torch import bench, cli
from caelo_tpu_torch.config import tiny_test_config
from caelo_tpu_torch.eval import metrics
from caelo_tpu_torch.frontend.registration import FrameFeatures, register_pair
from caelo_tpu_torch.models.weights_io import build_models, random_flax_params
from caelo_tpu_torch.ops import nms
from caelo_tpu_torch.ops.saliency import keypoint_score_bytes

N_FRAMES = 3
KEYS = {"metric", "value", "unit", "vs_baseline", "mfu", "costmodel_hbm_frac",
        "bytes_per_window", "p50_ms", "p95_ms", "n_frames_window", "reps",
        "dtype", "flops_per_window", "device", "warmup_s", "peak_mem_mib"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """``cli bench`` at the tiny config: ``(exit code, standard output, log
    record, windows)``, ``windows`` each window's features, in the order
    the bench ran them."""
    log = tmp_path_factory.mktemp("bench") / "bench.jsonl"
    windows = []
    make = bench.make_sequence_processor

    def recording(cfg):
        process = make(cfg)

        def run(*args):
            out = process(*args)
            windows.append(out[0])
            return out

        return run

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(bench, "make_sequence_processor", recording)
        mp.setattr(bench, "PipelineConfig", lambda **kw: (
            dataclasses.replace(tiny_test_config(), **kw)))
        mp.setenv("BENCH_FRAMES", str(N_FRAMES))
        mp.setenv("BENCH_REPS", "1")
        mp.setenv("BENCH_METRICS", str(log))
        rc = cli.main(["bench", "--platform", "cpu"])
    with open(log) as f:
        rec = json.loads(f.read().splitlines()[-1])
    return rc, out.getvalue(), rec, windows


def test_make_window_is_bench_py_recipe():
    """(a) The root bench.py's lines 124-137 with the JAX package's host
    functions."""
    cfg = jtiny()
    scene = jmake_scene(seed=0)
    world = jsample(scene, seed=0, n_points=cfg.max_points)
    rng = np.random.default_rng(0)
    want = []
    for i in range(N_FRAMES):
        t = np.array([1.2 * i, 0.05 * i, 0.0])
        local = jrange_filter((world - t).astype(np.float32), cfg.sensor)
        local = local + rng.normal(0, 0.005, local.shape).astype(np.float32)
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        want.append(jpad_points(np.concatenate([local, refl], 1),
                                cfg.max_points))
    pts, mask = bench.make_window(tiny_test_config(), N_FRAMES)
    assert pts.dtype == np.float32 and mask.dtype == bool
    np.testing.assert_array_equal(pts, np.stack([p for p, _ in want]))
    np.testing.assert_array_equal(mask, np.stack([m for _, m in want]))


def test_cli_bench_prints_one_json_line(bench_run):
    """(b)"""
    rc, stdout, rec, _ = bench_run
    assert rc == 0 and len(stdout.splitlines()) == 1
    out = json.loads(stdout)
    assert set(out) == KEYS
    assert out["metric"] == "frontend_frames_per_s" and out["unit"] == \
        "frames/s"
    assert math.isfinite(out["value"]) and out["value"] > 0
    # both rounded to 3 decimals
    assert out["value"] == pytest.approx(N_FRAMES / (out["p50_ms"] / 1e3),
                                         abs=1e-3)
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / bench.BASELINE_FPS, abs=0.01)
    assert out["p50_ms"] == out["p95_ms"] > 0         # one rep
    assert (out["mfu"], out["costmodel_hbm_frac"], out["peak_mem_mib"]) == (
        None, None, None)
    assert (out["n_frames_window"], out["reps"], out["dtype"],
            out["device"]) == (N_FRAMES, 1, "float32", "cpu")
    assert out["flops_per_window"] > 0 and out["bytes_per_window"] > 0
    assert out["warmup_s"] >= 0
    # the run log: bench.py's record, plus the FLOPs by op and peak memory
    assert rec["event"] == "bench" and rec["frames"] == N_FRAMES
    assert len(rec["window_ms"]) == 1 and 0 <= rec["pair_success"] <= 2
    assert rec["flops_per_window"] == out["flops_per_window"]
    assert rec["bytes_per_window"] == out["bytes_per_window"]
    assert set(rec["occupancy"]) == {"scale0", "scale1", "scale2"}
    assert rec["bitgrid_slots"] == list(tiny_test_config().voxel.bitgrid_slots)


def _conv_flops(out_pixels, c_in, c_out, taps):
    return 2 * out_pixels * c_in * c_out * taps


def test_flops_equal_the_hand_count(bench_run):
    """(c) Every FLOP the counter saw, from the layer shapes at the tiny
    config: per frame the respond net's two convs over the (H, W) ring
    image and the encoder on 3 x K patches; per pass of registration over
    the window's B pairs of K keypoints the (K, 60) x (60, K) distance
    matmul and RANSAC's Horn solves and refit products."""
    _, stdout, rec, windows = bench_run
    cfg = tiny_test_config()
    H, W = cfg.sensor.model_h, cfg.sensor.model_w
    K = cfg.keypoint.n_keypoints
    B = N_FRAMES - 1
    D = windows[0].descriptors.shape[-1]
    r = cfg.ransac.refit_iters
    respond = (_conv_flops(H * W, 3, 32, 9) + _conv_flops(H * W, 32, 8, 1))
    enc_conv = (_conv_flops(16 ** 3, 1, 8, 27) + _conv_flops(8 ** 3, 8, 16, 27)
                + _conv_flops(4 ** 3, 16, 32, 27))
    enc_linear = 2 * (32 * 4 ** 3 * 200 + 200 * 20)
    assert enc_conv == 7_077_888 and enc_linear == 827_200
    assert rec["flops_by_op"]["convolution"] == N_FRAMES * (
        respond + 3 * K * enc_conv)
    assert rec["flops_by_op"]["addmm"] == N_FRAMES * 3 * K * enc_linear

    matching = 2 * B * K * K * D
    # RANSAC: 1 + r weighted Horn solves (the (3, K) x (K, 3) covariance and
    # the (3, 3) x 3 translation), r refit products (K, 3) x (3, 3)
    ransac = (1 + r) * (2 * B * K * 9 + 2 * B * 9) + r * 2 * B * K * 9
    # the motion-prior pass: matching again, the prior's (K, 3) x (3, 3)
    # and the (K, 3) x (3, K) gate distances, and RANSAC again
    prior = matching + 2 * B * K * 9 + 2 * B * K * K * 3 + ransac
    feats = windows[-1]
    f0 = FrameFeatures(*(x[:-1] for x in feats))
    f1 = FrameFeatures(*(x[1:] for x in feats))
    pass1 = register_pair(f0, f1, cfg,
                          generator=torch.Generator().manual_seed(0))
    ran_prior = not bool(pass1.success.all())
    bmm = matching + ransac + (prior if ran_prior else 0)
    assert rec["flops_by_op"]["bmm"] == bmm
    assert set(rec["flops_by_op"]) == {"convolution", "addmm", "bmm"}
    assert json.loads(stdout)["flops_per_window"] == sum(
        rec["flops_by_op"].values())


def test_timed_windows_are_the_processors(bench_run):
    """(d) warm-up, the rep and the counted window: the features of the
    processor called directly on the same inputs."""
    *_, windows = bench_run
    assert len(windows) == 3
    cfg = tiny_test_config()
    respond, encoder = build_models(*random_flax_params(0), "cpu", cfg)
    pts, mask = bench.make_window(cfg, N_FRAMES)
    want, _ = bench.make_sequence_processor(cfg)(
        respond, encoder, torch.from_numpy(pts), torch.from_numpy(mask),
        torch.Generator().manual_seed(0))
    for got in windows:
        for name, a, b in zip(want._fields, got, want):
            assert torch.equal(a, b), name


def test_peak_lookup_stops_on_an_unknown_device():
    """(e)"""
    assert bench.lookup_peak(bench.PEAK_FLOPS, "NVIDIA H100 80GB HBM3") == {
        "float32": 67e12, "bfloat16": 989e12}
    for table in (bench.PEAK_FLOPS, bench.PEAK_HBM_BYTES):
        with pytest.raises(SystemExit, match="NVIDIA A100-SXM4-40GB"):
            bench.lookup_peak(table, "NVIDIA A100-SXM4-40GB")


def test_kernel_bytes_counts_each_launch_or_stops(monkeypatch):
    """(h) A stand-in for K1's wrapper that counts a launch per call."""
    def launching(planes, *rest):
        launching.launches += 1
        return planes

    launching.launches = 0
    monkeypatch.setattr(nms, "keypoint_score", launching)
    planes = torch.zeros(8, 4, 6)
    counter = bench._ByteCounter()
    with bench._kernel_bytes(counter):
        nms.keypoint_score(planes, None)
        nms.keypoint_score(planes, None)
    assert counter.bytes == 2 * keypoint_score_bytes(planes)
    assert nms.keypoint_score is launching
    with pytest.raises(RuntimeError, match="1 times, 0 of them through"):
        with bench._kernel_bytes(bench._ByteCounter()):
            launching.launches += 1         # a launch past the wrapped site
    assert nms.keypoint_score is launching


def test_cli_bench_without_a_card_stops(monkeypatch):
    """(f) The default platform is the card, with no fall-back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--platform cpu"):
        cli.main(["bench"])


def _unblocked_loop_closure_gt(pos, min_gap, revisit_m):
    """``loop_closure_pr``'s revisit matrix as it was computed whole."""
    n = pos.shape[0]
    dist = np.linalg.norm(pos[None, :] - pos[:, None], axis=-1)
    idx = np.arange(n)
    return (dist <= revisit_m) & ((idx[None, :] - idx[:, None]) >= min_gap)


def _unblocked_loop_closure_pr(edge_i, edge_j, positions, min_gap=50,
                               revisit_m=5.0, window=10):
    pos = np.asarray(positions, np.float64)
    n = pos.shape[0]
    ei = np.minimum(np.asarray(edge_i, int), np.asarray(edge_j, int))
    ej = np.maximum(np.asarray(edge_i, int), np.asarray(edge_j, int))
    gt = _unblocked_loop_closure_gt(pos, min_gap, revisit_m)
    tp = sum(bool(gt[max(a - window, 0):min(a + window + 1, n),
                     max(b - window, 0):min(b + window + 1, n)].any())
             for a, b in zip(ei, ej))
    events = []
    for j in np.where(gt.any(axis=0))[0]:
        if events and j - events[-1][-1] <= window:
            events[-1].append(j)
        else:
            events.append([j])
    recalled = sum(1 for ev in events
                   if any(abs(b - j) <= window for b in ej for j in ev))
    return {"precision": tp / len(ei) if len(ei) else float("nan"),
            "recall": recalled / len(events) if events else float("nan"),
            "n_edges": int(len(ei)), "n_true_positive": int(tp),
            "n_revisit_events": int(len(events))}


def _laps(n, lap, seed=0):
    """``n`` positions around a 40 m circle of ``lap`` frames, a little
    noise: every place revisited once a lap."""
    a = 2 * np.pi * np.arange(n) / lap
    rng = np.random.default_rng(seed)
    return np.stack([40 * np.cos(a), 40 * np.sin(a), np.zeros(n)], 1) + \
        rng.normal(0, 0.5, (n, 3))


def test_blocked_loop_closure_pr_equals_unblocked():
    """(g) 3.4 laps of 120 frames (407 frames: four row blocks, the last
    short): the revisit matrix entry for entry, and the scores for true
    edges (a frame and its next lap), false ones (a frame and half a lap
    on), both, and none."""
    n, lap = 407, 120
    pos = _laps(n, lap)
    assert n > 3 * metrics.PR_ROW_BLOCK
    np.testing.assert_array_equal(metrics.revisit_matrix(pos, 50, 5.0),
                                  _unblocked_loop_closure_gt(pos, 50, 5.0))
    true = [(i, i + lap) for i in range(0, n - lap, 37)]
    false = [(i + lap // 2, i) for i in range(0, n - lap // 2, 41)]
    for edges in (true, false, true + false, []):
        ei, ej = [a for a, _ in edges], [b for _, b in edges]
        got = metrics.loop_closure_pr(ei, ej, pos)
        want = _unblocked_loop_closure_pr(ei, ej, pos)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == want[k] or (math.isnan(got[k])
                                         and math.isnan(want[k])), k
    res = metrics.loop_closure_pr(*zip(*(true + false)), pos)
    assert 0 < res["precision"] < 1 and res["recall"] == 1.0


def test_loop_closure_pr_memory_at_sequence_scale():
    """(g) The 4,541-frame run's scoring: the unblocked N x N x 3 float64
    difference alone was 495 MB (~0.66 GB with the norm); blocked, the
    peak numpy allocation stays under 100 MB."""
    n = 4541
    pos = _laps(n, 520)
    edges = [(i, i + 520) for i in range(0, n - 520, 97)]
    tracemalloc.start()
    try:
        res = metrics.loop_closure_pr(*zip(*edges), pos)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 100e6, peak
    print(f"loop_closure_pr at N = {n}: peak numpy allocation "
          f"{peak / 1e6:.1f} MB")
    assert res["precision"] == 1.0 and res["n_edges"] == len(edges)
