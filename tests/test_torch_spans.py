"""The port's program spans (``caelo_tpu_torch.utils.telemetry.span``):
a shared no-op with no profiler active, record-function ranges (host
only, no device-side copy) under one, nested per frame under the driver's span, and the pipeline's stages
as spans; the attributes the benchmark swaps stay the plain functions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from caelo_tpu_torch.config import tiny_test_config
from caelo_tpu_torch.data.synthetic import (make_scene, range_filter,
                                            sample_scene_points)
from caelo_tpu_torch.models import weights_io
from caelo_tpu_torch.ops.masking import pad_points
from caelo_tpu_torch.utils import telemetry

CFG = tiny_test_config()
# every plain pass fails (it needs twice the valid pairs), so the
# motion-prior retry runs for every pair
CFG_RETRY = dataclasses.replace(CFG, ransac=dataclasses.replace(
    CFG.ransac, min_inlier_frac=2.0, min_inlier_abs=10 ** 6))

FRONT = ["caelo.frontend.project", "caelo.frontend.respond",
         "caelo.frontend.select", "caelo.frontend.voxelize",
         "caelo.frontend.patch_query", "caelo.frontend.encode"]
RANSAC = ["caelo.ransac.draw", "caelo.ransac.solve", "caelo.ransac.score",
          "caelo.ransac.refit"]


def _scans(n):
    scene = make_scene(seed=0, n_boxes=25, extent=30.0)
    world = sample_scene_points(scene, seed=0, n_points=CFG.max_points)
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        local = range_filter((world - [0.8 * i, 0.05 * i, 0.0]).astype(
            np.float32), CFG.sensor)
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        out.append(pad_points(np.concatenate([local, refl], 1),
                              CFG.max_points))
    return out


@pytest.fixture(scope="module")
def models():
    return weights_io.build_models(*weights_io.random_flax_params(0), "cpu",
                                   CFG)


def _profiled(fn):
    """``fn()`` under a CPU profiler: ``(result, [(name, start, end)])`` of
    the ``caelo.`` ranges, by start, outer first."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("caelo.")),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def _inside(spans, outer):
    """The spans held by ``outer``, a ``(name, start, end)``."""
    return [s for s in spans if s is not outer
            and outer[1] <= s[1] and s[2] <= outer[2]]


def _names(spans):
    return [s[0] for s in spans]


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(telemetry, "_RANGE", refuse)
    a, b = telemetry.span("caelo.a"), telemetry.span("caelo.b")
    assert a is b is telemetry._NO_SPAN
    with a, b:
        pass
    timer = telemetry.StageTimer(sync=False)
    with timer.stage("x"):
        pass
    assert timer.counts["x"] == 1


def test_span_under_a_profiler_is_a_record_function_range():
    def body():
        with telemetry.span("caelo.outer"):
            with telemetry.StageTimer(sync=False).stage("inner"):
                torch.ones(3).sum()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        body()
    mine = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("caelo.")]
    # operator ranges: no user annotation, so no copy on a device timeline
    assert mine and not any(e.is_user_annotation() for e in mine)
    _, spans = _profiled(body)
    assert _names(spans) == ["caelo.outer", "caelo.pipeline.inner"]
    assert _inside(spans, spans[0]) == spans[1:]


def test_run_odometry_nests_each_frame_under_its_span(models):
    """Three frames through ``run_odometry`` with the retry forced: one
    frame span each, closed before ``progress``; the front end's spans
    under ``extract``; a first-pass pair and a retry (holding its own
    pair) in every frame but the first, RANSAC's four under each pair."""
    from caelo_tpu_torch.frontend.odometry import run_odometry

    net, enc = models

    def progress(i):
        with telemetry.span(f"caelo.test.progress{i}"):
            pass

    res, spans = _profiled(lambda: run_odometry(
        _scans(3), net, enc, cfg=CFG_RETRY, progress=progress))
    assert not res.successes.any()
    frames = [s for s in spans if s[0] == "caelo.odometry.frame"]
    assert len(frames) == 3
    for i, frame in enumerate(frames):
        held = _inside(spans, frame)
        assert f"caelo.test.progress{i}" not in _names(held)
        (extract,) = [s for s in held if s[0] == "caelo.frontend.extract"]
        assert _names(_inside(spans, extract)) == FRONT
        pairs = [s for s in held if s[0] == "caelo.register.pair"]
        retries = [s for s in held if s[0] == "caelo.register.retry"]
        if i == 0:
            assert not pairs and not retries
            continue
        assert len(pairs) == 2 and len(retries) == 1
        first, again = pairs
        assert again in _inside(spans, retries[0])
        assert first not in _inside(spans, retries[0])
        for pair in pairs:
            assert _names(_inside(spans, pair)) == [
                "caelo.register.match"] + RANSAC
    # nothing outside the frames but the progress calls
    loose = [s for s in spans if not any(s in _inside(spans, f)
                                         for f in frames)]
    assert set(_names(loose)) == {"caelo.odometry.frame"} | {
        f"caelo.test.progress{i}" for i in range(3)}


def test_the_windowed_pipeline_stages_and_windows_are_spans(models):
    """``run_full_pipeline`` with no timer: its stages are spans, the
    front end's windows and their staging under the front-end stage, a
    frame's extraction and the window's pairs under the window."""
    from caelo_tpu_torch.pipeline import run_full_pipeline

    net, enc = models
    _, spans = _profiled(lambda: run_full_pipeline(
        _scans(4), net, enc, cfg=CFG, enable_refinement=False,
        enable_loop_closure=False, window=3))
    top = [s for s in spans if s[0].startswith("caelo.pipeline.")]
    assert _names(top) == ["caelo.pipeline.frontend", "caelo.pipeline.dejump"]
    held = _inside(spans, top[0])
    windows = [s for s in held if s[0] == "caelo.odometry.window"]
    assert len(windows) == 2
    assert _names(held).count("caelo.odometry.stage") == 2
    for w in windows:
        names = _names(_inside(spans, w))
        assert names.count("caelo.frontend.extract") in (2, 3)
        assert names.count("caelo.register.pair") == 1 + names.count(
            "caelo.register.retry")
        assert "caelo.odometry.stage" not in names


def test_the_ablation_feature_function_opens_extract_and_detect(models):
    from caelo_tpu_torch.frontend.ablation import make_ablation_feature_fn

    net, enc = models
    fn = make_ablation_feature_fn("random", net, enc, CFG)
    pts, mask = _scans(1)[0]
    _, spans = _profiled(lambda: fn(pts, mask))
    assert _names(spans) == ["caelo.frontend.extract",
                             "caelo.frontend.detect"] + FRONT[3:]
    assert _inside(spans, spans[0]) == spans[1:]


def test_the_attributes_the_benchmark_swaps_are_the_plain_functions():
    """Spans sit inside function bodies: every module attribute a benchmark
    wraps for a session is still the function it names."""
    from caelo_tpu_torch.frontend import (ablation, baselines, odometry,
                                          ransac, registration)
    from caelo_tpu_torch.ops import nms, plane_gather, saliency
    from caelo_tpu_torch.parallel import pipeline as par
    from caelo_tpu_torch.voxel import grid

    for mod in (odometry, par):
        assert mod.extract_frame_features is \
            registration.extract_frame_features
        assert mod.register_pair is registration.register_pair
        assert mod.register_pair_with_prior is \
            registration.register_pair_with_prior
    assert odometry.make_sequence_processor is par.make_sequence_processor
    assert registration.voxelize is grid.voxelize
    assert registration.extract_patches is grid.extract_patches
    assert nms.keypoint_score is saliency.keypoint_score
    assert grid.patches_from_planes is plane_gather.patches_from_planes
    assert ablation._DETECTORS["iss"] is baselines.iss_keypoints
    for fn, mod in [(ransac.draw_samples, ransac),
                    (saliency.keypoint_score, saliency),
                    (plane_gather.patches_from_planes, plane_gather),
                    (registration.extract_frame_features, registration),
                    (registration.register_pair, registration),
                    (registration.register_pair_with_prior, registration),
                    (odometry.make_sequence_processor, odometry),
                    (grid.voxelize, grid), (grid.extract_patches, grid)]:
        assert fn.__module__ == mod.__name__, fn
        assert fn is getattr(mod, fn.__qualname__), fn
