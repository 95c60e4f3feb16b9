"""``perfbench/program.py`` on hand-built stretches: self times, launches
matched by correlation id, host synchronisations, idle time by span, cut
spans; the nine readers of the program's spans; and a traced run of each
framewise and windowed cell at the tiny configuration on the CPU."""
import types

import pytest

from perfbench import harness, program
from perfbench.program import Event
from .smallcells import tiny

MAIN, OTHER = 7, 9
NOTID = 2 ** 64 - 1     # a runtime call no operator launched


def host(name, a, b, tid=MAIN, corr=0):
    return Event(name, False, a, b, tid, corr)


def dev(corr, a, b, name="kernel"):
    return Event(name, True, a, b, 0, corr)


def stretch():
    """One frame ``[0, 1000]``: extract (project inside), a first-pass
    pair, a retry holding its own pair.  Launches 1-5 (5 outside every
    span); device operation 99 has no launch; an operator shares id 3 with
    a launch and is no runtime call; a span of another thread; a sync with
    no thread of its own."""
    return [
        host("caelo.odometry.frame", 0, 1000),
        host("caelo.frontend.extract", 10, 500),
        host("caelo.frontend.project", 20, 100),
        host("caelo.register.pair", 600, 900),
        host("caelo.register.retry", 910, 990),
        host("caelo.register.pair", 920, 980),
        host("caelo.ransac.solve", 925, 945),
        host("caelo.odometry.stage", 0, 1250, tid=OTHER),
        host("aten::mul", 640, 660, corr=3),
        host("cudaLaunchKernel", 30, 40, corr=1),
        host("cudaLaunchKernel", 300, 310, corr=2),
        host("cudaLaunchKernel", 650, 655, corr=3),
        host("cuLaunchKernelEx", 930, 935, corr=4),
        host("cudaMemcpyAsync", 1100, 1110, corr=5),
        host("cudaStreamSynchronize", 950, 960, corr=6),
        host("cudaDeviceSynchronize", 995, 999, tid=NOTID, corr=8),
        host("cudaStreamSynchronize", 1200, 1210, corr=9),
        host("cudaEventSynchronize", 100, 110, tid=OTHER, corr=10),
        dev(1, 50, 60), dev(2, 320, 420), dev(3, 700, 705),
        dev(4, 940, 950), dev(5, 1120, 1150, "Memcpy HtoD"),
        dev(99, 1160, 1170),
    ]


def test_self_times_launches_and_syncs_by_span():
    out = program.reduce(stretch(), 0, 1300)
    s = out["spans"]
    ns = 1e-9
    assert s["caelo.odometry.frame"]["calls"] == 1
    assert s["caelo.odometry.frame"]["self_s"] == pytest.approx(
        (1000 - 490 - 300 - 80) * ns)
    assert s["caelo.frontend.extract"]["self_s"] == pytest.approx(410 * ns)
    assert s["caelo.frontend.project"]["self_s"] == pytest.approx(80 * ns)
    assert s["caelo.register.retry"]["self_s"] == pytest.approx(20 * ns)
    assert s["caelo.register.pair"]["self_s"] == pytest.approx(
        (300 + 40) * ns)
    assert s["caelo.register.pair"]["total_s"] == pytest.approx(360 * ns)
    # the pair under the retry is counted as retried; its solve too
    assert (s["caelo.register.pair"]["calls"],
            s["caelo.register.pair"]["retried"]) == (2, 1)
    assert s["caelo.ransac.solve"]["retried"] == 1
    # launches: 1 in project, 2 in extract's own time, 3 in the first
    # pair (not the operator with id 3), 4 in the retry's solve
    assert s["caelo.frontend.project"]["ops"] == 1
    assert (s["caelo.frontend.extract"]["ops"],
            s["caelo.frontend.extract"]["ops_under"]) == (1, 2)
    assert s["caelo.frontend.extract"]["device_s_under"] == pytest.approx(
        110 * ns)
    assert (s["caelo.register.pair"]["ops"],
            s["caelo.register.pair"]["ops_under"]) == (1, 2)
    assert s["caelo.ransac.solve"]["ops"] == 1
    assert s["caelo.register.retry"]["ops_under"] == 1
    assert (s["caelo.odometry.frame"]["ops"],
            s["caelo.odometry.frame"]["ops_under"]) == (0, 4)
    # syncs: one in the retried pair, one with no thread (the main
    # thread's, in the frame's own time); the one at 1200 outside every
    # span; the other thread's in its own span
    assert s["caelo.register.pair"]["syncs"] == 1
    assert s["caelo.register.retry"]["syncs_under"] == 1
    assert (s["caelo.odometry.frame"]["syncs"],
            s["caelo.odometry.frame"]["syncs_under"]) == (1, 2)
    assert s["caelo.odometry.stage"]["syncs"] == 1
    assert out["syncs_main_thread"] == 3
    assert (out["device_ops"], out["matched_ops"]) == (6, 5)
    assert out["matched_share"] == pytest.approx(5 / 6)


def test_idle_time_by_the_span_open_on_the_main_thread():
    out = program.reduce(stretch(), 0, 1300)
    idle = dict(out["idle_by_span"])
    ns = 1e-9
    # gaps (middle: span): lead 0-50 (25: project), 60-320 (190:
    # extract), 420-700 (560: frame), 705-940 (822: pair), 950-1120,
    # 1150-1160 and the tail 1170-1300 (outside)
    assert idle == pytest.approx({
        "caelo.frontend.project": 50 * ns,
        "caelo.frontend.extract": 260 * ns,
        "caelo.odometry.frame": 280 * ns,
        "caelo.register.pair": 235 * ns,
        program.OUTSIDE: (170 + 10 + 130) * ns})
    busy = 10 + 100 + 5 + 10 + 30 + 10
    assert out["idle_s"] == pytest.approx((1300 - busy) * ns)
    assert [k for k, _ in out["idle_by_span"]][:2] == [
        program.OUTSIDE, "caelo.odometry.frame"]


def test_a_cut_span_counts_nowhere():
    """A span reaching outside the stretch is left out; what it held
    falls to the span around it or outside."""
    out = program.reduce(stretch(), 5, 1300)
    assert "caelo.odometry.frame" not in out["spans"]
    assert "caelo.odometry.stage" not in out["spans"]
    assert out["spans"]["caelo.frontend.extract"]["self_s"] == \
        pytest.approx(410e-9)
    assert out["idle_by_span"][0][0] == program.OUTSIDE


def test_an_empty_stretch():
    out = program.reduce([], 0, 100)
    assert out["spans"] == {} and out["matched_share"] is None
    assert out["idle_by_span"] == [[program.OUTSIDE, pytest.approx(1e-7)]]


def _kineto(name, kind, start, dur, tid, corr, ua=False, end_tid=None):
    """A stand-in for one of the profiler's events (``end_tid`` 0: one the
    profiler stopped inside)."""
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: f"DeviceType.{kind}",
        start_ns=lambda: start, duration_ns=lambda: dur,
        start_thread_id=lambda: tid, correlation_id=lambda: corr,
        is_user_annotation=lambda: ua,
        end_thread_id=lambda: tid if end_tid is None else end_tid)


def test_events_leave_out_the_device_copies_of_spans():
    class Results:
        def events(self):
            return [_kineto("caelo.a", "CPU", 0, 10, 1, 3, True),
                    _kineto("caelo.a", "CUDA", 2, 5, 1, 3, True),
                    _kineto("kernel", "CUDA", 2, 5, 0, 4),
                    _kineto("caelo.open", "CPU", 8, 30, 1, 5, end_tid=0),
                    _kineto("cudaLaunchKernel", "CPU", 9, 1, 1, 6,
                            end_tid=0)]

    assert program.events(Results()) == [
        Event("caelo.a", False, 0, 10, 1, 3),
        Event("kernel", True, 2, 7, 0, 4),
        Event("cudaLaunchKernel", False, 9, 10, 1, 6)]


def test_a_span_open_when_the_profiler_stops_counts_nowhere():
    """The profiler ends a range it stopped inside at its stop; the
    program's table leaves it out, and a span begun before the start is
    not recorded at all."""
    import torch
    from caelo_tpu_torch.utils.telemetry import span

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with span("caelo.before"):
        prof.start()
        with span("caelo.closed"):
            torch.ones(4).sum()
        opened = span("caelo.open")
        opened.__enter__()
        torch.ones(4).sum()
        prof.stop()
    opened.__exit__(None, None, None)
    assert set(program.of_profiler(prof)["spans"]) == {"caelo.closed"}


NINE = ["launches_per_frame", "syncs_per_frame", "project_ms",
        "respond_ms", "select_ms", "syncs_per_frame.live",
        "launches_per_pair.live", "ransac_solve_ms.live", "refit_ms.live"]


def _reading(prog):
    r = harness.Reading(None)
    r.prof = None if prog is None else {"program": prog}
    return r


def test_the_nine_readers_read_nothing_from_an_empty_stretch():
    for prog in (None, program.reduce([], 0, 100)):
        for name in NINE:
            assert harness.reader(name).read(_reading(prog)) is None, name
    r = harness.Reading(None)
    r.prof = {"busy_s": 1.0}           # a stretch traced without spans
    assert all(harness.reader(n).read(r) is None for n in NINE)


def test_the_nine_readers_on_hand_built_stretches():
    ms = 1e-6                          # one ns in milliseconds
    live = _reading(program.reduce(stretch(), 0, 1300))
    read = lambda name, r: harness.reader(name).read(r)
    assert read("syncs_per_frame.live", live) == 2
    assert read("launches_per_pair.live", live) == 2   # one first pass
    assert read("ransac_solve_ms.live", live) == pytest.approx(20 * ms)
    assert read("refit_ms.live", live) is None
    assert read("project_ms", live) == pytest.approx(80 * ms)
    assert read("launches_per_frame", live) == 2
    # a window's stretch: two frames, no frame span; every main-thread
    # sync over the frames
    win = [host("caelo.frontend.extract", 0, 100),
           host("caelo.frontend.respond", 10, 30),
           host("caelo.frontend.select", 30, 60),
           host("caelo.frontend.extract", 200, 300),
           host("caelo.frontend.respond", 210, 220),
           host("cudaLaunchKernel", 15, 16, corr=1),
           host("cudaLaunchKernel", 215, 216, corr=2),
           host("cudaLaunchKernel", 250, 251, corr=3),
           host("cudaStreamSynchronize", 400, 410, corr=4),
           dev(1, 20, 25), dev(2, 230, 240), dev(3, 260, 270)]
    r = _reading(program.reduce(win, 0, 500))
    assert read("launches_per_frame", r) == 1.5
    assert read("syncs_per_frame", r) == 0.5
    assert read("respond_ms", r) == pytest.approx(15 * ms)
    assert read("select_ms", r) == pytest.approx(15 * ms)
    assert read("project_ms", r) is None
    assert read("launches_per_pair.live", r) is None


# seconds, and the profiled stretch: frames 2-3 at 2 Hz; the second of a
# call's two windows
TRACED = {"hdl64-live-5hz": (5.0, {"profile_seconds": 2.0,
                                   "profile_from": 1, "profile_units": 2}),
          "hdl64-offline-w64": (0.1, {})}


@pytest.mark.parametrize("cell", sorted(TRACED))
def test_a_traced_run_reads_the_program_spans(cell, capsys):
    """A traced run of the cell at the tiny configuration on the CPU: the
    new metrics of the cell read (no launch on the CPU, so launches and
    syncs read 0), the program's table and idle time by span are written
    to standard error, and the accepted breakdown is unchanged."""
    config, workload = tiny(cell)
    seconds, stretch = TRACED[cell]
    workload["trace"].update(stretch)
    out = harness.measure(cell, 2 ** 33 + 5, seconds, True, "cpu", 0.0,
                          config=config, workload=workload)
    new = {m["name"] for m in harness.benchmark()["per_layer"]
           if m["name"] in NINE and cell in m["workloads"]}
    assert new and new <= set(out["metrics"]), out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    err = capsys.readouterr().err
    assert err.count("program spans ") == 1
    assert err.count("program idle_by_span ") == 1
