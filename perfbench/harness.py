"""One run of one cell: set-up from the seed, warm-up, the measured
session, the check against the reference, and the metrics.

Everything a cell is made of is found by name: its workload file
(``workloads/<cell>.json``: configuration, entry, traffic, arrivals, what
the check samples, the limits), its configuration file
(``configs/<config>.json``), the entry module (``entries/<entry>.py``), the
traffic generator (``traffic/<kind>.py``) and one reader per metric
(``metrics/<metric>.py``).  ``BENCHMARK.json`` alone declares the metrics
and the cells each reports; a metric named ``<reader>.<part>`` (one
quantity split between cells that report different end-to-end metrics)
is read by ``metrics/<reader>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
import sys
import time

import torch

from . import check, trace
from .metrics._common import np_percentile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def program_config(d: dict):
    """The program's ``PipelineConfig`` from a configuration's numbers."""
    from caelo_tpu_torch import config as pc

    def build(cls, values):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in values:
                continue
            v = values[f.name]
            if dataclasses.is_dataclass(f.default):
                v = build(type(f.default), v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[f.name] = v
        return cls(**kw)

    return build(pc.PipelineConfig, d)


# (name, weight shape (out, in, ...)) of each layer the benchmark draws; the
# fan-in is the product of all but the first
RESPOND = [("conv1_1", (32, 3, 3, 3)), ("conv1_1_2", (8, 32, 1, 1))]


def encoder_layers(code: int):
    return [("conv1", (8, 1, 3, 3, 3)), ("conv2", (16, 8, 3, 3, 3)),
            ("conv3", (32, 16, 3, 3, 3)), ("fn1", (200, 2048)),
            ("fn2", (code, 200))]


def make_weights(seed: int, device, code: int):
    """``(respond, encoder)`` state dicts drawn on ``device`` from ``seed``
    in one call: lecun-normal weights (std 1/sqrt(fan-in)), zero biases.
    ``fn1`` reads the conv output flattened channels-last."""
    layers = [RESPOND, encoder_layers(code)]
    total = sum(math.prod(s) for group in layers for _, s in group)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(total, generator=gen, device=device)
    out, at = [], 0
    for group in layers:
        sd = {}
        for name, shape in group:
            n = math.prod(shape)
            fan_in = math.prod(shape[1:])
            sd[f"{name}.weight"] = (z[at:at + n].view(shape)
                                    / math.sqrt(fan_in)).contiguous()
            sd[f"{name}.bias"] = torch.zeros(shape[0], device=device)
            at += n
        out.append(sd)
    return tuple(out)


class Run:
    """Everything one run of a cell holds."""

    def __init__(self, cell: str, seed: int, device, config: dict = None,
                 workload: dict = None, clock: "SetupClock" = None):
        from caelo_tpu_torch import setup_device
        from caelo_tpu_torch.models.weights_io import (
            build_models_from_state_dicts)

        clock = clock or SetupClock(time.perf_counter())
        clock.mark("program imports")
        self.cell, self.seed = cell, seed
        self.device = setup_device(device)
        self.cuda = self.device.type == "cuda"
        self.workload = workload or load("workloads", cell)
        self.config = config or load("configs", self.workload["config"])
        pipe = self.config["pipeline"]
        self.cfg = program_config(pipe)
        self.weights = make_weights(seed, self.device,
                                    pipe["descriptor_dim"] // 3)
        clock.mark("card context and weights")
        self.net, self.enc = build_models_from_state_dicts(
            *self.weights, self.device, self.cfg)
        clock.mark("models")
        traffic = self.workload["traffic"]
        gen = importlib.import_module(f"perfbench.traffic.{traffic['kind']}")
        pts, mask = gen.make_lap(traffic, pipe["sensor"], pipe["max_points"],
                                 seed, self.device)
        self.frames = list(zip(pts.numpy(), mask.numpy()))
        self.start = gen.start_frame(traffic, seed)
        clock.mark("traffic")
        self.plan = check.plan(self.workload, seed)
        self.entry = importlib.import_module(
            f"perfbench.entries.{self.workload['entry']}").Entry(self)
        clock.mark("driver imports and entry")
        self.clock = clock


class SetupClock:
    """Seconds of each part of set-up, from ``t_start`` on."""

    def __init__(self, t_start: float):
        self.t, self.parts = t_start, []

    def mark(self, part: str, now: float = None):
        """``part`` took from the last mark until ``now`` (this moment by
        default)."""
        now = time.perf_counter() if now is None else now
        self.parts.append((part, now - self.t))
        self.t = now

    def describe(self, stream=sys.stderr):
        total = sum(s for _, s in self.parts)
        print(f"setup {total:.3f} s: " + ", ".join(
            f"{p} {s:.3f}" for p, s in self.parts), file=stream)


class Reading:
    """What the metric readers read (``metrics/<reader>.py``: ``read(r)``,
    None where the run holds nothing to read)."""

    def __init__(self, run, **kw):
        self.run = run
        self.setup_s = self.peak_bytes = None
        self.rec = self.spans = self.span_rec = self.prof = None
        self.__dict__.update(kw)


def reader(name: str):
    """The module that reads metric ``name``: the part before its first
    dot names the file under ``metrics/``."""
    return importlib.import_module(
        f"perfbench.metrics.{name.split('.')[0]}")


def read_metrics(entries: list, r: Reading) -> dict:
    out = {}
    for m in entries:
        value = reader(m["name"]).read(r)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _peak():
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else 0


def measure(cell: str, seed: int, seconds: float, traced: bool, device,
            t_start: float, config: dict = None, workload: dict = None,
            clock: SetupClock = None) -> dict:
    """One run: its result object (the JSON line's keys).  ``config`` and
    ``workload`` replace the cell's files (the tests' small shapes);
    ``clock`` holds the parts of set-up timed before the call."""
    run = Run(cell, seed, device, config, workload,
              clock or SetupClock(t_start))
    run.entry.warmup()
    if run.cuda:
        torch.cuda.synchronize()
    run.clock.mark("warm-up")
    setup_peak = _peak()
    if run.cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    run.clock.describe()
    bench = benchmark()
    if not traced:
        rec = run.entry.session(seconds, run.plan)
        window_peak = _peak()
        reading = Reading(run, setup_s=setup_s, peak_bytes=window_peak,
                          rec=rec)
        metrics = read_metrics(cell_metrics(bench, cell, "end_to_end"),
                               reading)
        device_info = {}
    else:
        split = run.workload["trace"]
        rec = run.entry.session(seconds * split["clean"], run.plan)
        spans, span_rec = trace.Spans(run), None
        if split["spans"]:
            with spans:
                span_rec = run.entry.session(seconds * split["spans"])
        prof = trace.Profile(run, split["profile_from"],
                             split["profile_units"])
        with prof:
            run.entry.session(split["profile_seconds"],
                              on_unit=prof.on_unit)
        red = prof.reduce()
        window_peak = _peak()
        reading = Reading(run, setup_s=setup_s, peak_bytes=window_peak,
                          rec=rec, spans=spans.times, span_rec=span_rec,
                          prof=red)
        metrics = read_metrics(cell_metrics(bench, cell, "per_layer"),
                               reading)
        device_info = {"busy_s": red["busy_s"] if red else 0.0,
                       "window_s": red["window_s"] if red else 0.0}
    peak_bytes = max(setup_peak, window_peak)
    _describe(cell, rec)
    values = check.numbers(run, rec)
    limits = run.workload["limits"]
    out = {
        "correct": check.verdict(values, limits),
        "attempted": rec["attempted"], "failed": rec["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if run.cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(run.device)
                            if run.cuda else "cpu"),
                   "count": 1, "memory_peak_bytes": peak_bytes,
                   **device_info},
    }
    if traced and red:
        out["breakdown"] = {"device_ops": trace.top_kernels(red),
                            "idle_gaps": red["idle_gaps"]}
    # the numbers compared, last: a non-finite one as its name
    out["checks"] = {n: {"value": values[n] if math.isfinite(values[n])
                         else str(values[n]), "limit": limits.get(n)}
                     for n in check.NAMES}
    return out


def _describe(cell: str, rec: dict, stream=sys.stderr):
    """One line on the measured session, for the record."""
    line = (f"session {cell}: {rec['frames']} frames, {rec['pairs']} pairs "
            f"in {rec['seconds']:.3f} s")
    lat = rec.get("latencies")
    if lat:
        q = [np_percentile(lat, p) * 1e3 for p in (50, 95, 100)]
        line += (f"; latency p50 / p95 / max {q[0]:.1f} / {q[1]:.1f} / "
                 f"{q[2]:.1f} ms, the generator at most "
                 f"{rec['generator_late'] * 1e3:.1f} ms late")
    print(line, file=stream)


def report_checks(out: dict, stream=sys.stderr):
    """The numbers compared, each beside its limit, as the last lines."""
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=stream)
    print(f"correct {out['correct']}", file=stream, flush=True)
