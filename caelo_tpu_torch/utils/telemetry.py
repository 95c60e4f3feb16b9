"""Stage timing, program spans and run metrics (the port's own copy of
``caelo_tpu/utils/telemetry.py``'s host parts).

* ``span``: a named range of the program (every name starts with
  ``caelo.``) on the profiler's timeline.  While a ``torch.profiler``
  session is active it is a record-function range of operator scope
  (``torch._C._profiler._RecordFunctionFast``), so the range shares its
  clock with the CUDA kernels, copies and runtime calls the profiler
  records and, unlike ``torch.profiler.record_function``'s user ranges,
  gets no copy on the device's timeline that a reader of device time
  would take for device work; otherwise it is one shared no-op context, a
  flag check, that allocates nothing.  Spans nest on the calling thread:
  a frame's ranges sit under its driver span (``caelo.odometry.frame`` or
  ``caelo.odometry.window``).
* ``StageTimer``: named wall-clock stages, aggregated (``summary``,
  ``report``); each stage is also the span ``caelo.pipeline.<name>``.
  With ``sync`` and a CUDA device it synchronises the device at both ends
  of a stage, so a stage's wall time holds the device work it queued and
  none that an earlier stage left running.
* ``trace``: the one exporter.  Wrap a run in ``trace(logdir)`` and the
  block's CPU and CUDA activity, the program's spans among it, is written
  to ``<logdir>/<name>.trace.json`` as a Chrome trace (``torch.profiler``
  in place of ``jax.profiler``); without a ``logdir`` the block is a
  named region in any profiler already running.
* ``MetricsLog``: an append-only JSONL run log, one record per event, in the
  JAX package's format.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, Dict

import torch

_NO_SPAN = contextlib.nullcontext()
_RANGE = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """The program range ``name`` while a profiler is active, else the
    shared no-op context: tracing is on exactly while a profiler runs."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return _RANGE(name)


class StageTimer:
    """Named stage timing with optional CUDA synchronisation."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block as stage ``name`` (and the span
        ``caelo.pipeline.<name>``); the CUDA synchronise at its end covers
        every tensor the stage queued."""
        sync = self.sync and torch.cuda.is_available()
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with span(f"caelo.pipeline.{name}"):
                yield
            if sync:
                torch.cuda.synchronize()
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self.totals[k], 4),
                "count": self.counts[k],
                "mean_ms": round(1000 * self.totals[k] / max(self.counts[k], 1), 3),
            }
            for k in self.totals
        }

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def trace(logdir: str | None = None, name: str = "caelo"):
    """Mark the block as the span ``name`` (shown in any active profiler's
    trace).  With ``logdir`` the block is profiled (CPU, and CUDA where a
    device is present) and its Chrome trace, the program's spans in it,
    written to ``<logdir>/<name>.trace.json``, also when the block raises;
    view it in Perfetto or ``chrome://tracing``."""
    if not logdir:
        with span(name):
            yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with span(name):
            yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, f"{name}.trace.json"))


class MetricsLog:
    """Append-only JSONL metrics stream, one record per event."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, event: str, **fields: Any):
        rec = {"t": round(time.time(), 3), "event": event}
        for k, v in fields.items():
            if hasattr(v, "item"):
                v = v.item()
            rec[k] = v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
