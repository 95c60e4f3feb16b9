"""What the traced run reads: spans around the program's layers, and a
profiler stretch reduced to device busy time, idle gaps and kernel times.

A span is one file under ``perfbench/spans/``: ``{"targets":
["module:attr", ...]}`` (functions the program calls through those module
attributes, or ``"module:attr[key]"`` of a dict) or ``{"hook": "encoder"}``
(forward pre- and post-hooks on the program's patch encoder).  Each span
synchronises the card at both ends, so it holds the device work its call
queued.  A span whose target the program no longer has is left out and
its metrics read null.
"""
from __future__ import annotations

import collections
import glob
import json
import os
import time

import torch

from .capture import Patches

HERE = os.path.dirname(os.path.abspath(__file__))
K1_TARGET = "caelo_tpu_torch.ops.nms:keypoint_score"
K2_TARGET = "caelo_tpu_torch.voxel.grid:patches_from_planes"


def span_files() -> dict:
    return {os.path.basename(p)[:-5]: json.load(open(p))
            for p in sorted(glob.glob(os.path.join(HERE, "spans", "*.json")))}


class Spans:
    """Installs every span while active: ``times[name]`` lists the
    seconds of each call."""

    def __init__(self, run):
        self.run = run
        self.times = collections.defaultdict(list)
        self._patches = Patches()
        self._handles = []

    def _sync(self):
        if self.run.cuda:
            torch.cuda.synchronize()

    def _wrap(self, name):
        def wrap(fn):
            def timed(*args, **kwargs):
                self._sync()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                self._sync()
                self.times[name].append(time.perf_counter() - t0)
                return out
            return timed
        return wrap

    def __enter__(self):
        for name, spec in span_files().items():
            for target in spec.get("targets", []):
                self._patches.set(target, self._wrap(name))
            if spec.get("hook") == "encoder":
                start = []

                def pre(module, args, start=start):
                    self._sync()
                    start.append(time.perf_counter())

                def post(module, args, out, start=start, name=name):
                    self._sync()
                    self.times[name].append(time.perf_counter() - start.pop())

                self._handles += [self.run.enc.register_forward_pre_hook(pre),
                                  self.run.enc.register_forward_hook(post)]
        return self

    def __exit__(self, *exc):
        self._patches.__exit__(*exc)
        for h in self._handles:
            h.remove()


class Profile:
    """A profiler over the units ``[first, first + n)`` of a session: it
    starts when unit ``first`` begins (``on_unit(first)``) and stops when
    unit ``first + n`` does, the card synchronised at both ends.  While it
    runs, the inputs of each K1 and K2 launch are kept for their bytes and
    operations."""

    def __init__(self, run, first: int, n: int):
        self.run, self.first, self.n = run, first, n
        self.prof = None
        self.on = False
        self.k1, self.k2 = [], []
        self.window_s = None
        self._patches = Patches()

    def _keep(self, store, pick):
        def wrap(fn):
            def kept(*args, **kwargs):
                if self.on:
                    store.append(pick(*args))
                return fn(*args, **kwargs)
            return kept
        return wrap

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.run.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def __enter__(self):
        # the profiler's first start sets up CUPTI, which takes seconds:
        # pay it here, before the session, not inside its stretch
        with torch.profiler.profile(activities=self._activities()):
            pass
        self._patches.set(K1_TARGET, self._keep(
            self.k1, lambda planes, image, counter, *_: (
                tuple(planes.shape), counter.clone())))
        self._patches.set(K2_TARGET, self._keep(
            self.k2, lambda table2, slot, o: (table2.shape[0],
                                              slot.clone())))
        return self

    def __exit__(self, *exc):
        if self.on:
            self._stop()
        self._patches.__exit__(*exc)

    def on_unit(self, i):
        if i == self.first and self.prof is None:
            if self.run.cuda:
                torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
            self.on = True
            self._t0 = time.perf_counter()
        elif i == self.first + self.n and self.on:
            self._stop()

    def _stop(self):
        if self.run.cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.on = False

    def reduce(self) -> dict | None:
        """Device intervals, busy time, kernel times by name and the idle
        gaps by what the host was doing, or None where nothing was
        traced."""
        if self.prof is None or self.window_s is None:
            return None
        dev, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            kind = str(e.device_type())
            rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if kind.endswith("CUDA"):
                dev.append(rec)
            elif kind.endswith("CPU") and e.duration_ns() > 0:
                host.append(rec + (e.start_thread_id(),))
        out = {"window_s": self.window_s, "n_units": self.n,
               "k1": self.k1, "k2": self.k2,
               "kernel_runs": collections.defaultdict(list)}
        for a, b, name in dev:
            out["kernel_runs"][name].append((b - a) * 1e-9)
        busy, gaps = _union(dev)
        out["busy_s"] = busy
        out["idle_gaps"] = _gaps_by_host(gaps, host)
        return out


def _union(intervals):
    """``(busy seconds, gaps [(start_ns, end_ns)])`` of the union of the
    device intervals."""
    if not intervals:
        return 0.0, []
    iv = sorted((a, b) for a, b, _ in intervals)
    busy, gaps = 0, []
    cur_a, cur_b = iv[0]
    for a, b in iv[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    return busy * 1e-9, gaps


def _gaps_by_host(gaps, host) -> list:
    """Idle seconds by the innermost host event (of the busiest thread)
    running at each gap's middle: ``[[name, seconds], ...]``, most first,
    at most 10."""
    if not gaps:
        return []
    by_thread = collections.Counter(h[3] for h in host)
    main = by_thread.most_common(1)[0][0] if by_thread else None
    events = sorted((h for h in host if h[3] == main), key=lambda h: h[0])
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    total = collections.defaultdict(float)
    stack, j = [], 0
    for m, length in mids:
        while j < len(events) and events[j][0] <= m:
            stack.append(events[j])
            j += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        # an outer event can end before an inner one began (async ends)
        stack[:] = [e for e in stack if e[1] >= m]
        live = stack
        name = live[-1][2] if live else "host, no profiled op"
        total[name] += length * 1e-9
    return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])
            ][:10]


def top_kernels(red: dict) -> list:
    """``[[name, seconds], ...]`` of the device operations that took most
    time in the stretch, at most 10."""
    total = {n: sum(ds) for n, ds in red["kernel_runs"].items()}
    return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])
            ][:10]
