"""The program's own spans in a profiled stretch, read against the device
trace on the same clock.

The program opens a span (a record-function range, every name starting
with ``caelo.``) at each of its layer boundaries while a profiler runs
(``caelo_tpu_torch.utils.telemetry.span``).  Kineto records those ranges
on the clock of the CUDA kernels, copies and runtime calls, so for each
span name ``reduce`` gives:

* ``calls``, and ``retried``: the calls that sit under a
  ``caelo.register.retry`` span;
* ``self_s``: the spans' seconds less the parts their direct child spans
  cover; ``total_s``: their whole seconds;
* ``ops`` and ``device_s``: the device operations (kernels, copies, sets)
  launched from inside the span and not from a child span, each matched by
  its correlation id to the runtime call that launched it, and their device
  seconds; ``ops_under`` and ``device_s_under`` add the child spans';
* ``syncs`` and ``syncs_under``: host synchronisations
  (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``, a blocking ``cudaMemcpy``) called the same way.

A runtime call belongs to the innermost span open on its thread when it
began; one whose thread holds no span (the profiler gives a call that no
operator launched no thread of its own) is taken as the main thread's, the
thread with the most spans.  A span the stretch cuts (begun before the
profiler started or open when it stopped) is not recorded, and one that
reaches outside ``[start_ns, end_ns]`` is left out of every count, as is
every runtime call and device operation that begins outside it.

``idle_by_span`` puts each stretch of device idle time down to the
innermost span open on the main thread at its middle, or to ``outside
spans``: the gaps between the device intervals (``trace._union``'s), and
the lead before the first and the tail after the last device operation
when the stretch's bounds are known.

The readers get the table from ``of_reading``: the harness hands them the
stretch's reduction (``trace.Profile.reduce``), which holds no events, so
the profiler whose stretch it is is found on the caller's stack (the
harness's ``measure`` holds it while it reads), reduced once, and its
table and idle time by span written to standard error for the record.
"""
from __future__ import annotations

import collections
import json
import math
import re
import sys
from typing import NamedTuple

PREFIX = "caelo."
RETRY = "caelo.register.retry"
OUTSIDE = "outside spans"
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
# CUDA runtime and driver API calls (cudaLaunchKernel, cuLaunchKernelEx, ...)
_RUNTIME = re.compile(r"cu(da)?[A-Z]")


class Event(NamedTuple):
    name: str
    device: bool        # a device operation: kernel, copy or set
    start: int          # ns
    end: int            # ns
    tid: int
    corr: int           # correlation id


def events(kineto_results) -> list:
    """The profiler's events as ``Event``s, without the device-side copies
    of user annotations (ranges on the CUDA timeline) and without the
    program's spans the profiler stopped inside (no thread ended them)."""
    out = []
    for e in kineto_results.events():
        kind = str(e.device_type())
        device = kind.endswith("CUDA")
        if device and e.is_user_annotation():
            continue
        if not device and not kind.endswith("CPU"):
            continue
        if (not device and e.name().startswith(PREFIX)
                and e.end_thread_id() == 0):
            continue
        out.append(Event(e.name(), device, e.start_ns(),
                         e.start_ns() + e.duration_ns(),
                         e.start_thread_id(), e.correlation_id()))
    return out


def _innermost(spans: list, times: list) -> list:
    """For each of ``times`` (ascending), the index in ``spans`` (nested
    intervals on one thread, sorted by start, outer first) of the innermost
    span holding it, or -1."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j].start <= t:
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]].end < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def _by_thread(spans: list, items: list, when, thread_of) -> list:
    """The innermost span (an index into ``spans``, or -1) of each item, at
    time ``when(item)`` on thread ``thread_of(item)``."""
    found = [-1] * len(items)
    groups = collections.defaultdict(list)
    for k, item in enumerate(items):
        groups[thread_of(item)].append(k)
    for tid, ks in groups.items():
        idx = [i for i, s in enumerate(spans) if s.tid == tid]
        if not idx:
            continue
        ks.sort(key=lambda k: when(items[k]))
        hits = _innermost([spans[i] for i in idx],
                          [when(items[k]) for k in ks])
        for k, h in zip(ks, hits):
            found[k] = idx[h] if h >= 0 else -1
    return found


def _parents(spans: list) -> list:
    """The index of each span's direct parent (-1 for none), spans sorted
    by start, outer first."""
    parent = [-1] * len(spans)
    stacks = collections.defaultdict(list)
    for i, s in enumerate(spans):
        stack = stacks[s.tid]
        while stack and spans[stack[-1]].end < s.end:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    return parent


def _gaps(dev: list, start_ns, end_ns) -> list:
    """``[(start, end)]`` of the device's idle stretches: between the union
    of the device intervals, and before and after it within the bounds."""
    if not dev:
        if start_ns is not None and end_ns is not None and end_ns > start_ns:
            return [(start_ns, end_ns)]
        return []
    iv = sorted((e.start, e.end) for e in dev)
    gaps, (cur_a, cur_b) = [], iv[0]
    first = cur_a
    for a, b in iv[1:]:
        if a > cur_b:
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if start_ns is not None and start_ns < first:
        gaps.append((start_ns, first))
    if end_ns is not None and end_ns > cur_b:
        gaps.append((cur_b, end_ns))
    return gaps


def reduce(evs: list, start_ns: int = None, end_ns: int = None) -> dict:
    """The span table, the syncs of the main thread, the share of device
    operations matched to their launch, and the idle time by span, of the
    events ``evs`` of one stretch (see the module's docstring)."""
    lo = -math.inf if start_ns is None else start_ns
    hi = math.inf if end_ns is None else end_ns
    spans = sorted((e for e in evs if not e.device
                    and e.name.startswith(PREFIX) and e.end > e.start
                    and lo <= e.start and e.end <= hi),
                   key=lambda e: (e.start, -e.end))
    calls = [e for e in evs if not e.device and _RUNTIME.match(e.name)
             and lo <= e.start <= hi]
    dev = [e for e in evs if e.device and lo <= e.start <= hi]
    threads = collections.Counter(s.tid for s in spans)
    main = threads.most_common(1)[0][0] if threads else None
    thread_of = lambda e: e.tid if e.tid in threads else main

    parent = _parents(spans)
    n = len(spans)
    child_s = [0] * n
    for i, p in enumerate(parent):
        if p >= 0:
            child_s[p] += spans[i].end - spans[i].start
    under_retry = [False] * n
    for i, p in enumerate(parent):
        under_retry[i] = p >= 0 and (spans[p].name == RETRY
                                     or under_retry[p])

    # launches: device operation -> runtime call -> innermost span
    launch = {c.corr: c for c in calls}
    matched = [(d, launch[d.corr]) for d in dev if d.corr in launch]
    at = _by_thread(spans, matched, lambda m: m[1].start,
                    lambda m: thread_of(m[1]))
    ops, dev_ns = [0] * n, [0] * n
    for (d, _), i in zip(matched, at):
        if i >= 0:
            ops[i] += 1
            dev_ns[i] += d.end - d.start

    syncs_all = [c for c in calls if c.name in SYNCS]
    at = _by_thread(spans, syncs_all, lambda c: c.start, thread_of)
    syncs = [0] * n
    for i in at:
        if i >= 0:
            syncs[i] += 1

    # totals under each span: children after parents in start order, so
    # walking backwards adds each subtree before its parent reads it
    ops_u, dev_u, syncs_u = list(ops), list(dev_ns), list(syncs)
    for i in range(n - 1, -1, -1):
        p = parent[i]
        if p >= 0:
            ops_u[p] += ops_u[i]
            dev_u[p] += dev_u[i]
            syncs_u[p] += syncs_u[i]

    table = {}
    for i, s in enumerate(spans):
        row = table.setdefault(s.name, collections.Counter())
        row["calls"] += 1
        row["retried"] += under_retry[i]
        row["self_s"] += (s.end - s.start - child_s[i]) * 1e-9
        row["total_s"] += (s.end - s.start) * 1e-9
        row["ops"] += ops[i]
        row["ops_under"] += ops_u[i]
        row["device_s"] += dev_ns[i] * 1e-9
        row["device_s_under"] += dev_u[i] * 1e-9
        row["syncs"] += syncs[i]
        row["syncs_under"] += syncs_u[i]

    main_spans = [s for s in spans if s.tid == main]
    gaps = sorted(_gaps(dev, start_ns, end_ns))
    idle = collections.defaultdict(float)
    hits = _innermost(main_spans, [(a + b) // 2 for a, b in gaps])
    for (a, b), i in zip(gaps, hits):
        idle[main_spans[i].name if i >= 0 else OUTSIDE] += (b - a) * 1e-9
    return {
        "spans": {k: dict(v) for k, v in sorted(table.items())},
        "syncs_main_thread": sum(1 for c in syncs_all
                                 if thread_of(c) == main),
        "device_ops": len(dev), "matched_ops": len(matched),
        "matched_share": len(matched) / len(dev) if dev else None,
        "idle_s": sum(idle.values()),
        "idle_by_span": [[k, v] for k, v in
                         sorted(idle.items(), key=lambda x: -x[1])],
    }


def of_profiler(prof) -> dict:
    """``reduce`` of a stopped ``torch.profiler.profile`` over its stretch:
    from the trace's start to the end of its last host event (the
    synchronise before the stop, where the profiler is stopped as the
    benchmark stops it)."""
    res = prof.profiler.kineto_results
    evs = events(res)
    ends = [e.end for e in evs if not e.device]
    return reduce(evs, res.trace_start_ns(), max(ends) if ends else None)


def _profile_of(red: dict):
    """The ``trace.Profile`` on the caller's stack whose reduction is
    ``red`` (matched by the lists they share), or None."""
    from .trace import Profile

    f = sys._getframe(1)
    while f is not None:
        for v in list(f.f_locals.values()):
            if (isinstance(v, Profile) and v.prof is not None
                    and v.k1 is red.get("k1")):
                return v
        f = f.f_back
    return None


def of_reading(r) -> dict:
    """The program's table of a reading's profiled stretch, ``{}`` where it
    has none: ``r.prof["program"]`` where the reduction holds it, else
    reduced from the stretch's profiler, once a reading."""
    red = r.prof
    if not red:
        return {}
    if "program" in red:
        return red["program"] or {}
    if "_program" not in r.__dict__:
        prof = _profile_of(red)
        out = of_profiler(prof.prof) if prof is not None else {}
        if out:
            print("program spans " + json.dumps(out["spans"]),
                  file=sys.stderr)
            print("program idle_by_span " + json.dumps(
                out["idle_by_span"][:10]) + " idle_s " + repr(out["idle_s"])
                  + " matched_share " + repr(out["matched_share"])
                  + " syncs_main_thread " + repr(out["syncs_main_thread"]),
                  file=sys.stderr)
        r._program = out
    return r._program


# --------------------------------------------------------------- readers
def spans(r) -> dict:
    """The span table of a reading's profiled stretch (empty where it has
    none)."""
    return of_reading(r).get("spans", {})


def calls(r, name: str) -> int:
    return spans(r).get(name, {}).get("calls", 0)


def first_pass_pairs(r) -> int:
    """Pair registrations of the stretch that no retry holds."""
    pair = spans(r).get("caelo.register.pair", {})
    return pair.get("calls", 0) - pair.get("retried", 0)


def per(r, name: str, key: str, units: int, scale: float = 1.0):
    """``key`` of span ``name`` over ``units`` (times ``scale``); None where
    the stretch holds no such span or no unit."""
    row = spans(r).get(name)
    if not row or not units:
        return None
    return row[key] / units * scale


def self_ms_per_frame(r, name: str):
    """Self milliseconds of span ``name`` per frame extracted in the
    stretch."""
    return per(r, name, "self_s", calls(r, "caelo.frontend.extract"), 1e3)
