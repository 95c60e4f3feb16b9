"""Burst bookkeeping of the burst-rescue stage, host numpy.

Copied from ``caelo_tpu/backend/burst.py:328-364``, a module that imports
JAX.  The rescue itself (``burst_map_icp``, ``rescue_bursts``) is not
ported yet; ``caelo_tpu_torch.pipeline`` uses ``find_burst_spans`` to
refuse sequences that would need it.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class BurstStats:
    spans: List = dataclasses.field(default_factory=list)      # (a, b)
    accepted: List = dataclasses.field(default_factory=list)
    rejected: List = dataclasses.field(default_factory=list)
    gains: List = dataclasses.field(default_factory=list)      # (r0, r1)
    # per span: the accepted closure evidence ("descriptor(N)" /
    # "icp(res)" / None)
    closures: List = dataclasses.field(default_factory=list)


def find_burst_spans(healthy: np.ndarray, min_burst: int = 4,
                     max_span: int = 62):
    """Maximal runs of consecutive UNHEALTHY frames, extended by one
    healthy anchor on each side.  Returns [(a, b)] frame spans (b
    inclusive); runs longer than ``max_span - 1`` are split."""
    healthy = np.asarray(healthy, bool)
    n = len(healthy)
    spans = []
    i = 0
    while i < n:
        if healthy[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and not healthy[j + 1]:
            j += 1
        if j - i + 1 >= min_burst:
            a = max(i - 1, 0)
            b = min(j + 1, n - 1)
            while b - a > max_span:
                spans.append((a, a + max_span))
                a = a + max_span
            if b > a:
                spans.append((a, b))
        i = j + 1
    return spans
