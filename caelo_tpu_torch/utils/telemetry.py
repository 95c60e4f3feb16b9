"""Stage timing and run metrics (the port's own copy of
``caelo_tpu/utils/telemetry.py``'s host parts).

* ``StageTimer``: named wall-clock stages, aggregated (``summary``,
  ``report``).  With ``sync`` and a CUDA device it synchronises the device
  at both ends of a stage, so a stage's wall time holds the device work it
  queued and none that an earlier stage left running.
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


class StageTimer:
    """Named stage timing with optional CUDA synchronisation."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block as stage ``name``; the CUDA synchronise at its end
        covers every tensor the stage queued."""
        sync = self.sync and torch.cuda.is_available()
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
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
