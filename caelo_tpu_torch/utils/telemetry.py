"""Stage timing and run metrics (counterpart of
``caelo_tpu/utils/telemetry.py``).

``MetricsLog`` and the timer's aggregation are the JAX package's own
(plain Python, no JAX).  The port's ``StageTimer`` synchronises the CUDA
device at both ends of a stage, so a stage's wall time holds the device
work it queued and none that an earlier stage left running.
"""
from __future__ import annotations

import contextlib

import torch

from caelo_tpu.utils.telemetry import MetricsLog  # noqa: F401
from caelo_tpu.utils.telemetry import StageTimer as _HostStageTimer


class StageTimer(_HostStageTimer):
    """Named wall-clock stages, aggregated (``summary``, ``report``).  With
    ``sync`` and a CUDA device, each stage synchronises the device when it
    starts and when it ends."""

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        sync = self.sync and torch.cuda.is_available()
        if sync:
            torch.cuda.synchronize()
        with super().stage(name):
            yield
            if sync:
                torch.cuda.synchronize()
