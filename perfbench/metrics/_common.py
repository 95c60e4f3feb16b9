"""Arithmetic the metric readers share."""
from __future__ import annotations

import numpy as np
import torch

from .. import yardstick


def np_percentile(values, q) -> float:
    """The ``q``-th percentile (numpy's linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def per_unit(r, span: str, per: str):
    """Milliseconds of span ``span`` per frame extracted (``per =
    "extracted"``) or pair registered (``"pairs"``) in the span session;
    None where the span did not fire."""
    times = (r.spans or {}).get(span)
    if not times or not r.span_rec or not r.span_rec[per]:
        return None
    return sum(times) / r.span_rec[per] * 1e3


def _peaks(r):
    if not r.run.cuda:
        return None
    return yardstick.peak(torch.cuda.get_device_name(r.run.device))


def roofline(r, kernel: str, which: str):
    """A kernel's share of its roofline (%): the mean per-launch bound (the
    larger of bytes over the HBM rate and operations over the float32 peak)
    over its mean per-launch device time in the trace; None where the
    trace holds no launch of it."""
    p, peaks = r.prof, _peaks(r)
    if not p or not peaks:
        return None
    runs = [d for name, ds in p["kernel_runs"].items() if kernel in name
            for d in ds]
    inputs = p[which]
    if not runs or not inputs:
        return None
    bounds = []
    for shape_or_rows, t in inputs:
        if which == "k1":
            n_bytes = yardstick.k1_bytes(shape_or_rows)
            n_ops = yardstick.k1_ops(t, shape_or_rows)
        else:
            n_bytes = yardstick.k2_bytes(shape_or_rows, t)
            n_ops = yardstick.k2_ops(t)
        bounds.append(max(n_bytes / peaks["hbm_bytes"],
                          n_ops / peaks["float32_flops"]))
    return (sum(bounds) / len(bounds)) / (sum(runs) / len(runs)) * 100.0


def mfu(r):
    """The clean session's FLOPs by the configuration's shapes over its
    seconds and the float32 peak (%)."""
    peaks = _peaks(r)
    if not peaks or not r.rec:
        return None
    cfg = r.run.config["pipeline"]
    flops = (r.rec["frames"] * sum(yardstick.frame_flops(cfg).values())
             + r.rec["pairs"] * sum(yardstick.pair_flops(cfg).values()))
    return flops / r.rec["seconds"] / peaks["float32_flops"] * 100.0
