"""Shared small shapes for the benchmark's CPU tests: the cells' files with
the repository's tiny configuration and short calls, so that a run of the
harness takes seconds on a CPU."""
import copy
import dataclasses
import json


def tiny(cell: str):
    """``(config, workload)`` of ``cell`` at the tiny configuration, its
    calls, windows and check cut to a few frames."""
    from caelo_tpu_torch.config import tiny_test_config
    from perfbench import harness

    wl = copy.deepcopy(harness.load("workloads", cell))
    cfg = copy.deepcopy(harness.load("configs", wl["config"]))
    cfg["pipeline"] = json.loads(json.dumps(
        dataclasses.asdict(tiny_test_config())))
    wl["traffic"]["lap_frames"] = 24
    if wl["entry"] == "windowed":
        wl.update(sequence_frames=15, window=8)
        wl["check"] = {"windows": 2, "within": 2, "frames": 3}
    else:
        wl["check"] = {"pairs": 2, "within": 3, "frames": 2}
        if wl["arrival"].get("rate_hz"):
            wl["arrival"]["rate_hz"] = 2.0
    return cfg, wl
