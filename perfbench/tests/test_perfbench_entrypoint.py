"""The benchmark's command: no result without a card, and on a card
one JSON line with the result's keys, the compared numbers last."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(*args, cwd=ROOT, timeout=600):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    p = run("--workload", "hdl64-offline-w64", "--seed", "3", "--seconds",
            "1", "--trace", "0")
    assert p.returncode == 2 and p.stdout == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["hdl64-offline-w64", "iss-offline",
                                  "hdl64-live-5hz"])
def test_one_short_run_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = run("--workload", cell, "--seed", str(2 ** 31 + 3), "--seconds",
            "3", "--trace", "0")
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks" and out["correct"]
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(out)
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert "setup_s" in out["metrics"]
