"""The readings the check's limits are set from: for each seed, a short
session of the cell at its own load, then the check's four numbers for the
program and for the control (the reference in TF32 and with a float32
chain, in the program's place), on the same sampled frames and pairs.
One JSON line a seed; no run of the benchmark runs this.

    python3 perfbench/control.py --workload hdl64-offline-w64 \\
        --seeds 11,12,13 --seconds 14
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell: str, seed: int, seconds: float, device, config=None,
             workload=None) -> dict:
    """``{"program": {...}, "control": {...}}`` of one seed."""
    import torch

    from perfbench import check, harness

    run = harness.Run(cell, seed, device, config, workload)
    run.entry.warmup()
    rec = run.entry.session(seconds, run.plan)
    if run.cuda:
        torch.cuda.synchronize()
    return {"seed": seed, "units": rec["units"],
            "program": check.numbers(run, rec),
            "control": check.numbers(run, rec, low=True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        out = readings(args.workload, int(s), args.seconds, "cuda")
        out["s"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
