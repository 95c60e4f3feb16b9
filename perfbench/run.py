"""The benchmark of the PyTorch and CUDA port (``caelo_tpu_torch``): one
run of one cell, one JSON line on standard output.

    python3 perfbench/run.py --workload hdl64-offline-w64 --seed 7 \\
        --seconds 30 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (``BENCHMARK.json``).  A run needs a CUDA card (and as
many as the cell asks for) and exits 2 without one; it exits 3 if the
process holds JAX or the JAX package once the window has closed.  The
numbers the check compared are printed beside their limits as the last
lines of standard error and under ``checks``, the line's last key.
"""
import time

T_START = time.perf_counter()       # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package and JAX itself, by top-level module name
FORBIDDEN = {"jax", "jaxlib", "flax", "caelo_tpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one host thread for torch's CPU ops unless the caller set it: the
    # odometry drivers are bound by one thread's kernel launches, which idle
    # intra-op threads on a shared host slow and spread
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    # kernel caches at fixed paths inside the checkout (the program's nvcc
    # library already lands in caelo_tpu_torch/_build/)
    cache = os.path.join(ROOT, "runs", "perfbench", "cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    sys.path.insert(0, ROOT)
    import torch

    t_torch = time.perf_counter()
    from perfbench import harness

    clock = harness.SetupClock(T_START)
    clock.mark("python and torch imports", t_torch)
    clock.mark("benchmark imports")
    chips = harness.load("workloads", args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    clock.mark("card check")
    out = harness.measure(args.workload, args.seed % 2 ** 63, args.seconds,
                          bool(args.trace), "cuda", T_START, clock=clock)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"perfbench: the process holds {loaded}", file=sys.stderr)
        return 3
    harness.report_checks(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
