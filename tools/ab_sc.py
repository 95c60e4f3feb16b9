"""Time the ScanContext correlation matrix of the port in the checkout ROOT
on one CUDA card, at trajectory lengths from a short circuit to a whole
KITTI sequence, for each card row block given.

    python3 tools/ab_sc.py ROOT [BLOCK ...]

ROOT is a checkout of this repository; its own ``caelo_tpu_torch`` is
imported, so two trees compare by running this once per tree, in turns,
within one machine session (A, B, B, A).  Where ROOT's
``backend/scancontext.py`` blocks its query rows (``SC_ROW_BLOCK``), each
BLOCK (default: the tree's own) is set as the card's block in turn; a tree
without blocks is timed once.

Inputs: ``(N, 16, 64)`` float32 signatures, uniform in [0, 8) from seed 0,
N = 88 (the smoke's loop-closure circuit), 1101 (KITTI 01) and 4541
(KITTI 00).  Each ``sc_correlation_matrix`` call is timed by CUDA events,
median of 3 after one warm call.  Prints one JSON line per (N, block) and
the card's nvidia-smi name and power limit.
"""
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from caelo_tpu_torch.backend import scancontext  # noqa: E402

LENGTHS = (88, 1101, 4541)


def ms(fn) -> float:
    fn()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[1]


def main():
    blocked = isinstance(getattr(scancontext, "SC_ROW_BLOCK", None), dict)
    blocks = ([int(b) for b in sys.argv[2:]] or
              [scancontext.SC_ROW_BLOCK["cuda"]]) if blocked else [None]
    rng = np.random.default_rng(0)
    for n in LENGTHS:
        scs = torch.from_numpy(rng.uniform(0, 8, (n, 16, 64)).astype(
            np.float32)).cuda()
        for blk in blocks:
            if blk is not None:
                scancontext.SC_ROW_BLOCK["cuda"] = blk
            t = ms(lambda: scancontext.sc_correlation_matrix(scs))
            print(json.dumps({"root": ROOT, "frames": n, "block": blk,
                              "ms": t}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
