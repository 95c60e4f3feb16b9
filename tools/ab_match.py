"""Time one batched ``match_descriptors`` call and the warm 16-frame window
of the port in the checkout ROOT, on one CUDA card.

    python3 tools/ab_match.py ROOT

ROOT is a checkout of this repository; its own ``caelo_tpu_torch`` and
``chip_smoke.py`` are imported, so two trees compare by running this once
per tree, in turns, within one machine session (A, B, B, A).

Inputs: ``chip_smoke.py``'s 17 synthetic scans at the default
``PipelineConfig()``, random weights from seed 0.  The match call is the
window's own: the 15 consecutive pairs of the first 16 frames' features,
``ratio=cfg.match_ratio``, no motion prior.  Prints the match's median
and mean host wall ms over 50 synchronised calls (after one warm call),
the number of exact-duplicate descriptor pairs among the valid frame-0
rows, the warm window's times (7 calls) and median, and the card's
nvidia-smi name and power limit.
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.abspath(sys.argv[1])
sys.path.insert(0, ROOT)
os.chdir(ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from caelo_tpu_torch import _build, setup_device  # noqa: E402
from caelo_tpu_torch.config import PipelineConfig  # noqa: E402
from caelo_tpu_torch.frontend.matching import match_descriptors  # noqa: E402
from caelo_tpu_torch.frontend.odometry import (  # noqa: E402
    make_sequence_processor, run_odometry_windowed)
from caelo_tpu_torch.models.weights_io import (  # noqa: E402
    build_models, random_flax_params)

WINDOW = 16


def wall_ms(fn, reps):
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ab_match: no CUDA device")
    dev = setup_device("cuda:0")
    _build.load_library()
    cfg = PipelineConfig()
    scans = chip_smoke.make_scans(cfg)
    net, enc = build_models(*random_flax_params(0), dev, cfg)

    _, feats = run_odometry_windowed(scans[:WINDOW], net, enc, cfg=cfg,
                                     window=WINDOW, seed=0,
                                     keep_features=True)
    d, m = feats.descriptors, feats.mask
    c0, m0, c1, m1 = d[:-1], m[:-1], d[1:], m[1:]
    n_dup = sum(int(((c0[p][:, None] == c1[p][None]).all(-1)
                     & m0[p][:, None]).sum()) for p in range(len(c0)))
    match = wall_ms(lambda: match_descriptors(c0, m0, c1, m1,
                                              ratio=cfg.match_ratio), 50)

    process = make_sequence_processor(cfg)
    pts_w = torch.stack([torch.from_numpy(s[0]) for s in scans[:WINDOW]]
                        ).to(dev)
    msk_w = torch.stack([torch.from_numpy(s[1]) for s in scans[:WINDOW]]
                        ).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    win = wall_ms(lambda: process(net, enc, pts_w, msk_w, gen), 7)

    print(f"tree {ROOT}")
    print(f"match_descriptors {tuple(c0.shape)} x {tuple(c1.shape)}: median "
          f"{np.median(match):.4f} ms, mean {np.mean(match):.4f} ms over "
          f"{len(match)} calls; exact-duplicate valid pairs {n_dup}")
    print(f"warm {WINDOW}-frame window: {[round(t, 3) for t in win]} ms, "
          f"median {np.median(win):.3f} ms")
    print(f"card: {chip_smoke.nvidia_smi_line()}", flush=True)


if __name__ == "__main__":
    main()
