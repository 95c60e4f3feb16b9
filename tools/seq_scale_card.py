"""The port's 4,541-frame sequence-scale proof on one CUDA device: the scan
cache written in parallel, trained weights, ``examples.seq_scale`` with
both loop-candidate sources, and, when asked, the window-staging A/B.

    python3 tools/seq_scale_card.py [--weights DIR] [--out runs/seq_scale]
        [--cache runs/seq_scale_cache] [--steps weights,cache,proof]

Steps, run in the order b, a, c, d, each reusing what an earlier run left
and making what is missing, so they can be split over several runs
(``--steps``, default ``weights,cache,proof``):

(a) ``cache``: ``data.scancache.write_benchmark_cache_parallel``, the
    ``FRAMES`` frames of the 520-frame circuit at seed 0 (~9.5 GB), byte
    for byte ``write_benchmark_cache``'s three files; kept at ``--cache``.
    (``examples.seq_scale`` writes it the same way when it is missing; the
    step times it alone.)
(b) ``weights``: ``--weights DIR``, or ``tools/trained_gates.py``'s study
    (its two 520-frame training caches, one process each, then
    ``train_from_scratch_study --plateau 50 --hard-pairs 48``) into
    ``<out>/weights``.
(c) ``proof``: ``python -m caelo_tpu_torch.examples.seq_scale --frames
    FRAMES --weights W`` once with ``--candidate-source descriptor`` and
    once with ``scancontext`` at the default window, each writing
    ``<out>/seq_scale_<source>.json`` and ``<out>/<source>.log``.
(d) ``ab``, only when named in ``--steps``: ``run_odometry_windowed``
    over the cache's first ``AB_FRAMES`` frames (two laps), keeping the
    features as ``run_full_pipeline`` does, in turns synchronous,
    threaded, threaded, synchronous staging, the poses of every turn
    bit-identical.  Before each turn the cache files' pages are dropped
    with ``posix_fadvise(DONTNEED)``, which a filesystem may ignore (the
    9p root of the H100 host this was run on did), so the step also times
    one read of those frames just after a drop and one just after that
    read: only a cold read slower than the warm one says the turns read
    from disk.

Prints the card's nvidia-smi name and power limit, then, after each step,
one JSON line of every step's exit code and seconds so far.  A proof whose
gates fail (exit 1) is a result; this script fails only if a step breaks.
Needs a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from caelo_tpu_torch.examples.seq_scale import LAP_FRAMES  # noqa: E402

FRAMES = 4541                   # KITTI seq 00, seq_scale's default
AB_FRAMES = 2 * LAP_FRAMES      # the staging A/B's two laps
SOURCES = ("descriptor", "scancontext")
TURNS = (False, True, True, False)      # threaded staging, in turns


def drop_page_cache(paths):
    """Write back and drop the files' pages from the page cache, so the
    next reads come from the disk where the filesystem honours the drop."""
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def staging_ab(base, frames, weights):
    """Step (d): the front end over the cache's first ``frames`` frames in
    ``TURNS``, the page cache dropped before each.  Returns the turns' seconds and the
    cold / warm seconds of reading those frames alone."""
    import torch
    from caelo_tpu_torch.config import PipelineConfig
    from caelo_tpu_torch.data.scancache import NpyScanReader
    from caelo_tpu_torch.examples.hard_benchmark import models
    from caelo_tpu_torch.examples.seq_scale import _Slice
    from caelo_tpu_torch.frontend.odometry import run_odometry_windowed

    dev = torch.device("cuda")
    respond_net, encoder, cfg = models(argparse.Namespace(weights=weights),
                                       PipelineConfig(), dev)
    reader = NpyScanReader(base)
    seq = _Slice(reader, frames)
    files = [reader.p_path, reader.m_path]

    def read_all():
        t0 = time.perf_counter()
        for i in range(frames):
            seq[i]
        return round(time.perf_counter() - t0, 3)

    drop_page_cache(files)
    reads = {"cold_s": read_all(), "warm_s": read_all()}

    def front_end(scans, threaded):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        odo, _, _ = run_odometry_windowed(
            scans, respond_net, encoder, cfg=cfg, seed=0,
            keep_features=True, keep_refine_features=True,
            threaded_staging=threaded)
        torch.cuda.synchronize()
        return odo, time.perf_counter() - t0

    # the default 16-frame window and one more: builds, lets cuDNN pick
    front_end(_Slice(reader, 17), False)
    turns, first = [], None
    for threaded in TURNS:
        drop_page_cache(files)
        odo, secs = front_end(seq, threaded)
        if first is None:
            first = odo
        elif not (np.array_equal(odo.poses, first.poses)
                  and np.array_equal(odo.successes, first.successes)):
            raise AssertionError(f"threaded={threaded}: the poses differ "
                                 "from the first turn's")
        turns.append({"threaded": threaded, "s": round(secs, 3),
                      "ms_per_frame": round(1e3 * secs / frames, 3)})
        print(json.dumps(turns[-1]), flush=True)
        del odo
        torch.cuda.empty_cache()
    return {"frames": frames, "read": reads, "turns": turns,
            "poses_bit_identical": True,
            "pairs_success": float(first.successes.mean())}


def main(argv=None):
    import trained_gates

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="runs/seq_scale")
    ap.add_argument("--cache", default="runs/seq_scale_cache",
                    help="base path of the scan cache")
    ap.add_argument("--weights", default="",
                    help="trained respond_ae / patch_ae checkpoints; "
                         "without it the study makes them")
    ap.add_argument("--steps", default="weights,cache,proof",
                    help="comma-separated steps; add ab for the staging "
                         "A/B")
    args = ap.parse_args(argv)
    steps = set(args.steps.split(","))
    import torch

    if not torch.cuda.is_available():
        sys.exit("seq_scale_card: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from caelo_tpu_torch.config import PipelineConfig
    from caelo_tpu_torch.data.scancache import (
        default_writer_procs, write_benchmark_cache_parallel)

    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    base = os.path.abspath(args.cache)
    weights = args.weights or os.path.join(out, "weights")
    summary = {"card": card, "frames": FRAMES}

    def report():
        print(json.dumps(summary), flush=True)

    # (b) weights: the study's two training caches, then the study
    if ("weights" in steps and not args.weights
            and not os.path.exists(os.path.join(weights, "patch_ae"))):
        t0 = time.perf_counter()
        scenes = trained_gates.TRAIN_SCENES
        with ProcessPoolExecutor(len(scenes),
                                 mp_context=get_context("spawn")) as pool:
            caches = [f.result() for f in [
                pool.submit(trained_gates.make_cache, *s) for s in scenes]]
        summary["train_caches_s"] = round(time.perf_counter() - t0, 1)
        rc, secs = trained_gates.run_example("train_from_scratch_study", [
            "--hard-caches", ",".join(p for p, _ in caches),
            "--plateau", "50", "--hard-pairs", "48", "--out", weights],
            os.path.join(out, "study.log"), 3000)
        summary["study"] = {"rc": rc, "s": secs}
        report()
        if rc != 0:
            sys.exit(f"seq_scale_card: the study exited {rc}")

    # (a) the cache
    if "cache" in steps and not os.path.exists(base + ".pts.npy"):
        t0 = time.perf_counter()
        write_benchmark_cache_parallel(base, FRAMES, PipelineConfig(),
                                       seed=0, lap_frames=LAP_FRAMES)
        summary["cache"] = {"procs": default_writer_procs(),
                            "s": round(time.perf_counter() - t0, 1)}
        report()

    # (c) the proof, one process a candidate source
    failed = []
    for source in SOURCES if "proof" in steps else ():
        json_out = os.path.join(out, f"seq_scale_{source}.json")
        if os.path.exists(json_out):
            os.remove(json_out)
        rc, secs = trained_gates.run_example("seq_scale", [
            "--frames", str(FRAMES), "--scan-cache", base,
            "--weights", weights, "--candidate-source", source,
            "--json-out", json_out], os.path.join(out, f"{source}.log"), 3000)
        summary[source] = {"rc": rc, "s": secs}
        with open(os.path.join(out, f"{source}.log")) as f:
            for line in f:
                if line.startswith(("SEQ-SCALE", "pipeline:", "peak device",
                                    "loop closure:", "burst rescue:")):
                    print(f"  {source} | {line.rstrip()}", flush=True)
        report()
        # exit 1 with no JSON is a run that broke before its gates
        if rc not in (0, 1) or not os.path.exists(json_out):
            failed.append(source)

    # (d) the staging A/B, asked for
    if "ab" in steps:
        t0 = time.perf_counter()
        summary["ab"] = staging_ab(base, AB_FRAMES, weights)
        summary["ab"]["s"] = round(time.perf_counter() - t0, 1)
        report()
    if failed:
        sys.exit(f"seq_scale_card: {failed} did not run to their gates")


if __name__ == "__main__":
    main()
