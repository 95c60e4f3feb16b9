"""Train both auto-encoders from scratch on hard-circuit scan caches and
gate the full pipeline with the trained weights on one CUDA device.

    python3 tools/trained_gates.py [--out runs/trained]
    python3 tools/trained_gates.py --weights DIR --pipeline-seed 1 ...

1. Scan caches (``examples.hard_benchmark.load_scans``, the ray cast of
   ``--scan-cache``, on the host, one process a cache): seeds 1 (clean)
   and 2 (``--degraded-turn``) to train on, so training never sees the
   gated scene; seed 0 clean, ``--degraded`` and ``--degraded-turn`` to
   gate.  They go to ``runs/hb_cache``.
2. ``python -m caelo_tpu_torch.examples.train_from_scratch_study
   --hard-caches <seeds 1, 2> --plateau 50 --hard-pairs 48 --out
   <out>/weights`` (the default step caps, 300 / 400).
3. ``python -m caelo_tpu_torch.examples.hard_benchmark --weights
   <out>/weights`` at seed 0: clean, clean with ``--candidate-source
   scancontext``, ``--degraded`` and ``--degraded-turn``, each writing
   ``<out>/<run>.json``; ``--runs clean,...`` runs those named only (and
   makes only their scenes' caches).

With ``--weights DIR`` the study is skipped (and the training caches are
not made) and DIR's checkpoints are gated; ``--pipeline-seed`` is passed
to every gate run (the registration draws on the same scenes).  Each
step's output goes to ``<out>/<step>.log``.  Prints the card's
nvidia-smi name and power limit, then one JSON line with each step's exit
code and seconds.  A gate that fails is a result (exit 1 of that run), not
a failure of this script; it fails if a cache, the study or a run fails
otherwise.  Needs a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CACHE = os.path.join(REPO, "runs", "hb_cache")
FRAMES = 520        # the circuit of every scene, as the reference gates it
# (seed, degraded, degraded_turn): two scenes to train on, three to gate
TRAIN_SCENES = [(1, False, False), (2, False, True)]
# each gate run: its scene and its flags
GATE_RUNS = {
    "clean": ((0, False, False), []),
    "clean_sc": ((0, False, False), ["--candidate-source", "scancontext"]),
    "degraded": ((0, True, False), ["--degraded"]),
    "degraded_turn": ((0, False, True), ["--degraded-turn"])}


def make_cache(seed, degraded, degraded_turn):
    """One scene's scan cache; returns its path and seconds."""
    from caelo_tpu_torch.config import PipelineConfig
    from caelo_tpu_torch.examples import hard_benchmark

    args = argparse.Namespace(frames=FRAMES, seed=seed, degraded=degraded,
                              degraded_turn=degraded_turn, scan_cache=CACHE)
    t0 = time.perf_counter()
    hard_benchmark.load_scans(args, PipelineConfig())
    return hard_benchmark.cache_path(args), time.perf_counter() - t0


def run_example(name, argv, log_path, timeout):
    """``python -m caelo_tpu_torch.examples.<name> argv``, its output to
    ``log_path``; returns ``(exit code, seconds)``."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run(
            [sys.executable, "-m", f"caelo_tpu_torch.examples.{name}",
             *argv], stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
            timeout=timeout).returncode
    return rc, round(time.perf_counter() - t0, 1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="runs/trained")
    ap.add_argument("--weights", default="",
                    help="gate these checkpoints instead of training")
    ap.add_argument("--pipeline-seed", type=int, default=-1,
                    help="registration seed of the gate runs (default: "
                         "the scene's, 0)")
    ap.add_argument("--runs", default=",".join(GATE_RUNS),
                    help="comma-separated gate runs (default: all of "
                         f"{', '.join(GATE_RUNS)})")
    args = ap.parse_args()
    runs = args.runs.split(",")
    if not set(runs) <= set(GATE_RUNS):
        sys.exit(f"trained_gates: --runs {args.runs}: not in "
                 f"{list(GATE_RUNS)}")
    import torch

    if not torch.cuda.is_available():
        sys.exit("trained_gates: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    summary = {"card": card, "frames": FRAMES}

    train_scenes = [] if args.weights else TRAIN_SCENES
    scenes = train_scenes + sorted({GATE_RUNS[r][0] for r in runs})
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(scenes),
                             mp_context=get_context("spawn")) as pool:
        futures = [pool.submit(make_cache, *s) for s in scenes]
        caches = [f.result() for f in futures]
    summary["caches"] = {os.path.basename(p): round(s, 1) for p, s in caches}
    summary["caches_wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(summary), flush=True)

    weights = args.weights or os.path.join(out, "weights")
    if not args.weights:
        rc, secs = run_example("train_from_scratch_study", [
            "--hard-caches",
            ",".join(p for p, _ in caches[:len(train_scenes)]),
            "--plateau", "50", "--hard-pairs", "48", "--out", weights],
            os.path.join(out, "study.log"), 3000)
        summary["study"] = {"rc": rc, "s": secs}
        print(json.dumps(summary), flush=True)
        if rc != 0:
            sys.exit(f"trained_gates: the study exited {rc}")

    failed = []
    for run in runs:
        flags = GATE_RUNS[run][1]
        rc, secs = run_example("hard_benchmark", [
            "--frames", str(FRAMES), "--weights", weights,
            "--scan-cache", CACHE, "--pipeline-seed", str(args.pipeline_seed),
            "--json-out", os.path.join(out, f"{run}.json"), *flags],
            os.path.join(out, f"{run}.log"), 3000)
        summary[run] = {"rc": rc, "s": secs}
        print(json.dumps(summary), flush=True)
        if rc not in (0, 1):
            failed.append(run)
    if failed:
        sys.exit(f"trained_gates: {failed} did not run to their gates")


if __name__ == "__main__":
    main()
