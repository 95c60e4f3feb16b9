"""Where the time and memory of the keypoint baselines go on one CUDA card.

    python3 tools/prof_baselines.py

Input: frame 0 of ``chip_smoke.py``'s 17 synthetic scans at the default
``PipelineConfig()`` (131,072 padded points).  Prints, with the card's
nvidia-smi name and power limit:

* which batch sizes of 3x3 matrices one ``torch.linalg.eigh`` call takes
  on the card (cuSOLVER's batched solver refuses large batches, hence
  ``frontend/baselines.py::_EIGH_BATCH``), and ``_eigh``'s time and peak
  memory over the frame's 131,072 covariances;
* ``_knn_neighbors`` (K4), and its plain version at 512 (the default),
  2,048 and 8,192 queries per chunk: ms by CUDA events and peak memory,
  and the same for the plain version's parts on one 512-query chunk
  (score matmul, top-k, the two sorts);
* ISS, Harris3D and SIFT3D whole and stage by stage (``_knn_neighbors``,
  ``_neighbor_cov``, ``_eigh``, ``_radius_nms``, ``_sift_scale_space``;
  the rest is the response and SIFT's level scores): ms by CUDA events,
  each stage synchronised, and the peak memory of each.
"""
import contextlib
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import caelo_tpu_torch.frontend.baselines as bl  # noqa: E402
from caelo_tpu_torch import setup_device  # noqa: E402
from caelo_tpu_torch.config import PipelineConfig  # noqa: E402

REPS = 5
STAGES = ("_knn_neighbors", "_neighbor_cov", "_eigh", "_radius_nms",
          "_sift_scale_space")


def timed(fn):
    """``(result, ms per call by CUDA events over REPS calls, peak MiB of
    one call above what was allocated before it)``."""
    out = fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / REPS, peak


def _one(fn):
    """``(ms by CUDA events, peak MiB above what was allocated before)`` of
    one synchronised call."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end),
            (torch.cuda.max_memory_allocated() - base) / 2 ** 20)


@contextlib.contextmanager
def staged(record):
    """Time every call of the baselines' stage functions (synchronised, by
    CUDA events) and its peak memory, appending ``(name, ms, MiB)``."""
    saved = {name: getattr(bl, name) for name in STAGES}

    def wrap(name, fn):
        def run(*args, **kwargs):
            out = []
            ms, peak = _one(lambda: out.append(fn(*args, **kwargs)))
            record.append((name, ms, peak))
            return out[0]
        return run

    for name, fn in saved.items():
        setattr(bl, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(bl, name, fn)


def report(what, fn):
    out, ms, peak = timed(fn)
    print(f"{what}: {ms:.3f} ms, peak {peak:.1f} MiB above the inputs",
          flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("prof_baselines: no CUDA device")
    dev = setup_device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    scans = chip_smoke.make_scans(PipelineConfig())
    pts = torch.from_numpy(scans[0][0][:, :3].copy()).to(dev)
    mask = torch.from_numpy(scans[0][1]).to(dev)
    N = pts.shape[0]
    print(f"frame 0: {int(mask.sum())} valid of {N} points")

    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((N, 3, 3), generator=g, device=dev)
    spd = a @ a.transpose(1, 2)
    for batch in (16384, 32768, N):
        try:
            torch.linalg.eigh(spd[:batch])
            torch.cuda.synchronize()
            print(f"torch.linalg.eigh of {batch} matrices in one call: taken")
        except torch.linalg.LinAlgError as e:
            print(f"torch.linalg.eigh of {batch} matrices in one call: "
                  f"refused ({str(e).splitlines()[0][:60]})")

    report("_knn_neighbors k 64 (K4, one launch)",
           lambda: bl._knn_neighbors(pts, mask, 64))
    for chunk in (512, 2048, 8192):
        report(f"_knn_neighbors_plain k 64, {chunk} queries a chunk",
               lambda: bl._knn_neighbors_plain(pts, mask, 64, chunk))
    qc = pts[:512]
    p2m = torch.where(mask, (pts * pts).sum(-1), 1e12)
    score = report("  one chunk: score matmul (512, N)",
                   lambda: 2.0 * (qc @ pts.T) - p2m[None]
                   - (qc * qc).sum(-1)[:, None])
    vals, idx = report("  one chunk: torch.topk k 64",
                       lambda: torch.topk(score, 64, dim=-1))
    report("  one chunk: the two sorts into lax.top_k's order",
           lambda: vals.gather(-1, idx.sort(-1)[1]).sort(
               dim=-1, descending=True, stable=True))

    for name, fn in (("iss", bl.iss_keypoints),
                     ("harris", bl.harris3d_keypoints),
                     ("sift", bl.sift3d_keypoints)):
        fn(pts, mask)                                        # warm
        whole, peak = _one(lambda: fn(pts, mask))
        stages = []
        with staged(stages):
            fn(pts, mask)
        split = "; ".join(f"{s} {ms:.3f} ms (peak {pk:.1f} MiB)"
                          for s, ms, pk in stages)
        print(f"{name}_keypoints: {whole:.3f} ms, peak {peak:.1f} MiB; "
              f"stage by stage, synchronised: {split}; the rest (response, "
              f"extremum tests) {whole - sum(ms for _, ms, _ in stages):.3f}"
              " ms", flush=True)
    print(f"card: {card}")


if __name__ == "__main__":
    main()
