"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repo root, one CUDA device

Phases (each raises on failure; the script then exits nonzero):

1. card facts: nvidia-smi name and power limit, torch/CUDA versions, TF32;
2. build the CUDA kernels of ``caelo_tpu_torch/csrc`` with nvcc;
3. K1 (keypoint saliency and gates in one pass) against its plain version
   on the card: random planes and ring images (a 16-frame batch) and frame
   0 of the main path; K1's own function (``saliency_map``) on random
   planes; kernel, plain and bound times; the whole
   ``select_keypoints_planes`` per frame on the kernel and all-plain
   routes;
4. K2 (the plane gather that writes finished patches) against its plain
   version on the card, bit-exact: random tables at the three table sizes
   (zero-plane and clamped slots, offsets 0 and 15) and frame 0's real
   query at each scale; kernel, plain, library (``table2[slot]``) and bound
   times; the whole ``extract_patches`` per frame on both routes;
4b. K3 (RANSAC's batched 4x4 Jacobi eigen solve in one launch) against
   its plain version on the card, bit for bit, on Horn matrices of random
   4-point sets at the live refit's 1 lane, the live hypotheses' 2,048 and
   an offline window's 129,024: kernel and plain times by CUDA events, the
   kernel's device time in a CUDA graph, its host enqueue, its bound (80
   bytes and ~3,760 float32 operations a lane) and, at 2,048 lanes, the
   time of ``torch.linalg.eigh`` on the same matrices; then 256 refit-like
   Horn matrices of 500 points, one lane a call, bit for bit;
4c. K4 (the keypoint baselines' KNN scored and selected in one launch)
   against its plain version on the card, bit for bit, on frame 0 at k 1,
   16, 64 and 128: kernel and plain times at k 64 by CUDA events, the
   kernel's host enqueue and its bound (every pair scored, 8 float32
   operations a pair);
5. the front-end odometry window at the full default ``PipelineConfig()``
   on 17 synthetic scans with random weights: run A (default config, K1 +
   K2) and run B (``use_pallas_plane_gather=False``: indexing), launch
   counts, pose sanity, A/B identity, one frame against the all-plain path,
   times;
6. refinement: the window with its refinement features (K1 + K2), hybrid
   ICP recovering the known motion of 16 pairs from a perturbed start, one
   frame's refinement features against the all-plain path, and
   ``run_full_pipeline`` (front end, de-jump, ICP refinement) at the
   default config on the 17 scans with scan 8 thinned to 40 % (unhealthy,
   so its pairs are refined), launch counts, pose sanity, times;
7. the whole pipeline: ``run_full_pipeline`` at the default config with
   loop closure on over the 88-frame ray-cast CI circuit (one lap, so the
   last frames revisit the first) with a degradation burst over frames
   30-41: front end, de-jump, refinement, burst rescue, loop closure and
   the pose-graph solve.  Checks that the burst span was solved, loop
   candidates were verified, the graph was solved when a closure was
   accepted, every pose is finite and on SO(3), and K1 and K2 ran on every
   frame; logs each stage's ATE against the ground truth, loop
   precision/recall, the burst and closure stats, stage times and peak
   memory;
8. training at full width: ``cli.main(["train-respond", "--synthetic",
   ...])`` at the default batch of 16 ring images (3 x 64 x 1792) and
   ``train-patch`` at the default batch of 256 patches; checkpoints written
   and reloaded bit-equal, finite losses, K1 and K2 launched per scan of
   the patch trainer's data path; 20 steps at lr 3e-3 on one fixed
   full-width batch of each lower the loss by the JAX tests' margins
   (``tests/test_training.py``); the trained submodels
   (``respond_params_from_ae``, ``encoder_params_from_ae``) drive one
   front-end window at the relu / linear encoder activations; ms per train
   step (device, synchronised) apart from the host data ms;
9. the command line on a KITTI tree: phase 5's 17 scans written as
   ``.bin`` files with a ``calib.txt`` whose Tr is not trivial and the
   ground-truth ``poses/00.txt``; ``odometry``, ``full --frames 17
   --no-loops``, ``preprocess``, ``refine --artifacts``, ``loop --artifacts
   --min-gap 10`` and ``evaluate`` in process through ``cli.main``, with
   the ``.h5`` loaders answering ``random_flax_params(0)`` (the files are
   not in the repository); every trajectory (17, 12), finite and on SO(3),
   K1 and K2 on every frame, and each command's time.  Logs whether the
   native scan loader was built;
10. the keypoint baselines, external trees and voxel views at the default
   config: (a) ISS, Harris3D and SIFT3D on frame 0 on the card against the
   CPU (neighbour lists equal but for k-th-place ties; given the same
   lists, keypoint sets equal but for counted threshold flips), each card
   run's time split into KNN, eigen or scale space, and the rest, and its
   peak memory; (b) ``odometry --keypoints`` for iss, harris, sift, random
   and external (3DFeatNet and USIP trees written from phase 5's
   features) on phase 9's tree, in process: every trajectory finite and on
   SO(3), keypoints on every detector row, K2 three times per frame where
   the CAE-LO encoder describes the keypoints (not in the 3DFeatNet row,
   whose files carry descriptors), no K1; ms per frame, pair success, RRE,
   RTE, ATE and peak memory per row; (c) ``decode_patch``,
   ``occupancy_stats`` and ``export_voxels_ply`` on frame 0;
11. the one-device remainder at the default config on phase 5's scans:
   (a) ``compute_dtype="bfloat16"``: a window whose five convolutions run
   in bfloat16 (forward hooks) with K1 and K2 per frame, frame 0 against
   the port's bfloat16 on the CPU, ``tests/test_bf16.py``'s gates and the
   poses against run A's float32, warm window and encoder ms in both
   dtypes; (b) the card's binning equal to the CPU's on frame 0 (the
   voxel pyramid, every point's voxel and the keypoint voxels at all
   three scales; the ring image's cells but at atan2 / asin bin edges),
   the window route (``bitgrid_slots=(0, 0, 0)``) bit-exact
   and the KNN route (lists equal but for k-th-place ties) on frame 0
   against the CPU, and a window of each with its ms and peak memory; (c)
   ``presorted_pyramid=False`` on a shuffled frame-0 pyramid with K2, equal
   to the presorted patches; (d) threaded window staging over an
   ``NpyScanReader`` cache of the scans, poses bit-identical to staging
   each window when due (the default), and both times, in turns
   synchronous, threaded, threaded, synchronous;
12. multi-GPU through ``torch.distributed``: (a) one spawned rank in a
   real NCCL world on the card runs the data-parallel feature extractor on
   16 of phase 5's scans at the default config (K1 once and K2 three times
   per frame, features bit-identical to ``extract_frame_features``), the
   halo exchange, the sharded ScanContext correlation over 88 random
   signatures and the span-sharded ICP on phase 6's 16 spans (both
   bit-identical), the sharded pose graph (translations within 1e-2, cost
   within 1e-6 of ``optimize``), one DP and one TP patch-AE step at the
   batch of 256 (loss within rtol 1e-5 of the one-device step), each
   path's ms by CUDA events, the extractor's frames/s and peak memory;
   then ``cli scaling`` (the sweep ``[1]``); (b) ``dryrun_multigpu(4,
   "cpu")``: 4 gloo ranks on the host's CPU run every sharded path with
   cross-rank halos, row blocks and TP shards, each checked in rank 0;
13. the example drivers (``caelo_tpu_torch/examples``) on the card through
   their ``run`` seams: (a) ``train_from_scratch_study`` trains both AEs
   for 20 steps each on phase 7's circuit written as a scan cache
   (``--hard-caches``) and scores them on 2 easy and 2 ray-cast pairs:
   ``study.json`` with the JAX study's fields, finite losses, the patch
   AE's loss lower at the end than at the start, each loop's data and step
   ms; (b) ``hard_benchmark --frames 88 --weights`` with those weights:
   every field of the JAX script's JSON, finite, the exit code its
   ``gates_pass`` (not asserted to pass), K1 and K2 on every frame, the
   gate lines and pipeline seconds; (c) ``register_pair_demo``,
   ``loop_closure_demo`` and ``kitti_golden`` (phase 9's tree) with the
   ``.h5`` loaders answering (a)'s weights at the relu / linear encoder:
   finite errors and ATEs (the demos' own checks and the golden verdict
   are logged, not asserted), and ``collect_validation`` over (b)'s JSON:
   one row of the JAX script's keys;
14. the sequence-scale driver: (a) ``data.scancache``'s parallel cache
   writer, 8 frames of the 520-frame circuit over 4 processes, byte for
   byte ``write_benchmark_cache``'s three files; (b) ``seq_scale.run``
   over phase 7's circuit written as its scan cache (no ray cast) with
   13a's weights, staging windows when due and then in a producer thread:
   every field of the JAX script's JSON, finite (the loop precision of a
   run with no accepted edge is NaN), the exit code the gates' verdict
   (not asserted to pass), K1 and K2 on every frame, stage seconds and
   peak device memory logged, and all four pose arrays of the threaded run
   bit-identical to the default's;
15. the benchmark: ``cli bench`` in process (``caelo_tpu_torch/bench.py``)
   at 64 and then 16 frames in float32, then 64 frames in bfloat16, 12
   timed reps each: its one JSON line (finite frames/s, p50 and p95, ``0 <
   mfu <= 1`` against the peak of its dtype, FLOPs and peak device memory
   logged), the FLOP count's convolutions and linear layers equal to the
   hand count from the layer shapes and its total within 10 % of the hand
   count with matching, K1 n and K2 3n times in each of the 14 windows a
   run makes (warm-up, reps, the counted window), and frames 0-15 of the
   64-frame float32 window bit-identical to the 16-frame window's.

K1's, K2's, K3's and K4's launches are counted on the main path only (runs
A, 6a, 6d, 7, the trainers and the window of phase 8, the commands of
phases 9 and 10b, the windows and the unsorted-pyramid query of phase 11,
12a's extractor in its rank, whose counts come back to this process, phase
13's drivers, phase 14b's two runs and phase 15's benches), each count set
to 0 just before its run and read just after; every run that registers a
pair must launch K3 at least four times (one RANSAC call), and 11c's query
and 12a's extractor, which register none, not at all; K4 runs once a frame
in phase 10b's ISS, Harris3D and SIFT3D rows and in none of runs A and B.
Prints a
``{"kernels": [...]}`` JSON line, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line.  Without a CUDA device
it fails; it never falls back to the CPU.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

N_SCANS = 17
WINDOW = 16
# phase 7: the CI circuit of tests/test_hard_full_stack.py with the burst of
# tests/test_degraded_rescue.py, ray-cast at the sensor's own azimuth step
CIRCUIT = dict(n_frames=88, seed=0, side=30.0, yaw_rate_deg=6.0, n_cars=3,
               degraded_spans=[(30, 42, 0.8, 140.0)], az_step_deg=0.2)
# phase 8: steps of each trainer through the command line, and of the
# loss-decrease check on one fixed batch (tests/test_training.py's recipe)
TRAIN_STEPS = {"respond": 2, "patch": 6}
FIXED_STEPS, FIXED_LR = 20, 3e-3
LOSS_MARGIN = {"respond": 0.95, "patch": 0.8}
# phase 13: training steps of each AE in the study, the hard benchmark's
# frames, and the JSON fields of examples/hard_benchmark.py:195-225 and of
# the study's pair summaries
STUDY_STEPS = 20
HB_FRAMES = 88
HB_FIELDS = ("frames", "window", "pipeline_seed", "candidate_source",
             "rre_deg", "rte_m", "rre_p50", "rre_p90", "rre_max", "rte_p50",
             "rte_p90", "rte_max", "success_rate", "pair_success_frontend",
             "ate_raw_m", "ate_dejumped_m", "ate_refined_m", "ate_final_m",
             "n_loop_closures", "dejumped", "stage_seconds",
             "per_pair_rre_deg", "per_pair_rte_m", "gates_pass")
STUDY_FIELDS = {"tag", "n_pairs", "success_rate", "rot_err_deg_mean",
                "t_err_m_mean", "inlier_ratio_mean"}
# phase 14: the parallel cache writer's frames and processes, and the JSON
# fields of examples/seq_scale.py:119-151
WRITER_FRAMES, WRITER_PROCS = 8, 4
SS_FIELDS = ("frames", "window", "candidate_source", "gen_seconds",
             "pipeline_seconds", "frames_per_s_e2e", "peak_rss_gb",
             "stage_seconds", "success_rate", "rre_deg", "rte_m", "ate_m",
             "n_loop_closures", "loop_precision", "loop_recall",
             "loop_edges", "dejumped", "refined_spans", "max_unpinned_span")
# phase 15: the bench's (window size, BENCH_DTYPE) runs and timed reps
# (cli bench's defaults; bfloat16 once, for its MFU against the bfloat16 peak)
BENCH_RUNS = ((64, "float32"), (16, "float32"), (64, "bfloat16"))
BENCH_REPS = 12
REPS = 50            # kernel timing launches per arm
STAGE_REPS = 20      # per-frame stage timings per arm
WINDOW_REPS = 3      # warm window timings
# phase 11: frame 0 in bfloat16 on the card against the CPU, both rounding
# float32 sums to bfloat16 in their own order: the share of the CPU's
# keypoints the card keeps, and the descriptors' largest difference, 2^-8:
# above the 1.953e-3 measured card against CPU, below the 4.640e-3 that
# bfloat16 differs from float32 on the card (NVIDIA H100 80GB HBM3, 700 W)
BF16_SHARED = 0.95
BF16_DESC_TOL = 2.0 ** -8
# phase 11b: the card bins coordinates into voxels as the CPU does (both
# multiply by the voxel size's float32 reciprocal, as jitted JAX does;
# ROADMAP.md §3, fixed): the share of a scale's voxels, of the points and
# of the keypoints that may fall in another voxel is 0
BIN_SHARE = 0
# phase 11b: a point may fall in another ring-image cell on the card only
# where atan2 / asin put it within this relative distance of a bin edge
# (tests/test_torch_models.py's _edge_cells)
RING_EDGE = 1e-4

def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` launches, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ab_ms(plain, kernel, reps=REPS):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def graph_ms(fn, reps=20):
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed 3 times between CUDA events, so no host cost is in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    return ms


def host_us(fn, reps=REPS):
    """Host microseconds per call of ``fn`` without a synchronise: the cost
    of enqueueing it, which sets a launch-bound call's rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return t


def bound(n_bytes, n_ops):
    """``(ms, "bytes" | "operations")``: the least time the card could take
    to move ``n_bytes`` and do ``n_ops`` float32 operations, at its peaks
    in ``caelo_tpu_torch/bench.py`` (a card that table lacks stops)."""
    import torch
    from caelo_tpu_torch.bench import PEAK_FLOPS, PEAK_HBM_BYTES, lookup_peak

    name = torch.cuda.get_device_name(0)
    t_bytes = n_bytes / lookup_peak(PEAK_HBM_BYTES, name) * 1e3
    t_ops = n_ops / lookup_peak(PEAK_FLOPS, name)["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_saliency(planes, occ, what):
    """K1's own function (``saliency_map``) against its plain version:
    n_occ and finiteness exact, min_d2 to atol 1e-4 / rtol 1e-5 (8-term
    float32 sums)."""
    import torch
    from caelo_tpu_torch.ops.saliency import saliency_map, saliency_map_plain

    md, cnt = saliency_map(planes, occ)
    md_ref, cnt_ref = saliency_map_plain(planes, occ)
    torch.cuda.synchronize()
    if not torch.equal(cnt, cnt_ref):
        raise AssertionError(f"K1 {what}: n_occ differs")
    fin = torch.isfinite(md_ref)
    if not torch.equal(torch.isfinite(md), fin):
        raise AssertionError(f"K1 {what}: finiteness of min_d2 differs")
    torch.testing.assert_close(md[fin], md_ref[fin], atol=1e-4, rtol=1e-5)
    err = float((md[fin] - md_ref[fin]).abs().max()) if fin.any() else 0.0
    # the bound of this function alone (the TPU kernel's, which K1 computed
    # before it took in the gates): planes and bool occupancy read, min_d2
    # and n_occ written; per occupied neighbour 24 flops and a min
    frames = planes.shape[0] if planes.dim() == 4 else 1
    bms, bby = bound((planes.numel() * 4 + occ.numel() * 9) / frames,
                     25 * int(cnt_ref.sum()) / frames)
    log(f"K1 saliency_map {what}: shape {tuple(planes.shape)}, finite "
        f"{int(fin.sum())}, max_abs_err {err:.3e}; bound of this function "
        f"per frame {bms:.4f} ms ({bby})")
    return err


def check_keypoint_score(planes, image, counter, sensor, kp, what):
    """K1 against its plain version: n_occ, finiteness of min_d2 and zext
    exact; min_d2 to atol 1e-4 / rtol 1e-5; the good mask exact except
    where saliency lies within 1e-5 of the threshold; score to atol 1e-4
    where both pass.  Returns ``(max_abs_err, plain result)``."""
    import torch
    from caelo_tpu_torch.ops.saliency import (keypoint_score,
                                              keypoint_score_plain)

    got = keypoint_score(planes, image, counter, sensor, kp, extras=True)
    want = keypoint_score_plain(planes, image, counter, sensor, kp,
                                extras=True)
    torch.cuda.synchronize()
    if not torch.equal(got.n_occ, want.n_occ):
        raise AssertionError(f"K1 {what}: n_occ differs")
    fin = torch.isfinite(want.min_d2)
    if not torch.equal(torch.isfinite(got.min_d2), fin):
        raise AssertionError(f"K1 {what}: finiteness of min_d2 differs")
    torch.testing.assert_close(got.min_d2[fin], want.min_d2[fin], atol=1e-4,
                               rtol=1e-5)
    if not torch.equal(got.zext, want.zext):
        raise AssertionError(f"K1 {what}: zext differs")
    good, good_ref = torch.isfinite(got.score), torch.isfinite(want.score)
    near = (want.saliency - kp.norm_diff_threshold).abs() <= 1e-5
    if not torch.equal(good & ~near, good_ref & ~near):
        raise AssertionError(f"K1 {what}: the good mask differs")
    both = good & good_ref
    torch.testing.assert_close(got.score[both], want.score[both], atol=1e-4,
                               rtol=0)
    err = max(float((got.min_d2[fin] - want.min_d2[fin]).abs().max())
              if fin.any() else 0.0,
              float((got.score[both] - want.score[both]).abs().max())
              if both.any() else 0.0)
    log(f"K1 {what}: shape {tuple(planes.shape)}, finite min_d2 "
        f"{int(fin.sum())}, good {int(good_ref.sum())} (mismatched near the "
        f"threshold {int((good != good_ref).sum())}), max_abs_err {err:.3e}")
    return err, want


def k1_bound(planes, counter, want):
    """K1's bound on these inputs: it reads the 8 planes, the counter and
    the z and range channels once and writes score and saliency; per
    occupied neighbour 8 differences, 8 squares, 8 sums and a min, per
    occupied window pixel (centre included) a z min and max, ~12 per pixel
    for the square root and gates."""
    from caelo_tpu_torch.ops.saliency import keypoint_score_bytes

    H, W = planes.shape[-2:]
    n_pix = want.score.numel()
    n_nb = int(want.n_occ.sum())
    n_occ = int((counter[..., :H, :W] > 0).sum())
    n_bytes = keypoint_score_bytes(planes)
    n_ops = 25 * n_nb + 2 * (n_nb + n_occ) + 12 * n_pix
    log(f"K1 bound of {tuple(planes.shape)}: {n_bytes / 1e6:.3f} MB, "
        f"{n_ops / 1e6:.3f} M float32 operations")
    return bound(n_bytes, n_ops)


def check_patches(query, what):
    """K2 against its plain version, bit-exact.  Returns the patches."""
    import torch
    from caelo_tpu_torch.ops.plane_gather import (patches_from_planes,
                                                  patches_from_planes_plain)

    out = patches_from_planes(*query)
    ref = patches_from_planes_plain(*query)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"K2 {what}: patches differ")
    return out


def k2_bound(query):
    """K2's bound on these inputs: the distinct table rows its slots name
    (1 KB each), the slots and offsets, once, and the float32 patches
    written; ~3 integer operations per patch value (shift, and, convert),
    counted at the float32 rate."""
    from caelo_tpu_torch.ops.plane_gather import patches_from_planes_bytes

    table2, slot, o = query
    K = slot.shape[0]
    n_bytes = patches_from_planes_bytes(table2, slot)
    log(f"K2 bound of {K} keypoints on a table of {table2.shape[0]} rows: "
        f"{n_bytes / 1e6:.3f} MB")
    return bound(n_bytes, 3 * K * 4096)


# K3's float32 operations a lane: 8 sweeps x 6 rotations, each 3 for its
# angle, one call each of atan2f, cosf and sinf, and 72 products and sums
# (rows and columns of A, columns of V); then 3 compares, 7 for the norm and
# 4 quotients
K3_OPS_PER_LANE = 48 * (3 + 3 + 72) + 3 + 7 + 4
K3_BYTES_PER_LANE = 16 * 4 + 4 * 4      # A read, the eigenvector written


def horn_lanes(B, g, dev, n=4, spread=10.0, tilt=None):
    """``(4, 4, B)`` Horn matrices of random ``n``-point sets under random
    motions (turns of about ``tilt`` radians where it is given) with 5 cm
    of noise: RANSAC's hypotheses at ``n = 4``, its refits at hundreds."""
    import torch
    from caelo_tpu_torch.geometry import se3

    p1 = torch.randn((B, n, 3), generator=g, device=dev) * spread
    q = torch.randn((B, 4), generator=g, device=dev)
    if tilt is not None:
        q = q * tilt + torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    R = se3.quat_to_rotmat(torch.nn.functional.normalize(q, dim=1))
    p0 = (se3.apply(R, torch.randn((B, 3), generator=g, device=dev), p1)
          + torch.randn((B, n, 3), generator=g, device=dev) * 0.05)
    q0, q1 = p0 - p0.mean(1, keepdim=True), p1 - p1.mean(1, keepdim=True)
    M = torch.einsum("bni,bnj->bij", q1, q0)
    return se3._horn_N(M).permute(1, 2, 0).contiguous()


def check_jacobi(A, what):
    """K3 against its plain version, bit for bit."""
    import torch
    from caelo_tpu_torch.geometry.se3 import (max_eigvec_sym4x4_lanes,
                                              max_eigvec_sym4x4_lanes_plain)

    out = max_eigvec_sym4x4_lanes(A)
    ref = max_eigvec_sym4x4_lanes_plain(A)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError(f"K3 {what}: {int((out != ref).sum())} of "
                             f"{out.numel()} entries differ from plain")


# K4's float32 operations a pair, every pair scored: three for the dot
# product and two for the score, an FMA counting two (8); the bytes a point
# read: x, y, z and |p|^2
K4_OPS_PER_PAIR = 8
K4_BYTES_IN = 16


def check_knn(pts, mask, k):
    """K4 against its plain version, bit for bit, one launch."""
    import torch
    from caelo_tpu_torch.frontend.baselines import (_knn_neighbors,
                                                    _knn_neighbors_plain)

    before = _knn_neighbors.launches
    out = _knn_neighbors(pts, mask, k)
    ref = _knn_neighbors_plain(pts, mask, k)
    torch.cuda.synchronize()
    if _knn_neighbors.launches != before + 1 or not torch.equal(out, ref):
        raise AssertionError(f"K4 k {k}: {int((out != ref).any(1).sum())} "
                             f"of {out.shape[0]} rows differ from plain")


def make_scans(cfg, thin=()):
    """Synthetic scans as bench.py makes them: the sensor translating
    through one scene, padded to cfg.max_points; scans in ``thin`` keep
    40 % of their points."""
    from caelo_tpu_torch.data.synthetic import (make_scene, range_filter,
                                                sample_scene_points)
    from caelo_tpu_torch.ops.masking import pad_points

    scene = make_scene(seed=0)
    world = sample_scene_points(scene, seed=0, n_points=cfg.max_points)
    rng = np.random.default_rng(0)
    scans = []
    for i in range(N_SCANS):
        t = np.array([1.2 * i, 0.05 * i, 0.0])
        local = range_filter((world - t).astype(np.float32), cfg.sensor)
        local = local + rng.normal(0, 0.005, local.shape).astype(np.float32)
        if i in thin:
            local = local[rng.uniform(size=len(local)) < 0.4]
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        scans.append(pad_points(np.concatenate([local, refl], 1),
                                cfg.max_points))
    return scans


def compare_frames(fa, fb, sal, kth_score, what):
    """Kernel-path vs plain-path features of one frame: the valid keypoint
    pixel sets may differ only by ties at the k-th score; descriptors of
    common keypoints agree to rtol/atol 1e-5."""
    import torch

    def by_pixel(f):
        m = f.mask.cpu().numpy()
        pix = f.key_pixels.cpu().numpy()[m]
        return {tuple(p): i for p, i in zip(pix.tolist(), np.nonzero(m)[0])}

    pa, pb = by_pixel(fa), by_pixel(fb)
    diff = set(pa) ^ set(pb)
    if not all(np.isclose(sal[p], kth_score, rtol=1e-5) for p in diff):
        raise AssertionError(f"{what}: keypoint sets differ beyond ties")
    common = sorted(set(pa) & set(pb))
    ia = torch.tensor([pa[p] for p in common])
    ib = torch.tensor([pb[p] for p in common])
    da, db = fa.descriptors[ia], fb.descriptors[ib]
    torch.testing.assert_close(da, db, rtol=1e-5, atol=1e-5)
    err = float((da - db).abs().max()) if len(common) else 0.0
    log(f"{what}: {len(common)} common keypoints, {len(diff)} tie swaps, "
        f"descriptor max_abs_err {err:.3e}")


def check_so3(R, what):
    """Rotations ``R (n, 3, 3)`` on SO(3) to 1e-4: returns the largest
    ``|R^T R - I|`` and ``|det R - 1|``."""
    orth = np.abs(np.einsum("nji,njk->nik", R, R) - np.eye(3)).max()
    det = np.abs(np.linalg.det(R) - 1.0).max()
    if orth > 1e-4 or det > 1e-4:
        raise AssertionError(f"{what}: rel R off SO(3) (orth {orth:.2e}, "
                             f"det {det:.2e})")
    return orth, det


def check_rel_rotations(poses, what):
    """Finite pose rows whose consecutive relative rotations lie on SO(3)."""
    if not np.isfinite(poses).all():
        raise AssertionError(f"{what}: non-finite poses")
    P = poses.reshape(-1, 3, 4)
    return check_so3(np.einsum("nji,njk->nik", P[:-1, :, :3], P[1:, :, :3]),
                     what)


def yaw(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def compare_refinement_features(fk, fp, rk, rp, what):
    """Kernel-path vs plain-path refinement features of one frame: where the
    two keypoint lists agree the extended clouds are identical; planar rows
    agree to 1e-4."""
    import torch

    same_kp = torch.equal(fk.key_pixels[fk.mask], fp.key_pixels[fp.mask])
    if same_kp and not (torch.equal(rk.ext_mask, rp.ext_mask)
                        and torch.equal(rk.ext_pts, rp.ext_pts)):
        raise AssertionError(f"{what}: extended clouds differ on equal "
                             "keypoints")
    if not torch.equal(rk.planar_mask, rp.planar_mask):
        raise AssertionError(f"{what}: planar masks differ")
    torch.testing.assert_close(rk.planar, rp.planar, atol=1e-4, rtol=0)
    err = float((rk.planar - rp.planar).abs().max())
    log(f"{what}: keypoint lists equal {same_kp}, extended points "
        f"{int(rk.ext_mask.sum())}, planar rows {int(rk.planar_mask.sum())},"
        f" planar max_abs_err {err:.3e}")


def count_calls(module, name, record):
    """Wrap ``module.name`` so every call appends ``(ms, result)`` to
    ``record``, synchronised; returns a function that restores it."""
    import torch

    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        record.append(((time.perf_counter() - t0) * 1e3, out))
        return out

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, fn)


def launch_counts():
    from caelo_tpu_torch.frontend.baselines import _knn_neighbors
    from caelo_tpu_torch.geometry.se3 import max_eigvec_sym4x4_lanes
    from caelo_tpu_torch.ops.plane_gather import patches_from_planes
    from caelo_tpu_torch.ops.saliency import keypoint_score

    return {"saliency_map": keypoint_score.launches,
            "gather_planes": patches_from_planes.launches,
            "max_eigvec_sym4x4": max_eigvec_sym4x4_lanes.launches,
            "knn_select": _knn_neighbors.launches}


def reset_launches():
    from caelo_tpu_torch.frontend.baselines import _knn_neighbors
    from caelo_tpu_torch.geometry.se3 import max_eigvec_sym4x4_lanes
    from caelo_tpu_torch.ops.plane_gather import patches_from_planes
    from caelo_tpu_torch.ops.saliency import keypoint_score

    keypoint_score.launches = 0
    patches_from_planes.launches = 0
    max_eigvec_sym4x4_lanes.launches = 0
    _knn_neighbors.launches = 0


def ran_k3(used, what):
    """Raises unless ``used`` counts a registration's K3 launches: four a
    batched RANSAC call, the hypotheses' solve, the refit and its two
    tightenings."""
    if used["max_eigvec_sym4x4"] < 4:
        raise AssertionError(f"{what}: K3 launched "
                             f"{used['max_eigvec_sym4x4']} times, want at "
                             "least the four of one RANSAC call")


def add_launches(total, more):
    for name in total:
        total[name] += more[name]


def whole_pipeline(cfg, respond_net, encoder, card):
    """Phase 7: run_full_pipeline with every stage on the CI circuit with a
    burst.  Every line with a time ends with ``card`` (the nvidia-smi
    name and power limit).  Returns the kernel launch counts of the run
    and the circuit, ``(scans, gt)``."""
    import torch
    import caelo_tpu_torch.backend.burst as burst_mod
    import caelo_tpu_torch.pipeline as pipe_mod
    from caelo_tpu_torch.data.hard_synthetic import generate_benchmark
    from caelo_tpu_torch.eval.metrics import (absolute_trajectory_error,
                                              loop_closure_pr,
                                              registration_summary,
                                              relative_pose_errors)
    from caelo_tpu_torch.utils.telemetry import StageTimer

    t0 = time.perf_counter()
    scans, gt = generate_benchmark(cfg=cfg, **CIRCUIT)
    n = len(scans)
    n_pts = [int(m.sum()) for _, m in scans]
    log(f"7 ray-cast {n} scans in {time.perf_counter() - t0:.1f} s on the "
        f"host: {min(n_pts)}-{max(n_pts)} points per scan, burst frames "
        f"{n_pts[30:42]}; {card}")

    loops, solves, maps, nn_calls = [], [], [], []
    restore = [count_calls(pipe_mod, "detect_and_close", loops),
               count_calls(pipe_mod, "optimize_host", solves),
               count_calls(burst_mod, "burst_map_icp", maps)]
    nn = burst_mod.nearest_neighbors
    burst_mod.nearest_neighbors = lambda *a: nn_calls.append(1) or nn(*a)
    timer = StageTimer(sync=True)     # synchronises the card at both ends
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = pipe_mod.run_full_pipeline(
            scans, respond_net, encoder, cfg=cfg, enable_loop_closure=True,
            min_loop_gap=60, timer=timer)
        torch.cuda.synchronize()
    finally:
        burst_mod.nearest_neighbors = nn
        for r in restore:
            r()
    t_all = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20

    summary = {k: round(v["total_s"] * 1e3, 1)
               for k, v in timer.summary().items()}
    log(f"7 run_full_pipeline: {t_all * 1e3:.1f} ms for {n} scans; stage ms "
        f"{summary}; peak device memory {peak:.1f} MiB; launches {launches}"
        f"; {card}")
    odo = res.odometry
    s = registration_summary(relative_pose_errors(gt, res.poses_raw,
                                                  np.eye(3), np.zeros(3)))
    log(f"7 front end: pair successes {int(odo.successes.sum())}/{n - 1}, "
        f"mean inliers {float(odo.n_inliers.mean()):.1f}; against the ground "
        f"truth: RRE {s['rre_deg']:.4f} deg, RTE {s['rte_m']:.4f} m, success "
        f"{s['success_rate']:.4f}")
    for name in ("poses_raw", "poses_dejumped", "poses_refined",
                 "poses_final"):
        P = getattr(res, name)
        orth, det = check_rel_rotations(P, name)
        check_so3(P.reshape(-1, 3, 4)[:, :, :3], f"{name} absolute")
        ate = absolute_trajectory_error(gt, P)
        log(f"7 {name}: ATE rmse {ate['ate_rmse']:.4f} m, max "
            f"{ate['ate_max']:.4f} m; rel |R^T R - I| {orth:.2e}")
    st = res.refine_stats
    log(f"7 de-jumped {res.dejumped_frames}; refined {len(st.refined)}, "
        f"failed {len(st.failed)}, rejected {len(st.rejected)}")

    bs = res.burst_stats
    trips = len(nn_calls)
    log(f"7 burst rescue: spans {bs.spans}, accepted {bs.accepted}, "
        f"rejected {bs.rejected}, gains {bs.gains}, closures {bs.closures}; "
        f"burst_map_icp {[round(ms, 1) for ms, _ in maps]} ms, "
        f"{trips} map nearest-neighbour passes; {card}")
    if not (bs.spans and bs.gains and maps):
        raise AssertionError("no burst span was solved")
    if sorted(bs.accepted + bs.rejected) != sorted(bs.spans):
        raise AssertionError("a burst span was neither accepted nor rejected")

    (ms_lc, lc), = loops
    pr = loop_closure_pr(res.loop_edge_i, res.loop_edge_j,
                         gt.reshape(-1, 3, 4)[:, :, 3], min_gap=40)
    log(f"7 loop closure: {lc.candidates_checked} candidates checked, "
        f"{lc.n_accepted} accepted, {res.n_loop_closures} with propagation, "
        f"rejects {lc.rejects}; edges "
        f"{list(zip(res.loop_edge_i.tolist(), res.loop_edge_j.tolist()))}; "
        f"precision {pr['precision']}, recall {pr['recall']} "
        f"({pr['n_revisit_events']} revisit events); graph solves "
        f"{[round(ms, 1) for ms, _ in solves]} ms; {card}")
    if lc.candidates_checked < 1:
        raise AssertionError("loop closure checked no candidate")
    if res.n_loop_closures > 0 and not solves:
        raise AssertionError("a closure was accepted but no graph solved")
    if launches["saliency_map"] < n or launches["gather_planes"] < 3 * n:
        raise AssertionError("run_full_pipeline did not run K1 and K2 per "
                             "frame")
    ran_k3(launches, "7 run_full_pipeline")
    return launches, (scans, gt)


def run_cli(argv, card):
    """``cli.main(argv)`` in this process, synchronised; echoes its output
    and errors, returns its standard output and its ms, and fails on a
    nonzero exit."""
    import torch
    from caelo_tpu_torch import cli

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, out, _ = echo(cli.main, argv)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    log(f"cli {argv[0]}: exit {rc}, {ms:.1f} ms; {card}")
    if rc != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited {rc}")
    return out, ms


def training(cfg, dev, card, tmp):
    """Phase 8: both trainers through the command line at full width, the
    checkpoints, the loss decrease on one fixed batch, and the trained
    submodels in one front-end window.  Returns the launch counts of the
    trainers' data path and the window."""
    import torch
    import caelo_tpu_torch.training.drivers as drivers
    from caelo_tpu_torch.frontend.odometry import run_odometry_windowed
    from caelo_tpu_torch.models import weights_io
    from caelo_tpu_torch.models.patch_encoder import VoxelPatchAE
    from caelo_tpu_torch.models.respond_net import SphericalRingAE
    from caelo_tpu_torch.training.train import (adam, create_train_state,
                                                make_train_step, patch_loss,
                                                respond_loss)
    from caelo_tpu_torch.utils.telemetry import MetricsLog

    launches = dict.fromkeys(launch_counts(), 0)
    saved, scans_seen, losses = [], [], []
    save = weights_io.save_checkpoint
    scan_patches = drivers.scan_patches
    make_step = drivers.make_train_step
    weights_io.save_checkpoint = lambda path, sd, step=0: saved.append(
        {k: v.detach().cpu().clone() for k, v in sd.items()}) or save(
            path, sd, step)
    drivers.scan_patches = lambda *a: scans_seen.append(1) or scan_patches(*a)

    def recording_step(loss_fn):
        step = make_step(loss_fn)

        def recorded(state, batch):
            state, loss = step(state, batch)
            losses.append(float(loss))
            return state, loss
        return recorded

    drivers.make_train_step = recording_step
    outs = {}
    try:
        for tag in ("respond", "patch"):
            out = os.path.join(tmp, f"train_{tag}")
            reset_launches()
            del scans_seen[:], losses[:]
            run_cli([f"train-{tag}", "--data", tmp, "--synthetic",
                     "--steps", str(TRAIN_STEPS[tag]), "--out", out], card)
            used = launch_counts()
            add_launches(launches, used)
            rec = [r for r in MetricsLog(os.path.join(
                out, "train_metrics.jsonl")).read()
                if r["event"] == "train"][-1]
            ck = weights_io.load_checkpoint(out)
            if not (saved and ck.keys() == saved[-1].keys() and all(
                    torch.equal(ck[k], saved[-1][k]) for k in ck)):
                raise AssertionError(f"{tag}: checkpoint does not reload "
                                     "bit-equal")
            if (rec["steps"] != TRAIN_STEPS[tag]
                    or len(losses) != TRAIN_STEPS[tag]
                    or not np.isfinite(losses).all()
                    or rec["final_loss"] != losses[-1]):
                raise AssertionError(f"{tag}: train record {rec}, losses "
                                     f"{losses}")
            log(f"8 train-{tag}: {rec['steps']} steps at batch "
                f"{16 if tag == 'respond' else 256}, losses "
                f"{[round(x, 5) for x in losses]}; mean ms per step "
                f"{rec['step_ms']} "
                f"(device, synchronised), per batch of data "
                f"{rec['data_ms']} (host generation and device "
                f"preprocessing); checkpoint {len(ck)} tensors reloaded "
                f"bit-equal; {card}")
            if tag == "patch":
                n = len(scans_seen)
                log(f"8 patch data path: {n} scans, launches {used}")
                if (n < 1 or used["saliency_map"] < n
                        or used["gather_planes"] < 3 * n):
                    raise AssertionError("the patch trainer did not run K1 "
                                         "and K2 on every scan")
            outs[tag] = out
    finally:
        weights_io.save_checkpoint = save
        drivers.scan_patches = scan_patches
        drivers.make_train_step = make_step

    # 20 steps at lr 3e-3 on one fixed full-width batch of each
    sph, vox = weights_io.random_ae_params(0)
    t0 = time.perf_counter()
    batch_r = next(drivers.respond_batches(
        drivers.synthetic_scan_stream(cfg, seed=1), cfg, 16, device=dev))
    reset_launches()
    batch_p = next(drivers.patch_batches(
        drivers.synthetic_scan_stream(cfg, seed=1), cfg, 256, device=dev))
    add_launches(launches, launch_counts())
    torch.cuda.synchronize()
    log(f"8 fixed batches {tuple(batch_r.shape)} and {tuple(batch_p.shape)} "
        f"made in {(time.perf_counter() - t0) * 1e3:.1f} ms; {card}")
    for tag, model, params, conv, loss_fn, batch in (
            ("respond", SphericalRingAE(), sph,
             weights_io.spherical_ae_params_to_torch, respond_loss, batch_r),
            ("patch", VoxelPatchAE(), vox, weights_io.voxel_ae_params_to_torch,
             patch_loss, batch_p)):
        model.load_state_dict(conv(params))
        model.to(dev)
        state = create_train_state(model, adam(model.parameters(), FIXED_LR))
        step = make_train_step(loss_fn)
        losses, step_ms = [], []
        for _ in range(FIXED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        log(f"8 {tag} AE, {FIXED_STEPS} steps at lr {FIXED_LR} on one batch "
            f"{tuple(batch.shape)}: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
            f"(every 5th {[round(x, 5) for x in losses[::5]]}); ms per step "
            f"median {float(np.median(step_ms)):.3f}, first "
            f"{step_ms[0]:.3f}; {card}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{tag}: a non-finite loss")
        if not losses[-1] < LOSS_MARGIN[tag] * losses[0]:
            raise AssertionError(f"{tag}: the loss fell by less than "
                                 f"{1 - LOSS_MARGIN[tag]:.0%}")

    # the trained submodels drive one front-end window
    cfg_t = dataclasses.replace(cfg, encoder_activation="relu",
                                encoder_code_activation="linear")
    net, enc = weights_io.build_models_from_state_dicts(
        weights_io.respond_params_from_ae(
            weights_io.load_checkpoint(outs["respond"])),
        weights_io.encoder_params_from_ae(
            weights_io.load_checkpoint(outs["patch"])), dev, cfg_t)
    scans = make_scans(cfg)[:WINDOW]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, feats = run_odometry_windowed(scans, net, enc, cfg=cfg_t,
                                       window=WINDOW, keep_features=True)
    torch.cuda.synchronize()
    used = launch_counts()
    add_launches(launches, used)
    if not (np.isfinite(res.poses).all()
            and bool(torch.isfinite(feats.descriptors).all())
            and bool(feats.mask.any())):
        raise AssertionError("the trained submodels gave non-finite output")
    log(f"8 trained submodels, one {WINDOW}-frame window: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, pair successes "
        f"{int(res.successes.sum())}/{WINDOW - 1}, keypoints per frame "
        f"{feats.mask.sum(1).tolist()}, launches {used}; {card}")
    if used["saliency_map"] < WINDOW or used["gather_planes"] < 3 * WINDOW:
        raise AssertionError("the trained window did not run K1 and K2 per "
                             "frame")
    ran_k3(used, "8 the trained window")
    return launches


def write_kitti_tree(root, scans, step):
    """The scans as a KITTI sequence 00: unpadded ``.bin`` files, a
    ``calib.txt`` whose Tr is the KITTI-style axis permutation and an
    offset, and the ground-truth camera poses (the lidar moves by ``step``
    per frame, no rotation)."""
    velo = os.path.join(root, "sequences", "00", "velodyne")
    os.makedirs(velo)
    os.makedirs(os.path.join(root, "poses"))
    for i, (pts, mask) in enumerate(scans):
        pts[mask].astype(np.float32).tofile(os.path.join(velo, f"{i:06d}.bin"))
    R_tr = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    t_tr = np.array([0.05, -0.1, -0.3])
    calib = os.path.join(root, "sequences", "00", "calib.txt")
    with open(calib, "w") as f:
        for k in ("P0", "P1", "P2", "P3"):
            f.write(f"{k}: " + " ".join(["0"] * 12) + "\n")
        Tr = np.hstack([R_tr, t_tr[:, None]]).reshape(-1)
        f.write("Tr: " + " ".join(f"{v:.9f}" for v in Tr) + "\n")
    # camera poses T_cam = Tr T_lidar Tr^-1, T_lidar = (I, i * step)
    rows = [np.hstack([np.eye(3), (R_tr @ (i * step))[:, None]]).reshape(-1)
            for i in range(len(scans))]
    gt = os.path.join(root, "poses", "00.txt")
    np.savetxt(gt, np.asarray(rows))
    return calib, gt


def check_trajectory(path, n, what):
    P = np.loadtxt(path)
    if P.shape != (n, 12):
        raise AssertionError(f"{what}: {path} has shape {P.shape}")
    orth, _ = check_rel_rotations(P, what)
    check_so3(P.reshape(-1, 3, 4)[:, :, :3], f"{what} absolute")
    return orth


def cli_on_kitti_tree(cfg, card, tmp):
    """Phase 9: the command line on a KITTI tree of phase 5's scans.
    Returns the launch counts of its commands."""
    from caelo_tpu_torch.data import native_loader
    from caelo_tpu_torch.models import weights_io

    scans = make_scans(cfg)
    root = os.path.join(tmp, "kitti")
    calib, gt = write_kitti_tree(root, scans, np.array([1.2, 0.05, 0.0]))
    lib = (native_loader._library_path() if native_loader.native_available()
           else "not built, the numpy fallback reads the scans")
    log(f"9 KITTI tree: {len(scans)} scans in {root}; native scan loader: "
        f"{lib}")
    rp, ep = weights_io.random_flax_params(0)
    loaders = (weights_io.load_respond_layer_params,
               weights_io.load_patch_encoder_params)
    weights_io.load_respond_layer_params = lambda path=None: rp
    weights_io.load_patch_encoder_params = lambda path=None: ep
    log("9 the .h5 loaders answer random_flax_params(0) in this process "
        "(the shipped weights are not in the repository)")
    n = str(N_SCANS)
    runs, art = os.path.join(tmp, "runs"), os.path.join(tmp, "artifacts")
    launches = dict.fromkeys(launch_counts(), 0)
    stage_ms, outs = {}, {}
    try:
        for argv in (["odometry", "--data", root, "--out", runs, "--frames", n],
                     ["full", "--data", root, "--out",
                      os.path.join(tmp, "full"), "--frames", n, "--no-loops"],
                     ["preprocess", "--data", root, "--out", runs,
                      "--artifacts", art, "--frames", n]):
            reset_launches()
            outs[argv[0]], stage_ms[argv[0]] = run_cli(argv, card)
            used = launch_counts()
            add_launches(launches, used)
            log(f"9 {argv[0]}: launches {used}")
            if (used["saliency_map"] < N_SCANS
                    or used["gather_planes"] < 3 * N_SCANS):
                raise AssertionError(f"cli {argv[0]} did not run K1 and K2 "
                                     "on every frame")
            ran_k3(used, f"9 cli {argv[0]}")
        p1 = os.path.join(runs, "poses_", "00.txt")
        reset_launches()
        _, stage_ms["refine"] = run_cli(
            ["refine", "--poses", p1, "--artifacts", art], card)
        _, stage_ms["loop"] = run_cli(
            ["loop", "--poses", os.path.join(runs, "poses___", "00.txt"),
             "--artifacts", art, "--min-gap", "10"], card)
        p4 = os.path.join(runs, "poses____", "00.txt")
        out, stage_ms["evaluate"] = run_cli(
            ["evaluate", "--gt", gt, "--est", p4, "--calib", calib], card)
        add_launches(launches, launch_counts())
    finally:
        (weights_io.load_respond_layer_params,
         weights_io.load_patch_encoder_params) = loaders
    ev = json.loads(out)
    for k in ("rre_deg", "rte_m", "success_rate", "ate_rmse"):
        if k not in ev:
            raise AssertionError(f"evaluate printed no {k}")
    full = json.loads(outs["full"].strip().splitlines()[-1])
    if full["frames"] != N_SCANS:
        raise AssertionError(f"cli full: {full}")
    for d in (runs, os.path.join(tmp, "full")):
        for name in ("poses_", "poses__", "poses___", "poses____"):
            orth = check_trajectory(os.path.join(d, name, "00.txt"), N_SCANS,
                                    f"{os.path.basename(d)}/{name}")
            log(f"9 {os.path.basename(d)}/{name}: ({N_SCANS}, 12), finite, "
                f"rel |R^T R - I| {orth:.2e}")
    log(f"9 evaluate of poses____ against the ground truth: RRE "
        f"{ev['rre_deg']:.4f} deg, RTE {ev['rte_m']:.4f} m, success "
        f"{ev['success_rate']:.4f}, ATE rmse {ev['ate_rmse']:.4f} m")
    log(f"9 command ms {({k: round(v, 1) for k, v in stage_ms.items()})}; "
        f"{card}")
    return launches


def detectors_card_vs_cpu(cfg, dev, card, scans):
    """Phase 10a: each baseline detector on frame 0 at full width on the
    card against the same function on the CPU copy of its inputs.  The
    neighbour lists must be equal but for ties at the k-th place
    (``neighbor_ties``); given the same lists (the CPU's), the keypoint
    sets must be equal but for flips at a decision threshold
    (``explain_flips``).  With its own lists the card's keypoints are
    logged against the CPU's, unchecked: a list that differs at a tie
    changes that point's covariance, not by rounding.  Logs the card's
    time split into KNN, eigen (or scale space) and the rest (NMS or
    extremum test, and the top-k) and its peak memory."""
    import torch
    import caelo_tpu_torch.frontend.baselines as bl
    from caelo_tpu_torch.eval.keypoint_flips import (explain_flips,
                                                     neighbor_ties)

    n_kp = cfg.keypoint.n_keypoints
    pts_c = torch.from_numpy(np.ascontiguousarray(scans[0][0][:, :3]))
    msk_c = torch.from_numpy(scans[0][1])
    pts_g, msk_g = pts_c.to(dev), msk_c.to(dev)
    t0 = time.perf_counter()
    idx_c = bl._knn_neighbors(pts_c, msk_c, 64)
    cpu_knn_s = time.perf_counter() - t0
    idx_g = bl._knn_neighbors(pts_g, msk_g, 64).cpu()
    n_tied = neighbor_ties(pts_c, msk_c, idx_c, idx_g)
    log(f"10a frame 0: {int(msk_c.sum())} valid of {len(pts_c)} points; "
        f"neighbour lists (k 64) on the card against the CPU: {n_tied} rows "
        f"differ, each at a k-th-place tie; CPU KNN {cpu_knn_s:.1f} s")
    knn = bl._knn_neighbors

    @contextlib.contextmanager
    def given_lists():
        bl._knn_neighbors = lambda p, m, k, chunk=512: idx_c.to(p.device)
        try:
            yield
        finally:
            bl._knn_neighbors = knn

    keys = lambda r: {tuple(p) for p in r.key_pts[r.key_mask].tolist()}
    stages = {"_knn_neighbors": "knn", "_eigh": "eigen",
              "_sift_scale_space": "scale space"}
    for name, fn in (("iss", bl.iss_keypoints),
                     ("harris", bl.harris3d_keypoints),
                     ("sift", bl.sift3d_keypoints)):
        fn(pts_g, msk_g, n_keypoints=n_kp)                       # warm
        torch.cuda.reset_peak_memory_stats()
        rec = {k: [] for k in stages}
        restore = [count_calls(bl, k, rec[k]) for k in stages]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        try:
            res_g = fn(pts_g, msk_g, n_keypoints=n_kp)
        finally:
            end.record()
            torch.cuda.synchronize()
            for r in restore:
                r()
        total = start.elapsed_time(end)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        split = {stages[k]: round(sum(ms for ms, _ in v), 3)
                 for k, v in rec.items() if v}
        split["nms and top-k"] = round(total - sum(split.values()), 3)
        with given_lists():
            t0 = time.perf_counter()
            res_c = fn(pts_c, msk_c, n_keypoints=n_kp)
            cpu_s = time.perf_counter() - t0
            res_gc = fn(pts_g, msk_g, n_keypoints=n_kp)
        got = explain_flips(name, pts_c, msk_c, res_c.key_pts, res_c.key_mask,
                            res_gc.key_pts.cpu(), res_gc.key_mask.cpu(), n_kp,
                            idx=idx_c)
        own = len(keys(res_c) ^ keys(type(res_g)(*(x.cpu() for x in res_g))))
        log(f"10a {name}: card {total:.3f} ms (split {split}; synchronised "
            f"per stage), peak device memory {peak:.1f} MiB; CPU after the "
            f"lists {cpu_s:.1f} s; given the CPU's lists: keypoints CPU "
            f"{got['a']}, card {got['b']}, flips {got['flips']} "
            f"({got['at_threshold']} at a threshold, {got['at_cut']} next "
            f"to the cut); with the card's own lists {int(res_g.key_mask.sum())}"
            f" keypoints, {own} differ from the CPU's; {card}")
        if got["unexplained"] or abs(got["a"] - got["b"]) > got["flips"]:
            raise AssertionError(f"{name}: card and CPU keypoints differ "
                                 f"beyond threshold flips: {got}")


def write_external_trees(root, feats):
    """Phase 5's features as the reference's external trees: 3DFeatNet's
    35-column files (xyz and the first 32 descriptor dimensions) and USIP's
    keypoints-only files stored rotated by R90^T
    (``examples/eval_matrix.py:68-91``)."""
    from caelo_tpu_torch.data.external import R90

    for fmt in ("3dfeatnet", "usip"):
        os.makedirs(os.path.join(root, fmt, "00"))
    for i in range(feats.mask.shape[0]):
        m = feats.mask[i].cpu().numpy()
        kp = feats.key_pts[i].cpu().numpy()[m]
        desc = feats.descriptors[i].cpu().numpy()[m][:, :32]
        np.concatenate([kp, desc], 1).astype(np.float32).tofile(
            os.path.join(root, "3dfeatnet", "00", f"{i:06d}.bin"))
        (R90.T @ kp.T).T.astype(np.float32).tofile(
            os.path.join(root, "usip", "00", f"{i:06d}.bin"))


def keypoint_rows(cfg, card, tmp, feats):
    """Phase 10b: ``odometry --keypoints`` for every source but cae-lo on
    phase 9's KITTI tree, in process, the ``.h5`` loaders answering
    ``random_flax_params(0)``.  Checks every trajectory finite and on
    SO(3), keypoints on every detector row, K2 three times per frame where
    the CAE-LO encoder describes the keypoints (none in the 3DFeatNet row,
    whose file holds the descriptors); logs ms per frame by CUDA events,
    pair success, RRE, RTE and ATE against the ground truth and peak
    memory.  Returns the rows' launch counts."""
    import torch
    import caelo_tpu_torch.frontend.ablation as abl
    from caelo_tpu_torch.eval.metrics import (absolute_trajectory_error,
                                              registration_summary,
                                              relative_pose_errors)
    from caelo_tpu_torch.geometry.kitti_pose import load_calib_tr
    from caelo_tpu_torch.models import weights_io

    root = os.path.join(tmp, "kitti")
    calib = os.path.join(root, "sequences", "00", "calib.txt")
    gt = np.loadtxt(os.path.join(root, "poses", "00.txt"))
    R_tr, t_tr = load_calib_tr(calib)
    ext = os.path.join(tmp, "external")
    write_external_trees(ext, feats)
    rp, ep = weights_io.random_flax_params(0)
    loaders = (weights_io.load_respond_layer_params,
               weights_io.load_patch_encoder_params)
    weights_io.load_respond_layer_params = lambda path=None: rp
    weights_io.load_patch_encoder_params = lambda path=None: ep
    launches = dict.fromkeys(launch_counts(), 0)
    n = N_SCANS
    try:
        for row in ("iss", "harris", "sift", "random", "ext-3dfeatnet",
                    "ext-usip"):
            out = os.path.join(tmp, "rows", row)
            argv = ["odometry", "--data", root, "--out", out, "--frames",
                    str(n)]
            if row.startswith("ext-"):
                argv += ["--keypoints", "external", "--external-dir",
                         os.path.join(ext, row[4:]), "--external-fmt",
                         row[4:]]
            else:
                argv += ["--keypoints", row]
            described = []
            restore = count_calls(abl, "features_from_keypoints", described)
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            try:
                run_cli(argv, card)
            finally:
                end.record()
                torch.cuda.synchronize()
                restore()
            ms = start.elapsed_time(end)
            used = launch_counts()
            add_launches(launches, used)
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            n_kp = [int(f.mask.sum()) for _, f in described]
            P = np.loadtxt(os.path.join(out, "poses_", "00.txt"))
            orth = check_trajectory(os.path.join(out, "poses_", "00.txt"), n,
                                    f"row {row}")
            s = registration_summary(relative_pose_errors(gt, P, R_tr, t_tr))
            ate = absolute_trajectory_error(gt, P)
            succ = np.load(os.path.join(out, "odom_00.npz"))["successes"]
            log(f"10b row {row}: {ms / n:.1f} ms per frame ({ms:.1f} ms for "
                f"{n} frames, CUDA events), pair success "
                f"{int(succ.sum())}/{n - 1}; against the ground truth: RRE "
                f"{s['rre_deg']:.4f} deg, RTE {s['rte_m']:.4f} m, success "
                f"{s['success_rate']:.4f}, ATE rmse {ate['ate_rmse']:.4f} m;"
                f" keypoints per frame {n_kp or 'from the file'}; launches "
                f"{used}; peak device memory {peak:.1f} MiB; rel |R^T R - I| "
                f"{orth:.2e}; {card}")
            want_k2 = 0 if row == "ext-3dfeatnet" else 3 * n
            want_k4 = n if row in ("iss", "harris", "sift") else 0
            if (used["saliency_map"], used["gather_planes"],
                    used["knn_select"]) != (0, want_k2, want_k4):
                raise AssertionError(f"row {row}: launches {used}, want K2 "
                                     f"{want_k2}, K4 {want_k4} and no K1")
            ran_k3(used, f"10b row {row}")
            if row in ("iss", "harris", "sift") and not sum(n_kp):
                raise AssertionError(f"row {row}: no keypoints")
    finally:
        (weights_io.load_respond_layer_params,
         weights_io.load_patch_encoder_params) = loaders
    return launches


def voxel_views(cfg, card, tmp, scans, feats):
    """Phase 10c on frame 0: ``decode_patch`` of the first keypoint's patch
    at each scale puts every occupied cell within half a voxel (per axis)
    of a scan point; ``occupancy_stats``' supercells within
    ``cfg.voxel.bitgrid_slots`` and its voxels, capped at ``max_voxels``,
    those the pyramid keeps; ``export_voxels_ply`` writes one vertex per
    kept voxel."""
    import torch
    from caelo_tpu_torch.eval.viz import export_voxels_ply
    from caelo_tpu_torch.voxel.grid import (decode_patch, extract_patches,
                                            occupancy_stats, voxelize)

    vc = cfg.voxel
    dev = feats.key_pts.device
    pts = torch.from_numpy(scans[0][0]).to(dev)
    msk = torch.from_numpy(scans[0][1]).to(dev)
    valid = pts[msk, :3]
    pyr = voxelize(pts[:, :3], msk, vc)
    kp0, km0 = feats.key_pts[0], feats.mask[0]
    patches = extract_patches(kp0, km0, pyr, vc)
    stats = occupancy_stats(pyr, vc)
    for s, vs in enumerate(vc.voxel_sizes):
        # the first keypoint whose patch at this scale is occupied
        full = torch.nonzero(km0 & patches[s].flatten(1).any(1))[:, 0]
        if not len(full):
            raise AssertionError(f"scale {s}: every patch of frame 0 is empty")
        k = int(full[0])
        centers, occ = decode_patch(patches[s][k], kp0[k], s, vc)
        c = centers[occ]
        # the scan point nearest each cell centre, by the largest axis gap
        gap = torch.cat([(c[i:i + 256, None] - valid[None]).abs().amax(-1)
                         .min(1).values for i in range(0, len(c), 256)])
        st = stats[f"scale{s}"]
        ply = export_voxels_ply(os.path.join(tmp, f"vox{s}.ply"), pyr, s, vc)
        with open(ply) as f:
            head = [next(f) for _ in range(7)]
            n_lines = sum(1 for _ in f)
        n_vox = int(pyr.masks[s].sum())
        log(f"10c scale {s}: decode_patch of frame 0's keypoint {k}, "
            f"{int(occ.sum())} occupied cells, farthest from a scan point "
            f"{float(gap.max()):.4f} m by the largest axis (half a voxel "
            f"{vs / 2:.3f} m); occupancy {st} against {vc.bitgrid_slots[s]} "
            f"slots and {vc.max_voxels[s]} voxels; PLY {n_lines} vertices for "
            f"{n_vox} voxels")
        if float(gap.max()) > vs / 2 + 1e-4:
            raise AssertionError(f"decode_patch scale {s}: a cell is not "
                                 "within half a voxel of a scan point")
        # n_voxels counts the unique voxels before the pyramid keeps
        # max_voxels of them
        if (st["n_supercells"] > vc.bitgrid_slots[s]
                or min(st["n_voxels"], vc.max_voxels[s]) != n_vox):
            raise AssertionError(f"occupancy_stats scale {s}: {st}")
        if (f"element vertex {n_vox}\n" not in head[:3] or n_lines != n_vox):
            raise AssertionError(f"export_voxels_ply scale {s}: {head[:3]}, "
                                 f"{n_lines} vertex lines")


def shared_keypoints(fa, fb):
    """Pixels of the valid keypoints of both features, and each one's row
    in ``fa`` and in ``fb``; the share of ``fb``'s keypoints they are."""
    def rows(f):
        m = f.mask.cpu().numpy()
        return {tuple(p): i for i, p in
                enumerate(f.key_pixels.cpu().numpy().tolist()) if m[i]}

    ra, rb = rows(fa), rows(fb)
    common = sorted(set(ra) & set(rb))
    return ([ra[p] for p in common], [rb[p] for p in common],
            len(common) / max(len(rb), 1))


def ring_off_edge(pts, differ, sensor):
    """Of the float32 points ``pts`` (CPU numpy), those flagged ``differ``
    whose float64 column and row coordinates both lie farther than
    ``RING_EDGE`` from a bin edge."""
    x, y, z = (pts[differ, i].astype(np.float64) for i in range(3))
    r = np.sqrt(x * x + y * y + z * z)
    colf = (np.pi - np.arctan2(y, x)) / sensor.azimuth_res
    rowf = (np.arcsin(np.clip(z / np.maximum(r, 1e-9), -1, 1))
            / sensor.vertical_res + sensor.vertical_pixel_offset)
    near = lambda f: np.abs(f - np.round(f)) < RING_EDGE * np.maximum(
        1, np.abs(f))
    return int((~(near(colf) | near(rowf))).sum())


def conv_dtypes(modules, fn):
    """``fn()`` with a forward hook on every convolution of ``modules``:
    returns ``(fn's result, {(conv, input dtype, output dtype)})``."""
    import torch

    seen, hooks = set(), []
    for tag, module in modules:
        for name, m in module.named_modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
                hooks.append(m.register_forward_hook(
                    lambda mod, inp, out, n=f"{tag}.{name}": seen.add(
                        (n, str(inp[0].dtype), str(out.dtype)))))
    try:
        return fn(), seen
    finally:
        for h in hooks:
            h.remove()


def one_device_remainder(cfg, dev, card, scans, params, nets, res_a, feats_a,
                         window_batch, tmp):
    """Phase 11: the one-device configurations beside the default.  (a) the
    bfloat16 front end: a window with every convolution in bfloat16 (forward
    hooks), K1 and K2 per frame, frame 0 against the port's bfloat16 on the
    CPU and against run A's float32 (tests/test_bf16.py's gates), the warm
    window and the encoder in both dtypes; (b) the window route
    (``bitgrid_slots=(0, 0, 0)``) and the KNN route on frame 0 against the
    CPU (the window route bit-exact; the KNN lists equal but for ties at
    the k-th place, the patches then those of the card's lists) and a
    window of each; (c) ``presorted_pyramid=False`` on a shuffled frame-0
    pyramid with K2, equal to the presorted patches; (d)
    ``run_odometry_windowed`` staging an ``NpyScanReader`` cache of the
    scans in its producer thread, bit-identical to staging each window
    when due.  Returns the launch counts of the windows and queries it
    drives."""
    import torch
    from caelo_tpu_torch.data.scancache import NpyScanReader
    from caelo_tpu_torch.eval.keypoint_flips import neighbor_ties
    from caelo_tpu_torch.frontend.odometry import (run_odometry_windowed,
                                                   window_starts)
    from caelo_tpu_torch.frontend.registration import (
        extract_frame_features, run_in)
    from caelo_tpu_torch.models.weights_io import build_models
    from caelo_tpu_torch.parallel.pipeline import make_sequence_processor
    from caelo_tpu_torch.projection.spherical import ring_bins
    from caelo_tpu_torch.voxel import grid

    net, enc = nets
    vc = cfg.voxel
    launches = dict.fromkeys(launch_counts(), 0)
    n_frames = sum(min(s + WINDOW, N_SCANS) - s
                   for s in window_starts(N_SCANS, WINDOW))

    def window(run_cfg, what, want_k2=True, seq=None, **kw):
        """One run of ``run_odometry_windowed`` over ``seq`` (default the
        scans), counted and timed."""
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_odometry_windowed(scans if seq is None else seq, net, enc,
                                    cfg=run_cfg, window=WINDOW, seed=0,
                                    keep_features=True, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        used = launch_counts()
        add_launches(launches, used)
        res, feats = out
        if not (np.isfinite(res.poses).all()
                and bool(torch.isfinite(feats.descriptors).all())):
            raise AssertionError(f"11 {what}: non-finite output")
        want = {"saliency_map": n_frames,
                "gather_planes": 3 * n_frames if want_k2 else 0}
        if {k: used[k] for k in want} != want:
            raise AssertionError(f"11 {what}: launches {used}, want {want}")
        ran_k3(used, f"11 {what}")
        log(f"11 {what}: {ms:.1f} ms for {N_SCANS} scans, pair successes "
            f"{int(res.successes.sum())}/{N_SCANS - 1}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB, launches "
            f"{used}; {card}")
        return res, feats, ms

    # ---- (a) the bfloat16 front end
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    (res16, feats16, _), convs = conv_dtypes(
        (("respond", net), ("encoder", enc)),
        lambda: window(cfg16, "bfloat16 window"))
    log(f"11a convolutions seen in the bfloat16 window: {sorted(convs)}")
    if len(convs) != 5 or any(i != "torch.bfloat16" or o != "torch.bfloat16"
                              for _, i, o in convs):
        raise AssertionError(f"11a the bfloat16 window ran convolutions "
                             f"{sorted(convs)}")
    if any(p.dtype != torch.float32 for m in nets for p in m.parameters()):
        raise AssertionError("11a the bfloat16 run cast the caller's modules")
    # frame 0 against the port's bfloat16 on the CPU
    cpu_nets = build_models(*params, "cpu", cfg)
    f_cpu = extract_frame_features(*cpu_nets,
                                   torch.from_numpy(scans[0][0]),
                                   torch.from_numpy(scans[0][1]), cfg16)
    f_dev = type(f_cpu)(*(x[0] for x in feats16))
    ia, ib, share = shared_keypoints(f_dev, f_cpu)
    d = (f_dev.descriptors[ia].cpu() - f_cpu.descriptors[ib]).abs()
    log(f"11a frame 0 bfloat16, card against CPU: {share:.4f} of the CPU's "
        f"keypoints shared, descriptor max_abs_err {float(d.max()):.3e} "
        f"over {len(ia)} (tolerance: share >= {BF16_SHARED}, error <= "
        f"{BF16_DESC_TOL})")
    if share < BF16_SHARED or float(d.max()) > BF16_DESC_TOL:
        raise AssertionError("11a bfloat16 frame 0 differs between the card "
                             "and the CPU beyond the tolerance")
    # against run A's float32: tests/test_bf16.py's gates and the poses
    f32 = type(f_cpu)(*(x[0] for x in feats_a))
    ia, ib, share = shared_keypoints(f_dev, f32)
    d = (f_dev.descriptors[ia[:64]] - f32.descriptors[ib[:64]]).abs()
    rel_t = np.linalg.norm(res16.rel_ts - res_a.rel_ts, axis=1)
    gt_t = np.array([1.2, 0.05, 0.0])
    ok16 = res16.successes
    t_err = np.linalg.norm(res16.rel_ts - gt_t, axis=1)[ok16]
    r_err = np.degrees(np.arccos(np.clip(
        (np.trace(res16.rel_Rs, axis1=1, axis2=2) - 1) / 2, -1, 1)))[ok16]
    log(f"11a bfloat16 against run A's float32: frame 0 keypoint overlap "
        f"{share:.4f} (gate > 0.7), descriptor max_abs_err "
        f"{float(d.max()):.3e} on 64 shared (gate < 0.1); pair successes "
        f"{int(ok16.sum())} against {int(res_a.successes.sum())}, the "
        f"successes within {t_err.max():.4f} m / {r_err.max():.4f} deg of "
        f"the true motion (gate 0.5 m / 1 deg); rel translations differ by "
        f"up to {rel_t.max():.4f} m, poses by up to "
        f"{np.abs(res16.poses - res_a.poses).max():.4f}")
    if (share <= 0.7 or float(d.max()) >= 0.1 or not ok16.any()
            or ok16.sum() < res_a.successes.sum() - 1
            or t_err.max() >= 0.5 or r_err.max() >= 1.0):
        raise AssertionError("11a bfloat16 fails test_bf16.py's gates")
    # warm window and encoder, float32 against bfloat16, in turns
    pts_w, msk_w = window_batch
    gen = torch.Generator(device=dev).manual_seed(1)
    procs = {"float32": make_sequence_processor(cfg),
             "bfloat16": make_sequence_processor(cfg16)}
    win = {k: [] for k in procs}
    for k in ("float32", "bfloat16", "bfloat16", "float32"):
        win[k] += timed_ms(lambda: procs[k](net, enc, pts_w, msk_w, gen),
                           WINDOW_REPS)
    with torch.no_grad():
        pyr = grid.voxelize(torch.from_numpy(scans[0][0][:, :3]).to(dev),
                            torch.from_numpy(scans[0][1]).to(dev), vc)
        stacked = torch.cat(grid.extract_patches(f32.key_pts, f32.mask, pyr,
                                                 vc))
        chunks = stacked.split(cfg.encoder_chunk)
        encs = {k: (lambda dt=dt: [run_in(enc, c, dt) for c in chunks])
                for k, dt in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16))}
        enc_ms = {k: [] for k in encs}
        for k in ("float32", "bfloat16", "bfloat16", "float32"):
            enc_ms[k].append(cuda_ms(encs[k], STAGE_REPS))
    log(f"11a warm {WINDOW}-frame window ms: " + "; ".join(
        f"{k} {[round(t, 3) for t in v]}, median {np.median(v):.3f}"
        for k, v in win.items()) + f"; encoder per frame ({len(stacked)} "
        f"patches in chunks of {cfg.encoder_chunk}) ms: " + "; ".join(
        f"{k} {[round(t, 4) for t in v]}" for k, v in enc_ms.items())
        + f"; {card}")

    # ---- (b) the window route and the KNN route
    cfg_w = dataclasses.replace(cfg, voxel=dataclasses.replace(
        vc, bitgrid_slots=(0, 0, 0)))
    cfg_k = dataclasses.replace(cfg, voxel=dataclasses.replace(
        vc, patch_method="knn"))
    pyr_c = grid.VoxelPyramid(*([x.cpu() for x in f] for f in pyr))
    kp_c, km_c = f32.key_pts.cpu(), f32.mask.cpu()
    # the card bins as the CPU: the pyramid, every point's voxel and the
    # keypoints' voxels equal at each scale; the ring image's cells equal
    # but where atan2 / asin differ at a bin edge
    pyr_cpu = grid.voxelize(torch.from_numpy(scans[0][0][:, :3]),
                            torch.from_numpy(scans[0][1]), vc)

    def voxel_keys(c, m):
        c = c[m].to(torch.int64)
        return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]

    n_vox = [int((~torch.isin(voxel_keys(a.cpu(), ma.cpu()),
                              voxel_keys(b, mb))).sum()
                 + (~torch.isin(voxel_keys(b, mb),
                                voxel_keys(a.cpu(), ma.cpu()))).sum())
             for a, ma, b, mb in zip(pyr.coords, pyr.masks, pyr_cpu.coords,
                                     pyr_cpu.masks)]
    n_valid = [int(m.sum()) for m in pyr.masks]
    half = torch.tensor([vc.visible_length, vc.visible_width,
                         vc.visible_height])
    p0 = torch.from_numpy(scans[0][0][:, :3])
    inside = p0[torch.from_numpy(scans[0][1]) & (p0.abs() <= half).all(1)]
    n_kv, n_pt = [], []
    for s in range(3):
        a, b = (grid.keypoint_voxels(f32.key_pts, s, vc).cpu(),
                grid.keypoint_voxels(kp_c, s, vc))
        n_kv.append(int((a != b).any(1).sum()))
        a, b = (grid.keypoint_voxels(inside.to(dev), s, vc).cpu(),
                grid.keypoint_voxels(inside, s, vc))
        n_pt.append(int((a != b).any(1).sum()))
    sensor = cfg.sensor
    pts0, msk0 = (torch.from_numpy(a) for a in scans[0])
    ring_d = [x.cpu() for x in ring_bins(pts0.to(dev), msk0.to(dev),
                                         sensor)[1:]]
    ring_c = ring_bins(pts0, msk0, sensor)[1:]
    differ = ((ring_d[0] != ring_c[0]) | (ring_d[1] != ring_c[1])
              | (ring_d[2] != ring_c[2])) & msk0
    n_ring, n_ring_off = int(differ.sum()), ring_off_edge(
        scans[0][0], differ.numpy(), sensor)
    log(f"11b binning, card against CPU on frame 0: voxels in one pyramid "
        f"and not the other per scale {n_vox} of {n_valid}, points binned "
        f"otherwise {n_pt} of {len(inside)}, keypoint voxels differing "
        f"{n_kv} of {int(f32.mask.sum())} (limits: {BIN_SHARE} of each); "
        f"ring-image cells differing {n_ring} of {int(msk0.sum())} points, "
        f"{n_ring_off} of them off a bin edge (limit 0)")
    if n_ring_off or any(n > BIN_SHARE * v for n, v in zip(
            n_vox + n_pt + n_kv, n_valid + [len(inside)] * 3
            + [int(f32.mask.sum())] * 3)):
        raise AssertionError("11b the card bins points unlike the CPU")
    for s in range(3):
        kv = grid.keypoint_voxels(f32.key_pts, s, vc)
        out_w = grid._patches_one_scale_window(
            kv, f32.mask, pyr.coords[s], pyr.masks[s], cfg_w.voxel, s)
        ref_w = grid._patches_one_scale_window(
            kv.cpu(), km_c, pyr_c.coords[s], pyr_c.masks[s], cfg_w.voxel, s)
        if not torch.equal(out_w.cpu(), ref_w):
            raise AssertionError(f"11b window route scale {s}: card and CPU "
                                 "patches differ")
        log(f"11b window route, frame 0 scale {s}: patches bit-exact "
            f"against the CPU, occupancy {float(ref_w.mean()):.4f}")
    for s in range(3):
        kv = grid.keypoint_voxels(f32.key_pts, s, vc)
        args = (pyr.coords[s], pyr.masks[s], cfg_k.voxel)
        idx_d = grid.knn_indices(kv, *args)
        idx_c = grid.knn_indices(kv.cpu(), pyr_c.coords[s], pyr_c.masks[s],
                                 cfg_k.voxel)
        n_tied = neighbor_ties(pyr_c.coords[s], pyr_c.masks[s], idx_c,
                               idx_d.cpu(), queries=kv.cpu(),
                               query_mask=km_c)
        got = grid._patches_one_scale(kv, f32.mask, *args)
        from_lists = grid.patches_from_neighbors(
            idx_d.cpu(), kv.cpu(), km_c, pyr_c.coords[s], pyr_c.masks[s],
            cfg_k.voxel)
        if not torch.equal(got.cpu(), from_lists):
            raise AssertionError(f"11b KNN route scale {s}: the card's "
                                 "patches are not those of its lists")
        ref = grid.patches_from_neighbors(idx_c, kv.cpu(), km_c,
                                          pyr_c.coords[s], pyr_c.masks[s],
                                          cfg_k.voxel)
        log(f"11b KNN route, frame 0 scale {s}: {n_tied} keypoints' lists "
            f"differ from the CPU's, each at a k-th-place tie; "
            f"{int((got.cpu() != ref).sum())} patch cells differ, all from "
            f"those ties")
    for run_cfg, what in ((cfg_w, "window-route window"),
                          (cfg_k, "KNN-route window")):
        window(run_cfg, what, want_k2=False)

    # ---- (c) presorted_pyramid=False: a shuffled pyramid, K2
    g = torch.Generator(device=dev).manual_seed(7)
    perm = [torch.randperm(len(c), generator=g, device=dev)
            for c in pyr.coords]
    shuf = grid.VoxelPyramid(tuple(c[p] for c, p in zip(pyr.coords, perm)),
                             tuple(m[p] for m, p in zip(pyr.masks, perm)),
                             pyr.counts)
    cfg_u = dataclasses.replace(vc, presorted_pyramid=False)
    reset_launches()
    out_u = grid.extract_patches(f32.key_pts, f32.mask, shuf, cfg_u)
    torch.cuda.synchronize()
    used = launch_counts()
    add_launches(launches, used)
    out_p = grid.extract_patches(f32.key_pts, f32.mask, pyr, vc)
    if used != {"saliency_map": 0, "gather_planes": 3,
                "max_eigvec_sym4x4": 0, "knn_select": 0} or not all(
            torch.equal(a, b) for a, b in zip(out_u, out_p)):
        raise AssertionError(f"11c unsorted pyramid: launches {used}, or "
                             "patches differ from the presorted ones")
    log(f"11c presorted_pyramid=False on a shuffled frame-0 pyramid: patches "
        f"equal to the presorted ones, launches {used}")

    # ---- (d) threaded staging over a disk-backed cache of the scans (just
    # written, so read from the page cache), in turns
    base = os.path.join(tmp, "scans")
    np.save(base + ".pts.npy", np.stack([p for p, _ in scans]))
    np.save(base + ".msk.npy", np.stack([m for _, m in scans]))
    runs = {}
    for threaded in (False, True, True, False):
        res, _, ms = window(cfg, f"NpyScanReader window, threaded staging "
                            f"{threaded}", seq=NpyScanReader(base),
                            threaded_staging=threaded)
        runs.setdefault(threaded, []).append((res, ms))
    a, b = runs[True][0][0], runs[False][0][0]
    if not (np.array_equal(a.poses, b.poses)
            and np.array_equal(a.successes, b.successes)
            and np.array_equal(a.poses, res_a.poses)):
        raise AssertionError("11d threaded staging changed the poses")
    log(f"11d staging: poses bit-identical threaded, synchronous and run A; "
        f"ms threaded {[round(ms, 1) for _, ms in runs[True]]}, synchronous "
        f"{[round(ms, 1) for _, ms in runs[False]]}; {card}")
    return launches


def event_ms(fn):
    """``(fn's result, ms of its device work)`` by CUDA events, after a
    synchronise."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def warm_ms(fn):
    """``(fn's result, ms of a first call, ms of a second call)`` by CUDA
    events."""
    _, first = event_ms(fn)
    out, warm = event_ms(fn)
    return out, first, warm


def card_world(rank, world, inputs):
    """Phase 12a, one rank of a real NCCL world on the card: every sharded
    path at the default config against its one-device function.  Returns
    the extractor's kernel launches, each path's ms (a first call, and a
    second, warm, one) and the checks' values (CPU data)."""
    import torch
    import torch.distributed as dist
    from caelo_tpu_torch import setup_device
    from caelo_tpu_torch.backend.posegraph import (PoseGraph, optimize,
                                                   optimize_sharded)
    from caelo_tpu_torch.backend.refine_runner import (RefinementFeatures,
                                                       make_batched_icp_fn)
    from caelo_tpu_torch.backend.scancontext import sc_correlation_matrix
    from caelo_tpu_torch.config import PipelineConfig
    from caelo_tpu_torch.frontend.registration import extract_frame_features
    from caelo_tpu_torch.models.patch_encoder import VoxelPatchAE
    from caelo_tpu_torch.models.weights_io import (build_models,
                                                   voxel_ae_params_to_torch)
    from caelo_tpu_torch.parallel.mesh import make_mesh
    from caelo_tpu_torch.parallel.pipeline import (
        make_batched_feature_extractor, make_sharded_icp_fn,
        make_sharded_sc_correlation, neighbor_pose_exchange)
    from caelo_tpu_torch.training.train import (
        adam, create_train_state, make_sharded_train_step, make_train_step,
        patch_loss, shard_train_state)

    if dist.get_backend() != "nccl":
        raise AssertionError(f"12a the world's backend is "
                             f"{dist.get_backend()}, not nccl")
    dev = setup_device(f"cuda:{rank}")
    cfg = PipelineConfig()
    nets = build_models(inputs["respond"], inputs["encoder"], dev, cfg)
    mesh = make_mesh()
    out = {"ms": {}, "world": world, "backend": dist.get_backend()}
    ms = out["ms"]

    # the data-parallel extractor: K1 once and K2 three times per frame,
    # the features those of the one-device extractor bit for bit
    pts = torch.from_numpy(inputs["pts"]).to(dev)
    mask = torch.from_numpy(inputs["mask"]).to(dev)
    ex = make_batched_feature_extractor(mesh, cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    feats, ms["extractor_first"] = event_ms(lambda: ex(*nets, pts, mask))
    out["launches"] = launch_counts()
    B = pts.shape[0]
    if out["launches"] != {"saliency_map": B, "gather_planes": 3 * B,
                           "max_eigvec_sym4x4": 0, "knn_select": 0}:
        raise AssertionError(f"12a extractor launches {out['launches']} for "
                             f"{B} frames")
    _, ms["extractor"] = event_ms(lambda: ex(*nets, pts, mask, gather=True))
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    for b in range(B):
        one = extract_frame_features(*nets, pts[b], mask[b], cfg)
        if not all(torch.equal(a[b], o) for a, o in zip(feats, one)):
            raise AssertionError(f"12a extractor frame {b} differs from "
                                 "extract_frame_features")

    # halo exchange: a world of one is its own left neighbour
    poses = torch.from_numpy(inputs["poses"]).to(dev)
    (total, left), ms["halo_first"], ms["halo"] = warm_ms(
        lambda: neighbor_pose_exchange(mesh)(poses))
    p64 = inputs["poses"].astype(np.float64)
    want = float(((p64[1:] - p64[:-1]) ** 2).sum())
    out["halo"] = (float(total), want)
    if not (torch.equal(left, poses[-1])
            and abs(float(total) - want) <= 1e-6 * want):
        raise AssertionError(f"12a halo: total {float(total)} against "
                             f"{want}, or left_last not the last pose")

    # ScanContext correlation: the gathered matrices bit for bit
    scs = torch.from_numpy(inputs["scs"]).to(dev)
    (score, yaw), ms["sc_correlation_first"], ms["sc_correlation"] = warm_ms(
        lambda: make_sharded_sc_correlation(mesh)(scs, gather=True))
    s1, y1 = sc_correlation_matrix(scs)
    if not (torch.equal(score, s1) and torch.equal(yaw, y1)):
        raise AssertionError("12a sharded ScanContext correlation differs")

    # the edge-sharded pose graph against the one-device solve
    R0, t0 = (torch.from_numpy(x).to(dev) for x in inputs["R0t0"])
    graph = PoseGraph(*(torch.from_numpy(inputs["graph"][f]).to(dev)
                        for f in PoseGraph._fields))
    (R, t, cost), ms["posegraph_first"], ms["posegraph"] = warm_ms(
        lambda: optimize_sharded(mesh, len(R0), n_iters=4, cg_iters=40)(
            R0, t0, graph))
    _, t1, c1 = optimize(R0, t0, graph, n_iters=4, cg_iters=40)
    out["posegraph"] = (float((t - t1).abs().max()), float(cost), float(c1))
    if out["posegraph"][0] > 1e-2 or abs(float(cost) - float(c1)) > 1e-6:
        raise AssertionError(f"12a sharded pose graph {out['posegraph']}")

    # span-sharded ICP on a 16-span call, bit for bit the one-device call
    ref = RefinementFeatures(*(torch.from_numpy(x).to(dev)
                               for x in inputs["ref"]))
    spans = inputs["spans"]
    n_spans = len(spans[0])
    sharded = make_sharded_icp_fn(ref, mesh, cfg, spans_per_device=n_spans)
    got, ms["icp_first"], ms["icp"] = warm_ms(lambda: sharded(*spans))
    one = make_batched_icp_fn(ref, cfg, chunk=n_spans)(*spans)
    if not all(np.array_equal(a, b) for a, b in zip(got, one)):
        raise AssertionError("12a sharded ICP differs from the one-device "
                             "call")
    out["icp_successes"] = int(got[2].sum())

    # one DP and one TP patch-AE step at the trainer's batch of 256
    batch = torch.from_numpy(inputs["ae_batch"]).to(dev)
    state_dict = voxel_ae_params_to_torch(inputs["ae"])

    def fresh():
        model = VoxelPatchAE().to(dev)
        model.load_state_dict(state_dict)
        return create_train_state(model, adam(model.parameters()))

    _, want = make_train_step(patch_loss)(fresh(), batch)
    out["losses"] = {"one_device": float(want)}
    for name, tp in (("dp", False), ("tp", True)):
        step, _ = make_sharded_train_step(patch_loss, mesh)
        state = shard_train_state(fresh(), mesh, tensor_parallel=tp)
        (_, loss), ms[f"{name}_step_first"] = event_ms(
            lambda: step(state, batch))
        _, ms[f"{name}_step"] = event_ms(lambda: step(state, batch))
        out["losses"][name] = float(loss)
        if abs(float(loss) - float(want)) > 1e-5 * abs(float(want)):
            raise AssertionError(f"12a {name} step loss {float(loss)} "
                                 f"against {float(want)}")
    return out


def multi_gpu(cfg, card, scans, params, ref, icp_rels):
    """Phase 12: (a) a real NCCL world of one rank on the card running
    every sharded path (``card_world``) and ``cli scaling``; (b) the
    4-rank dry run on gloo CPU ranks.  Returns 12a's kernel launches."""
    import torch
    from caelo_tpu_torch import cli
    from caelo_tpu_torch.parallel.dryrun import (dryrun_multigpu,
                                                 square_graph)
    from caelo_tpu_torch.parallel.mesh import run_ranks
    from caelo_tpu_torch.models.weights_io import random_ae_params

    rng = np.random.default_rng(12)
    R0, t0, graph = square_graph(1)
    relRs, relTs = icp_rels
    inputs = dict(
        respond=params[0], encoder=params[1],
        pts=np.stack([p for p, _ in scans[:WINDOW]]),
        mask=np.stack([m for _, m in scans[:WINDOW]]),
        poses=np.cumsum(rng.normal(0, 1, (WINDOW, 12)), 0).astype(np.float32),
        scs=rng.uniform(0, 8, (88, 16, 64)).astype(np.float32),
        R0t0=(R0, t0), graph=graph,
        ref=tuple(x.cpu().numpy() for x in ref),
        spans=(np.arange(WINDOW, dtype=np.int32),
               np.arange(1, WINDOW + 1, dtype=np.int32), relRs, relTs),
        ae=random_ae_params(0)[1],
        ae_batch=(rng.uniform(size=(256, 16, 16, 16)) < 0.2
                  ).astype(np.float32))
    torch.cuda.empty_cache()
    t0_s = time.perf_counter()
    out = run_ranks(card_world, 1, args=(inputs,), device_type="cuda")[0]
    log(f"12a NCCL world of {out['world']} ({out['backend']}): extractor "
        f"on {WINDOW} frames at the default config bit-identical to "
        f"extract_frame_features, launches {out['launches']}; ms (CUDA "
        f"events) {json.dumps({k: round(v, 3) for k, v in out['ms'].items()})}"
        f"; extractor {WINDOW / out['ms']['extractor'] * 1e3:.3f} frames/s "
        f"warm, peak device memory {out['peak_mib']:.1f} MiB; halo total "
        f"{out['halo'][0]:.6f} (float64 {out['halo'][1]:.6f}); pose graph "
        f"max|dt| {out['posegraph'][0]:.2e}, cost {out['posegraph'][1]:.6e} "
        f"(one device {out['posegraph'][2]:.6e}); ICP {out['icp_successes']}"
        f"/{WINDOW} spans solved, bit-identical; patch-AE losses "
        f"{out['losses']}; {time.perf_counter() - t0_s:.1f} s with the "
        f"spawn; {card}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["scaling"])
    sweep = json.loads(buf.getvalue())["sweep"]
    log(f"12a cli scaling: {json.dumps(sweep)}; {card}")
    if [r["devices"] for r in sweep] != [torch.cuda.device_count()] or not (
            sweep[0]["frames_per_s"] > 0):
        raise AssertionError(f"12a cli scaling swept {sweep}")
    t0_s = time.perf_counter()
    summary = dryrun_multigpu(4, "cpu")
    log(f"12b dryrun_multigpu(4, \"cpu\") on gloo CPU ranks: "
        f"{json.dumps(summary)} "
        f"({time.perf_counter() - t0_s:.1f} s)")
    return out["launches"]


def echo(fn, *args, show_out=True):
    """``fn(*args)`` with its standard output and error captured and
    echoed (its output only with ``show_out``); returns ``(result, stdout,
    stderr)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = fn(*args)
    for text in (out.getvalue() if show_out else "", err.getvalue()):
        for line in text.replace("\r", "\n").splitlines():
            if line.strip():
                log(f"  | {line}")
    return result, out.getvalue(), err.getvalue()


def finite_numbers(pattern, text, what):
    """The numbers ``pattern``'s groups read in ``text``; each must be
    finite."""
    import re

    m = re.search(pattern, text)
    if m is None:
        raise AssertionError(f"{what}: no line matches {pattern!r}")
    vals = [float(v) for v in m.groups()]
    if not np.isfinite(vals).all():
        raise AssertionError(f"{what}: {vals}")
    return vals


def example_drivers(cfg, card, tmp, circuit):
    """Phase 13: the example drivers of ``caelo_tpu_torch/examples`` on the
    card through their ``run`` seams.  (a) the study trains both AEs on
    phase 7's circuit written as a scan cache and scores them; (b) the hard
    benchmark gates the full pipeline with those weights; (c) the pair and
    loop demos and KITTI golden (on phase 9's tree) with the ``.h5``
    loaders answering the trained weights, and collect_validation over
    (b)'s JSON.  Returns the launch counts of all three."""
    import argparse
    import torch
    from caelo_tpu_torch.examples import (collect_validation, hard_benchmark,
                                          kitti_golden, loop_closure_demo,
                                          register_pair_demo)
    from caelo_tpu_torch.examples import train_from_scratch_study as study
    from caelo_tpu_torch.models import weights_io

    launches = dict.fromkeys(launch_counts(), 0)
    # ---- (a) the study on the circuit's cache
    scans, gt = circuit
    cache = os.path.join(tmp, "circuit.npz")
    np.savez(cache, pts=np.stack([p for p, _ in scans]),
             msk=np.stack([m for _, m in scans]), gt=gt)
    out = os.path.join(tmp, "scratch")
    argv = ["--hard-caches", cache, "--steps2d", str(STUDY_STEPS),
            "--steps3d", str(STUDY_STEPS), "--pairs", "2", "--hard-pairs",
            "2", "--out", out]
    reset_launches()
    t0 = time.perf_counter()
    rc, _, _ = echo(study.run, study.parser().parse_args(argv), cfg)
    used = launch_counts()
    add_launches(launches, used)
    with open(os.path.join(out, "study.json")) as f:
        res = json.load(f)
    log(f"13a study {' '.join(argv)}: exit {rc}, "
        f"{time.perf_counter() - t0:.1f} s, launches {used}; study.json "
        f"{json.dumps(res)}; {card}")
    losses = res["loss2d"] + res["loss3d"]
    if not (rc == 0 and set(res) == {"results", "loss2d", "loss3d"}
            and [r["tag"] for r in res["results"]]
            == ["trained-from-scratch/easy", "trained-from-scratch/hard"]
            and all(set(r) == STUDY_FIELDS for r in res["results"])
            and np.isfinite(losses).all()):
        raise AssertionError(f"13a study.json {res}")
    if not res["loss3d"][1] < res["loss3d"][0]:
        raise AssertionError("13a the patch AE's loss did not fall")
    if used["saliency_map"] < 8 or used["gather_planes"] < 24:
        raise AssertionError("13a the study's evaluation did not run K1 "
                             "and K2 per frame")
    ran_k3(used, "13a the study's evaluation")

    # ---- (b) the hard benchmark with the trained weights
    runs = os.path.join(tmp, "hb_runs")
    os.makedirs(runs)
    json_out = os.path.join(runs, "hb_clean_w64.json")
    argv = ["--frames", str(HB_FRAMES), "--weights", out, "--json-out",
            json_out]
    reset_launches()
    t0 = time.perf_counter()
    rc, _, _ = echo(hard_benchmark.run,
                    hard_benchmark.parser().parse_args(argv), cfg,
                    show_out=False)          # the JSON, read from its file
    used = launch_counts()
    add_launches(launches, used)
    with open(json_out) as f:
        hb = json.load(f)
    log(f"13b hard_benchmark {' '.join(argv[:4])}: exit {rc}, "
        f"{time.perf_counter() - t0:.1f} s with the ray cast, launches "
        f"{used}; gates_pass {hb['gates_pass']}; the loop stage runs only "
        f"past run_full_pipeline's min_loop_gap of 100 frames; {card}")
    missing = [k for k in HB_FIELDS if k not in hb]
    if hb["n_loop_closures"] > 0:
        missing += [k for k in ("loop_precision", "loop_recall",
                                "loop_edges") if k not in hb]
    bad = [k for k, v in hb.items() if isinstance(v, float)
           and not np.isfinite(v)]
    bad += [k for k in ("per_pair_rre_deg", "per_pair_rte_m")
            if not np.isfinite(hb[k]).all()]
    if missing or bad or rc != (0 if hb["gates_pass"] else 1):
        raise AssertionError(f"13b fields missing {missing}, not finite "
                             f"{bad}, exit {rc}, gates {hb['gates_pass']}")
    if not {"frontend", "dejump", "refine"} <= set(hb["stage_seconds"]):
        raise AssertionError(f"13b stage_seconds {hb['stage_seconds']}")
    if (used["saliency_map"] < HB_FRAMES
            or used["gather_planes"] < 3 * HB_FRAMES):
        raise AssertionError("13b the pipeline did not run K1 and K2 per "
                             "frame")
    ran_k3(used, "13b hard_benchmark")

    # ---- (c) the demos and KITTI golden, the .h5 loaders answering (a)'s
    # trained weights (relu / linear encoder), and collect_validation
    sph = weights_io.spherical_ae_params_from_torch(
        weights_io.load_checkpoint(os.path.join(out, "respond_ae")))
    vox = weights_io.voxel_ae_params_from_torch(
        weights_io.load_checkpoint(os.path.join(out, "patch_ae")))
    rp, ep = ({"params": sph["params"]["respond"]},
              {"params": vox["params"]["encoder"]})
    cfg_t = dataclasses.replace(cfg, encoder_activation="relu",
                                encoder_code_activation="linear")
    loaders = (weights_io.load_respond_layer_params,
               weights_io.load_patch_encoder_params)
    weights_io.load_respond_layer_params = lambda path=None: rp
    weights_io.load_patch_encoder_params = lambda path=None: ep
    card_args = argparse.Namespace(platform="cuda")
    golden = os.path.join(tmp, "KITTI_GOLDEN.json")
    reset_launches()
    try:
        t0 = time.perf_counter()
        rc, text, _ = echo(register_pair_demo.run, card_args, cfg_t)
        finite_numbers(r"rotation error: (\S+) deg\s+translation error: "
                       r"(\S+) m", text, "13c register_pair_demo")
        log(f"13c register_pair_demo: exit {rc} (its own checks; not "
            f"asserted at {STUDY_STEPS} training steps), "
            f"{time.perf_counter() - t0:.1f} s; {card}")
        t0 = time.perf_counter()
        with contextlib.chdir(tmp):
            rc, text, _ = echo(loop_closure_demo.run, card_args, cfg_t)
        finite_numbers(r"ATE raw:\s+(\S+) m rmse.*\nATE final:\s+(\S+) "
                       r"m rmse", text, "13c loop_closure_demo")
        log(f"13c loop_closure_demo: exit {rc} (its own check; not "
            f"asserted), {time.perf_counter() - t0:.1f} s; {card}")
        t0 = time.perf_counter()
        rc, _, _ = echo(kitti_golden.run, kitti_golden.parser().parse_args(
            ["--data", os.path.join(tmp, "kitti"), "--seqs", "00",
             "--out", os.path.join(tmp, "golden"), "--json-out", golden]),
            cfg_t)
    finally:
        (weights_io.load_respond_layer_params,
         weights_io.load_patch_encoder_params) = loaders
    used = launch_counts()
    add_launches(launches, used)
    with open(golden) as f:
        kg = json.load(f)
    agg = kg["aggregate"]
    log(f"13c kitti_golden on phase 9's tree: exit {rc} (the verdict of a "
        f"synthetic tree means nothing), aggregate {json.dumps(agg)}, "
        f"{time.perf_counter() - t0:.1f} s; launches of 13c {used}; {card}")
    if not (kg["per_seq"]["00"]["frames"] == N_SCANS
            and np.isfinite(list(agg.values())).all()):
        raise AssertionError(f"13c kitti_golden {kg}")
    if (used["saliency_map"] < 2 + 41 + N_SCANS
            or used["gather_planes"] < 3 * (2 + 41 + N_SCANS)):
        raise AssertionError("13c the demos did not run K1 and K2 per frame")
    ran_k3(used, "13c the demos")
    rows = collect_validation.collect(runs)
    row, = rows["clean_w64"]
    want = [k for k in collect_validation.KEYS if k in hb] + ["stage_s"]
    log(f"13c collect_validation: clean_w64 row {json.dumps(row)}")
    if list(row) != want:
        raise AssertionError(f"13c collect_validation row keys {list(row)}")
    return launches


def sequence_scale(cfg, card, tmp, circuit):
    """Phase 14: the sequence-scale driver.  (a) ``data.scancache``'s
    parallel cache writer against ``write_benchmark_cache``, byte for byte;
    (b) ``seq_scale.run`` over phase 7's circuit written as its scan cache
    with 13a's weights, once staging windows when due and once in a
    producer thread.  Returns the launch counts of (b)'s runs."""
    import filecmp
    import torch
    from caelo_tpu_torch.data.scancache import (
        write_benchmark_cache, write_benchmark_cache_parallel)
    from caelo_tpu_torch.examples import seq_scale

    # ---- (a) the parallel writer, byte for byte the serial one
    serial, parallel = (os.path.join(tmp, d, "seq") for d in ("ws", "wp"))
    t0 = time.perf_counter()
    write_benchmark_cache(serial, WRITER_FRAMES, cfg,
                          lap_frames=seq_scale.LAP_FRAMES)
    t1 = time.perf_counter()
    write_benchmark_cache_parallel(
        parallel, WRITER_FRAMES, cfg, lap_frames=seq_scale.LAP_FRAMES,
        procs=WRITER_PROCS)
    t2 = time.perf_counter()
    same = {s: filecmp.cmp(serial + s, parallel + s, shallow=False)
            for s in (".pts.npy", ".msk.npy", ".gt.npy")}
    log(f"14a cache of {WRITER_FRAMES} frames: serial {t1 - t0:.1f} s, "
        f"{WRITER_PROCS} processes {t2 - t1:.1f} s; files equal {same}")
    if not all(same.values()) or sorted(os.listdir(os.path.dirname(
            parallel))) != ["seq.gt.npy", "seq.msk.npy", "seq.pts.npy"]:
        raise AssertionError(f"14a the parallel writer's files {same}")

    # ---- (b) seq_scale.run on the circuit's cache, 13a's weights
    scans, gt = circuit
    n = len(scans)
    base = os.path.join(tmp, "circuit")
    np.save(base + ".pts.npy", np.stack([p for p, _ in scans]))
    np.save(base + ".msk.npy", np.stack([m for _, m in scans]))
    np.save(base + ".gt.npy", gt)
    json_out = os.path.join(tmp, "seq_scale.json")
    argv = ["--frames", str(n), "--scan-cache", base, "--weights",
            os.path.join(tmp, "scratch"), "--json-out", json_out]
    launches = dict.fromkeys(launch_counts(), 0)
    pipeline = seq_scale.run_full_pipeline
    results = {}
    for threaded in (False, True):
        seq_scale.run_full_pipeline = lambda *a, **kw: results.setdefault(
            threaded, pipeline(*a, threaded_staging=threaded, **kw))
        reset_launches()
        t0 = time.perf_counter()
        try:
            rc, _, _ = echo(seq_scale.run, seq_scale.parser().parse_args(
                argv), cfg, show_out=False)     # the JSON, read from its file
        finally:
            seq_scale.run_full_pipeline = pipeline
        torch.cuda.synchronize()
        used = launch_counts()
        add_launches(launches, used)
        with open(json_out) as f:
            out = json.load(f)
        log(f"14b seq_scale.run {' '.join(argv[:2])}, threaded staging "
            f"{threaded}: exit {rc}, {time.perf_counter() - t0:.1f} s, "
            f"launches {used}; stage seconds "
            f"{ {k: v['total_s'] for k, v in out['stage_seconds'].items()} }"
            f", pipeline {out['pipeline_seconds']} s, peak device memory "
            f"{out['peak_device_mib']} MiB, peak RSS {out['peak_rss_gb']} "
            f"GB; {card}")
        missing = [k for k in SS_FIELDS if k not in out]
        # a run with no accepted edge has no precision: loop_closure_pr
        # answers NaN for it (the loop stage runs past 100 frames only)
        nan_ok = {"loop_precision"} if out["n_loop_closures"] == 0 else set()
        values = [(k, v) for k, v in out.items() if k not in nan_ok
                  and isinstance(v, float)]
        values += [(f"ate_m.{k}", v) for k, v in out["ate_m"].items()]
        values += [(f"stage_seconds.{k}", v["total_s"])
                   for k, v in out["stage_seconds"].items()]
        bad = [k for k, v in values if not np.isfinite(v)]
        verdict = all(seq_scale.gates(out).values())
        if missing or bad or rc != (0 if verdict else 1):
            raise AssertionError(f"14b fields missing {missing}, not finite "
                                 f"{bad}, exit {rc}, gates {verdict}")
        if not ({"frontend", "dejump", "refine"} <= set(out["stage_seconds"])
                and out["peak_device_mib"] > 0
                and out["device"] == torch.cuda.get_device_name(0)):
            raise AssertionError(f"14b stage seconds, device memory or "
                                 f"device: {out}")
        if (used["saliency_map"] < n or used["gather_planes"] < 3 * n):
            raise AssertionError("14b the pipeline did not run K1 and K2 per "
                                 "frame")
        ran_k3(used, "14b seq_scale.run")
    log(f"14b gates (not asserted): {seq_scale.gates(out)}; success "
        f"{out['success_rate']}, "
        f"{out['frames_per_s_e2e']} frames/s, ATE {out['ate_m']}, loop "
        f"closures {out['n_loop_closures']}, max unpinned span "
        f"{out['max_unpinned_span']}")
    for name in ("poses_raw", "poses_dejumped", "poses_refined",
                 "poses_final"):
        if not np.array_equal(getattr(results[True], name),
                              getattr(results[False], name)):
            raise AssertionError(f"14b threaded staging changed {name}")
    log("14b threaded staging: all four pose arrays bit-identical to "
        "staging each window when due")
    return launches


def bench_flops_by_hand(cfg, n):
    """``(conv + linear, whole)``: the FLOPs of an ``n``-frame window of the
    processor from its layer shapes: per frame the respond net's 3x3 and
    1x1 convs over the (H, W) ring image and the encoder's three conv3d and
    two linear layers on 3 x K patches; per pair the (K, 60) x (60, K)
    distance matmul of matching."""
    H, W = cfg.sensor.model_h, cfg.sensor.model_w
    K = cfg.keypoint.n_keypoints
    respond = 2 * H * W * (3 * 32 * 9 + 32 * 8)
    encoder = 2 * (16 ** 3 * 8 * 27 + 8 ** 3 * 8 * 16 * 27
                   + 4 ** 3 * 16 * 32 * 27 + 32 * 4 ** 3 * 200 + 200 * 20)
    layers = n * (respond + 3 * K * encoder)
    return layers, layers + (n - 1) * 2 * K * K * (3 * 20)  # 3 scales' codes


def bench_windows(cfg, card, tmp):
    """Phase 15: ``cli bench`` in process for each of ``BENCH_RUNS``,
    ``BENCH_REPS`` reps: its JSON line (finite frames/s, ``0 < mfu <= 1``,
    FLOPs, peak memory), its FLOP count against the hand count, K1 n and K2
    3n times in every window it ran (warm-up, reps, the counted window),
    and frames 0-15 of the 64-frame float32 window bit-identical to the
    16-frame window's.  Returns the launch counts."""
    import torch
    from caelo_tpu_torch import bench, cli

    make = bench.make_sequence_processor
    launches = dict.fromkeys(launch_counts(), 0)
    first = {}               # (frames, dtype) -> the warm-up's features
    for n, dtype in BENCH_RUNS:
        windows = []                 # each window's launches

        def recording(cfg_, run_key=(n, dtype), windows=windows):
            process = make(cfg_)

            def run(*args):
                before = launch_counts()
                out = process(*args)
                windows.append({k: v - before[k]
                                for k, v in launch_counts().items()})
                first.setdefault(run_key, out[0])
                return out

            return run

        metrics = os.path.join(tmp, f"bench{n}{dtype}.jsonl")
        env = {"BENCH_FRAMES": str(n), "BENCH_REPS": str(BENCH_REPS),
               "BENCH_DTYPE": dtype, "BENCH_METRICS": metrics}
        what = f"{n} frames {dtype}"
        reset_launches()
        t0 = time.perf_counter()
        with mock.patch.dict(os.environ, env), mock.patch.object(
                bench, "make_sequence_processor", recording):
            rc, out, _ = echo(cli.main, ["bench"])
        seconds = time.perf_counter() - t0
        used = launch_counts()
        add_launches(launches, used)
        lines = out.splitlines()
        res = json.loads(lines[-1])
        with open(metrics) as f:
            rec = json.loads(f.read().splitlines()[-1])
        layers, whole = bench_flops_by_hand(cfg, n)
        counted = rec["flops_by_op"]
        log(f"15 cli bench, {what}, {BENCH_REPS} reps: {seconds:.1f} s in "
            f"all; {res['value']} frames/s, p50 {res['p50_ms']} ms, p95 "
            f"{res['p95_ms']} ms, warm-up {res['warmup_s']} s, mfu "
            f"{res['mfu']}, costmodel_hbm_frac {res['costmodel_hbm_frac']}, "
            f"peak device memory {res['peak_mem_mib']} MiB (with the live "
            f"tensors of earlier phases); {card}")
        log(f"15 {what}: window ms {rec['window_ms']}, pair success "
            f"{rec['pair_success']}/{n - 1}; FLOPs {res['flops_per_window']:.6e}"
            f" ({counted}), by hand: layers {layers:.6e}, with matching "
            f"{whole:.6e}; bytes {res['bytes_per_window']:.6e}; launches "
            f"{used}")
        if rc != 0 or len(lines) != 1:
            raise AssertionError(f"15 cli bench: exit {rc}, {len(lines)} "
                                 "lines")
        finite = [res[k] for k in ("value", "p50_ms", "p95_ms", "mfu",
                                   "flops_per_window", "peak_mem_mib")]
        if not (np.isfinite(finite).all() and res["value"] > 0
                and 0 < res["mfu"] <= 1 and res["flops_per_window"] > 0
                and res["peak_mem_mib"] > 0):
            raise AssertionError(f"15 {what}: {res}")
        if (res["metric"], res["device"], res["n_frames_window"],
                res["reps"], res["dtype"]) != (
                    "frontend_frames_per_s", torch.cuda.get_device_name(0),
                    n, BENCH_REPS, dtype):
            raise AssertionError(f"15 {what}: {res}")
        if (counted["convolution"] + counted["addmm"] != layers
                or abs(res["flops_per_window"] / whole - 1) > 0.1):
            raise AssertionError(f"15 {what}: FLOPs {counted} against "
                                 f"{layers} / {whole} by hand")
        want = {"saliency_map": n, "gather_planes": 3 * n}
        if len(windows) != BENCH_REPS + 2 or any(
                {k: w[k] for k in want} != want for w in windows):
            raise AssertionError(f"15 {what}: launches per window "
                                 f"{windows}, want {want} in each of "
                                 f"{BENCH_REPS + 2}")
        for w in windows:
            ran_k3(w, f"15 {what}, a window")
    big, small = (64, "float32"), (16, "float32")
    for name, a, b in zip(first[small]._fields, first[big], first[small]):
        if not torch.equal(a[:small[0]], b):
            raise AssertionError(f"15 frames 0-{small[0] - 1}: {name} "
                                 "differs between the two windows")
    log(f"15 frames 0-{small[0] - 1} of the {big[0]}-frame window: features "
        f"bit-identical to the {small[0]}-frame window's")
    return launches


def timed_ms(fn, reps):
    """Host wall-clock ms per call of ``fn``, synchronised, after one warm
    call; returns the list of times."""
    import torch

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
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the card and does not fall back to the CPU")

    from caelo_tpu_torch import _build, setup_device
    from caelo_tpu_torch.backend.refine_runner import (
        RefinementFeatures, make_batched_icp_fn, refine_pairs_batched)
    from caelo_tpu_torch.config import PipelineConfig
    from caelo_tpu_torch.frontend.baselines import (_knn_neighbors,
                                                    _knn_neighbors_plain)
    from caelo_tpu_torch.frontend.odometry import run_odometry_windowed
    from caelo_tpu_torch.frontend.registration import (
        extract_frame_features, extract_frame_features_full)
    from caelo_tpu_torch.geometry.se3 import (max_eigvec_sym4x4_lanes,
                                              max_eigvec_sym4x4_lanes_plain)
    from caelo_tpu_torch.models.weights_io import (build_models,
                                                   random_flax_params)
    from caelo_tpu_torch.ops.nms import select_keypoints_planes
    from caelo_tpu_torch.ops.plane_gather import (patches_from_planes,
                                                  patches_from_planes_plain)
    from caelo_tpu_torch.ops.saliency import (keypoint_score,
                                              keypoint_score_plain)
    from caelo_tpu_torch.parallel.pipeline import make_sequence_processor
    from caelo_tpu_torch.pipeline import run_full_pipeline
    from caelo_tpu_torch.projection.spherical import (
        model_input, project_to_spherical_ring)
    from caelo_tpu_torch.voxel.grid import (bitgrid_query, extract_patches,
                                            keypoint_voxels, voxelize)

    # ---- 1. card facts
    smi = nvidia_smi_line()
    dev = setup_device("cuda:0")
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    log(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # ---- 2. build
    t0 = time.perf_counter()
    kl = _build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {kl.build_s:.1f} s) "
        f"-> {kl.path}")
    for line in kl.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    cfg = PipelineConfig()
    if not cfg.voxel.use_pallas_plane_gather:
        raise AssertionError("the port's default config must take K2")
    # run B's config: indexing instead of K2; the all-plain config: neither
    cfg_b = dataclasses.replace(cfg, voxel=dataclasses.replace(
        cfg.voxel, use_pallas_plane_gather=False))
    cfg_plain = dataclasses.replace(cfg_b, keypoint=dataclasses.replace(
        cfg.keypoint, use_pallas_nms=False))
    sensor, kp = cfg.sensor, cfg.keypoint
    scans = make_scans(cfg)
    respond_np, encoder_np = random_flax_params(0)
    respond_net, encoder = build_models(respond_np, encoder_np, dev, cfg)
    H, W = sensor.model_h, sensor.model_w

    # ---- 3. K1 against its plain version
    g = torch.Generator(device=dev).manual_seed(0)
    planes16 = torch.randn((16, 8, H, W), generator=g, device=dev).relu_() * 15
    image16 = torch.zeros((16, sensor.img_h, sensor.img_w, 5), device=dev)
    image16[..., 2] = torch.rand(image16.shape[:-1], generator=g,
                                 device=dev) * 5 - 3
    image16[..., 4] = torch.rand(image16.shape[:-1], generator=g,
                                 device=dev) * 40
    counter16 = ((torch.rand(image16.shape[:-1], generator=g, device=dev)
                  < 0.6) * torch.randint(1, 4, image16.shape[:-1], generator=g,
                                         device=dev)).to(torch.int32)
    k1_err = check_saliency(planes16, counter16[:, :H, :W] > 0,
                            "random planes")
    k1_err = max(k1_err, check_keypoint_score(
        planes16, image16, counter16, sensor, kp, "random planes and images")[0])
    pts0 = torch.from_numpy(scans[0][0]).to(dev)
    msk0 = torch.from_numpy(scans[0][1]).to(dev)
    with torch.no_grad():
        image0, counter0 = project_to_spherical_ring(pts0, msk0, sensor)
        planes0 = respond_net(
            model_input(image0, sensor).permute(2, 0, 1)[None])[0]
    log(f"respond map of frame 0: max {float(planes0.max()):.3f}, "
        f"occupied {int((counter0[:H, :W] > 0).sum())}")
    err0, want0 = check_keypoint_score(planes0, image0, counter0, sensor, kp,
                                       "frame 0")
    k1_err = max(k1_err, err0)
    k1_bound_ms, k1_bound_by = k1_bound(planes0, counter0, want0)
    k1_ms, k1_plain_ms = ab_ms(
        lambda: keypoint_score_plain(planes0, image0, counter0, sensor, kp),
        lambda: keypoint_score(planes0, image0, counter0, sensor, kp))
    k1b_ms, k1b_plain_ms = ab_ms(
        lambda: keypoint_score_plain(planes16, image16, counter16, sensor, kp),
        lambda: keypoint_score(planes16, image16, counter16, sensor, kp), 10)
    _, want16 = check_keypoint_score(planes16, image16, counter16, sensor, kp,
                                     "16-frame batch, for its bound")
    k1b_bound_ms = k1_bound(planes16, counter16, want16)[0]
    sel_ms, sel_plain_ms = ab_ms(
        lambda: select_keypoints_planes(image0, counter0, planes0, sensor,
                                        cfg_plain.keypoint),
        lambda: select_keypoints_planes(image0, counter0, planes0, sensor,
                                        kp), STAGE_REPS)
    k1_kernel = lambda: keypoint_score(planes0, image0, counter0, sensor, kp)
    k1_dev = graph_ms(k1_kernel)
    k1_plain_dev = graph_ms(lambda: keypoint_score_plain(
        planes0, image0, counter0, sensor, kp))
    k1_host = host_us(k1_kernel)
    log(f"K1 device time per frame (CUDA graph of 20 calls): kernel "
        f"{k1_dev:.4f} ms, plain {k1_plain_dev:.4f} ms; host enqueue of one "
        f"kernel call {k1_host:.1f} us")
    log(f"K1 time per frame (8, {H}, {W}): kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.4f} ms, bound {k1_bound_ms:.4f} ms ({k1_bound_by}); "
        f"per 16-frame batch: kernel {k1b_ms:.4f} ms, plain "
        f"{k1b_plain_ms:.4f} ms, bound {k1b_bound_ms:.4f} ms; {smi}")
    log(f"select_keypoints_planes per frame: kernel route {sel_ms:.4f} ms, "
        f"all-plain route {sel_plain_ms:.4f} ms; {smi}")

    # ---- 4. K2 against its plain version, bit-exact
    P = cfg.voxel.patch_size
    for slots in cfg.voxel.bitgrid_slots:
        table2 = torch.randint(-2 ** 31, 2 ** 31 - 1, (slots + 1, P, P),
                               generator=g, device=dev, dtype=torch.int64
                               ).to(torch.int32)
        table2[slots] = 0
        slot = torch.randint(0, slots + 1, (1024, 2, 2, 2), generator=g,
                             device=dev, dtype=torch.int64).to(torch.int32)
        slot[::7] = slots                  # zero-plane rows
        slot[1, 0, 0, 0] = -3              # clamped into the table
        slot[2, 1, 1, 1] = slots + 9
        o = torch.randint(0, P, (1024, 3), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int32)
        o[3], o[4], o[5], o[6] = 0, P - 1, torch.tensor([P - 1, 0, P - 1]), \
            torch.tensor([0, P - 1, 0])
        query = (table2, slot, o)
        check_patches(query, f"random table of {slots + 1} rows")
        km, pm = ab_ms(lambda: patches_from_planes_plain(*query),
                       lambda: patches_from_planes(*query))
        slot_l = slot.clamp(0, slots).long()
        lib = cuda_ms(lambda: table2[slot_l], REPS)
        # the bound of the gather alone (the TPU kernel's function, which K2
        # computed before it took in the patch tail): the distinct rows
        # read, the slots, the (1024, 2, 2, 2, 16, 16) int32 planes written
        rows = torch.unique(slot_l).numel()
        gather_bound = bound(rows * 1024 + slot.numel() * (4 + 1024), 0)[0]
        log(f"K2 random table ({slots + 1}, {P}, {P}), slot (1024, 2, 2, 2): "
            f"bit-exact; kernel {km:.4f} ms, plain {pm:.4f} ms, table2[slot] "
            f"{lib:.4f} ms, bound {k2_bound(query)[0]:.4f} ms; bound of the "
            f"gather alone {gather_bound:.4f} ms (bytes)")
        del table2, slot, o, query
    # frame 0's real query at each scale: the main path's shapes and data
    with torch.no_grad():
        kpts0, _, kmask0, _ = select_keypoints_planes(image0, counter0,
                                                      planes0, sensor, kp)
        pyr0 = voxelize(pts0[:, :3], msk0, cfg.voxel)
    k2_ms = k2_plain_ms = k2_lib_ms = k2_bound_ms = 0.0
    k2_bound_by = set()
    for sc, slots in enumerate(cfg.voxel.bitgrid_slots):
        query = bitgrid_query(keypoint_voxels(kpts0, sc, cfg.voxel), kmask0,
                              pyr0.coords[sc], pyr0.masks[sc], cfg.voxel, sc,
                              slots)
        out = check_patches(query, f"frame 0 scale {sc}")
        km, pm = ab_ms(lambda: patches_from_planes_plain(*query),
                       lambda: patches_from_planes(*query))
        slot_l = query[1].clamp(0, slots).long()
        lib = cuda_ms(lambda: query[0][slot_l], REPS)
        bms, bby = k2_bound(query)
        k2_kernel = lambda: patches_from_planes(*query)
        dev_ms = [graph_ms(f) for f in (
            k2_kernel, lambda: patches_from_planes_plain(*query),
            lambda: query[0][slot_l])]
        log(f"K2 frame 0 scale {sc} device time (CUDA graph of 20 calls): "
            f"kernel {dev_ms[0]:.4f} ms, plain {dev_ms[1]:.4f} ms, "
            f"table2[slot] {dev_ms[2]:.4f} ms; host enqueue of one kernel "
            f"call {host_us(k2_kernel):.1f} us")
        k2_ms, k2_plain_ms, k2_lib_ms = k2_ms + km, k2_plain_ms + pm, \
            k2_lib_ms + lib
        k2_bound_ms += bms
        k2_bound_by.add(bby)
        log(f"K2 frame 0 scale {sc} (table {slots + 1} rows, "
            f"{int(kmask0.sum())} keypoints, patch occupancy "
            f"{float(out.mean()):.4f}): bit-exact; kernel {km:.4f} ms, plain "
            f"{pm:.4f} ms, table2[slot] {lib:.4f} ms, bound {bms:.4f} ms "
            f"({bby})")
    k2_bound_by = "bytes" if k2_bound_by == {"bytes"} else "operations"
    k2_err = 0.0                                 # bit-exact, checked above
    vox_plain = cfg_b.voxel
    ext_ms, ext_plain_ms = ab_ms(
        lambda: extract_patches(kpts0, kmask0, pyr0, vox_plain),
        lambda: extract_patches(kpts0, kmask0, pyr0, cfg.voxel), STAGE_REPS)
    log(f"K2 time per frame (3 scales, frame 0): kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.4f} ms, table2[slot] {k2_lib_ms:.4f} ms, bound "
        f"{k2_bound_ms:.4f} ms; {smi}")
    log(f"extract_patches per frame: kernel route {ext_ms:.4f} ms, indexing "
        f"route {ext_plain_ms:.4f} ms; {smi}")

    # ---- 4b. K3 against its plain version, bit for bit
    k3_ms = k3_plain_ms = k3_bound_ms = k3_lib_ms = 0.0
    k3_bound_by = None
    for B, what in ((2048, "live hypotheses"), (1, "live refit"),
                    (63 * 2048, "offline window's hypotheses")):
        A = horn_lanes(B, g, dev)
        check_jacobi(A, f"{B} lanes")
        k3_kernel = lambda: max_eigvec_sym4x4_lanes(A)
        km, pm = ab_ms(lambda: max_eigvec_sym4x4_lanes_plain(A), k3_kernel,
                       10)
        bms, bby = bound(B * K3_BYTES_PER_LANE, B * K3_OPS_PER_LANE)
        bytes_ms = bound(B * K3_BYTES_PER_LANE, 0)[0]
        log(f"K3 {B} lanes ({what}): bit-exact; kernel {km:.4f} ms, plain "
            f"{pm:.4f} ms, bound {bms:.5f} ms ({bby}; bytes alone "
            f"{bytes_ms:.5f} ms); device time (CUDA graph of 20 calls) "
            f"{graph_ms(k3_kernel):.4f} ms; host enqueue of one kernel "
            f"call {host_us(k3_kernel):.1f} us; {smi}")
        if B == 2048:    # the kernel row: the live hypotheses' solve
            k3_ms, k3_plain_ms, k3_bound_ms = km, pm, bms
            k3_bound_by = bby
            # the library's batched eigen solve of the same matrices: all
            # four eigenpairs, the last column the largest's eigenvector
            eigh = lambda: torch.linalg.eigh(A.permute(2, 0, 1))[1][..., -1]
            k3_lib_ms = cuda_ms(eigh, 10)
            cos = (eigh() * k3_kernel().T).sum(1).abs()
            log(f"K3 {B} lanes: torch.linalg.eigh {k3_lib_ms:.4f} ms (CUDA "
                f"events), its eigenvector against K3's |cos| >= "
                f"{float(cos.min()):.6f}; {smi}")
        del A
    # the live refit and its tightenings solve one lane a call, where torch
    # sums the norm's squares as a tree: refit-like lanes of 500 points, one
    # at a time
    A = horn_lanes(256, g, dev, n=500, spread=20.0, tilt=0.02)
    for b in range(A.shape[2]):
        check_jacobi(A[:, :, b:b + 1], f"refit-like lane {b}")
    log(f"K3 {A.shape[2]} refit-like lanes of 500 points, one a call: "
        "bit-exact")
    del A
    k3_err = 0.0                                 # bit-exact, checked above

    # ---- 4c. K4 against its plain version, bit for bit
    pts_k = torch.from_numpy(np.ascontiguousarray(scans[0][0][:, :3])).to(dev)
    msk_k = torch.from_numpy(scans[0][1]).to(dev)
    for k in (64, 1, 16, 128):
        check_knn(pts_k, msk_k, k)
    k4_ms, k4_plain_ms = ab_ms(lambda: _knn_neighbors_plain(pts_k, msk_k, 64),
                               lambda: _knn_neighbors(pts_k, msk_k, 64), 3)
    n_k = pts_k.shape[0]
    k4_bytes = n_k * K4_BYTES_IN + n_k * 64 * 8
    k4_bound_ms, k4_bound_by = bound(k4_bytes, n_k * n_k * K4_OPS_PER_PAIR)
    log(f"K4 frame 0 ({n_k} points, {int(msk_k.sum())} valid, k 64): "
        f"bit-exact at k 1, 16, 64 and 128; kernel {k4_ms:.4f} ms, plain "
        f"{k4_plain_ms:.4f} ms, bound {k4_bound_ms:.4f} ms ({k4_bound_by}, "
        f"every pair scored; bytes alone {bound(k4_bytes, 0)[0]:.4f} ms); "
        f"host enqueue "
        f"{host_us(lambda: _knn_neighbors(pts_k, msk_k, 64), 10):.1f} us; "
        f"{smi}")
    del pts_k, msk_k

    # ---- 5. the slice
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res_a, feats_a = run_odometry_windowed(
        scans, respond_net, encoder, cfg=cfg, window=WINDOW, seed=0,
        keep_features=True)
    torch.cuda.synchronize()
    t_a = time.perf_counter() - t0
    launches = launch_counts()
    ran_k3(launches, "run A")
    reset_launches()
    t0 = time.perf_counter()
    res_b, feats_b = run_odometry_windowed(
        scans, respond_net, encoder, cfg=cfg_b, window=WINDOW, seed=0,
        keep_features=True)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    launches_b = launch_counts()
    log(f"run A (default config, K1 + K2): {t_a:.3f} s for {N_SCANS} scans, "
        f"launches {launches}; run B (indexing instead of K2): {t_b:.3f} s, "
        f"launches {launches_b}")
    for name in ("saliency_map", "gather_planes", "max_eigvec_sym4x4"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if launches["knn_select"]:
        raise AssertionError("run A launched K4, which only the keypoint "
                             "baselines run")
    if launches_b["gather_planes"]:
        raise AssertionError("run B launched K2")

    for tag, res in (("A", res_a), ("B", res_b)):
        if not np.isfinite(res.poses).all():
            raise AssertionError(f"run {tag}: non-finite poses")
        orth, det = check_so3(res.rel_Rs, f"run {tag}")
        log(f"run {tag}: pair successes {int(res.successes.sum())}/"
            f"{len(res.successes)} {res.successes.astype(int).tolist()}, "
            f"inliers {res.n_inliers.tolist()}, |R^T R - I| {orth:.2e}, "
            f"|det - 1| {det:.2e}")

    # A and B differ only in K2 vs indexing: identical patches and features
    for j in (0, N_SCANS - 1):
        pts = torch.from_numpy(scans[j][0]).to(dev)
        msk = torch.from_numpy(scans[j][1]).to(dev)
        pyr = voxelize(pts[:, :3], msk, cfg.voxel)
        pa = extract_patches(feats_a.key_pts[j], feats_a.mask[j], pyr,
                             cfg.voxel)
        pb = extract_patches(feats_a.key_pts[j], feats_a.mask[j], pyr,
                             cfg_b.voxel)
        if not all(torch.equal(a, b) for a, b in zip(pa, pb)):
            raise AssertionError(f"frame {j}: patches differ between A and B")
    for name, a, b in zip(feats_a._fields, feats_a, feats_b):
        if not torch.equal(a, b):
            raise AssertionError(f"features differ between A and B: {name}")
    if not (np.array_equal(res_a.rel_Rs, res_b.rel_Rs)
            and np.array_equal(res_a.successes, res_b.successes)):
        raise AssertionError("poses differ between A and B")
    log("runs A and B: patches, features and poses bit-identical")

    # one frame: kernel path against the all-plain path
    fk = extract_frame_features(respond_net, encoder, pts0, msk0, cfg)
    fp = extract_frame_features(respond_net, encoder, pts0, msk0, cfg_plain)
    with torch.no_grad():
        _, _, _, sal = select_keypoints_planes(image0, counter0, planes0,
                                               sensor, kp)
    sal = sal.cpu().numpy()
    kpix = fk.key_pixels[fk.mask].cpu().numpy()
    kth_score = sal[kpix[:, 0], kpix[:, 1]].min() if len(kpix) else 0.0
    compare_frames(fk, fp, sal, kth_score, "frame 0 kernel vs plain path")

    # warm window time: one 16-frame window (15 pairs) of the processor
    process = make_sequence_processor(cfg)
    pts_w = torch.stack([torch.from_numpy(s[0]) for s in scans[:WINDOW]]
                        ).to(dev)
    msk_w = torch.stack([torch.from_numpy(s[1]) for s in scans[:WINDOW]]
                        ).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    times = []
    for _ in range(WINDOW_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        process(respond_net, encoder, pts_w, msk_w, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    win_s = float(np.median(times))
    log(f"warm {WINDOW}-frame window: {[round(t * 1e3, 3) for t in times]} "
        f"ms, median {win_s * 1e3:.3f} ms -> {WINDOW / win_s:.3f} frames/s; "
        f"{smi}")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")

    # ---- 6. refinement
    # 6a: the window with refinement features, both kernels
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res_r, _, ref = run_odometry_windowed(
        scans, respond_net, encoder, cfg=cfg, window=WINDOW, seed=0,
        keep_refine_features=True)
    torch.cuda.synchronize()
    launches_r = launch_counts()
    log(f"6a window with refinement features: launches {launches_r}")
    if (launches_r["saliency_map"] < N_SCANS
            or launches_r["gather_planes"] <= 0):
        raise AssertionError("refinement window did not run both kernels")
    ran_k3(launches_r, "6a window with refinement features")
    if not np.array_equal(res_r.rel_Rs, res_b.rel_Rs):
        raise AssertionError("refinement window changed the odometry")
    E, P = cfg.icp.max_points, cfg.icp.max_planar
    if (tuple(ref.ext_pts.shape) != (N_SCANS, E, 3)
            or tuple(ref.planar.shape) != (N_SCANS, P, 6)):
        raise AssertionError(f"refinement features of shapes "
                             f"{tuple(ref.ext_pts.shape)}, "
                             f"{tuple(ref.planar.shape)}")
    n_ext = ref.ext_mask.sum(1).cpu().numpy()
    n_pl = ref.planar_mask.sum(1).cpu().numpy()
    log(f"refinement features {tuple(ref.ext_pts.shape)} / "
        f"{tuple(ref.planar.shape)}: extended points per frame "
        f"{n_ext.tolist()}, planar rows per frame {n_pl.tolist()}")
    if not (n_ext.all() and n_pl.all()):
        raise AssertionError("a frame has no extended or planar points")

    # 6b: ICP recovers the known motion (R = I, t = (1.2, 0.05, 0)) of the
    # 16 consecutive pairs from a start 0.3 m and 1 deg of yaw off
    gt_t = np.array([1.2, 0.05, 0.0])
    off = np.array([0.3, 0.0, 0.0])
    relRs = np.stack([yaw(1.0 if k % 2 else -1.0) for k in range(WINDOW)])
    relTs = np.stack([gt_t + (off if k % 2 else -off) for k in range(WINDOW)])
    f_i = RefinementFeatures(*(x[:-1] for x in ref))
    f_j = RefinementFeatures(*(x[1:] for x in ref))
    icp = refine_pairs_batched(
        f_i, f_j, torch.as_tensor(relRs, dtype=torch.float32, device=dev),
        torch.as_tensor(relTs, dtype=torch.float32, device=dev), cfg)
    dR = icp.R.double().cpu().numpy()
    ok = icp.success.cpu().numpy()
    newR = dR @ relRs
    newT = np.einsum("nij,nj->ni", dR, relTs) + icp.t.double().cpu().numpy()
    t_err = np.linalg.norm(newT - gt_t, axis=1)
    r_err = np.degrees(np.arccos(np.clip(
        (np.trace(newR, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)))
    log(f"6b ICP from a 0.3 m / 1 deg start: success {int(ok.sum())}/"
        f"{WINDOW}, iters {icp.iters.cpu().tolist()}, translation error "
        f"{np.round(t_err, 4).tolist()} m, rotation error "
        f"{np.round(r_err, 4).tolist()} deg, residual "
        f"{np.round(icp.init_res.double().cpu().numpy(), 4).tolist()} -> "
        f"{np.round(icp.final_res.double().cpu().numpy(), 4).tolist()} m")
    if ok.sum() < 12:
        raise AssertionError(f"ICP succeeded on {int(ok.sum())}/16 pairs")
    if t_err[ok].max() > 0.05 or r_err[ok].max() > 0.2:
        raise AssertionError("ICP missed the known motion")
    icp_fn = make_batched_icp_fn(ref, cfg)
    ii = np.arange(WINDOW, dtype=np.int32)
    icp_times = timed_ms(lambda: icp_fn(ii, ii + 1, relRs, relTs), 3)
    log(f"warm 16-span make_batched_icp_fn call (thr_scale 1): "
        f"{[round(t, 3) for t in icp_times]} ms, median "
        f"{float(np.median(icp_times)):.3f} ms")

    # 6c: one frame's refinement features, kernel path against plain path
    fk, rk = extract_frame_features_full(respond_net, encoder, pts0, msk0,
                                         cfg)
    fp, rp = extract_frame_features_full(respond_net, encoder, pts0, msk0,
                                         cfg_plain)
    compare_refinement_features(fk, fp, rk, rp,
                                "frame 0 refinement features, kernel vs plain")

    # window processor with and without refinement features, warm
    process_r = make_sequence_processor(cfg, with_refine=True)
    win_ms = timed_ms(lambda: process(respond_net, encoder, pts_w, msk_w,
                                      gen), WINDOW_REPS)
    win_r_ms = timed_ms(lambda: process_r(respond_net, encoder, pts_w, msk_w,
                                          gen), WINDOW_REPS)
    log(f"warm {WINDOW}-frame window: without refinement features "
        f"{[round(t, 3) for t in win_ms]} ms, median "
        f"{float(np.median(win_ms)):.3f}; with "
        f"{[round(t, 3) for t in win_r_ms]} ms, median "
        f"{float(np.median(win_r_ms)):.3f}")

    # 6d: the full pipeline through refinement, scan 8 unhealthy
    scans_thin = make_scans(cfg, thin=(8,))
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = run_full_pipeline(scans_thin, respond_net, encoder, cfg=cfg)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    launches_f = launch_counts()
    for name in ("poses_raw", "poses_dejumped", "poses_refined",
                 "poses_final"):
        orth, det = check_rel_rotations(getattr(full, name), name)
        log(f"{name}: |R^T R - I| {orth:.2e}, |det - 1| {det:.2e}")
    st = full.refine_stats
    log(f"6d run_full_pipeline: {t_full * 1e3:.1f} ms for {N_SCANS} scans; "
        f"pair successes {full.odometry.successes.astype(int).tolist()}; "
        f"dejumped {full.dejumped_frames}; refined {st.refined}, failed "
        f"{st.failed}, rejected {st.rejected}, skipped {st.skipped}; "
        f"launches {launches_f}")
    if not (st.refined or st.failed or st.rejected):
        raise AssertionError("refinement solved no span")
    if (launches_f["saliency_map"] < N_SCANS
            or launches_f["gather_planes"] < 3 * N_SCANS):
        raise AssertionError("run_full_pipeline did not run K1 and K2 per "
                             "frame")
    ran_k3(launches_f, "6d run_full_pipeline")
    moved = np.abs(full.poses_refined - full.poses_dejumped).max()
    log(f"refinement moved the poses by up to {moved:.4f}; peak device "
        f"memory of phase 6: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
    # ---- 7. the whole pipeline
    launches_7, circuit = whole_pipeline(cfg, respond_net, encoder, smi)
    for name in launches:
        launches[name] += (launches_r[name] + launches_f[name]
                           + launches_7[name])
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 8. training at full width
        add_launches(launches, training(cfg, dev, smi, tmp))
        # ---- 9. the command line on a KITTI tree
        add_launches(launches, cli_on_kitti_tree(cfg, smi, tmp))
        # ---- 10. the keypoint baselines, external trees, voxel views
        detectors_card_vs_cpu(cfg, dev, smi, scans)
        add_launches(launches, keypoint_rows(cfg, smi, tmp, feats_a))
        voxel_views(cfg, smi, tmp, scans, feats_a)
        # ---- 11. the one-device remainder: bfloat16, the window and KNN
        # patch routes, an unsorted pyramid, threaded staging
        add_launches(launches, one_device_remainder(
            cfg, dev, smi, scans, (respond_np, encoder_np),
            (respond_net, encoder), res_a, feats_a, (pts_w, msk_w), tmp))
        # ---- 13. the example drivers: the study on phase 7's circuit, the
        # hard benchmark with its weights, the demos, KITTI golden
        add_launches(launches, example_drivers(cfg, smi, tmp, circuit))
        # ---- 14. the sequence-scale driver on the circuit's scan cache
        add_launches(launches, sequence_scale(cfg, smi, tmp, circuit))
        # ---- 15. the bench: the 64- and 16-frame windows, and 64 in bfloat16
        add_launches(launches, bench_windows(cfg, smi, tmp))
    # ---- 12. multi-GPU: a NCCL world on the card, and 4 gloo CPU ranks
    add_launches(launches, multi_gpu(cfg, smi, scans, (respond_np, encoder_np),
                                     ref, (relRs, relTs)))

    kernels = [
        {"name": "saliency_map", "route": "cuda",
         "source": "caelo_tpu_torch/csrc/saliency.cu",
         "replaces": "caelo_tpu/ops/pallas_nms.py:60",
         "launches": launches["saliency_map"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
         "bound_by": k1_bound_by, "library_ms": None},
        {"name": "gather_planes", "route": "cuda",
         "source": "caelo_tpu_torch/csrc/plane_gather.cu",
         "replaces": "caelo_tpu/ops/pallas_patches.py:66",
         "launches": launches["gather_planes"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": k2_bound_by, "library_ms": k2_lib_ms},
        {"name": "max_eigvec_sym4x4", "route": "cuda",
         "source": "caelo_tpu_torch/csrc/sym4_jacobi.cu", "replaces": None,
         "launches": launches["max_eigvec_sym4x4"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound_ms,
         "bound_by": k3_bound_by, "library_ms": k3_lib_ms},
        {"name": "knn_select", "route": "cuda",
         "source": "caelo_tpu_torch/csrc/knn_select.cu", "replaces": None,
         "launches": launches["knn_select"], "max_abs_err": 0.0,
         "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound_ms,
         "bound_by": k4_bound_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
