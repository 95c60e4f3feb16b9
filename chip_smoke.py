"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repo root, one CUDA device

Phases (each raises on failure; the script then exits nonzero):

1. card facts: nvidia-smi name and power limit, torch/CUDA versions, TF32;
2. build the CUDA kernels of ``caelo_tpu_torch/csrc`` with nvcc;
3. K1 (saliency stencil) against its plain version on the card;
4. K2 (plane gather) against ``table2[slot]`` on the card, bit-exact;
5. the front-end odometry window at the full default ``PipelineConfig()``
   on 17 synthetic scans with random weights: run A (default config, K1)
   and run B (``use_pallas_plane_gather=True``, K1 + K2), launch counts,
   pose sanity, A/B identity, one frame against the all-plain path, times;
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
   accepted, every pose is finite and on SO(3), and K1 ran on every frame;
   logs each stage's ATE against the ground truth, loop precision/recall,
   the burst and closure stats, stage times and peak memory.

Prints a ``{"kernels": [...]}`` JSON line, then the nvidia-smi line, then
``{"ok": true, "device": {...}}`` as the last line.  Without a CUDA device
it fails; it never falls back to the CPU.
"""
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

N_SCANS = 17
WINDOW = 16
# phase 7: the CI circuit of tests/test_hard_full_stack.py with the burst of
# tests/test_degraded_rescue.py, ray-cast at the sensor's own azimuth step
CIRCUIT = dict(n_frames=88, seed=0, side=30.0, yaw_rate_deg=6.0, n_cars=3,
               degraded_spans=[(30, 42, 0.8, 140.0)], az_step_deg=0.2)
REPS = 50            # kernel timing launches per arm
WINDOW_REPS = 3      # warm window timings


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


def check_saliency(planes, occ, what):
    """K1 against its plain version: n_occ and finiteness exact, min_d2 to
    atol 1e-4 / rtol 1e-5 (8-term float32 sums in another order)."""
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
    log(f"K1 {what}: shape {tuple(planes.shape)}, finite "
        f"{int(fin.sum())}, max_abs_err {err:.3e}")
    return err


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


def whole_pipeline(cfg, respond_net, encoder, card):
    """Phase 7: run_full_pipeline with every stage on the CI circuit with a
    burst.  Every line with a time ends with ``card`` (the nvidia-smi
    name and power limit).  Returns the kernel launch counts of the run."""
    import torch
    import caelo_tpu_torch.backend.burst as burst_mod
    import caelo_tpu_torch.pipeline as pipe_mod
    from caelo_tpu_torch.data.hard_synthetic import generate_benchmark
    from caelo_tpu_torch.eval.metrics import (absolute_trajectory_error,
                                              loop_closure_pr,
                                              registration_summary,
                                              relative_pose_errors)
    from caelo_tpu_torch.ops.plane_gather import gather_planes
    from caelo_tpu_torch.ops.saliency import saliency_map
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
    saliency_map.launches = 0
    gather_planes.launches = 0
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
    launches = {"saliency_map": saliency_map.launches,
                "gather_planes": gather_planes.launches}
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
    if launches["saliency_map"] < n:
        raise AssertionError("run_full_pipeline did not run K1 per frame")
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
    from caelo_tpu_torch.frontend.odometry import run_odometry_windowed
    from caelo_tpu_torch.frontend.registration import (
        extract_frame_features, extract_frame_features_full)
    from caelo_tpu_torch.models.weights_io import (build_models,
                                                   random_flax_params)
    from caelo_tpu_torch.ops.nms import select_keypoints_planes
    from caelo_tpu_torch.ops.plane_gather import (gather_planes,
                                                  gather_planes_plain)
    from caelo_tpu_torch.ops.saliency import saliency_map, saliency_map_plain
    from caelo_tpu_torch.parallel.pipeline import make_sequence_processor
    from caelo_tpu_torch.pipeline import run_full_pipeline
    from caelo_tpu_torch.projection.spherical import (
        model_input, project_to_spherical_ring)
    from caelo_tpu_torch.voxel.grid import extract_patches, voxelize

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
    scans = make_scans(cfg)
    respond_np, encoder_np = random_flax_params(0)
    respond_net, encoder = build_models(respond_np, encoder_np, dev, cfg)
    H, W = cfg.sensor.model_h, cfg.sensor.model_w

    # ---- 3. K1 against its plain version
    g = torch.Generator(device=dev).manual_seed(0)
    planes16 = torch.randn((16, 8, H, W), generator=g, device=dev)
    occ16 = torch.rand((16, H, W), generator=g, device=dev) < 0.6
    k1_err = check_saliency(planes16, occ16, "random planes")
    pts0 = torch.from_numpy(scans[0][0]).to(dev)
    msk0 = torch.from_numpy(scans[0][1]).to(dev)
    with torch.no_grad():
        image0, counter0 = project_to_spherical_ring(pts0, msk0, cfg.sensor)
        planes0 = respond_net(
            model_input(image0, cfg.sensor).permute(2, 0, 1)[None])[0]
    occ0 = counter0[:H, :W] > 0
    log(f"respond map of frame 0: max {float(planes0.max()):.3f}, "
        f"occupied {int(occ0.sum())}")
    k1_err = max(k1_err, check_saliency(planes0.contiguous(), occ0,
                                        "frame-0 respond map"))
    k1_ms, k1_plain_ms = ab_ms(lambda: saliency_map_plain(planes0, occ0),
                               lambda: saliency_map(planes0, occ0))
    k1w_ms, k1w_plain_ms = ab_ms(lambda: saliency_map_plain(planes16, occ16),
                                 lambda: saliency_map(planes16, occ16), 10)
    log(f"K1 time per frame (8, {H}, {W}): kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.4f} ms; per 16-frame batch: kernel {k1w_ms:.4f} ms,"
        f" plain {k1w_plain_ms:.4f} ms")

    # ---- 4. K2 against table2[slot], bit-exact
    k2_ms = k2_plain_ms = k2_err = 0.0
    for slots in cfg.voxel.bitgrid_slots:
        P = cfg.voxel.patch_size
        table2 = torch.randint(-2 ** 31, 2 ** 31 - 1, (slots + 1, P, P),
                               generator=g, device=dev, dtype=torch.int64
                               ).to(torch.int32)
        table2[slots] = 0
        slot = torch.randint(0, slots + 1, (1024, 2, 2, 2), generator=g,
                             device=dev, dtype=torch.int64).to(torch.int32)
        slot[::7] = slots                  # zero-plane rows
        slot[1, 0, 0, 0] = -3              # clamped into the table
        slot[2, 1, 1, 1] = slots + 9
        out = gather_planes(table2, slot)
        ref = gather_planes_plain(table2, slot)
        torch.cuda.synchronize()
        k2_err = max(k2_err, float((out.long() - ref.long()).abs().max()))
        if not torch.equal(out, ref):
            raise AssertionError(f"K2 table of {slots + 1} rows: differs")
        km, pm = ab_ms(lambda: gather_planes_plain(table2, slot),
                       lambda: gather_planes(table2, slot))
        k2_ms += km
        k2_plain_ms += pm
        log(f"K2 table ({slots + 1}, {P}, {P}), slot (1024, 2, 2, 2): "
            f"bit-exact; kernel {km:.4f} ms, plain {pm:.4f} ms")
        del table2, out, ref
    log(f"K2 time per frame (3 scales): kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.4f} ms")

    # ---- 5. the slice
    cfg_b = dataclasses.replace(cfg, voxel=dataclasses.replace(
        cfg.voxel, use_pallas_plane_gather=True))
    torch.cuda.reset_peak_memory_stats()
    saliency_map.launches = 0
    gather_planes.launches = 0
    t0 = time.perf_counter()
    res_a, feats_a = run_odometry_windowed(
        scans, respond_net, encoder, cfg=cfg, window=WINDOW, seed=0,
        keep_features=True)
    torch.cuda.synchronize()
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_b, feats_b = run_odometry_windowed(
        scans, respond_net, encoder, cfg=cfg_b, window=WINDOW, seed=0,
        keep_features=True)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    launches = {"saliency_map": saliency_map.launches,
                "gather_planes": gather_planes.launches}
    log(f"run A (default config): {t_a:.3f} s for {N_SCANS} scans; run B "
        f"(plane-gather kernel): {t_b:.3f} s; launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

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
    cfg_plain = dataclasses.replace(cfg, keypoint=dataclasses.replace(
        cfg.keypoint, use_pallas_nms=False))
    fk = extract_frame_features(respond_net, encoder, pts0, msk0, cfg_b)
    fp = extract_frame_features(respond_net, encoder, pts0, msk0, cfg_plain)
    with torch.no_grad():
        _, _, _, sal = select_keypoints_planes(image0, counter0, planes0,
                                               cfg.sensor, cfg.keypoint)
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
        f"ms, median {win_s * 1e3:.3f} ms -> {WINDOW / win_s:.3f} frames/s")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")

    # ---- 6. refinement
    # 6a: the window with refinement features, both kernels
    torch.cuda.reset_peak_memory_stats()
    saliency_map.launches = 0
    gather_planes.launches = 0
    res_r, _, ref = run_odometry_windowed(
        scans, respond_net, encoder, cfg=cfg_b, window=WINDOW, seed=0,
        keep_refine_features=True)
    torch.cuda.synchronize()
    launches_r = {"saliency_map": saliency_map.launches,
                  "gather_planes": gather_planes.launches}
    log(f"6a window with refinement features: launches {launches_r}")
    if (launches_r["saliency_map"] < N_SCANS
            or launches_r["gather_planes"] <= 0):
        raise AssertionError("refinement window did not run both kernels")
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
                                         cfg_b)
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
    saliency_map.launches = 0
    gather_planes.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = run_full_pipeline(scans_thin, respond_net, encoder, cfg=cfg)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t0
    launches_f = {"saliency_map": saliency_map.launches,
                  "gather_planes": gather_planes.launches}
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
    if launches_f["saliency_map"] < N_SCANS:
        raise AssertionError("run_full_pipeline did not run K1 per frame")
    moved = np.abs(full.poses_refined - full.poses_dejumped).max()
    log(f"refinement moved the poses by up to {moved:.4f}; peak device "
        f"memory of phase 6: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB")
    # ---- 7. the whole pipeline
    launches_7 = whole_pipeline(cfg, respond_net, encoder, smi)
    for name in launches:
        launches[name] += (launches_r[name] + launches_f[name]
                           + launches_7[name])

    kernels = [
        {"name": "saliency_map", "route": "cuda",
         "source": "caelo_tpu_torch/csrc/saliency.cu",
         "replaces": "caelo_tpu/ops/pallas_nms.py:60",
         "launches": launches["saliency_map"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "gather_planes", "route": "cuda",
         "source": "caelo_tpu_torch/csrc/plane_gather.cu",
         "replaces": "caelo_tpu/ops/pallas_patches.py:66",
         "launches": launches["gather_planes"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
