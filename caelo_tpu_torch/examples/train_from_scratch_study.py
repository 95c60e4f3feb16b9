"""Train both auto-encoders from scratch and score their descriptors (port
of ``examples/train_from_scratch_study.py``).

Runs the reference's unsupervised recipe (``AE4SphericalRingPC.py:117-170``
MSE; ``AE4VoxelPatch.py:163-235`` BCE; Adam at 1e-3 for both, as the JAX
study) on synthetic scenes or on hard-circuit scan caches, then evaluates
the trained descriptors on held-out registration pairs, and the shipped
reference weights beside them when their ``.h5`` files are present:

* registration success rate / RRE / RTE (``EvaluationOnRegistration.py``
  semantics),
* RANSAC inlier ratio (the matchability metric of ``GenerateTrajactory.m``'s
  ``Matchablity_*.mat`` artifacts).

    python -m caelo_tpu_torch.examples.train_from_scratch_study \\
        [--steps2d N] [--steps3d N] [--out runs/scratch] [--platform cpu]

Writes ``<out>/respond_ae`` and ``<out>/patch_ae`` (``weights_io``
checkpoints) and ``<out>/study.json``.  Each loop's mean ms of data per
batch and of a step (the device synchronised at both ends of each) is
printed after it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..cli import _add_common, _device
from ..config import PipelineConfig
from ..data.hard_synthetic import generate_benchmark
from ..data.synthetic import synthetic_scan_pair
from ..frontend.registration import extract_frame_features, register_pair
from ..models import weights_io
from ..models.patch_encoder import VoxelPatchAE
from ..models.respond_net import RespondLayer, SphericalRingAE
from ..training.drivers import (cached_scan_stream, patch_batches,
                                respond_batches, synthetic_scan_stream)
from ..training.train import (adam, create_train_state, make_train_step,
                              patch_loss, respond_loss)
from ..utils.telemetry import StageTimer


def _train_loop(state, step, batches, max_steps: int, tag: str,
                plateau_window: int = 0, plateau_tol: float = 0.01,
                min_steps: int = 0, timer: StageTimer | None = None):
    """Run until ``max_steps`` or, with ``plateau_window``, until the
    median loss over the last window improves on the previous window by
    less than ``plateau_tol`` (relative).  ``timer`` times each batch's
    making (stage "data") apart from its step ("step").  Returns ``(state,
    losses)``."""
    timer = timer or StageTimer(sync=True)
    batches = iter(batches)
    losses = []
    t0 = time.time()
    for i in range(max_steps):
        with timer.stage("data"):
            batch = next(batches, None)
        if batch is None:
            break
        with timer.stage("step"):
            state, loss = step(state, batch)
            losses.append(float(loss))
        if i % 25 == 0:
            print(f"{tag} step {i}: loss={losses[-1]:.5f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
        W = plateau_window
        if (W and i >= max(min_steps, 2 * W) and i % W == 0):
            prev = float(np.median(losses[-2 * W:-W]))
            cur = float(np.median(losses[-W:]))
            if prev - cur < plateau_tol * max(abs(prev), 1e-9):
                print(f"{tag}: plateau at step {i} "
                      f"({prev:.5f} -> {cur:.5f})", flush=True)
                break
    return state, losses


def _print_ms(tag: str, timer: StageTimer, n_steps: int) -> None:
    ms = {k: v["mean_ms"] for k, v in timer.summary().items()}
    print(f"{tag}: {n_steps} steps, mean ms per step {ms.get('step')} "
          f"(device, synchronised), per batch of data {ms.get('data')}",
          flush=True)


def train_both(cfg: PipelineConfig, steps2d: int, steps3d: int, out: str,
               scan_stream_fn=None, plateau_window: int = 0,
               device="cuda"):
    """Train both AEs on ``device`` from ``random_ae_params`` 0 and 1 (the
    JAX study initialises them from keys 0 and 1).  ``scan_stream_fn(seed)
    -> iterator`` selects the training distribution (default: easy
    synthetic scenes).  Returns the trained ``RespondLayer`` and
    ``PatchEncoder`` state dicts and both loss lists."""
    if scan_stream_fn is None:
        scan_stream_fn = lambda seed: synthetic_scan_stream(cfg, seed=seed)
    # ---- 2D respond AE (MSE/Adam, AE4SphericalRingPC.py:150)
    model2 = SphericalRingAE()
    model2.load_state_dict(weights_io.spherical_ae_params_to_torch(
        weights_io.random_ae_params(0)[0]))
    model2.to(device)
    state2 = create_train_state(model2, adam(model2.parameters(), 1e-3))
    timer2 = StageTimer(sync=True)
    state2, losses2 = _train_loop(
        state2, make_train_step(respond_loss),
        respond_batches(scan_stream_fn(100), cfg, batch=4, device=device),
        steps2d, "respond", plateau_window=plateau_window, timer=timer2)
    _print_ms("respond", timer2, len(losses2))
    respond_sd = model2.state_dict()
    respond_trained = weights_io.respond_params_from_ae(respond_sd)

    # ---- 3D voxel-patch AE (BCE, AE4VoxelPatch.py:213), patches anchored
    # at keypoints detected by the freshly trained respond net
    respond_net = RespondLayer()
    respond_net.load_state_dict(respond_trained)
    model3 = VoxelPatchAE()
    model3.load_state_dict(weights_io.voxel_ae_params_to_torch(
        weights_io.random_ae_params(1)[1]))
    model3.to(device)
    state3 = create_train_state(model3, adam(model3.parameters(), 1e-3))
    timer3 = StageTimer(sync=True)
    state3, losses3 = _train_loop(
        state3, make_train_step(patch_loss),
        patch_batches(scan_stream_fn(200), cfg, batch=128,
                      respond_net=respond_net, device=device),
        steps3d, "patch", plateau_window=plateau_window, timer=timer3)
    _print_ms("patch", timer3, len(losses3))
    patch_sd = model3.state_dict()
    encoder_trained = weights_io.encoder_params_from_ae(patch_sd)

    weights_io.save_checkpoint(os.path.join(out, "respond_ae"), respond_sd)
    weights_io.save_checkpoint(os.path.join(out, "patch_ae"), patch_sd)
    return respond_trained, encoder_trained, losses2, losses3


def _hard_pairs(n_pairs: int, cfg: PipelineConfig, seed: int = 7,
                span: int = 220):
    """Ray-cast pairs sampled EVENLY across a ``span``-frame stretch of the
    hard circuit, covering straights and the 20 deg/s turns.  Each pair's
    two frames are ray-cast alone (``frame_range``), as the whole stretch
    would give them."""
    span = max(span, n_pairs + 1)
    starts = np.unique((np.arange(n_pairs) * (span - 1)) // max(n_pairs, 1))
    out = []
    for i in starts[:n_pairs]:
        i = int(i)
        ((s0, m0), (s1, m1)), gt = generate_benchmark(
            n_frames=span, seed=seed, cfg=cfg, frame_range=(i, i + 2))
        gt = gt.reshape(-1, 3, 4)
        R0, t0 = gt[i, :, :3], gt[i, :, 3]
        R1, t1 = gt[i + 1, :, :3], gt[i + 1, :, 3]
        # frame-1 -> frame-0: x0 = R0^T (R1 x1 + t1 - t0)
        Rg = R0.T @ R1
        tg = R0.T @ (t1 - t0)
        out.append((s0, m0, s1, m1, Rg, tg))
    return out


def evaluate(tag: str, respond_net, encoder, cfg: PipelineConfig,
             n_pairs: int, seed0: int = 900, hard: bool = False, *,
             samples=None):
    """Held-out pair registration quality (scenes unseen in training) of
    the modules ``respond_net`` and ``encoder``, on their device.  Pair
    ``i``'s RANSAC draws come from ``torch.Generator`` seed ``i``, or from
    ``samples(i)`` (an ``(H, S)`` array; the parity tests' seam)."""
    dev = next(respond_net.parameters()).device
    on = lambda a: torch.as_tensor(a).to(dev)
    stats = {"success": [], "rot_err_deg": [], "t_err_m": [],
             "inlier_ratio": []}
    hard_set = _hard_pairs(n_pairs, cfg) if hard else None
    for i in range(n_pairs):
        if hard:
            s0, m0, s1, m1, R_gt, t_gt = hard_set[i]
        else:
            s0, m0, s1, m1, R_gt, t_gt = synthetic_scan_pair(
                seed=seed0 + i, cfg=cfg,
                angle_deg=float(np.random.default_rng(i).uniform(0.5, 3.0)),
            )
        f0 = extract_frame_features(respond_net, encoder, on(s0), on(m0), cfg)
        f1 = extract_frame_features(respond_net, encoder, on(s1), on(m1), cfg)
        reg = register_pair(
            f0, f1, cfg, generator=torch.Generator(dev).manual_seed(i),
            samples=None if samples is None else on(samples(i)))
        R, t = reg.R.double().cpu().numpy(), reg.t.double().cpu().numpy()
        cosang = (np.trace(R.T @ R_gt) - 1) / 2
        rot_err = float(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
        t_err = float(np.linalg.norm(t - t_gt))
        n_valid = int(f1.mask.sum())
        stats["success"].append(bool(reg.success))
        stats["rot_err_deg"].append(rot_err)
        stats["t_err_m"].append(t_err)
        stats["inlier_ratio"].append(int(reg.n_inliers) / max(n_valid, 1))
    ok = np.array(stats["success"])
    summary = {
        "tag": tag + ("/hard" if hard else "/easy"),
        "n_pairs": n_pairs,
        "success_rate": float(ok.mean()),
        "rot_err_deg_mean": float(np.mean(stats["rot_err_deg"])),
        "t_err_m_mean": float(np.mean(stats["t_err_m"])),
        "inlier_ratio_mean": float(np.mean(stats["inlier_ratio"])),
    }
    print(json.dumps(summary), flush=True)
    return summary


def run(args, cfg: PipelineConfig) -> int:
    device = _device(args)
    if args.eval_only:
        respond_t, encoder_t = weights_io.load_trained(args.eval_only)
        l2 = l3 = [float("nan"), float("nan")]
    else:
        stream_fn = None
        if args.hard_caches:
            paths = [p for p in args.hard_caches.split(",") if p]
            stream_fn = lambda seed: cached_scan_stream(paths,
                                                        shuffle_seed=seed)
        respond_t, encoder_t, l2, l3 = train_both(
            cfg, args.steps2d, args.steps3d, args.out,
            scan_stream_fn=stream_fn, plateau_window=args.plateau,
            device=device)
        print(f"respond loss {l2[0]:.5f} -> {l2[-1]:.5f} "
              f"({len(l2)} steps); patch loss {l3[0]:.5f} -> {l3[-1]:.5f} "
              f"({len(l3)} steps)", flush=True)

    # trained checkpoints use the training activations (relu convs + linear
    # code); the shipped artifact is tanh (see models/patch_encoder.py)
    cfg_trained = dataclasses.replace(
        cfg, encoder_activation="relu", encoder_code_activation="linear")
    nets = weights_io.build_models_from_state_dicts(respond_t, encoder_t,
                                                    device, cfg_trained)
    results = [evaluate("trained-from-scratch", *nets, cfg_trained,
                        args.pairs)]
    if args.hard_pairs:
        results.append(evaluate("trained-from-scratch", *nets, cfg_trained,
                                args.hard_pairs, hard=True))
    if weights_io.reference_models_available():
        shipped = weights_io.build_models(
            weights_io.load_respond_layer_params(),
            weights_io.load_patch_encoder_params(), device, cfg)
        results.append(evaluate("shipped-reference", *shipped, cfg,
                                args.pairs))
        if args.hard_pairs:
            results.append(evaluate("shipped-reference", *shipped, cfg,
                                    args.hard_pairs, hard=True))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "study.json"), "w") as f:
        json.dump({"results": results,
                   "loss2d": [l2[0], l2[-1]],
                   "loss3d": [l3[0], l3[-1]]}, f, indent=1)
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps2d", type=int, default=300)
    ap.add_argument("--steps3d", type=int, default=400)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--hard-pairs", type=int, default=8,
                    help="also score on hard ray-cast pairs (0 = skip)")
    ap.add_argument("--out", default="runs/scratch")
    ap.add_argument("--eval-only", default="",
                    help="skip training; load respond_ae/patch_ae "
                         "checkpoints from this directory")
    ap.add_argument("--hard-caches", default="",
                    help="comma-separated hard-benchmark scan caches "
                         "(.npz) to TRAIN on: the hard-circuit "
                         "distribution incl. degraded bursts; with "
                         "--plateau the loops run to a loss-plateau "
                         "convergence criterion")
    ap.add_argument("--plateau", type=int, default=0,
                    help="plateau window (steps); 0 = fixed step counts")
    _add_common(ap)
    return ap


def main(argv=None) -> int:
    return run(parser().parse_args(argv), PipelineConfig())


if __name__ == "__main__":
    sys.exit(main())
