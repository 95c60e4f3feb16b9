"""Profile one train step of each auto-encoder at full width on one CUDA
device: the respond AE on a batch of 16 synthetic ring images (3, 64,
1792), the patch AE on a batch of 256 keypoint-anchored patches, both from
the trainers' own data pipelines (``training/drivers.py``), float32 with
TF32 off, at ``random_ae_params(0)``.

    python3 tools/prof_train.py          # from the repo root, one CUDA card

Prints, per AE: ms per step by CUDA events over 10 steps after 3 warm ones,
with cuDNN's default algorithm choice and with ``cudnn.benchmark`` on; the
kernel time per step of 3 profiled steps and their kernels by device time
(``torch.profiler``); and the card's nvidia-smi name and power limit beside
every time.  Fails without a CUDA device.
"""
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from caelo_tpu_torch import setup_device  # noqa: E402
from caelo_tpu_torch.config import PipelineConfig  # noqa: E402
from caelo_tpu_torch.models import weights_io  # noqa: E402
from caelo_tpu_torch.models.patch_encoder import VoxelPatchAE  # noqa: E402
from caelo_tpu_torch.models.respond_net import SphericalRingAE  # noqa: E402
from caelo_tpu_torch.training import drivers  # noqa: E402
from caelo_tpu_torch.training.train import (  # noqa: E402
    adam, create_train_state, make_train_step, patch_loss, respond_loss)

WARM, TIMED, PROFILED = 3, 10, 3


def step_ms(state, step, batch, n):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        state, _ = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return state, start.elapsed_time(end) / n


def main():
    if not torch.cuda.is_available():
        raise SystemExit("prof_train: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = setup_device("cuda:0")
    cfg = PipelineConfig()
    t0 = time.perf_counter()
    batch_r = next(drivers.respond_batches(
        drivers.synthetic_scan_stream(cfg, seed=1), cfg, 16, device=dev))
    batch_p = next(drivers.patch_batches(
        drivers.synthetic_scan_stream(cfg, seed=1), cfg, 256, device=dev))
    torch.cuda.synchronize()
    print(f"batches {tuple(batch_r.shape)}, {tuple(batch_p.shape)} made in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    sph, vox = weights_io.random_ae_params(0)
    for tag, model, params, conv, loss_fn, batch in (
            ("respond", SphericalRingAE(), sph,
             weights_io.spherical_ae_params_to_torch, respond_loss, batch_r),
            ("patch", VoxelPatchAE(), vox, weights_io.voxel_ae_params_to_torch,
             patch_loss, batch_p)):
        times = {}
        for bench in (False, True):
            torch.backends.cudnn.benchmark = bench
            model.load_state_dict(conv(params))
            model.to(dev)
            state = create_train_state(model, adam(model.parameters()))
            step = make_train_step(loss_fn)
            state, _ = step_ms(state, step, batch, WARM)
            state, ms = step_ms(state, step, batch, TIMED)
            times[bench] = ms
            print(f"{tag} AE step, batch {tuple(batch.shape)}, "
                  f"cudnn.benchmark={bench}: {ms:.3f} ms; {card}", flush=True)
        torch.backends.cudnn.benchmark = False
        model.load_state_dict(conv(params))
        state = create_train_state(model, adam(model.parameters()))
        state, _ = step_ms(state, step, batch, WARM)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            for _ in range(PROFILED):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
        # the kernels themselves: an operator's row repeats its kernels' time
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in events)
        events.sort(key=lambda e: -e.self_device_time_total)
        # against the step time by events: the profiler's own start-up lies
        # inside its window, so its wall time says nothing of the step
        print(f"{tag} AE, {PROFILED} profiled steps: kernel time "
              f"{busy_us / PROFILED / 1e3:.3f} ms per step (the step takes "
              f"{times[False]:.3f} ms by CUDA events); {card}")
        for e in events[:12]:
            print(f"  {e.self_device_time_total / PROFILED / 1e3:9.3f} ms/step "
                  f"{e.count // PROFILED:4d} calls/step  {e.key[:100]}")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
