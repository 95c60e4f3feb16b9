"""Where the encoder's time goes in float32 and in bfloat16, on one CUDA
card.

    python3 tools/prof_bf16.py

Inputs: ``chip_smoke.py``'s frame 0 at the default ``PipelineConfig()``,
random weights from seed 0: its 1,024 keypoints' patches at the three
scales, 3,072 (16, 16, 16) occupancy patches, encoded in chunks of
``encoder_chunk`` as the front end encodes them.  For each dtype (float32
with TF32 off; bfloat16 through ``run_in``, the front end's bfloat16 path):

* the whole encoder per frame and each layer alone on that layer's real
  input (CUDA events over 20 calls after a warm call, in turns float32,
  bfloat16, bfloat16, float32);
* the encoder under ``torch.profiler``: the five kernels with the most
  device time, and the device time in all.

Prints the card's nvidia-smi name and power limit.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.nn import functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from caelo_tpu_torch import _build, setup_device  # noqa: E402
from caelo_tpu_torch.config import PipelineConfig  # noqa: E402
from caelo_tpu_torch.frontend.registration import (  # noqa: E402
    extract_frame_features, run_in)
from caelo_tpu_torch.models.weights_io import (  # noqa: E402
    build_models, random_flax_params)
from caelo_tpu_torch.voxel.grid import extract_patches, voxelize  # noqa: E402

REPS = 20
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def layer_inputs(enc, x):
    """Each layer's input on the float32 forward of ``x (N, 16, 16, 16)``:
    ``[(name, module, input)]``."""
    h = x[:, None]
    out = []
    for name in ("conv1", "conv2", "conv3"):
        m = getattr(enc, name)
        out.append((name, m, h))
        h = torch.tanh(m(h))
        if name != "conv3":
            h = F.max_pool3d(h, 2)
    h = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)
    out.append(("fn1", enc.fn1, h))
    out.append(("fn2", enc.fn2, torch.tanh(enc.fn1(h))))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("prof_bf16: no CUDA device")
    smi = chip_smoke.nvidia_smi_line()
    dev = setup_device("cuda:0")
    _build.load_library()
    cfg = PipelineConfig()
    scans = chip_smoke.make_scans(cfg)
    net, enc = build_models(*random_flax_params(0), dev, cfg)
    pts = torch.from_numpy(scans[0][0]).to(dev)
    msk = torch.from_numpy(scans[0][1]).to(dev)
    with torch.no_grad():
        f = extract_frame_features(net, enc, pts, msk, cfg)
        stacked = torch.cat(extract_patches(
            f.key_pts, f.mask, voxelize(pts[:, :3], msk, cfg.voxel),
            cfg.voxel))
        chunks = stacked.split(cfg.encoder_chunk)
        whole = {k: [] for k in DTYPES}
        per_layer = {k: {} for k in DTYPES}
        for k in ("float32", "bfloat16", "bfloat16", "float32"):
            dt = DTYPES[k]
            whole[k].append(chip_smoke.cuda_ms(
                lambda: [run_in(enc, c, dt) for c in chunks], REPS))
            for name, m, h in layer_inputs(enc, chunks[0]):
                per_layer[k].setdefault(name, []).append(chip_smoke.cuda_ms(
                    lambda: run_in(m, h, dt), REPS))
        print(f"encoder per frame ({len(stacked)} patches, chunks of "
              f"{cfg.encoder_chunk}), ms: " + "; ".join(
                  f"{k} {[round(t, 4) for t in v]}" for k, v in whole.items())
              + f"; {smi}")
        for k, layers in per_layer.items():
            print(f"{k} per layer, one chunk of {len(chunks[0])}, ms: "
                  + ", ".join(f"{n} {np.mean(v):.4f}"
                              for n, v in layers.items()))
        for k, dt in DTYPES.items():
            fn = lambda: [run_in(enc, c, dt) for c in chunks]
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            events.sort(key=lambda e: -e.self_device_time_total)
            total = sum(e.self_device_time_total for e in events) / 1e3
            print(f"{k} profile: device time {total:.4f} ms; top kernels "
                  + "; ".join(f"{e.key[:70]} "
                              f"{e.self_device_time_total / 1e3:.4f} ms "
                              f"x{e.count}" for e in events[:5]))
    print(smi)


if __name__ == "__main__":
    main()
