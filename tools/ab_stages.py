"""Time the keypoint selection, the patch query and the warm 16-frame window
of the port in the checkout ROOT, on one CUDA card, and split the window by
stage.

    python3 tools/ab_stages.py ROOT

ROOT is a checkout of this repository; its own ``caelo_tpu_torch`` and
``chip_smoke.py`` are imported, so two trees compare by running this once
per tree, in turns, within one machine session (A, B, B, A).

Inputs: ``chip_smoke.py``'s 17 synthetic scans at the tree's default
``PipelineConfig()``, random weights from seed 0.  Per frame, on frame 0:
``select_keypoints_planes`` and ``extract_patches`` as the tree's default
config runs them (CUDA events over 50 calls after one warm call).  Then the
warm window of ``make_sequence_processor`` (7 synchronised calls, host
wall clock), and the same window's work stage by stage (projection, respond
net, saliency + NMS, voxelize, patch query, encoder per frame, then the
batched pair registration), each stage synchronised at both ends, summed
over the window, median of 3 warm runs.  Prints the times, their medians,
the split and its shares, and the card's nvidia-smi name and power limit.
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
from caelo_tpu_torch.frontend.odometry import (  # noqa: E402
    make_sequence_processor)
from caelo_tpu_torch.frontend.registration import (  # noqa: E402
    FrameFeatures, register_pair, stack_features)
from caelo_tpu_torch.models.weights_io import (  # noqa: E402
    build_models, random_flax_params)
from caelo_tpu_torch.ops.nms import select_keypoints_planes  # noqa: E402
from caelo_tpu_torch.projection.spherical import (  # noqa: E402
    model_input, project_to_spherical_ring)
from caelo_tpu_torch.utils.telemetry import StageTimer  # noqa: E402
from caelo_tpu_torch.voxel.grid import extract_patches, voxelize  # noqa: E402

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


def window_split(net, enc, pts, msk, cfg, gen):
    """The window's work (``make_sequence_processor``'s, without the
    motion-prior retry, which runs only after a failed pair) stage by
    stage: ``{stage: ms summed over the window}``."""
    timer = StageTimer(sync=True)
    feats = []
    for b in range(pts.shape[0]):
        with timer.stage("projection"):
            image, counter = project_to_spherical_ring(pts[b], msk[b],
                                                       cfg.sensor)
        with timer.stage("respond net"):
            planes = net(model_input(image, cfg.sensor).permute(2, 0, 1)[None]
                         )[0]
        with timer.stage("saliency + NMS"):
            kpts, kpix, kmask, _ = select_keypoints_planes(
                image, counter, planes, cfg.sensor, cfg.keypoint)
        with timer.stage("voxelize"):
            pyr = voxelize(pts[b][:, :3], msk[b], cfg.voxel)
        with timer.stage("patch query"):
            patches = extract_patches(kpts, kmask, pyr, cfg.voxel)
        with timer.stage("encoder"):
            K, ck = patches[0].shape[0], cfg.encoder_chunk
            stacked = torch.cat(patches, 0)
            codes = (torch.cat([enc(c) for c in stacked.split(ck)])
                     if ck and stacked.shape[0] > ck
                     and stacked.shape[0] % ck == 0 else enc(stacked))
            desc = torch.cat([codes[i * K:(i + 1) * K]
                              for i in range(len(patches))], -1)
            desc = torch.where(kmask[:, None], desc, 0.0)
        feats.append(FrameFeatures(kpts, desc, kmask, kpix))
    with timer.stage("register pairs"):
        f = stack_features(feats)
        register_pair(FrameFeatures(*(x[:-1] for x in f)),
                      FrameFeatures(*(x[1:] for x in f)), cfg, generator=gen)
    return {k: v["total_s"] * 1e3 for k, v in timer.summary().items()}


@torch.no_grad()
def main():
    if not torch.cuda.is_available():
        raise SystemExit("ab_stages: no CUDA device")
    dev = setup_device("cuda:0")
    _build.load_library()
    cfg = PipelineConfig()
    scans = chip_smoke.make_scans(cfg)
    net, enc = build_models(*random_flax_params(0), dev, cfg)

    pts0 = torch.from_numpy(scans[0][0]).to(dev)
    msk0 = torch.from_numpy(scans[0][1]).to(dev)
    image0, counter0 = project_to_spherical_ring(pts0, msk0, cfg.sensor)
    planes0 = net(model_input(image0, cfg.sensor).permute(2, 0, 1)[None])[0]
    kpts, _, kmask, _ = select_keypoints_planes(image0, counter0, planes0,
                                                cfg.sensor, cfg.keypoint)
    pyr = voxelize(pts0[:, :3], msk0, cfg.voxel)
    sel = chip_smoke.cuda_ms(lambda: select_keypoints_planes(
        image0, counter0, planes0, cfg.sensor, cfg.keypoint), 50)
    ext = chip_smoke.cuda_ms(lambda: extract_patches(kpts, kmask, pyr,
                                                     cfg.voxel), 50)

    process = make_sequence_processor(cfg)
    pts_w = torch.stack([torch.from_numpy(s[0]) for s in scans[:WINDOW]]
                        ).to(dev)
    msk_w = torch.stack([torch.from_numpy(s[1]) for s in scans[:WINDOW]]
                        ).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    win = wall_ms(lambda: process(net, enc, pts_w, msk_w, gen), 7)
    window_split(net, enc, pts_w, msk_w, cfg, gen)
    splits = [window_split(net, enc, pts_w, msk_w, cfg, gen)
              for _ in range(3)]
    split = {k: float(np.median([sp[k] for sp in splits]))
             for k in splits[0]}
    total = sum(split.values())

    print(f"tree {ROOT}: use_pallas_nms {cfg.keypoint.use_pallas_nms}, "
          f"use_pallas_plane_gather {cfg.voxel.use_pallas_plane_gather}")
    print(f"select_keypoints_planes per frame {sel:.4f} ms; extract_patches "
          f"per frame {ext:.4f} ms (CUDA events, mean of 50)")
    print(f"warm {WINDOW}-frame window: {[round(t, 3) for t in win]} ms, "
          f"median {np.median(win):.3f} ms")
    print(f"window split, ms summed over the window (median of 3), share: "
          + ", ".join(f"{k} {v:.3f} ({v / total:.1%})"
                      for k, v in split.items())
          + f"; sum {total:.3f} ms")
    print(f"card: {chip_smoke.nvidia_smi_line()}", flush=True)


if __name__ == "__main__":
    main()
