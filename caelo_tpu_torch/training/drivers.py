"""Training drivers: data pipelines and step loops for both auto-encoders
(port of ``caelo_tpu/training/drivers.py``).

Scans come from the synthetic scene generator (``--synthetic``, no dataset),
from on-disk benchmark caches, or from a KITTI tree.  Each scan is projected
on the device; the patch pipeline also runs the respond net, keypoint
selection (K1) and the 3-scale patch query (K2) there, as the front end
does, so the encoder trains on patches anchored where it will describe
them (``AE4VoxelPatch.py:66``, ``RandDataSource=1``).  The patch draws are
numpy's ``rng.choice``, as in the JAX package.
"""
from __future__ import annotations

import os
import time
from typing import Iterator

import numpy as np
import torch

from .. import setup_device
from ..config import PipelineConfig
from ..data.synthetic import make_scene, range_filter, sample_scene_points
from ..models import weights_io
from ..models.patch_encoder import VoxelPatchAE
from ..models.respond_net import RespondLayer, SphericalRingAE
from ..ops.masking import pad_points
from ..ops.nms import select_keypoints_planes
from ..projection.spherical import model_input, project_to_spherical_ring
from ..utils.telemetry import MetricsLog, StageTimer
from ..voxel.grid import extract_patches, voxelize
from .train import (TrainState, adam, create_train_state, make_train_step,
                    patch_loss, respond_loss)


# ----------------------------------------------------------------- data feeds
def synthetic_scan_stream(cfg: PipelineConfig, seed: int = 0
                          ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Endless padded scans: a new scene every 4 scans, the sensor at a
    random offset in each."""
    rng = np.random.default_rng(seed)
    i = 0
    while True:
        scene = make_scene(seed=seed + i // 4)
        world = sample_scene_points(scene, seed=seed + i, n_points=cfg.max_points)
        t = rng.uniform(-5, 5, 3) * np.array([1, 1, 0.02])
        local = range_filter((world - t).astype(np.float32), cfg.sensor)
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        yield pad_points(np.concatenate([local, refl], 1), cfg.max_points)
        i += 1


def cached_scan_stream(npz_paths, shuffle_seed: int = 0
                       ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Cycle scans from on-disk benchmark caches (``.npz`` files with
    ``pts``/``msk`` stacks), in shuffled order, reshuffled per pass: training
    on the ray-cast circuit without ray casting per step."""
    rng = np.random.default_rng(shuffle_seed)
    stacks = []
    for p in npz_paths:
        z = np.load(p)
        stacks.append((z["pts"], z["msk"]))
    n_total = sum(s[0].shape[0] for s in stacks)
    while True:
        order = rng.permutation(n_total)
        bounds = np.cumsum([0] + [s[0].shape[0] for s in stacks])
        for g in order:
            si = int(np.searchsorted(bounds, g, side="right") - 1)
            i = int(g - bounds[si])
            yield stacks[si][0][i], stacks[si][1][i]


def kitti_scan_stream(root: str, cfg: PipelineConfig, seqs=None
                      ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Cycle the scans of a KITTI tree's sequences (all by default)."""
    from ..data.kitti import KittiOdometry

    ds = KittiOdometry(root, cfg)
    seqs = seqs or sorted(os.listdir(os.path.join(root, "sequences")))
    while True:
        for seq in seqs:
            for scan, mask in ds.iter_scans(seq):
                yield scan, mask


def respond_batches(scan_stream, cfg: PipelineConfig, batch: int,
                    device="cuda"):
    """Batches of ``(B, 3, n_lines, model_w)`` ring-image inputs on
    ``device``, NCHW (the AE trains on the x, y, z channels,
    ``AE4SphericalRingPC.py:66-75``)."""
    device = setup_device(device)
    buf = []
    for pts, mask in scan_stream:
        img, _ = project_to_spherical_ring(torch.as_tensor(pts).to(device),
                                           torch.as_tensor(mask).to(device),
                                           cfg.sensor)
        buf.append(model_input(img, cfg.sensor).permute(2, 0, 1))
        if len(buf) == batch:
            yield torch.stack(buf)
            buf = []


@torch.no_grad()
def scan_patches(respond_net, pts: torch.Tensor, mask: torch.Tensor,
                 cfg: PipelineConfig):
    """One scan's keypoint-anchored patches: projection, respond planes,
    keypoint selection (K1), voxel pyramid and the 3-scale patch query
    (K2).  Returns the three ``(n, 16, 16, 16)`` stacks of the valid
    keypoints."""
    img, counter = project_to_spherical_ring(pts, mask, cfg.sensor)
    planes = respond_net(model_input(img, cfg.sensor).permute(2, 0, 1)[None])[0]
    key_pts, _, key_mask, _ = select_keypoints_planes(
        img, counter, planes, cfg.sensor, cfg.keypoint)
    pyr = voxelize(pts[:, :3], mask, cfg.voxel)
    patches = extract_patches(key_pts, key_mask, pyr, cfg.voxel)
    valid = key_mask.nonzero()[:, 0]
    return [p[valid] for p in patches]


def patch_batches(scan_stream, cfg: PipelineConfig, batch: int,
                  respond_net: RespondLayer | None = None, seed: int = 0,
                  device="cuda"):
    """Batches of ``(B, 16, 16, 16)`` occupancy patches on ``device``,
    anchored at detected keypoints across the 3 scales
    (``AE4VoxelPatch.py:58-133``): per scan and scale, ``min(batch, n)`` of
    its ``n`` valid patches drawn without replacement by numpy's
    ``rng.choice``.  ``respond_net`` defaults to the shipped respond layer
    when its ``.h5`` is present, else to ``random_flax_params(0)``'s."""
    device = setup_device(device)
    if respond_net is None:
        params = (weights_io.load_respond_layer_params()
                  if weights_io.reference_models_available()
                  else weights_io.random_flax_params(0)[0])
        respond_net = RespondLayer()
        respond_net.load_state_dict(weights_io.respond_params_to_torch(params))
    respond_net = respond_net.to(device).eval()
    rng = np.random.default_rng(seed)
    P = cfg.voxel.patch_size
    buf = torch.zeros((0, P, P, P), device=device)
    for pts, mask in scan_stream:
        for ps in scan_patches(respond_net, torch.as_tensor(pts).to(device),
                               torch.as_tensor(mask).to(device), cfg):
            if ps.shape[0]:
                take = rng.choice(ps.shape[0], min(batch, ps.shape[0]),
                                  replace=False)
                buf = torch.cat([buf, ps[torch.as_tensor(take, device=device)]])
        while buf.shape[0] >= batch:
            yield buf[:batch]
            buf = buf[batch:]


# ----------------------------------------------------------------- main loops
def _run_loop(state: TrainState, step_fn, batches, n_steps: int, tag: str,
              timer: StageTimer | None = None):
    """``n_steps`` steps (all of ``batches`` if negative); ``timer`` times
    each batch's making (stage "data") apart from its step ("step"), the
    device synchronised at both ends of each."""
    timer = timer or StageTimer(sync=True)
    t0 = time.time()
    loss = float("nan")
    batches = iter(batches)
    i = 0
    while n_steps < 0 or i < n_steps:
        with timer.stage("data"):
            batch = next(batches, None)
        if batch is None:
            break
        with timer.stage("step"):
            state, loss = step_fn(state, batch)
        if i % 10 == 0:
            print(f"{tag} step {i}: loss={float(loss):.5f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
        i += 1
    return state, float(loss)


def _train(args, tag: str, model, loss_fn, batches_fn) -> int:
    """Train ``model`` on ``args``' scan source and save its checkpoint and
    a ``train`` record (steps, final loss, mean data and step ms) in
    ``<out>/train_metrics.jsonl``."""
    device = setup_device(getattr(args, "platform", "cuda"))
    cfg = PipelineConfig()
    model = model.to(device)
    state = create_train_state(model, adam(model.parameters(), args.lr))
    stream = (synthetic_scan_stream(cfg) if args.synthetic
              else kitti_scan_stream(args.data, cfg))
    n_steps = args.steps if args.steps > 0 else args.epochs * 100
    timer = StageTimer(sync=True)
    state, loss = _run_loop(state, make_train_step(loss_fn),
                            batches_fn(stream, cfg, args.batch, device=device),
                            n_steps, tag, timer)
    weights_io.save_checkpoint(args.out, state.module.state_dict())
    ms = {f"{k}_ms": v["mean_ms"] for k, v in timer.summary().items()}
    MetricsLog(os.path.join(args.out, "train_metrics.jsonl")).log(
        "train", model=tag, steps=state.step, final_loss=loss,
        device=str(device), **ms)
    print(f"final loss {loss:.5f} after {state.step} steps (mean ms {ms}); "
          f"saved to {args.out}")
    return 0


def train_respond_main(args) -> int:
    """Train ``SphericalRingAE`` from ``random_ae_params(0)``'s weights."""
    model = SphericalRingAE()
    model.load_state_dict(weights_io.spherical_ae_params_to_torch(
        weights_io.random_ae_params(0)[0]))
    return _train(args, "respond", model, respond_loss, respond_batches)


def train_patch_main(args) -> int:
    """Train ``VoxelPatchAE`` from ``random_ae_params(0)``'s weights."""
    model = VoxelPatchAE()
    model.load_state_dict(weights_io.voxel_ae_params_to_torch(
        weights_io.random_ae_params(0)[1]))
    return _train(args, "patch", model, patch_loss, patch_batches)
