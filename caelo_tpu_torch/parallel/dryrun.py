"""Multi-rank dry run of every sharded path (the port's counterpart of
``__graft_entry__.py::dryrun_multichip``).

    python -m caelo_tpu_torch.parallel.dryrun 4     # 4 NCCL ranks, 4 cards
    python -m caelo_tpu_torch.parallel.dryrun 4 --platform cpu  # 4 gloo ranks

``dryrun_multigpu(n_ranks)`` spawns ``n_ranks`` ranks (NCCL, one a CUDA
device, by default; ``device_type="cpu"``: gloo ranks on the CPU) and
runs, on ``tiny_test_config`` inputs made from a seed with numpy
(``dryrun_inputs``), each sharded path once, checking it in rank 0 against
the port's one-device function:

* ``train``: two data-parallel patch-AE steps on a flat mesh, and a DP +
  TP step (the dense layers over ``"model"`` when the world splits in two)
  after a one-device step, losses within rtol 1e-5 of two
  ``make_train_step`` steps;
* ``extract``: the data-parallel feature extractor, one frame per data
  rank, bit-identical to ``extract_frame_features``;
* ``halo``: the ring halo exchange, ``left_last`` exact and the chain
  residual within rtol 1e-6 of its float64 value;
* ``posegraph``: ``optimize_sharded`` on a noisy square with a loop edge
  against ``optimize``: translations within 1e-2 and a finite cost, as
  ``dryrun_multichip`` holds it (the loop leaves a cost of ~2e-3, which
  the float32 CG reaches in another summation order);
* ``window``: one window of ``make_sequence_processor`` per data rank
  (the window axis over ``"data"``, the same frames and draws in each),
  every rank's registrations bit-identical to the one-device window;
* ``icp``: ``make_sharded_icp_fn`` on 10 spans, through
  ``refine_odometry_batched`` and through the pipeline's
  ``stage_refinement``, bit-identical to ``make_batched_icp_fn`` at the
  same span batch;
* ``sc``: the row-sharded ScanContext correlation, bit-identical to
  ``sc_correlation_matrix``.

(``mesh`` reports the meshes' shapes.)  The worker functions live at
module level so that the spawned ranks can
import them; ``sharded_paths`` returns the gathered results for a caller
(the parity tests hold them to the JAX package's sharded functions).
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..backend import refine
from ..backend.posegraph import PoseGraph, optimize, optimize_sharded
from ..backend.refine_runner import RefinementFeatures, make_batched_icp_fn
from ..backend.scancontext import sc_correlation_matrix, sc_row_block
from ..config import tiny_test_config
from ..data.synthetic import synthetic_scan_pair
from ..frontend.registration import extract_frame_features
from ..models import weights_io
from ..models.patch_encoder import VoxelPatchAE
from ..pipeline import _pose_fns, stage_refinement
from ..training.train import (adam, create_train_state,
                              make_sharded_train_step, make_train_step,
                              patch_loss, shard_train_state)
from .mesh import (all_gather_rows, make_mesh, run_ranks, shard_rows,
                   world_mesh)
from .pipeline import (make_batched_feature_extractor, make_sequence_processor,
                       make_sharded_icp_fn, make_sharded_sc_correlation,
                       neighbor_pose_exchange)

PATHS = ("mesh", "train", "extract", "halo", "posegraph", "window", "icp",
         "sc")
SPANS_PER_DEVICE = 4
WINDOW_FRAMES = 4
# the sharded pose graph's cost against the one-device solve's: the float32
# sums over 4 ranks read 1e-3 to 2e-3 off it on the square graph, while a
# cost summed over one rank's edges alone reads over 60 % off
POSEGRAPH_COST_RTOL = 5e-3


def n_model_of(n_ranks: int) -> int:
    """The model size of the DP + TP mesh: 2 where the world splits in two
    halves of at least 2 ranks, else 1 (as ``dryrun_multichip``)."""
    return 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1


def square_graph(n_ranks: int, n_nodes: int = 13, seed: int = 0):
    """``dryrun_multichip``'s pose graph: a drifted odometry chain round a
    square with one loop edge, padded with weight-0 edges to a multiple of
    ``n_ranks``; numpy float32 ``(R0, t0, fields of PoseGraph)``."""
    prng = np.random.default_rng(seed)
    yaw = np.zeros(n_nodes)
    yaw[3:] = np.cumsum(np.where(np.arange(3, n_nodes) % 3 == 0,
                                 np.pi / 2, 0))
    gt_R = np.stack([np.array([[np.cos(a), -np.sin(a), 0],
                               [np.sin(a), np.cos(a), 0], [0, 0, 1]])
                     for a in yaw])
    gt_t = np.zeros((n_nodes, 3))
    for i in range(1, n_nodes):
        gt_t[i] = gt_t[i - 1] + gt_R[i - 1] @ np.array([2.0, 0, 0])
    rel_R = np.einsum("nji,njk->nik", gt_R[:-1], gt_R[1:])
    rel_t = np.einsum("nji,nj->ni", gt_R[:-1], gt_t[1:] - gt_t[:-1])
    rel_t += prng.normal(0, 0.05, rel_t.shape)
    E = n_nodes                                  # n_nodes - 1 odometry + loop
    pad = (-E) % n_ranks
    f32 = lambda a: np.asarray(a, np.float32)
    graph = dict(
        edge_i=np.concatenate([np.arange(n_nodes - 1), [0], np.zeros(pad)]
                              ).astype(np.int32),
        edge_j=np.concatenate([np.arange(1, n_nodes), [n_nodes - 1],
                               np.zeros(pad)]).astype(np.int32),
        rel_R=f32(np.concatenate([rel_R, (gt_R[0].T @ gt_R[-1])[None],
                                  np.tile(np.eye(3), (pad, 1, 1))])),
        rel_t=f32(np.concatenate([rel_t, (gt_R[0].T @ (gt_t[-1] - gt_t[0]))
                                  [None], np.zeros((pad, 3))])),
        weight=f32(np.concatenate([np.ones(E), np.zeros(pad)])),
        rot_info=f32(np.concatenate([np.full(E - 1, 100.0), [100.0],
                                     np.zeros(pad)])))
    R0, t0 = [np.eye(3)], [np.zeros(3)]
    for i in range(n_nodes - 1):
        R0.append(R0[-1] @ rel_R[i])
        t0.append(R0[-2] @ rel_t[i] + t0[-1])
    return f32(np.stack(R0)), f32(np.stack(t0)), graph


def icp_case(cfg, n_frames: int = 8, seed: int = 3):
    """``dryrun_multichip``'s refinement case: one base cloud and a planar
    floor moved 0.8 m a frame, and drifted odometry poses; numpy
    ``(RefinementFeatures fields, poses (n, 12))``."""
    rr = np.random.default_rng(seed)
    E, Pl = cfg.icp.max_points, cfg.icp.max_planar
    base = rr.uniform(-20, 20, (E, 3)).astype(np.float32)
    plb = rr.uniform(-10, 10, (Pl, 3)).astype(np.float32)
    plb[:, 2] = 0.0
    nrm = np.tile(np.array([0, 0, 1], np.float32), (Pl, 1))
    step = lambda i: np.array([0.8 * i, 0.0, 0.0], np.float32)
    feats = dict(
        ext_pts=np.stack([base + step(i) for i in range(n_frames)]),
        ext_mask=np.ones((n_frames, E), bool),
        planar=np.stack([np.concatenate([plb + step(i), nrm], 1)
                         for i in range(n_frames)]),
        planar_mask=np.ones((n_frames, Pl), bool))
    poses, tr = [], np.zeros(3)
    for _ in range(n_frames):
        poses.append(np.concatenate([np.eye(3), tr.reshape(3, 1)], 1)
                     .reshape(12))
        tr = tr + np.array([-0.8, 0.0, 0.0]) + rr.normal(0, 0.02, 3)
    return feats, np.stack(poses)


def dryrun_inputs(n_ranks: int, device_type: str = "cuda", seed: int = 0
                  ) -> dict:
    """The numpy inputs of every path for a world of ``n_ranks`` on
    ``device_type`` (one ScanContext row block a rank)."""
    cfg = tiny_test_config()
    rng = np.random.default_rng(seed)
    scans = [synthetic_scan_pair(s, cfg)[:2] for s in range(n_ranks)]
    s0, m0, s1, m1 = synthetic_scan_pair(seed, cfg)[:4]
    poses = np.cumsum(rng.normal(0, 1, (4 * n_ranks, 12)), 0)
    R0, t0, graph = square_graph(n_ranks)
    feats, ref_poses = icp_case(cfg)
    span_i = np.array([0, 1, 2, 3, 4, 5, 6, 0, 2, 4], np.int32)
    span_j = np.array([1, 2, 3, 4, 5, 6, 7, 2, 4, 7], np.int32)
    rels = [_rel(ref_poses[i], ref_poses[j]) for i, j in zip(span_i, span_j)]
    return dict(
        respond=weights_io.random_flax_params(seed)[0],
        encoder=weights_io.random_flax_params(seed)[1],
        ae=weights_io.random_ae_params(seed)[1],
        ae_batch=(rng.uniform(size=(2 * n_ranks, 16, 16, 16)) < 0.2
                  ).astype(np.float32),
        pts=np.stack([p for p, _ in scans]),
        mask=np.stack([m for _, m in scans]),
        window_pts=np.stack([s0, s1] * (WINDOW_FRAMES // 2)),
        window_mask=np.stack([m0, m1] * (WINDOW_FRAMES // 2)),
        poses=poses.astype(np.float32),
        R0=R0, t0=t0, graph=graph,
        icp_feats=feats, icp_poses=ref_poses,
        icp_spans=(span_i, span_j, np.stack([R for R, _ in rels]),
                   np.stack([t for _, t in rels])),
        scs=rng.uniform(0, 8, (sc_row_block(device_type) * n_ranks, 16, 64)
                        ).astype(np.float32))


def _rel(p0, p1):
    P0 = np.asarray(p0, np.float64).reshape(3, 4)
    P1 = np.asarray(p1, np.float64).reshape(3, 4)
    return P0[:, :3].T @ P1[:, :3], P0[:, :3].T @ (P1[:, 3] - P0[:, 3])


def _apply(p0, R, t):
    P0 = np.asarray(p0, np.float64).reshape(3, 4)
    return np.concatenate([P0[:, :3] @ np.asarray(R),
                           (P0[:, :3] @ np.asarray(t) + P0[:, 3]
                            ).reshape(3, 1)], 1).reshape(12)


def _require(ok: bool, what: str):
    if not ok:
        raise AssertionError(f"dryrun: {what}")


def _np(x):
    if isinstance(x, tuple):
        return type(x)(*(_np(f) for f in x))
    return x.detach().cpu().numpy()


def _meshes(world, rank):
    """Dimension sizes and this rank's coordinate of the flat mesh, the
    DP + TP mesh and a mesh over the first rank alone; whether
    ``world_mesh`` gives the same mesh on a second call."""
    n_model = n_model_of(world)
    flat, tp = make_mesh(), make_mesh(n_data=world // n_model,
                                      n_model=n_model)
    first = make_mesh(n_data=1, ranks=[0])
    coordinate = lambda m: (None if m.get_coordinate() is None
                            else list(m.get_coordinate()))
    return dict(flat=tuple(flat.shape), tp=tuple(tp.shape),
                tp_coordinate=coordinate(tp),
                first_coordinate=coordinate(first),
                world_mesh_reused=world_mesh() is world_mesh())


def _train(inputs, world, rank, dev):
    """Two DP patch-AE steps on the flat mesh, and a one-device step then
    a DP + TP step on the ``n_model_of`` mesh, against two
    ``make_train_step`` steps on rank 0."""
    batch = torch.from_numpy(inputs["ae_batch"]).to(dev)
    state_dict = weights_io.voxel_ae_params_to_torch(inputs["ae"])

    def fresh():
        model = VoxelPatchAE().to(dev)
        model.load_state_dict(state_dict)
        return create_train_state(model, adam(model.parameters()))

    out = {}
    n_model = n_model_of(world)
    # DP from a fresh state; TP after one one-device step, so the shards
    # take the optimizer's moments with them
    flat = make_mesh()
    state = shard_train_state(fresh(), flat, tensor_parallel=False)
    step, _ = make_sharded_train_step(patch_loss, flat)
    out["dp"] = [float(step(state, batch)[1]) for _ in range(2)]
    state = fresh()
    out["tp"] = [float(make_train_step(patch_loss)(state, batch)[1])]
    mesh = make_mesh(n_data=world // n_model, n_model=n_model)
    state = shard_train_state(state, mesh, tensor_parallel=True)
    out["tp"].append(float(make_sharded_train_step(patch_loss, mesh)[0](
        state, batch)[1]))
    if rank == 0:
        state, step = fresh(), make_train_step(patch_loss)
        out["one_device"] = [float(step(state, batch)[1]) for _ in range(2)]
        for name in ("dp", "tp"):
            np.testing.assert_allclose(out[name], out["one_device"],
                                       rtol=1e-5, err_msg=name)
    return out


def _extract(inputs, world, rank, dev, nets, cfg):
    mesh = make_mesh()
    ex = make_batched_feature_extractor(mesh, cfg)
    pts = torch.from_numpy(inputs["pts"]).to(dev)
    mask = torch.from_numpy(inputs["mask"]).to(dev)
    feats = _np(ex(*nets, pts, mask, gather=True))
    if rank == 0:
        for b in range(pts.shape[0]):
            one = _np(extract_frame_features(*nets, pts[b], mask[b], cfg))
            _require(all(np.array_equal(a[b], o) for a, o in zip(feats, one)),
                     f"extractor frame {b} differs from the one-device "
                     "features")
    return feats


def _halo(inputs, world, rank, dev):
    mesh = make_mesh()
    poses = torch.from_numpy(inputs["poses"]).to(dev)
    total, left_last = neighbor_pose_exchange(mesh)(poses)
    left_all = _np(all_gather_rows(left_last[None], mesh))
    if rank == 0:
        p = inputs["poses"].astype(np.float64)
        want = float(((p[1:] - p[:-1]) ** 2).sum())
        K = len(p) // world
        lasts = p[K - 1::K].astype(np.float32)
        _require(np.array_equal(left_all, np.roll(lasts, 1, 0)),
                 "halo: a rank received another rank's pose than its left "
                 "neighbour's last")
        np.testing.assert_allclose(float(total), want, rtol=1e-6)
    return float(total), left_all


def _posegraph(inputs, world, rank, dev):
    mesh = make_mesh()
    R0 = torch.from_numpy(inputs["R0"]).to(dev)
    t0 = torch.from_numpy(inputs["t0"]).to(dev)
    graph = PoseGraph(*(torch.from_numpy(inputs["graph"][f]).to(dev)
                        for f in PoseGraph._fields))
    R, t, cost = optimize_sharded(mesh, n_nodes=len(R0), n_iters=4,
                                  cg_iters=40)(R0, t0, graph)
    out = dict(R=_np(R), t=_np(t), cost=float(cost))
    if rank == 0:
        _, t1, c1 = optimize(R0, t0, graph, n_iters=4, cg_iters=40)
        out["one_device"] = dict(t=_np(t1), cost=float(c1))
        _require(np.abs(out["t"] - out["one_device"]["t"]).max() < 1e-2,
                 "sharded pose graph: translations off the one-device solve")
        c1 = float(c1)
        _require(abs(out["cost"] - c1) <= POSEGRAPH_COST_RTOL * c1,
                 "sharded pose graph: cost off the one-device solve's")
    return out


def _window(inputs, world, rank, dev, nets, cfg):
    """One window per data rank, the windows' frames and RANSAC draws the
    same, so each rank's registrations must be the one-device window's."""
    mesh = make_mesh()
    process = make_sequence_processor(cfg)
    wpts = torch.from_numpy(np.stack([inputs["window_pts"]] * world)).to(dev)
    wmsk = torch.from_numpy(np.stack([inputs["window_mask"]] * world)).to(dev)

    def run(p, m):
        gen = torch.Generator(device=dev).manual_seed(1)
        _, regs = process(*nets, p, m, gen)
        return regs.R, regs.t, regs.success

    mine = [run(p, m) for p, m in zip(shard_rows(wpts, mesh),
                                      shard_rows(wmsk, mesh))]
    R, t, ok = all_gather_rows(tuple(torch.stack(x) for x in zip(*mine)),
                               mesh)
    if rank == 0:
        R1, t1, ok1 = run(wpts[0], wmsk[0])
        _require(all(torch.equal(R[w], R1) and torch.equal(t[w], t1)
                     and torch.equal(ok[w], ok1) for w in range(world)),
                 "a rank's window differs from the one-device window")
    return dict(R=_np(R), t=_np(t), success=_np(ok))


def _icp(inputs, world, rank, dev, cfg):
    mesh = make_mesh()
    feats = RefinementFeatures(*(torch.from_numpy(inputs["icp_feats"][f])
                                 .to(dev) for f in RefinementFeatures._fields))
    poses = inputs["icp_poses"]
    sharded = make_sharded_icp_fn(feats, mesh, cfg, SPANS_PER_DEVICE)
    p_shard, stats = refine.refine_odometry_batched(
        poses, sharded, _rel, _apply, cfg=cfg.refine)
    out = dict(poses=p_shard, refined=list(stats.refined),
               spans=sharded(*inputs["icp_spans"]))
    # the pipeline's refinement stage takes the sharded solves in a world
    # of several ranks (the camera frame is the LiDAR's: Tr = I)
    eye, zero = np.eye(3), np.zeros(3)
    p_stage, _ = stage_refinement(poses, feats, None, eye, zero, cfg)
    if rank == 0:
        one = make_batched_icp_fn(feats, cfg, chunk=SPANS_PER_DEVICE)
        p_one, _ = refine.refine_odometry_batched(
            poses, one, _rel, _apply, cfg=cfg.refine)
        # the stage shards the spans over several ranks, SPANS_PER_DEVICE
        # a rank, and solves them alone in a world of one
        stage_fn = one if world > 1 else make_batched_icp_fn(feats, cfg)
        p_stage_one, _ = refine.refine_odometry_batched(
            poses, stage_fn, *_pose_fns(eye, zero), cfg=cfg.refine)
        _require(np.array_equal(p_shard, p_one) and all(
            np.array_equal(a, b) for a, b in zip(
                out["spans"], one(*inputs["icp_spans"]))),
                 "sharded ICP differs from the one-device solves")
        _require(np.array_equal(p_stage, p_stage_one),
                 "stage_refinement in a world of ranks differs from the "
                 "one-device refinement")
    return out


def _sc(inputs, world, rank, dev):
    mesh = make_mesh()
    scs = torch.from_numpy(inputs["scs"]).to(dev)
    corr = make_sharded_sc_correlation(mesh)
    score, yaw = corr(scs, gather=True)
    lo, hi = corr.rows(scs)
    _require(all(torch.equal(a, b[lo:hi]) for a, b in zip(corr(scs),
                                                          (score, yaw))),
             "a rank's rows differ from its rows of the gathered matrices")
    out = dict(score=_np(score), yaw=_np(yaw))
    if rank == 0:
        s1, y1 = sc_correlation_matrix(scs)
        _require(torch.equal(score, s1) and torch.equal(yaw, y1),
                 "sharded ScanContext correlation differs from the "
                 "one-device matrix")
        out["one_device"] = dict(score=_np(s1), yaw=_np(y1))
    return out


def sharded_paths(rank: int, world: int, inputs: dict, paths=PATHS,
                  device_type: str = "cuda") -> dict:
    """One rank of the dry run: each of ``paths`` on ``inputs``
    (``dryrun_inputs``), checked in rank 0; returns each path's gathered
    result (numpy) and its seconds on this rank."""
    dev = torch.device(f"cuda:{rank}" if device_type == "cuda" else "cpu")
    cfg = tiny_test_config()
    nets = weights_io.build_models(inputs["respond"], inputs["encoder"], dev,
                                   cfg)
    run = dict(
        mesh=lambda: _meshes(world, rank),
        train=lambda: _train(inputs, world, rank, dev),
        extract=lambda: _extract(inputs, world, rank, dev, nets, cfg),
        halo=lambda: _halo(inputs, world, rank, dev),
        posegraph=lambda: _posegraph(inputs, world, rank, dev),
        window=lambda: _window(inputs, world, rank, dev, nets, cfg),
        icp=lambda: _icp(inputs, world, rank, dev, cfg),
        sc=lambda: _sc(inputs, world, rank, dev))
    out, seconds = {}, {}
    for name in paths:
        t0 = time.perf_counter()
        out[name] = run[name]()
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def dryrun_multigpu(n_ranks: int, device_type: str = "cuda") -> dict:
    """Spawn ``n_ranks`` ranks and run every sharded path once, each
    checked in rank 0 against its one-device function (a failed check
    raises); returns rank 0's summary."""
    inputs = dryrun_inputs(n_ranks, device_type)
    t0 = time.perf_counter()
    out = run_ranks(sharded_paths, n_ranks, device_type=device_type,
                    args=(inputs, PATHS, device_type))[0]
    return {
        "ranks": n_ranks, "device_type": device_type,
        "mesh_tp": [n_ranks // n_model_of(n_ranks), n_model_of(n_ranks)],
        "losses_dp": out["train"]["dp"], "losses_tp": out["train"]["tp"],
        "losses_one_device": out["train"]["one_device"],
        "chain_residual": out["halo"][0],
        "sharded_gn_cost": out["posegraph"]["cost"],
        "one_device_gn_cost": out["posegraph"]["one_device"]["cost"],
        "window_successes": int(out["window"]["success"].sum()),
        "refined_spans": len(out["icp"]["refined"]),
        "seconds_rank0": {k: round(v, 3) for k, v in out["seconds"].items()},
        "wall_s": round(time.perf_counter() - t0, 3)}


if __name__ == "__main__":
    import argparse
    import json

    from ..cli import _add_common

    ap = argparse.ArgumentParser(description="Run every sharded path on "
                                 "N ranks, each checked in rank 0.")
    ap.add_argument("ranks", type=int, nargs="?", default=4)
    _add_common(ap)     # cuda: NCCL ranks, one a card; cpu: gloo ranks
    args = ap.parse_args()
    device_type = torch.device(args.platform).type
    if device_type == "cuda" and torch.cuda.device_count() < args.ranks:
        sys.exit(f"dryrun: {args.ranks} NCCL ranks need {args.ranks} CUDA "
                 f"devices, found {torch.cuda.device_count()}; pass "
                 "--platform cpu for gloo ranks on the CPU")
    print(json.dumps(dryrun_multigpu(args.ranks, device_type)))
