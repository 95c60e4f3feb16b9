"""The frame-window processor and the sharded paths (port of
``caelo_tpu/parallel/pipeline.py``).

* ``make_sequence_processor``: extraction loops over the window's frames;
  the consecutive pairs register as one batch; the motion-prior retry runs
  only when some pair failed.
* ``make_batched_feature_extractor``: the frame axis over the mesh's
  ``"data"`` ranks, each extracting its own block of frames with
  ``extract_frame_features`` (the CUDA kernels run on every frame).
* ``make_sharded_icp_fn``: the keyframe-span ICP solves of
  ``refine_odometry_batched`` with the span axis over ``"data"``.
* ``make_sharded_sc_correlation``: the ScanContext correlation matrix with
  its query rows over ``"data"``.
* ``neighbor_pose_exchange``: a ring send of each rank's last pose (the
  halo) and the all-reduced squared chain residual.

The sharded functions are SPMD: every rank of the mesh calls them with the
same global arguments (``parallel/mesh.py``).  None reduces across ranks
but the halo's residual, so the extractor, ICP and correlation give the
bits of the one-device functions.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch
import torch.distributed as dist

from ..backend.refine_runner import (RefinementFeatures, _stacked,
                                     refine_pairs_batched)
from ..backend.refine_runner import stack_features as gather_frames
from ..backend.scancontext import sc_correlation_rows, sc_row_block
from ..config import PipelineConfig
from ..frontend.registration import (FrameFeatures, PairRegistration,
                                     extract_frame_features,
                                     extract_frame_features_full,
                                     register_pair, register_pair_with_prior,
                                     stack_features)
from ..utils.telemetry import span
from .mesh import (all_gather_rows, all_reduce_sum, axis, broadcast_module,
                   shard_rows)


def make_batched_feature_extractor(mesh, cfg: PipelineConfig = PipelineConfig()):
    """Returns ``fn(respond_net, encoder, pts (B, N, 4), mask (B, N),
    gather=False) -> FrameFeatures``: each data rank extracts its
    contiguous block of the B frames (B a multiple of the data size), frame
    by frame, and returns that block's features (leading axis B / n), or
    with ``gather`` the whole batch's (leading axis B) on every rank.

    The weights are replicated: a module's parameters are broadcast from
    the first data rank the first time the function sees the module, not
    on every call."""
    group, _, _ = axis(mesh)
    synced = weakref.WeakSet()

    def extract(respond_net, encoder, pts, mask, gather=False):
        for module in (respond_net, encoder):
            if module not in synced:
                broadcast_module(module, group)
                synced.add(module)
        p, m = shard_rows(pts, mesh), shard_rows(mask, mesh)
        feats = stack_features([
            extract_frame_features(respond_net, encoder, p[b], m[b], cfg)
            for b in range(p.shape[0])])
        return all_gather_rows(feats, mesh) if gather else feats

    return extract


def make_sequence_processor(cfg: PipelineConfig = PipelineConfig(),
                            with_refine: bool = False):
    """Returns ``process(respond_net, encoder, pts (B, N, 4), mask (B, N),
    generator=None, samples=None) -> (FrameFeatures batch of B,
    PairRegistration batch of B-1)``, or with ``with_refine`` ``->
    (FrameFeatures, RefinementFeatures, PairRegistration)``: the
    refinement features come from the same projection / respond / NMS
    results, with no second front-end pass.

    ``samples``, if given, is ``(pass1, pass2)``: ``(B-1, H, S)`` RANSAC
    pair indices for the plain pass and for the motion-prior retry.
    """
    extract = extract_frame_features_full if with_refine else (
        lambda *args: (extract_frame_features(*args), None))

    def process(respond_net, encoder, pts, mask, generator=None,
                samples=None):
        per_frame = [extract(respond_net, encoder, pts[b], mask[b], cfg)
                     for b in range(pts.shape[0])]
        feats = stack_features([f for f, _ in per_frame])
        f0 = FrameFeatures(*(x[:-1] for x in feats))
        f1 = FrameFeatures(*(x[1:] for x in feats))
        s1, s2 = (None, None) if samples is None else samples
        regs = register_pair(f0, f1, cfg, generator=generator, samples=s1)
        # motion-prior fallback: pair k retries with pair k-1's pass-1
        # result as a constant-velocity prior (identity for the window's
        # first pair and after a failure), kept only where pass 1 failed.
        # The JAX version hides the pass under lax.cond; here it is a host
        # check.
        if cfg.prior_gate_m > 0.0 and not bool(regs.success.all()):
            with span("caelo.register.retry"):
                eye = torch.eye(3, dtype=regs.R.dtype,
                                device=regs.R.device)[None]
                zero = torch.zeros_like(regs.t[:1])
                ok_prev = regs.success[:-1]
                prior_R = torch.cat([eye, torch.where(
                    ok_prev[:, None, None], regs.R[:-1], eye)])
                prior_t = torch.cat([zero, torch.where(
                    ok_prev[:, None], regs.t[:-1], zero)])
                regs2 = register_pair_with_prior(
                    f0, f1, prior_R, prior_t, cfg, generator=generator,
                    samples=s2)
                use2 = ~regs.success & regs2.success
                regs = PairRegistration(*(
                    torch.where(use2.view(-1, *[1] * (a.dim() - 1)), a, b)
                    for a, b in zip(regs2, regs)))
        if with_refine:
            ref_feats = RefinementFeatures(*(
                torch.stack(xs) for xs in zip(*(r for _, r in per_frame))))
            return feats, ref_feats, regs
        return feats, regs

    return process


def make_sharded_icp_fn(features, mesh, cfg: PipelineConfig = PipelineConfig(),
                        spans_per_device: int = 4):
    """Mesh-sharded drop-in for ``refine_runner.make_batched_icp_fn``: the
    keyframe-span hybrid-ICP solves of ``refine.refine_odometry_batched``
    with the span axis over the mesh's ``"data"`` ranks.

    Each call of the returned function solves its spans in batches of
    ``n_data * spans_per_device`` (the last padded with copies of its last
    span); each data rank solves its ``spans_per_device`` of a batch
    against the replicated feature stack, and the results are gathered, so
    every rank returns every span's solve.  A span's ICP never crosses
    ranks: the results are those of ``make_batched_icp_fn(features, cfg,
    chunk=spans_per_device)`` bit for bit.

    Returns ``batched(idx_i, idx_j, relRs, relTs, thr_scale=1.0) -> (dRs,
    dts, oks, init_res, final_res)``, host float64 numpy.
    """
    feats = _stacked(features)
    dev = feats.ext_pts.device
    _, index, n = axis(mesh)
    S = n * spans_per_device
    mine = slice(index * spans_per_device, (index + 1) * spans_per_device)

    def batched(idx_i, idx_j, relRs, relTs, thr_scale=1.0):
        n_spans = len(idx_i)
        dRs = np.zeros((n_spans, 3, 3))
        dts = np.zeros((n_spans, 3))
        oks = np.zeros((n_spans,), bool)
        r0s = np.zeros((n_spans,))
        r1s = np.zeros((n_spans,))
        for s in range(0, n_spans, S):
            sel = slice(s, min(s + S, n_spans))
            k = sel.stop - sel.start
            pad = lambda a: np.concatenate(
                [a[sel], np.repeat(a[sel][-1:], S - k, axis=0)])[mine]
            res = refine_pairs_batched(
                gather_frames(feats, pad(np.asarray(idx_i))),
                gather_frames(feats, pad(np.asarray(idx_j))),
                torch.as_tensor(pad(np.asarray(relRs)), dtype=torch.float32,
                                device=dev),
                torch.as_tensor(pad(np.asarray(relTs)), dtype=torch.float32,
                                device=dev), cfg, thr_scale=float(thr_scale))
            R, t, ok, r0, r1 = all_gather_rows(
                (res.R, res.t, res.success, res.init_res, res.final_res),
                mesh)
            dRs[sel] = R[:k].double().cpu().numpy()
            dts[sel] = t[:k].double().cpu().numpy()
            oks[sel] = ok[:k].cpu().numpy()
            r0s[sel] = r0[:k].double().cpu().numpy()
            r1s[sel] = r1[:k].double().cpu().numpy()
        return dRs, dts, oks, r0s, r1s

    return batched


def make_sharded_sc_correlation(mesh):
    """Row-sharded ScanContext correlation matrix
    (``backend.scancontext.sc_correlation_matrix`` with the query-frame
    axis over ``"data"``): each data rank correlates a contiguous block of
    query rows against the whole (replicated) signature stack; no
    collective runs but the optional gather.  The rows go in blocks of
    ``sc_row_block(device)``, a rank taking whole blocks (N is padded to a
    multiple of the block times the data size with rows that are not
    computed), so every value is the one-device matrix's bit for bit.

    Returns ``fn(scs (N, R, S), gather=False) -> (score, yaw)``: this
    rank's rows ``lo:hi`` of the ``(N, N)`` matrices (``fn.rows(scs)`` gives
    ``lo, hi``; a rank past the last frame gets none), or with ``gather``
    the whole matrices on every rank.
    """
    _, index, n = axis(mesh)

    def rows(scs):
        N, blk = scs.shape[0], sc_row_block(scs.device)
        per = -(-N // (blk * n)) * blk
        return min(index * per, N), min((index + 1) * per, N), per

    def corr(scs, gather=False):
        N = scs.shape[0]
        lo, hi, per = rows(scs)
        score, yaw = sc_correlation_rows(scs, lo, hi)
        if not gather:
            return score, yaw
        pad = lambda x: torch.cat([x, x.new_zeros((per - (hi - lo), N))])
        score, yaw = all_gather_rows((pad(score), pad(yaw)), mesh)
        return score[:N], yaw[:N]

    corr.rows = lambda scs: rows(scs)[:2]
    return corr


def neighbor_pose_exchange(mesh):
    """Halo exchange over keyframe spans.

    Returns ``fn(poses (n * K, 12)) -> (total, left_last)``: each data rank
    owns a contiguous span of K poses, sends its last pose to the next rank
    of the ring and receives the previous rank's (``left_last``, (12,)),
    so it can evaluate the chain constraint across the span boundary;
    ``total`` is the squared chain residual ``sum ||p_k - p_{k-1}||^2``
    over the whole trajectory, all-reduced (the boundary term masked out on
    data rank 0).  A world of one rank is its own left neighbour: the halo
    is a local copy.
    """
    group, index, n = axis(mesh)
    right = dist.get_global_rank(group, (index + 1) % n)
    left = dist.get_global_rank(group, (index - 1) % n)

    def step(poses):
        local = shard_rows(poses, mesh)
        last = local[-1].contiguous()
        if n == 1:
            left_last = last.clone()
        else:
            left_last = torch.empty_like(last)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, last, right, group),
                    dist.P2POp(dist.irecv, left_last, left, group)]):
                req.wait()
        intra = ((local[1:] - local[:-1]) ** 2).sum()
        boundary = ((local[0] - left_last) ** 2).sum()
        if index == 0:
            boundary = torch.zeros_like(boundary)
        return all_reduce_sum(intra + boundary, group), left_last

    return step
