"""The frame-window processor (port of
``caelo_tpu/parallel/pipeline.py::make_sequence_processor``).

Extraction loops over the window's frames; the consecutive pairs register
as one batch; the motion-prior retry runs only when some pair failed.
The sharding helpers of the JAX module are not ported yet.
"""
from __future__ import annotations

import torch

from ..backend.refine_runner import RefinementFeatures
from ..config import PipelineConfig
from ..frontend.registration import (FrameFeatures, PairRegistration,
                                     extract_frame_features,
                                     extract_frame_features_full,
                                     register_pair, register_pair_with_prior,
                                     stack_features)


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
            eye = torch.eye(3, dtype=regs.R.dtype, device=regs.R.device)[None]
            zero = torch.zeros_like(regs.t[:1])
            ok_prev = regs.success[:-1]
            prior_R = torch.cat([eye, torch.where(
                ok_prev[:, None, None], regs.R[:-1], eye)])
            prior_t = torch.cat([zero, torch.where(
                ok_prev[:, None], regs.t[:-1], zero)])
            regs2 = register_pair_with_prior(f0, f1, prior_R, prior_t, cfg,
                                             generator=generator, samples=s2)
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
