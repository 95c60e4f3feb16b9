"""Stage-by-stage parity of registration pairs between the JAX package and
the port, each package running on its own outputs from the padded scans
on: the ring image, the respond map, the keypoints, the voxel pyramid, the
patches, the descriptors, the matches, and RANSAC with JAX's own draws
injected into the port (plain, and with a motion prior as the window's
retry).  The JAX side runs jitted, as the package runs.  The first stage
at which the two part is printed for each pair.

pytest does not collect this file (no ``test_`` prefix);
``tests/test_torch_fullconfig.py`` reuses its comparisons.  It imports JAX,
which ``tools/`` may not.  On the CPU, at ``PipelineConfig()``:

    python tests/parity_pairs.py --weights runs/study0 \\
        --hb-json runs/hb_study0.json          # the pairs that failed there
    python tests/parity_pairs.py --pairs 100,101 --keys 8   # random weights

``--weights`` takes ``train_from_scratch_study``'s output (carried to JAX
by ``weights_io.*_params_from_torch``, bit-exact); without it both run
``random_flax_params(0)``.  Pair ``i`` is frames ``(i, i + 1)`` of the
``--frames``-frame ray-cast circuit at ``--seed``, each cast alone
(``generate_benchmark(frame_range=)``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:        # run as a script from anywhere
    sys.path.insert(0, REPO)

from caelo_tpu.frontend import registration as jreg
from caelo_tpu.frontend.matching import match_descriptors as jmatch
from caelo_tpu.models import weights_io as jweights
from caelo_tpu.models.respond_net import RespondLayer as JRespond
from caelo_tpu.ops.nms import select_keypoints as jselect
from caelo_tpu.projection.spherical import model_input as jmodel_input
from caelo_tpu.projection.spherical import (
    project_to_spherical_ring as jproject)
from caelo_tpu.voxel import grid as jgrid
from caelo_tpu_torch.config import PipelineConfig
from caelo_tpu_torch.frontend import registration as treg
from caelo_tpu_torch.frontend.matching import match_descriptors as tmatch
from caelo_tpu_torch.models import weights_io
from caelo_tpu_torch.ops.nms import select_keypoints_planes
from caelo_tpu_torch.projection.spherical import model_input as tmodel_input
from caelo_tpu_torch.projection.spherical import (
    project_to_spherical_ring as tproject)
from caelo_tpu_torch.voxel import grid as tgrid

# floats that part: off by more than this share of their scale (float32
# sums in other orders: convolutions, matmuls, the RANSAC refit)
TOL = 1e-4

_jrespond = jax.jit(JRespond().apply)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _exact(*pairs):
    """``(equal, detail)`` of ``(name, port tensor, JAX array)`` triples
    held exactly."""
    bad = [f"{n}: {int((np.asarray(a) != np.asarray(b)).sum())} differ"
           for n, a, b in pairs
           if not np.array_equal(np.asarray(a), np.asarray(b))]
    return not bad, "; ".join(bad) or "exact"


def _close(name, a, b, scale=None):
    """``(equal, detail)``: every element of ``a`` within ``TOL`` times
    ``scale`` of ``b``'s; ``scale`` defaults to ``b``'s largest magnitude
    (at least 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    if scale is None:
        scale = max(1.0, float(np.abs(b).max()) if b.size else 0.0)
    return (err <= TOL * scale,
            f"{name} max |diff| {err:.3g} (scale {scale:.3g})")


def _joint(*checks):
    return all(ok for ok, _ in checks), "; ".join(d for _, d in checks)


def frame_stages(rp, ep, nets, pts, mask, cfg):
    """The front end's stages of one padded scan in both packages:
    ``([(stage, equal, detail)], port FrameFeatures, JAX FrameFeatures)``.
    Every stage is held exactly but the floating outputs of the networks
    (to ``TOL`` of their scale)."""
    pj, mj = jnp.asarray(pts), jnp.asarray(mask)
    pt, mt = _t(pts), _t(mask)
    out = []
    img_j, cnt_j = jproject(pj, mj, cfg.sensor)
    img_t, cnt_t = tproject(pt, mt, cfg.sensor)
    out.append(("ring image", *_exact(("counter", cnt_t, cnt_j),
                                      ("image", img_t, img_j))))
    resp_j = _jrespond(rp, jmodel_input(img_j, cfg.sensor)[None])[0]
    with torch.no_grad():
        planes = nets[0](tmodel_input(img_t, cfg.sensor).permute(
            2, 0, 1)[None])[0]
    out.append(("respond map",
                *_close("respond", planes.permute(1, 2, 0), resp_j)))
    kj = jselect(img_j, cnt_j, resp_j, cfg.sensor, cfg.keypoint)
    kt = select_keypoints_planes(img_t, cnt_t, planes, cfg.sensor,
                                 cfg.keypoint)
    ok, detail = _exact(("mask", kt[2], kj[2]), ("pixels", kt[1], kj[1]),
                        ("points", kt[0], kj[0]))
    if not ok:      # a reordering among near-equal saliencies, or not
        as_set = lambda k: set(map(tuple, np.asarray(k[1])[np.asarray(
            k[2])].tolist()))
        detail += f"; {len(as_set(kt) ^ as_set(kj))} pixels in one set only"
    out.append(("keypoints", ok, detail))
    pyr_j = jgrid.voxelize(pj[:, :3], mj, cfg.voxel)
    pyr_t = tgrid.voxelize(pt[:, :3], mt, cfg.voxel)
    out.append(("pyramid", *_exact(
        *((f"scale {s} {n}", a, b) for s in range(3)
          for n, a, b in (("voxels", pyr_t.coords[s], pyr_j.coords[s]),
                          ("mask", pyr_t.masks[s], pyr_j.masks[s]),
                          ("count", pyr_t.counts[s], pyr_j.counts[s]))))))
    pat_j = jgrid.extract_patches(kj[0], kj[2], pyr_j, cfg.voxel)
    pat_t = tgrid.extract_patches(kt[0], kt[2], pyr_t, cfg.voxel)
    out.append(("patches", *_exact(*((f"scale {s}", pat_t[s], pat_j[s])
                                     for s in range(3)))))
    stage, ft, fj = features_stage(rp, ep, nets, pts, mask, cfg)
    return out + [stage], ft, fj


def features_stage(rp, ep, nets, pts, mask, cfg):
    """``extract_frame_features`` of one padded scan in both packages:
    ``(("descriptors", equal, detail), port FrameFeatures, JAX
    FrameFeatures)``, keypoints held exactly and descriptors to ``TOL`` of
    their scale."""
    fj = jreg.extract_frame_features(rp, ep, jnp.asarray(pts),
                                     jnp.asarray(mask), cfg)
    ft = treg.extract_frame_features(nets[0], nets[1], _t(pts), _t(mask),
                                     cfg)
    return ("descriptors", *_joint(
        _exact(("mask", ft.mask, fj.mask),
               ("pixels", ft.key_pixels, fj.key_pixels),
               ("points", ft.key_pts, fj.key_pts)),
        _close("descriptors", ft.descriptors, fj.descriptors))), ft, fj


def jax_draw(key, f0, f1, cfg, prior=None):
    """The ``(H, S)`` RANSAC draws JAX's ``ransac_rigid`` makes from
    ``key`` (``frontend/ransac.py:91-100``) on JAX's own matches."""
    H, S = cfg.ransac.n_hypotheses, cfg.ransac.sample_size
    kw = {}
    if prior is not None:
        kw = dict(pts0=f0.key_pts, pts1=f1.key_pts, prior_R=prior[0],
                  prior_t=prior[1], gate_m=cfg.prior_gate_m)
    _, pm, pd = jmatch(f0.descriptors, f0.mask, f1.descriptors, f1.mask,
                       ratio=cfg.match_ratio, **kw)
    n_top = jnp.maximum(
        (cfg.ransac.sample_top_frac * jnp.sum(pm)).astype(jnp.int32), 4 * S)
    d = jnp.where(pm, pd, jnp.inf)
    cutoff = jnp.sort(d)[jnp.clip(n_top - 1, 0, pm.shape[0] - 1)]
    logits = jnp.where(pm & (d <= cutoff), 0.0, -jnp.inf)
    return np.array(jax.random.categorical(key, logits, shape=(H, S)))


def pair_stages(ft0, ft1, fj0, fj1, cfg, key, prior=None):
    """Matching and registration of one pair in both packages, the port
    fed JAX's draws from ``key``: ``([(stage, equal, detail)], port
    PairRegistration, JAX PairRegistration)``.  With ``prior`` (``(R,
    t)`` float32) both gate the matches around it and register as the
    window's retry does (``register_pair_with_prior``)."""
    kw_j = kw_t = {}
    if prior is not None:
        kw_j = dict(pts0=fj0.key_pts, pts1=fj1.key_pts,
                    prior_R=jnp.asarray(prior[0]),
                    prior_t=jnp.asarray(prior[1]), gate_m=cfg.prior_gate_m)
        kw_t = dict(pts0=ft0.key_pts, pts1=ft1.key_pts,
                    prior_R=_t(prior[0]), prior_t=_t(prior[1]),
                    gate_m=cfg.prior_gate_m)
    mj = jmatch(fj0.descriptors, fj0.mask, fj1.descriptors, fj1.mask,
                ratio=cfg.match_ratio, **kw_j)
    mt = tmatch(ft0.descriptors, ft0.mask, ft1.descriptors, ft1.mask,
                ratio=cfg.match_ratio, **kw_t)
    tag = " with prior" if prior is not None else ""
    # squared distances through |a|^2 + |b|^2 - 2 a.b: rounding scales
    # with the squared norms
    sq = lambda f: float(jnp.max(jnp.sum(f.descriptors ** 2, -1)))
    out = [("matches" + tag, *_joint(
        _exact(("pairs", mt[0], mj[0]), ("valid", mt[1], mj[1])),
        _close("distances", torch.where(mt[1], mt[2], 0.0),
               jnp.where(mj[1], mj[2], 0.0), sq(fj0) + sq(fj1))))]
    samples = torch.from_numpy(jax_draw(key, fj0, fj1, cfg, prior))
    if prior is None:
        rj = jreg.register_pair(key, fj0, fj1, cfg)
        rt = treg.register_pair(ft0, ft1, cfg, samples=samples)
    else:
        rj = jreg.register_pair_with_prior(key, fj0, fj1, kw_j["prior_R"],
                                           kw_j["prior_t"], cfg)
        rt = treg.register_pair_with_prior(ft0, ft1, kw_t["prior_R"],
                                           kw_t["prior_t"], cfg,
                                           samples=samples)
    out.append(("registration" + tag, *_joint(
        _exact(("success", rt.success, rj.success),
               ("n_inliers", rt.n_inliers, rj.n_inliers)),
        _close("R", rt.R, rj.R), _close("t", rt.t, rj.t))))
    return out, rt, rj


def first_parting(stages):
    """The name of the first stage whose outputs differ, or None."""
    return next((name for name, ok, _ in stages if not ok), None)


def pose_errors(R, t, Rg, tg):
    """``(RRE deg, RTE m)`` of an estimate against the true motion."""
    c = np.clip((np.trace(np.asarray(Rg).T @ np.asarray(R)) - 1.0) / 2.0,
                -1.0, 1.0)
    return float(np.degrees(np.arccos(c))), float(
        np.linalg.norm(np.asarray(t) - tg))


def _models(weights, cfg):
    """``(Flax respond params, Flax encoder params, (port respond, port
    encoder), cfg)``: the study's weights in both packages (with the
    recipe's relu / linear encoder) or ``random_flax_params(0)``."""
    if not weights:
        rp, ep = weights_io.random_flax_params(0)
        return rp, ep, weights_io.build_models(rp, ep, "cpu", cfg), cfg
    cfg = dataclasses.replace(cfg, encoder_activation="relu",
                              encoder_code_activation="linear")
    sph = weights_io.spherical_ae_params_from_torch(
        weights_io.load_checkpoint(os.path.join(weights, "respond_ae")))
    vox = weights_io.voxel_ae_params_from_torch(
        weights_io.load_checkpoint(os.path.join(weights, "patch_ae")))
    nets = weights_io.build_models_from_state_dicts(
        *weights_io.load_trained(weights), "cpu", cfg)
    return (jweights.respond_params_from_ae(sph),
            jweights.encoder_params_from_ae(vox), nets, cfg)


def failing_pairs(hb_json):
    """The pairs a ``hard_benchmark`` JSON counts as failed (RRE >= 1 deg
    or RTE >= 0.5 m, ``examples/hard_benchmark.py``'s gate)."""
    with open(hb_json) as f:
        out = json.load(f)
    return [i for i, (r, t) in enumerate(zip(out["per_pair_rre_deg"],
                                             out["per_pair_rte_m"]))
            if r >= 1.0 or t >= 0.5]


def main(argv=None) -> int:
    from caelo_tpu_torch.data.hard_synthetic import generate_benchmark

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default="")
    ap.add_argument("--pairs", default="",
                    help="comma-separated first frames of the pairs")
    ap.add_argument("--hb-json", default="",
                    help="take the failed pairs of this hard_benchmark JSON")
    ap.add_argument("--frames", type=int, default=520)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keys", type=int, default=4,
                    help="JAX draw keys per pair")
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    torch.set_grad_enabled(False)
    rp, ep, nets, cfg = _models(args.weights, PipelineConfig())
    pairs = [int(p) for p in args.pairs.split(",") if p]
    if args.hb_json:
        pairs += failing_pairs(args.hb_json)
    report, parted = [], False
    for i in sorted(set(pairs)):
        ((s0, m0), (s1, m1)), gt = generate_benchmark(
            n_frames=args.frames, seed=args.seed, cfg=cfg,
            frame_range=(i, i + 2))
        gt = np.asarray(gt).reshape(-1, 3, 4)
        rel = lambda a, b: (gt[a, :, :3].T @ gt[b, :, :3],
                            gt[a, :, :3].T @ (gt[b, :, 3] - gt[a, :, 3]))
        Rg, tg = rel(i, i + 1)
        # the window's retry gates around the previous pair's motion
        prior = tuple(np.float32(x) for x in rel(max(i - 1, 0), max(i, 1)))
        st0, ft0, fj0 = frame_stages(rp, ep, nets, s0, m0, cfg)
        st1, ft1, fj1 = frame_stages(rp, ep, nets, s1, m1, cfg)
        stages = [(f"{n} (frame {k})", ok, d)
                  for k, st in enumerate((st0, st1)) for n, ok, d in st]
        keys = []
        for k in range(args.keys):
            key = jax.random.key(k)
            for p, kk in ((None, key), (prior, jax.random.fold_in(key, 1))):
                st, rt, rj = pair_stages(ft0, ft1, fj0, fj1, cfg, kk, p)
                stages += [(f"{n} (key {k})", ok, d) for n, ok, d in st]
                keys.append({
                    "key": k, "prior": p is not None,
                    "jax": [bool(rj.success), int(rj.n_inliers),
                            *pose_errors(rj.R, rj.t, Rg, tg)],
                    "port": [bool(rt.success), int(rt.n_inliers),
                             *pose_errors(rt.R, rt.t, Rg, tg)]})
        first = first_parting(stages)
        parted |= first is not None
        print(f"pair {i}: first stage where the packages part: "
              f"{first or 'none'}")
        for name, ok, detail in stages:
            print(f"  {'ok  ' if ok else 'PART'} {name}: {detail}")
        for r in keys:
            print(f"  key {r['key']}{' prior' if r['prior'] else ''}: "
                  "(success, inliers, RRE deg, RTE m) JAX "
                  f"{r['jax']} port {r['port']}")
        report.append({"pair": i, "first_parting": first, "keys": keys,
                       "stages": [list(s) for s in stages]})
        sys.stdout.flush()
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    return 1 if parted else 0


if __name__ == "__main__":
    sys.exit(main())
