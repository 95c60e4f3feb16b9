"""The comparison that decides ``correct``: what the timed path produced,
held to the plain reference (``perfbench/reference``).

Four numbers, each the worst over what a run checks:

* ``kp_miss``: per sampled frame, the share of the reference's keypoints
  (pixel and point, bit for bit; ISS: the point) the program's set lacks
  or adds, from the scan and the weights the benchmark made;
* ``desc_gap``: the largest difference of a descriptor entry over the
  keypoints both sets hold;
* ``pose_gap``: per sampled pair, the largest difference of a rotation
  entry or a translation coordinate (m) between the program's registration
  and the reference's, run from the program's own features with the
  hypotheses the program drew (a success flag that differs reads inf);
* ``chain_gap``: the largest difference of a pose-row entry between each
  call's poses and the reference chain of its pair motions, and of the
  sampled pairs' motions between the program's and the reference's
  plausibility gate and constant-velocity fallback.

The registration and the chain are checked step by step from the
program's state (its features, its draws, its earlier pairs); the front
end that produces that state is checked on its own from the scans.  With
``low`` the control takes the program's place: the reference in its
control precision (TF32 products, a float32 chain), held to the same
comparisons.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from .reference import chain, frontend, full_float32, registration
from .reference.sizes import Sizes

NAMES = ("kp_miss", "desc_gap", "pose_gap", "chain_gap")


def plan(workload: dict, seed: int) -> dict:
    """The units a run checks, drawn from the seed: windows (and frame
    offsets in them) or pairs (and frames)."""
    c = workload["check"]
    rng = np.random.default_rng([seed, 1])
    if "windows" in c:
        ws = sorted(rng.choice(c["within"], c["windows"], replace=False))
        return {"windows": [int(w) for w in ws],
                "offsets": [sorted(int(o) for o in rng.choice(
                    workload["window"], c["frames"], replace=False))
                    for _ in ws]}
    pairs = sorted(int(k) for k in rng.choice(c["within"], c["pairs"],
                                              replace=False))
    frames = sorted({f for k in pairs[:c["frames"]] for f in (k, k + 1)}
                    )[:c["frames"]]
    keep = sorted({f for k in pairs for f in (k, k + 1)} | set(frames))
    return {"pairs": pairs, "frames": frames, "keep_frames": keep}


@torch.no_grad()
def reference_features(run, pts, mask, low=False):
    """``(key_pts, descriptors, key_mask, key_pixels)`` of one scan by the
    reference (where the configuration names a ``detector``, its
    keypoints by ``reference/<name>.py``; their ``key_pixels`` None)."""
    S = Sizes(run.config["pipeline"])
    det = run.config.get("detector")
    if det is None:
        return frontend.features(pts, mask, run.weights, S, low)
    detector = importlib.import_module(f"perfbench.reference.{det['name']}")
    kp, km = detector.keypoints(pts[:, :3].contiguous(), mask, det,
                                S.cfg["keypoint"]["n_keypoints"], low)
    return kp, frontend.describe(pts, mask, kp, km, run.weights[1], S,
                                 low), km, None


def _keypoint_set(key_pts, key_mask, key_pixels=None):
    pts = key_pts[key_mask].double().cpu().numpy()
    if key_pixels is None:
        return {tuple(p) for p in pts}
    pix = key_pixels[key_mask].cpu().numpy()
    return {tuple(a) + tuple(b) for a, b in zip(pix, pts)}


def frame_numbers(run, prog, lap_index: int, low=False) -> tuple:
    """``(kp_miss, desc_gap)`` of one frame's program features ``prog =
    (key_pts, descriptors, key_mask, key_pixels)`` (with ``low``, the
    control's) against the reference from the same scan."""
    pts, mask = (torch.as_tensor(a).to(run.device)
                 for a in run.frames[lap_index % len(run.frames)])
    ref = reference_features(run, pts, mask)
    if low:
        prog = reference_features(run, pts, mask, low=True)
    use_pix = "detector" not in run.config
    a = _keypoint_set(ref[0], ref[2], ref[3] if use_pix else None)
    b = _keypoint_set(prog[0], prog[2], prog[3] if use_pix else None)
    miss = max(len(a - b), len(b - a)) / max(len(a), 1)
    # descriptors of the keypoints both hold, matched by their point
    key = lambda f: {tuple(p): i for i, p in enumerate(
        f[0].double().cpu().numpy()) if bool(f[2][i])}
    ka, kb = key(ref), key(prog)
    common = [p for p in ka if p in kb]
    if not common:
        return miss, float("inf")
    ia = torch.tensor([ka[p] for p in common], device=run.device)
    ib = torch.tensor([kb[p] for p in common], device=prog[1].device)
    gap = (ref[1][ia].double().cpu() - prog[1][ib].double().cpu()).abs().max()
    return miss, float(gap)


def _pose_gap(R0, t0, ok0, R1, t1, ok1) -> float:
    """The largest rotation-entry or translation (m) difference of two
    registrations; inf where their success flags differ."""
    R0, t0, R1, t1 = (np.asarray(x, np.float64) for x in (R0, t0, R1, t1))
    if not np.array_equal(np.asarray(ok0, bool), np.asarray(ok1, bool)):
        return float("inf")
    return float(max(np.abs(R0 - R1).max(), np.abs(t0 - t1).max()))


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return x.numpy() if x.dtype == torch.bool else x.double().numpy()
    return x


def windowed_numbers(run, rec, low=False) -> dict:
    cfg = run.config["pipeline"]
    kept = rec["kept"]
    if not kept:
        return dict.fromkeys(NAMES, float("inf"))
    kp, dg, pg, cg = [0.0], [0.0], [0.0], [chain_numbers(rec, low)]
    by_w = dict(zip(run.plan["windows"], run.plan["offsets"]))
    for w, k in kept.items():
        f = k["feats"]
        for o in by_w[w]:
            if o < k["frames"]:
                m, g = frame_numbers(run, tuple(x[o] for x in f),
                                     k["first"] + o, low)
                kp.append(m)
                dg.append(g)
        three = (f[0], f[1], f[2])
        ref = registration.register_window(three, k["draws"], cfg)
        regs = k["regs"]
        prog = (regs.R, regs.t, regs.success)
        if low:
            prog = registration.register_window(three, k["draws"], cfg, True)
        if ref is None or prog is None:
            pg.append(float("inf"))
            continue
        pg.append(_pose_gap(*(_np(x) for x in prog + ref)))
        if low:
            continue
        # the driver's plausibility gate and fallback on these pairs
        call = rec["calls"][k["call"]]
        for j in range(k["frames"] - 1):
            g = k["start"] + j
            R, t = _np(regs.R[j]), _np(regs.t[j])
            ok = bool(regs.success[j]) and registration.plausible(R, t, cfg)
            if not ok:
                R, t = _previous(call, g)
            cg.append(_pose_gap(call["rel_Rs"][g], call["rel_ts"][g],
                                call["successes"][g], R, t, ok))
    return {"kp_miss": max(kp), "desc_gap": max(dg), "pose_gap": max(pg),
            "chain_gap": max(cg)}


def _previous(call, g):
    """The driver's motion before pair ``g`` (the identity before the
    first)."""
    if g == 0:
        return np.eye(3), np.zeros(3)
    return call["rel_Rs"][g - 1], call["rel_ts"][g - 1]


def framewise_numbers(run, rec, low=False) -> dict:
    cfg = run.config["pipeline"]
    feats, draws = rec["kept"]["feats"], rec["kept"]["draws"]
    call = rec["calls"][0]
    kp, dg, pg = [0.0], [0.0], [0.0]
    checked = 0
    for i in run.plan["frames"]:
        if i in feats:
            m, g = frame_numbers(run, feats[i], rec["first"] + i, low)
            kp.append(m)
            dg.append(g)
            checked += 1
    for k in run.plan["pairs"]:
        if k not in draws or k + 1 not in feats:
            continue
        f0, f1 = (tuple(feats[i][:3]) for i in (k, k + 1))
        prev = _previous(call, k)
        ref = registration.register_step(f0, f1, prev, draws[k], cfg)
        prog = (call["rel_Rs"][k], call["rel_ts"][k], call["successes"][k])
        if low:
            prog = registration.register_step(f0, f1, prev, draws[k], cfg,
                                              True)
        if ref is None or prog is None:
            pg.append(float("inf"))
        else:
            pg.append(_pose_gap(*prog, *ref))
        checked += 1
    if not checked:
        return dict.fromkeys(NAMES, float("inf"))
    return {"kp_miss": max(kp), "desc_gap": max(dg), "pose_gap": max(pg),
            "chain_gap": chain_numbers(rec, low)}


def chain_numbers(rec, low=False) -> float:
    """The largest pose-row gap between each call's poses (with ``low``,
    the float32 chain's) and the reference chain of its motions (the
    identity calibration, as the benchmark calls the drivers)."""
    gap = 0.0
    for c in rec["calls"]:
        args = (c["rel_Rs"], c["rel_ts"], np.eye(3), np.zeros(3))
        prog = chain.chain_poses(*args, np.float32) if low else c["poses"]
        gap = max(gap, float(np.abs(chain.chain_poses(*args) - prog).max()))
    return gap


def numbers(run, rec, low=False) -> dict:
    """The four numbers of a run's record, the reference in full float32
    (and the control's emulated TF32) whatever precision the program
    left set."""
    fn = windowed_numbers if "windows" in run.plan else framewise_numbers
    with full_float32():
        return fn(run, rec, low)


def verdict(values: dict, limits: dict) -> bool:
    """Each number at or under its limit (a missing limit fails)."""
    return all(n in limits and values[n] <= limits[n] for n in NAMES)
