"""The frame-by-frame driver ``run_odometry``, fed from the lap in host
memory: in a closed loop (the generator yields the next scan as soon as
the driver asks, and stops when the session's time is up) or in an open
loop at the sensor's rate (scan ``i`` is released at ``t0 + i / rate``
and its latency is counted from then).

Keypoints come from the CAE-LO front end (the driver's default) or, with
``"features": "iss"``, from ``frontend/ablation.py``'s ISS feature
function, as ``cli odometry --keypoints iss`` runs them.

A unit is one frame.  The check keeps the features of the frames the plan
samples and of both frames of each sampled pair, with the hypotheses
RANSAC drew for the pair."""
from __future__ import annotations

import time

import torch

from ..capture import DRAW_TARGET, Draws, Patches

ODOMETRY = "caelo_tpu_torch.frontend.odometry"


class Entry:
    def __init__(self, run):
        from caelo_tpu_torch.frontend import odometry

        self.run = run
        self.odometry = odometry
        self.pos = run.start
        self.features = run.workload.get("features", "cae-lo")
        self.feature_fn = None
        if self.features != "cae-lo":
            from caelo_tpu_torch.frontend.ablation import (
                make_ablation_feature_fn)

            self.feature_fn = make_ablation_feature_fn(
                self.features, run.net, run.enc, run.cfg)
        self.rate = run.workload["arrival"].get("rate_hz")

    def _next(self):
        lap = self.run.frames
        f = lap[self.pos % len(lap)]
        self.pos += 1
        return f

    def warmup(self):
        """Three frames through the driver, then a pair's retry with an
        identity prior (it runs only after a failed pair)."""
        from caelo_tpu_torch.frontend.registration import (
            register_pair_with_prior)

        got = []
        run = self.run

        def keep(f):
            def wrapped(*a, **k):
                out = f(*a, **k)
                got.append(out)
                return out
            return wrapped

        fn = None
        with Patches() as p:
            if self.feature_fn is None:
                p.set(f"{ODOMETRY}:extract_frame_features", keep)
            else:
                fn = keep(self.feature_fn)
            self.odometry.run_odometry(
                [self._next() for _ in range(3)], run.net, run.enc,
                cfg=run.cfg, seed=run.seed, feature_fn=fn)
        register_pair_with_prior(
            got[0], got[1], torch.eye(3, device=run.device),
            torch.zeros(3, device=run.device), run.cfg,
            generator=torch.Generator(run.device).manual_seed(0))

    def session(self, seconds, plan=None, on_unit=None):
        run = self.run
        draws = Draws()
        keep_frames = set(plan["keep_frames"]) if plan else set()
        keep_pairs = set(plan["pairs"]) if plan else set()
        kept = {"feats": {}, "draws": {}}
        n_frame, n_pair = [0], [0]
        dues, done, late = [], [], []

        def feature(f):
            def wrapped(*a, **k):
                out = f(*a, **k)
                i = n_frame[0]
                n_frame[0] += 1
                if i in keep_frames:
                    kept["feats"][i] = out
                return out
            return wrapped

        def register(f, retry):
            def wrapped(*a, **k):
                if not retry:
                    n_pair[0] += 1
                pair = n_pair[0] - 1
                draws.active = pair in keep_pairs
                out = f(*a, **k)
                draws.active = False
                if pair in keep_pairs:
                    kept["draws"].setdefault(pair, []).extend(draws.take())
                return out
            return wrapped

        def progress(i):
            done.append(time.perf_counter())
            if on_unit is not None:
                on_unit(i)

        if self.rate:
            n_due = int(round(seconds * self.rate))

            def scans():
                for i in range(n_due):
                    due = t0 + i / self.rate
                    wait = due - time.perf_counter()
                    if wait > 0:
                        time.sleep(wait)
                    dues.append(due)
                    late.append(time.perf_counter() - due)
                    yield self._next()
        else:
            def scans():
                while time.perf_counter() - t0 < seconds:
                    dues.append(time.perf_counter())
                    yield self._next()

        with Patches() as p:
            p.set(DRAW_TARGET, draws.wrap)
            p.set(f"{ODOMETRY}:register_pair", lambda f: register(f, False))
            p.set(f"{ODOMETRY}:register_pair_with_prior",
                  lambda f: register(f, True))
            fn = self.feature_fn
            if fn is None:
                p.set(f"{ODOMETRY}:extract_frame_features", feature)
            else:
                fn = feature(fn)
            first = self.pos
            if run.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = self.odometry.run_odometry(
                scans(), run.net, run.enc, cfg=run.cfg, seed=run.seed,
                feature_fn=fn, progress=progress)
            elapsed = time.perf_counter() - t0
        n = len(done)
        return {"frames": n, "pairs": max(n - 1, 0), "extracted": n,
                "seconds": elapsed,
                "units": n, "attempted": len(dues), "failed": len(dues) - n,
                "latencies": [d - s for d, s in zip(done, dues)],
                "generator_late": max(late, default=0.0),
                "kept": kept, "first": first,
                "calls": [{"first": first, "poses": res.poses,
                           "rel_Rs": res.rel_Rs, "rel_ts": res.rel_ts,
                           "successes": res.successes}]}
