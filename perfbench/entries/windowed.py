"""The offline path on recorded sequences: a closed loop of calls to
``run_odometry_windowed`` (``cli odometry``'s driver), each over the next
``sequence_frames`` scans of the lap, held in host memory.

A unit is one window.  The check keeps, for the windows the plan samples,
the window's features and pair registrations as the processor returned
them and the hypotheses RANSAC drew, and every call's poses."""
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
        self.n = run.workload["sequence_frames"]
        self.window = run.workload["window"]
        self.pos = run.start
        self.calls = 0
        self.starts = odometry.window_starts(self.n, self.window)

    def _sequence(self, n):
        lap = self.run.frames
        seq = [lap[(self.pos + i) % len(lap)] for i in range(n)]
        first = self.pos
        self.pos += n
        return seq, first

    def _call(self, n, process_hook=None):
        seq, first = self._sequence(n)
        self.calls += 1
        run = self.run
        with Patches() as p:
            if process_hook is not None:
                p.set(f"{ODOMETRY}:make_sequence_processor", process_hook)
            res, _ = self.odometry.run_odometry_windowed(
                seq, run.net, run.enc, cfg=run.cfg, window=self.window,
                seed=run.seed + self.calls)
        return res, first

    def warmup(self):
        """One call of one window, then the window's retry with an identity
        prior (the batched motion-prior pass runs only after a failed
        pair)."""
        from caelo_tpu_torch.frontend.registration import (
            FrameFeatures, register_pair_with_prior)

        got = {}

        def hook(make):
            def factory(*a, **k):
                process = make(*a, **k)

                def wrapped(*args):
                    out = process(*args)
                    got["feats"] = out[0]
                    return out
                return wrapped
            return factory

        self._call(self.window, hook)
        f = got["feats"]
        f0 = FrameFeatures(*(x[:-1] for x in f))
        f1 = FrameFeatures(*(x[1:] for x in f))
        B = f0.key_pts.shape[0]
        eye = torch.eye(3, device=self.run.device).expand(B, 3, 3)
        register_pair_with_prior(
            f0, f1, eye, torch.zeros((B, 3), device=self.run.device),
            self.run.cfg,
            generator=torch.Generator(self.run.device).manual_seed(0))

    def session(self, seconds, plan=None, on_unit=None):
        """Calls until ``seconds`` have passed since the first began (the
        last runs to its end).  Returns the session's record."""
        draws = Draws()
        kept = {}
        results = []
        unit = [0]
        extracted = [0]
        keep_windows = set(plan["windows"]) if plan else set()

        def hook(make):
            def factory(*a, **k):
                process = make(*a, **k)
                k_in_call = [0]

                def wrapped(*args):
                    w = unit[0]
                    unit[0] += 1
                    if on_unit is not None:
                        on_unit(w)
                    draws.active = w in keep_windows
                    extracted[0] += args[2].shape[0]
                    out = process(*args)
                    draws.active = False
                    if w in keep_windows:
                        start = self.starts[k_in_call[0]]
                        kept[w] = {"feats": out[0], "regs": out[-1],
                                   "draws": draws.take(),
                                   "call": len(results), "start": start,
                                   "first": call_first[0] + start,
                                   "frames": args[2].shape[0]}
                    k_in_call[0] += 1
                    return out
                return wrapped
            return factory

        frames, call_first = 0, [self.pos]
        with Patches() as p:
            p.set(DRAW_TARGET, draws.wrap)
            if self.run.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            while True:
                call_first[0] = self.pos
                res, first = self._call(self.n, hook)
                frames += self.n
                results.append({"first": first, "poses": res.poses,
                                "rel_Rs": res.rel_Rs, "rel_ts": res.rel_ts,
                                "successes": res.successes})
                elapsed = time.perf_counter() - t0
                if elapsed >= seconds:
                    break
        return {"frames": frames, "pairs": frames - len(results),
                "extracted": extracted[0], "seconds": elapsed,
                "units": unit[0], "attempted": frames,
                "failed": 0, "kept": kept, "calls": results}
