"""Per-frame artifact store: stage checkpoint and resume (the port's own
copy of ``caelo_tpu/data/artifacts.py``).

One ``.npz`` per frame per stage under ``root/<stage>/<seq>/<frame>.npz``,
with get-or-compute semantics, so a back-end stage re-runs from disk.  The
layout is the JAX package's, so either package reads a store the other
wrote (``tests/test_torch_imports.py``).
"""
from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np

STAGES = ("spherical_ring", "voxel_model", "keypts", "features",
          "refine_features", "inliers", "meta")


class ArtifactStore:
    def __init__(self, root: str):
        self.root = root

    def path(self, stage: str, seq: str, frame: int | str) -> str:
        name = f"{frame:06d}" if isinstance(frame, int) else str(frame)
        return os.path.join(self.root, stage, seq, name + ".npz")

    def has(self, stage: str, seq: str, frame) -> bool:
        return os.path.exists(self.path(stage, seq, frame))

    def save(self, stage: str, seq: str, frame, **arrays):
        p = self.path(stage, seq, frame)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp.npz"  # savez appends .npz unless already present
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp, p)  # atomic: a crash never leaves a torn artifact

    def load(self, stage: str, seq: str, frame) -> Dict[str, np.ndarray]:
        with np.load(self.path(stage, seq, frame)) as z:
            return {k: z[k] for k in z.files}

    def get_or_compute(self, stage: str, seq: str, frame,
                       compute: Callable[[], Dict[str, np.ndarray]],
                       refresh: bool = False) -> Dict[str, np.ndarray]:
        if not refresh and self.has(stage, seq, frame):
            return self.load(stage, seq, frame)
        out = compute()
        self.save(stage, seq, frame, **out)
        return out

    def frames_done(self, stage: str, seq: str) -> int:
        d = os.path.join(self.root, stage, seq)
        if not os.path.isdir(d):
            return 0
        return len([f for f in os.listdir(d) if f.endswith(".npz")])
