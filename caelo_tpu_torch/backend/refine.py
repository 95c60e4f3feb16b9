"""The pose-refinement back end's host logic, shared with the JAX package.

``caelo_tpu/backend/refine.py`` (de-jump, keyframe transfer chains, the
sequential and batched refinement loops) is float64 numpy with no JAX in
its import chain, so the port imports it rather than keeping a copy that
could drift.  The device work enters through the ICP callables of
``caelo_tpu_torch.backend.refine_runner``.
"""
from caelo_tpu.backend.refine import (  # noqa: F401
    RefineStats, _all_rels, _row, _rt, fix_jump_poses, refine_odometry,
    refine_odometry_batched)
