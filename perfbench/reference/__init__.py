"""The plain reference the benchmark holds the program to.

Plain PyTorch (convolutions, matmuls, sorts and elementwise ops) and numpy,
frozen here so that a change to the program cannot change the yardstick.
It imports nothing of the program: every size is worked out again from the
configuration's own numbers (``sizes.py``), and the weights and scans are
the ones the benchmark made.

* ``frontend.features``: scan -> spherical-ring image -> respond planes ->
  saliency, gates and top-k keypoints -> voxel pyramid -> 16^3 patches by
  membership in the occupied-voxel set -> encoder -> 60-dim descriptors;
* ``iss.keypoints``: the ISS detector (KNN, covariance, eigenvalues,
  radius NMS); a configuration's ``detector`` names its module here, each
  with ``keypoints(pts, mask, det, n_keypoints, low)``;
* ``registration``: descriptor matching, RANSAC on given hypotheses, the
  Horn refit and its tightening, the motion-prior retry of both drivers;
* ``chain``: the plausibility gate, the constant-velocity fallback and the
  float64 pose chain.

Every function that multiplies matrices takes ``low``: True rounds both
operands to TF32 (10 mantissa bits) before the float32 product, as the
card's tensor cores do when TF32 is on.  That is the control, the nearest
precision below the configuration's float32.  ``full_float32`` keeps
every other product in full float32, whatever the process set.
"""
import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """Float32 convolutions and matmuls in full float32 inside, whatever the
    process had set (the program may turn TF32 on for its own calls); the
    settings are put back on the way out.  The reference sets its own
    precision so that it can never drift with the program's."""
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]
