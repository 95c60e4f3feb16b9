"""Binning by division: ``caelo_tpu_torch.divide`` (the divisor a 0-d
tensor on the input's device, which keeps PyTorch's CUDA kernel from
multiplying by the reciprocal) gives on the CPU the bits of the
Python-number division it replaced, on 10^5 coordinates within 2 float32
units of a bin edge for each divisor the port bins by (the three voxel
sizes, the ring image's azimuth and elevation steps, the ScanContext's
range and angle spans); and ``keypoint_voxels`` on such coordinates equals
the JAX package's exactly."""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from caelo_tpu.voxel.grid import keypoint_voxels as jkeypoint_voxels
from caelo_tpu_torch import divide
from caelo_tpu_torch.config import SensorConfig, VoxelConfig
from caelo_tpu_torch.voxel.grid import keypoint_voxels

N = 100_000
VC, SC = VoxelConfig(), SensorConfig()
DIVISORS = [*VC.voxel_sizes, SC.azimuth_res, SC.vertical_res, 80.0,
            2.0 * math.pi]


def _near_edges(d, n, lo=-200, hi=200, seed=0):
    """``n`` float32 values ``k * d`` moved by -2..2 float32 units."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(lo, hi, n) * np.float32(d)).astype(np.float32)
    for _ in range(2):
        step = rng.integers(-1, 2, n)
        x = np.where(step > 0, np.nextafter(x, np.float32(np.inf)),
                     np.where(step < 0, np.nextafter(x, np.float32(-np.inf)),
                              x)).astype(np.float32)
    return x


@pytest.mark.parametrize("d", DIVISORS)
def test_divide_is_the_python_number_division_on_the_cpu(d):
    x = torch.from_numpy(_near_edges(d, N))
    q = divide(x, d)
    assert q.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), (x / d).numpy())
    np.testing.assert_array_equal(torch.floor(q).numpy(),
                                  torch.floor(x / d).numpy())


@pytest.mark.parametrize("scale", [0, 1, 2])
def test_keypoint_voxels_near_edges_match_jax(scale):
    half = np.array([VC.visible_length, VC.visible_width, VC.visible_height],
                    np.float32)
    pts = np.stack([_near_edges(VC.voxel_sizes[scale], N // 3, 0, 400,
                                seed=s) for s in range(3)], 1) - half
    out = keypoint_voxels(torch.from_numpy(pts), scale, VC).numpy()
    ref = np.asarray(jkeypoint_voxels(jnp.asarray(pts), scale, VC))
    np.testing.assert_array_equal(out, ref)
