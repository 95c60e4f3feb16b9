"""Binning as the jitted JAX package bins: under ``jax.jit`` XLA rewrites a
division by a constant into a product with its reciprocal, and every
binning site of the JAX package runs under jit.  Each site's expression in
the port (``caelo_tpu_torch.xlamath.mul_reciprocal`` and
``mul_reciprocal_add``, and the burst map ICP's gate slope) against
``jax.jit`` of the JAX line it copies, on 10^5 float32 values within 2 units of the site's bin edges:
the three voxel sizes, the ring image's column and row, the ScanContext's
ring and sector, and the burst gate's ``thr / GATE_RANGE``.  Subnormal
inputs are left out: XLA's CPU flushes them to zero, and no coordinate is
that small.  ``keypoint_voxels`` on such coordinates equals the jitted
JAX function's exactly, and the port's ``atan2``, ``asin`` and ``hypot``
equal XLA's (glibc's ``atan2f``, a fused multiply-add) bit for bit."""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from caelo_tpu.voxel.grid import keypoint_voxels as jkeypoint_voxels
from caelo_tpu_torch.backend.burst import GATE_RANGE, gate_slope
from caelo_tpu_torch.backend.scancontext import N_RINGS, N_SECTORS
from caelo_tpu_torch.config import SensorConfig, VoxelConfig
from caelo_tpu_torch.voxel.grid import keypoint_voxels
from caelo_tpu_torch.xlamath import (asin, atan2, hypot, mul_reciprocal,
                                     mul_reciprocal_add)

N = 100_000
VC, SC = VoxelConfig(), SensorConfig()
AZ, EL, OFF = SC.azimuth_res, SC.vertical_res, SC.vertical_pixel_offset
MAX_RANGE = 80.0


def _near_edges(d, n, lo=-200, hi=200, seed=0, offset=0.0):
    """``n`` float32 values ``(k + offset) * d`` moved by -2..2 float32
    units."""
    rng = np.random.default_rng(seed)
    x = ((rng.integers(lo, hi, n) + offset) * np.float32(d)).astype(
        np.float32)
    for _ in range(2):
        step = rng.integers(-1, 2, n)
        x = np.where(step > 0, np.nextafter(x, np.float32(np.inf)),
                     np.where(step < 0, np.nextafter(x, np.float32(-np.inf)),
                              x)).astype(np.float32)
    return x


def _t(f):
    return lambda x: f(torch.from_numpy(x)).numpy()


# each site by its divisor: (edge spacing, edge range, the JAX line's
# arithmetic, the port's)
SITES = {
    **{vs: (vs, (-200, 200, 0.0),
            # caelo_tpu/voxel/grid.py:96
            lambda x, vs=vs: jnp.floor(x / vs),
            _t(lambda x, vs=vs: torch.floor(mul_reciprocal(x, vs))))
       for vs in VC.voxel_sizes},
    # caelo_tpu/projection/spherical.py:49, the ring image's column
    AZ: (AZ, (1, 1801, 0.0), lambda x: jnp.floor(x / AZ),
         _t(lambda x: torch.floor(mul_reciprocal(x, AZ)))),
    # caelo_tpu/projection/spherical.py:51, its row
    EL: (EL, (-40, 40, -OFF), lambda x: jnp.floor(x / EL + OFF),
         _t(lambda x: torch.floor(mul_reciprocal_add(x, EL, OFF)))),
    # caelo_tpu/backend/scancontext.py:48, the ScanContext's ring
    MAX_RANGE: (MAX_RANGE / N_RINGS, (1, 2 * N_RINGS, 0.0),
                lambda x: (x / MAX_RANGE * N_RINGS).astype(jnp.int32),
                _t(lambda x: (mul_reciprocal(x, MAX_RANGE)
                              * N_RINGS).to(torch.int32))),
    # caelo_tpu/backend/scancontext.py:52, its sector
    2.0 * math.pi: (2.0 * math.pi / N_SECTORS, (1, N_SECTORS + 1, 0.0),
                    lambda x: (x / (2.0 * jnp.pi)
                               * N_SECTORS).astype(jnp.int32),
                    _t(lambda x: (mul_reciprocal(x, 2.0 * math.pi)
                                  * N_SECTORS).to(torch.int32))),
    # caelo_tpu/backend/burst.py:121, the gate's slope itself (no floor)
    GATE_RANGE: (0.05, (1, 200, 0.0), lambda x: x / GATE_RANGE,
                 gate_slope),
}


@pytest.mark.parametrize("d", list(SITES))
def test_divide_is_the_python_number_division_on_the_cpu(d):
    """The binning by divisor ``d`` bit for bit as the jitted JAX line
    computes it (a product with the reciprocal), at 10^5 values near the
    site's bin edges."""
    step, (lo, hi, offset), jax_line, port = SITES[d]
    x = _near_edges(step, N, lo, hi, offset=offset)
    ref = np.asarray(jax.jit(jax_line)(jnp.asarray(x)))
    out = port(x)
    assert out.dtype == ref.dtype
    normal = np.abs(x) >= np.finfo(np.float32).tiny
    assert normal.sum() > 0.99 * N
    np.testing.assert_array_equal(out[normal], ref[normal])


@pytest.mark.parametrize("scale", [0, 1, 2])
def test_keypoint_voxels_near_edges_match_jax(scale):
    half = np.array([VC.visible_length, VC.visible_width, VC.visible_height],
                    np.float32)
    pts = np.stack([_near_edges(VC.voxel_sizes[scale], N // 3, 0, 400,
                                seed=s) for s in range(3)], 1) - half
    out = keypoint_voxels(torch.from_numpy(pts), scale, VC).numpy()
    ref = np.asarray(jax.jit(jkeypoint_voxels, static_argnums=(1, 2))(
        jnp.asarray(pts), scale, VC))
    np.testing.assert_array_equal(out, ref)


def _spread(n, seed):
    """``n`` float32 values of both signs over 12 decades, with zeros of
    both signs and ones."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 10.0 ** rng.uniform(-6, 6, n)).astype(
        np.float32)
    x[:300] = np.repeat(np.array([0.0, -0.0, 1.0], np.float32), 100)
    return rng.permutation(x)


# (the port's function, JAX's, its inputs from a seed)
FUNCTIONS = {
    "atan2": (atan2, jnp.arctan2, lambda: (_spread(N, 1), _spread(N, 2))),
    "asin": (asin, jnp.arcsin, lambda: (np.concatenate([
        np.random.default_rng(3).uniform(-1, 1, N - 4).astype(np.float32),
        np.array([1.0, -1.0, 0.0, -0.0], np.float32)]),)),
    "hypot": (hypot, jnp.hypot, lambda: (_spread(N, 4), _spread(N, 5))),
}


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_angle_and_range_functions_match_jitted_jax(name):
    port, jfun, inputs = FUNCTIONS[name]
    args = inputs()
    ref = np.asarray(jax.jit(jfun)(*map(jnp.asarray, args)))
    out = port(*map(torch.from_numpy, args)).numpy()
    normal = np.ones(N, bool)
    for a in args:
        normal &= (a == 0) | (np.abs(a) >= np.finfo(np.float32).tiny)
    assert normal.sum() > 0.99 * N
    np.testing.assert_array_equal(out.view(np.int32)[normal],
                                  ref.view(np.int32)[normal])
