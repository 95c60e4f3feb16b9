"""float32 arithmetic as the jitted JAX package computes it on XLA's CPU,
for the port's binning: a bin index is ``floor`` of a float, and a point
within an ulp of a bin edge falls on the side its rounding puts it.

XLA departs from plain IEEE float32 in three ways there:

* its algebraic simplifier, which runs before every backend, rewrites a
  division by a constant into a product with the constant's reciprocal
  (``mul_reciprocal``);
* its CPU backend lets LLVM contract a product and a sum into one fused
  multiply-add (``fma32``, and the sums of squares built on it);
* ``atan2`` is glibc's ``atan2f`` (fdlibm's algorithm, which glibc 2.36
  still ships), and ``asin(x)`` is ``2 * atan2(x, 1 + sqrt((1 - x) * (1 +
  x)))`` (``atan2``, ``asin``).

Every function here is plain torch elementwise ops on IEEE float32 and
float64 values, one operation a kernel, so the card and the CPU give the
same bits.  On a ray-cast scan every beam's elevation sits on a row edge
of the ring image: with torch's own ``arcsin`` a third of a frame's cells
came out otherwise than the JAX package's.
"""
from __future__ import annotations

import torch


def reciprocal(d: float, dtype: torch.dtype = torch.float32) -> float:
    """``1 / d`` with ``d`` rounded to ``dtype`` and the quotient rounded to
    ``dtype``: the constant XLA folds for ``x / d``."""
    one = torch.ones((), dtype=dtype)
    return float(one / torch.full((), d, dtype=dtype))


def mul_reciprocal(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as the jitted JAX package computes it: ``x`` times ``d``'s
    reciprocal in ``x``'s dtype (``np.float32(1) / np.float32(d)`` for
    float32), one IEEE multiply on every device.  A true division floors
    otherwise for 4-15 % of the values within 2 float32 units of a bin
    edge (the voxel sizes, the ring image's angular steps, the
    ScanContext's 2 pi), which moved up to 28 points a full-size frame
    into another voxel and one descriptor by 0.023."""
    return x * torch.full((), reciprocal(d, x.dtype), dtype=x.dtype,
                          device=x.device)


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a product and a sum that LLVM
    contracts into a fused multiply-add.  The product of two float32
    values is exact in float64, so the float64 sum rounded to float32 is
    the fused result (but where that sum lands on a float32 rounding
    midpoint, some 2^-28 of values).  ``b`` and ``c`` are float32 tensors
    or Python numbers that float32 holds exactly."""
    f64 = lambda v: v.double() if torch.is_tensor(v) else v
    return (a.double() * f64(b) + f64(c)).float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt`` correctly rounded on every device, through float64:
    torch's float32 CPU ``sqrt`` is not (~0.5 % of a frame's ranges miss
    by an ulp), XLA's and CUDA's are."""
    return torch.sqrt(x.double()).float()


def mul_reciprocal_add(x: torch.Tensor, d: float, c: float) -> torch.Tensor:
    """float32 ``x / d + c``: ``fma32`` of ``x``, ``d``'s float32
    reciprocal and ``c``."""
    c32 = float(torch.tensor(c, dtype=torch.float32))
    return fma32(x, reciprocal(d), c32)


def hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.hypot``: ``hi * sqrt(1 + (lo / hi)^2)``, the square
    and the sum one fused multiply-add.  ``torch.hypot`` rounds otherwise
    in ~27 % of a frame's points."""
    a, b = x.abs(), y.abs()
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    q = lo / torch.where(hi == 0, 1.0, hi)
    return torch.where(hi == 0, hi, hi * sqrt32(fma32(q, q, 1.0)))


# fdlibm's s_atanf.c: atan at the reduction points 0.5, 1, 1.5 and
# infinity, split in high and low parts, and the odd polynomial's
# coefficients (float32 literals)
_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
            1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
            7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
       -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
       6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
       -3.6531571299e-02, 1.6285819933e-02)
# atanf's value past 2^25, atan_hi[3] + atan_lo[3] in float32
_ATAN_INF = float(torch.tensor(_ATAN_HI[3]) + torch.tensor(_ATAN_LO[3]))
# e_atan2f.c's constants
_PI_O_2, _PI, _PI_LO = 1.5707963705e+00, 3.1415927410e+00, -8.7422776573e-08


def _poly(w: torch.Tensor, coefs) -> torch.Tensor:
    """Horner's ``c0 + w * (c1 + w * (...))`` one float32 op at a time."""
    acc = torch.full_like(w, coefs[-1])
    for c in reversed(coefs[:-1]):
        acc = c + w * acc
    return acc


def _pick(m1, m2, m3, values):
    """``values[i]`` where ``i`` masks of the four ranges hold."""
    return torch.where(m2, torch.where(m3, values[3], values[2]),
                       torch.where(m1, values[1], values[0]))


def _atan(a: torch.Tensor) -> torch.Tensor:
    """fdlibm's float32 ``atanf`` (glibc's ``__atanf``) of ``a >= 0``.
    Every value is computed with Python-number constants (no copy to the
    device, which would wait for it)."""
    small = a < 0.4375
    m1, m2, m3 = a >= 0.6875, a >= 1.1875, a >= 2.4375
    # argument reduction about c = 0.5, 1, 1.5: (a - c) / (1 + c a), which
    # is fdlibm's (2a - 1) / (2 + a) bit for bit at c = 0.5 (a power of two
    # apart); about infinity: -1 / a
    c = torch.where(m2, 1.5, torch.where(m1, 1.0, 0.5))
    t = torch.where(m3, -1.0 / a, (a - c) / (1.0 + c * a))
    t = torch.where(small, a, t)
    z = t * t
    w = z * z
    ts = t * (z * _poly(w, _AT[0::2]) + w * _poly(w, _AT[1::2]))
    big = _pick(m1, m2, m3, _ATAN_HI) - ((ts - _pick(m1, m2, m3, _ATAN_LO))
                                         - t)
    out = torch.where(small, t - ts, big)
    return torch.where(a >= 2.0 ** 25, _ATAN_INF, out)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.arctan2(y, x)`` as XLA's CPU computes it: glibc's
    ``atan2f`` (fdlibm's ``e_atan2f.c``), for finite ``y`` and ``x``.
    Its ``x == 1`` shortcut, ``atanf(y)``, is the general path's value:
    fdlibm's ``atanf`` is odd bit for bit."""
    y, x = torch.broadcast_tensors(y, x)
    sy, sx = torch.signbit(y), torch.signbit(x)
    bits = lambda v: v.abs().contiguous().view(torch.int32)
    k = (bits(y) - bits(x)) >> 23          # ~ the exponents' difference
    z = _atan((y / x).abs())
    z = torch.where(k > 60, _PI_O_2 + 0.5 * _PI_LO, z)
    z = torch.where(sx & (k < -60), 0.0, z)
    zl = z - _PI_LO
    out = torch.where(sx, torch.where(sy, zl - _PI, _PI - zl),
                      torch.where(sy, -z, z))
    # y = 0: +-0 for x >= +0, +-pi for x <= -0 (the sign of y's zero)
    on_axis = torch.where(sx, torch.where(sy, -_PI, _PI), y)
    out = torch.where(y == 0, on_axis, out)
    return torch.where((x == 0) & (y != 0),
                       torch.where(sy, -_PI_O_2, _PI_O_2), out)


def asin_base(x: torch.Tensor) -> torch.Tensor:
    """``1 + sqrt((1 - x) * (1 + x))``: ``asin(x)`` is ``2 * atan2(x,
    asin_base(x))`` under XLA."""
    return 1.0 + sqrt32((1.0 - x) * (1.0 + x))


def asin(x: torch.Tensor) -> torch.Tensor:
    """float32 ``jnp.arcsin`` as XLA computes it: ``2 * atan2(x, 1 +
    sqrt((1 - x) * (1 + x)))``."""
    a = atan2(x, asin_base(x))
    return a + a
