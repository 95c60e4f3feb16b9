"""float32 binning arithmetic as the configuration's source computes it.

The system this benchmark measures bins as the jitted JAX package it was
ported from: a division by a constant is a product with the constant's
float32 reciprocal, a product and a sum round once (a fused multiply-add),
``atan2`` is fdlibm's ``atan2f`` and ``asin(x)`` is ``2 atan2(x, 1 +
sqrt((1 - x)(1 + x)))``.  A point within an ulp of a bin edge falls where
that rounding puts it, so the reference bins the same way.  Every function
is plain float32 / float64 torch ops, the same bits on the card and the CPU.
"""
from __future__ import annotations

import torch


def reciprocal(d: float, dtype: torch.dtype = torch.float32) -> float:
    """``1 / d`` with ``d`` and the quotient rounded to ``dtype``."""
    one = torch.ones((), dtype=dtype)
    return float(one / torch.full((), d, dtype=dtype))


def mul_reciprocal(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as ``x`` times ``d``'s reciprocal in ``x``'s dtype."""
    return x * torch.full((), reciprocal(d, x.dtype), dtype=x.dtype,
                          device=x.device)


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (exact products in float64)."""
    f64 = lambda v: v.double() if torch.is_tensor(v) else v
    return (a.double() * f64(b) + f64(c)).float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``sqrt``, through float64."""
    return torch.sqrt(x.double()).float()


def mul_reciprocal_add(x: torch.Tensor, d: float, c: float) -> torch.Tensor:
    """float32 ``x / d + c``: one fused multiply-add with ``d``'s
    reciprocal."""
    c32 = float(torch.tensor(c, dtype=torch.float32))
    return fma32(x, reciprocal(d), c32)


# fdlibm's s_atanf.c and e_atan2f.c constants (float32 literals)
_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
            1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
            7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
       -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
       6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
       -3.6531571299e-02, 1.6285819933e-02)
_ATAN_INF = float(torch.tensor(_ATAN_HI[3]) + torch.tensor(_ATAN_LO[3]))
_PI_O_2, _PI, _PI_LO = 1.5707963705e+00, 3.1415927410e+00, -8.7422776573e-08


def _poly(w, coefs):
    acc = torch.full_like(w, coefs[-1])
    for c in reversed(coefs[:-1]):
        acc = c + w * acc
    return acc


def _pick(m1, m2, m3, values):
    return torch.where(m2, torch.where(m3, values[3], values[2]),
                       torch.where(m1, values[1], values[0]))


def _atan(a: torch.Tensor) -> torch.Tensor:
    """fdlibm's float32 ``atanf`` of ``a >= 0``."""
    small = a < 0.4375
    m1, m2, m3 = a >= 0.6875, a >= 1.1875, a >= 2.4375
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
    """fdlibm's float32 ``atan2f`` for finite ``y`` and ``x``."""
    y, x = torch.broadcast_tensors(y, x)
    sy, sx = torch.signbit(y), torch.signbit(x)
    bits = lambda v: v.abs().contiguous().view(torch.int32)
    k = (bits(y) - bits(x)) >> 23
    z = _atan((y / x).abs())
    z = torch.where(k > 60, _PI_O_2 + 0.5 * _PI_LO, z)
    z = torch.where(sx & (k < -60), 0.0, z)
    zl = z - _PI_LO
    out = torch.where(sx, torch.where(sy, zl - _PI, _PI - zl),
                      torch.where(sy, -z, z))
    on_axis = torch.where(sx, torch.where(sy, -_PI, _PI), y)
    out = torch.where(y == 0, on_axis, out)
    return torch.where((x == 0) & (y != 0),
                       torch.where(sy, -_PI_O_2, _PI_O_2), out)


def asin_base(x: torch.Tensor) -> torch.Tensor:
    """``1 + sqrt((1 - x)(1 + x))``: ``asin(x) = 2 atan2(x, asin_base(x))``."""
    return 1.0 + sqrt32((1.0 - x) * (1.0 + x))
