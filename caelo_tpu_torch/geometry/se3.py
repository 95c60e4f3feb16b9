"""Batched rigid-transform algebra and the Horn rigid solve in PyTorch.

Port of ``caelo_tpu/geometry/se3.py``: the transform algebra, the Euler,
quaternion and angle-axis converters, the Horn solve, the Lie maps and
the beam-angle fix.  The 3x3 algebra is broadcast products and sums, full
float32 whatever the TF32 settings.  Shapes are polymorphic over leading
batch dimensions, as in the JAX module.  A transform is ``(R, t)``,
``(..., 3, 3)`` and ``(..., 3)``, mapping ``x -> R x + t``.  The scan
loaders' beam-angle fix, ``correct_beam_angle_np``, is host numpy;
``correct_beam_angle`` is its tensor twin.
"""
from __future__ import annotations

import math

import numpy as np
import torch

RADIAN2DEGREE = 180.0 / math.pi

# Jacobi rotation order of one sweep (caelo_tpu/geometry/se3.py:202)
_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R v`` for vectors ``v (..., 3)``, as a broadcast product and sum."""
    return (R * v[..., None, :]).sum(-1)


def apply(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply ``x -> R x + t`` to points of shape ``(..., N, 3)``."""
    return _rotate(R[..., None, :, :], pts) + t[..., None, :]


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` for ``(..., 3, 3)`` matrices as a broadcast product and
    sum: full float32 whatever the TF32 settings, where the JAX package
    asks for HIGHEST matmul precision."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def compose(R1, t1, R2, t2):
    """The transform equal to applying ``(R2, t2)`` first, then ``(R1,
    t1)``.

    The algebra here is broadcast products and sums, never a matmul, so it
    runs in full float32 whatever the TF32 settings: pose composition
    chains, and the JAX version asks for HIGHEST matmul precision for the
    same reason."""
    return matmul3(R1, R2), _rotate(R1, t2) + t1


def project_so3(R: torch.Tensor) -> torch.Tensor:
    """Nearest-ish rotation by Gram-Schmidt on rows (batched): the cheap
    re-orthonormalisation of a long device-side pose chain; exact for
    inputs already in SO(3)."""
    r0 = R[..., 0, :]
    r0 = r0 / torch.clamp_min(
        torch.linalg.vector_norm(r0, dim=-1, keepdim=True), 1e-20)
    r1 = R[..., 1, :]
    r1 = r1 - (r0 * r1).sum(-1, keepdim=True) * r0
    r1 = r1 / torch.clamp_min(
        torch.linalg.vector_norm(r1, dim=-1, keepdim=True), 1e-20)
    return torch.stack([r0, r1, torch.linalg.cross(r0, r1)], -2)


def inverse(R, t):
    Rin = R.transpose(-1, -2)
    return Rin, -_rotate(Rin, t)


def rotmat_to_euler_xyz_deg(R: torch.Tensor) -> torch.Tensor:
    """XYZ Euler angles in degrees (``caelo_tpu/geometry/se3.py:62-70``)."""
    ax = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    ay = torch.atan2(-R[..., 2, 0],
                     torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    az = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([ax, ay, az], -1) * RADIAN2DEGREE


def euler_xyz_to_rotmat(angles_rad: torch.Tensor) -> torch.Tensor:
    """Rotation ``R = Rz @ Ry @ Rx`` from XYZ Euler angles ``(..., 3)`` in
    radians (reference ``EulerAngle2RotateMat`` with sequence 'xyz',
    ``Transformations.py:188-211``)."""
    ax, ay, az = angles_rad.unbind(-1)
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)
    mat = lambda rows: torch.stack([torch.stack(r, -1) for r in rows], -2)
    Rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    Ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return matmul3(matmul3(Rz, Ry), Rx)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion ``(..., 4)`` (w, x, y, z) -> rotation ``(..., 3, 3)``."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (y * w + z * x)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation ``(..., 3, 3)`` -> unit quaternion ``(..., 4)`` (w, x, y, z)
    with ``w >= 0``: the eigenvector of the largest eigenvalue of
    Bar-Itzhack's symmetric 4x4 K matrix (reference ``RotMat2Quatern``,
    ``Transformations.py:213-239``), by the batched Jacobi solver."""
    q = max_eigvec_sym4x4(_bar_itzhack_K(R))
    # K stores (x, y, z, w) with the vector part conjugated relative to
    # quat_to_rotmat's convention
    q = torch.cat([q[..., 3:4], -q[..., 0:3]], -1)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def _bar_itzhack_K(R: torch.Tensor) -> torch.Tensor:
    """Bar-Itzhack's symmetric 4x4 matrix of a rotation, ``(..., 4, 4)``."""
    t = 1.0 / 3.0
    r = lambda i, j: R[..., i, j]
    k01 = t * (r(1, 0) + r(0, 1))
    k02 = t * (r(2, 0) + r(0, 2))
    k03 = t * (r(1, 2) - r(2, 1))
    k12 = t * (r(2, 1) + r(1, 2))
    k13 = t * (r(2, 0) - r(0, 2))
    k23 = t * (r(0, 1) - r(1, 0))
    rows = [
        [t * (r(0, 0) - r(1, 1) - r(2, 2)), k01, k02, k03],
        [k01, t * (r(1, 1) - r(0, 0) - r(2, 2)), k12, k13],
        [k02, k12, t * (r(2, 2) - r(0, 0) - r(1, 1)), k23],
        [k03, k13, k23, t * (r(0, 0) + r(1, 1) + r(2, 2))],
    ]
    return torch.stack([torch.stack(row, -1) for row in rows], -2)


def angle_axis_to_quat(angle: torch.Tensor,
                       axis: torch.Tensor) -> torch.Tensor:
    """``(angle (...), unit axis (..., 3))`` -> quaternion ``(..., 4)`` (w,
    x, y, z) (reference ``AngleAxis2Quatern``, ``Transformations.py:
    264-272``)."""
    half = angle / 2.0
    return torch.cat([torch.cos(half)[..., None],
                      axis * torch.sin(half)[..., None]], -1)


def quat_to_angle_axis(q: torch.Tensor):
    """Quaternion ``(..., 4)`` -> ``(angle (...), axis (..., 3))``; the axis
    is zero where the rotation is the identity (reference
    ``Quatern2AngleAndAxis``, ``Transformations.py:254-262``)."""
    half = torch.arccos(torch.clamp(q[..., 0], -1.0, 1.0))
    s = torch.sin(half)
    tiny = (s.abs() < 1e-12)[..., None]
    axis = q[..., 1:4] / torch.where(tiny, 1.0, s[..., None])
    return 2.0 * half, torch.where(tiny, 0.0, axis)


def max_eigvec_sym4x4_lanes(A: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """Eigenvector of the largest eigenvalue of symmetric 4x4 matrices with
    the batch on the LAST axis: ``A`` is ``(4, 4, B)``, returns ``(4, B)``.

    Cyclic Jacobi with a fixed sweep count and the same rotation order as
    the JAX version: every Givens rotation is elementwise math on ``(B,)``
    vectors, with no data-dependent control flow.
    """
    A = A.clone()
    B = A.shape[-1]
    V = torch.eye(4, dtype=A.dtype, device=A.device)[..., None].repeat(1, 1, B)
    for _ in range(sweeps):
        for p, q in _PAIRS:
            theta = 0.5 * torch.atan2(2.0 * A[p, q], A[p, p] - A[q, q])
            c, s = torch.cos(theta), torch.sin(theta)
            # rows of A, then columns of A, then V <- V G
            Ap, Aq = c * A[p] + s * A[q], -s * A[p] + c * A[q]
            A[p], A[q] = Ap, Aq
            Ap, Aq = c * A[:, p] + s * A[:, q], -s * A[:, p] + c * A[:, q]
            A[:, p], A[:, q] = Ap, Aq
            Vp, Vq = c * V[:, p] + s * V[:, q], -s * V[:, p] + c * V[:, q]
            V[:, p], V[:, q] = Vp, Vq
    diag = torch.stack([A[i, i] for i in range(4)])           # (4, B)
    imax = torch.argmax(diag, dim=0)                           # (B,)
    v = V.gather(1, imax.view(1, 1, B).expand(4, 1, B))[:, 0]  # (4, B)
    return v / torch.linalg.vector_norm(v, dim=0, keepdim=True)


def max_eigvec_sym4x4(A: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """Eigenvector of the largest eigenvalue of a symmetric 4x4, batched over
    leading axes: ``(..., 4, 4) -> (..., 4)``.

    The JAX version applies each Givens rotation as ``G^T A G`` on
    ``(..., 4, 4)`` blocks; here the batch moves to the last axis and the
    rotation runs as the row/column updates of
    :func:`max_eigvec_sym4x4_lanes` -- the same rotations in the same order
    (the products with G's zero entries are exact), with far fewer kernel
    launches on the card.
    """
    batch = A.shape[:-2]
    lanes = A.reshape(-1, 4, 4).permute(1, 2, 0)
    return max_eigvec_sym4x4_lanes(lanes, sweeps).T.reshape(*batch, 4)


def _horn_N(M: torch.Tensor) -> torch.Tensor:
    """Horn's symmetric 4x4 matrix from a 3x3 cross-covariance."""
    m = lambda i, j: M[..., i, j]
    tr = m(0, 0) + m(1, 1) + m(2, 2)
    d0 = m(1, 2) - m(2, 1)
    d1 = m(2, 0) - m(0, 2)
    d2 = m(0, 1) - m(1, 0)
    rows = [
        [tr, d0, d1, d2],
        [d0, 2 * m(0, 0) - tr, m(0, 1) + m(1, 0), m(0, 2) + m(2, 0)],
        [d1, m(0, 1) + m(1, 0), 2 * m(1, 1) - tr, m(1, 2) + m(2, 1)],
        [d2, m(0, 2) + m(2, 0), m(1, 2) + m(2, 1), 2 * m(2, 2) - tr],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def solve_rigid_horn(p0: torch.Tensor, p1: torch.Tensor,
                     weights: torch.Tensor | None = None):
    """Weighted least-squares rigid transform mapping ``p1 -> p0``.

    Args:
      p0: ``(..., N, 3)`` target points.
      p1: ``(..., N, 3)`` source points.
      weights: optional ``(..., N)`` nonnegative weights (inlier masks).

    Returns ``(R, t)``, ``(..., 3, 3)`` and ``(..., 3)``: always a proper
    rotation (Horn's quaternion method, no reflection branch).
    """
    if weights is None:
        weights = torch.ones(p0.shape[:-1], dtype=p0.dtype, device=p0.device)
    w = weights[..., None]
    wsum = torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    mean0 = (p0 * w).sum(-2) / wsum
    mean1 = (p1 * w).sum(-2) / wsum
    q0 = p0 - mean0[..., None, :]
    q1 = p1 - mean1[..., None, :]
    # cross covariance M[i, j] = sum_n w_n q1[n, i] q0[n, j]
    M = torch.einsum("...ni,...nj->...ij", q1 * w, q0)
    q = max_eigvec_sym4x4(_horn_N(M))      # (w, x, y, z): q1 into q0
    R = quat_to_rotmat(q)
    t = mean0 - torch.einsum("...ij,...j->...i", R, mean1)
    return R, t


def skew(w: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` -> skew-symmetric ``(..., 3, 3)``."""
    z = torch.zeros_like(w[..., 0])
    rows = [[z, -w[..., 2], w[..., 1]],
            [w[..., 2], z, -w[..., 0]],
            [-w[..., 1], w[..., 0], z]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle ``(..., 3)`` -> rotation ``(..., 3, 3)``.

    Taylor-safe near zero; the trig branch is evaluated at a safe argument
    so its derivative stays finite where the Taylor branch is selected
    (the pose-graph solve differentiates through both)."""
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    safe = theta2 > 1e-12
    t2s = torch.where(safe, theta2, 1.0)
    theta = torch.sqrt(t2s)
    K = skew(w)
    A = torch.where(safe, torch.sin(theta) / theta, 1.0 - theta2 / 6.0)
    B = torch.where(safe, (1.0 - torch.cos(theta)) / t2s,
                    0.5 - theta2 / 24.0)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + A * K + B * matmul3(K, K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation ``(..., 3, 3)`` -> axis-angle ``(..., 3)`` (principal
    branch), differentiable away from theta = pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(c)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    safe = theta > 1e-7
    s = torch.where(safe, 2.0 * torch.sin(theta), 1.0)   # safe denominator
    scale = torch.where(safe[..., None], (theta / s)[..., None],
                        0.5 + theta[..., None] ** 2 / 12.0)
    return v * scale


def rotation_geodesic_deg(R0: torch.Tensor, R1: torch.Tensor) -> torch.Tensor:
    """Geodesic angle between two rotations, in degrees."""
    Rrel = R0.transpose(-1, -2) @ R1
    tr = Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2]
    c = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    return torch.arccos(c) * RADIAN2DEGREE


def correct_beam_angle(pts: torch.Tensor,
                       angle_deg: float = 0.22) -> torch.Tensor:
    """Velodyne beam-angle intrinsic correction on the device: rotate each
    point of ``pts (N, 3)`` by ``angle_deg`` about the axis ``p x z``
    (reference ``CorrectPC``, ``Transformations.py:28-39``), Rodrigues on
    the per-point axis.  A point on the z axis has no rotation axis and is
    left as it is."""
    z = torch.tensor([0.0, 0.0, 1.0], dtype=pts.dtype, device=pts.device)
    axis = torch.linalg.cross(pts, z.expand_as(pts))
    n = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.where(n < 1e-12, 1.0, n)
    out = _rotate(exp_so3(axis * math.radians(angle_deg)), pts)
    return torch.where(n < 1e-12, pts, out)


def correct_beam_angle_np(pts, angle_deg: float = 0.22):
    """Velodyne beam-angle intrinsic correction on the host (numpy copy of
    ``caelo_tpu/geometry/se3.py::correct_beam_angle_np``): rotate each point
    by ``angle_deg`` about the axis ``p x z`` (Rodrigues on the per-point
    axis).  Scan loading is host code, so the fix never touches the device.

    A point exactly on the z axis has no rotation axis and is left as it
    is (the reference collapses it to the origin)."""
    pts = np.asarray(pts)
    z = np.array([0.0, 0.0, 1.0], pts.dtype)
    axis = np.cross(pts, z)
    n = np.linalg.norm(axis, axis=-1, keepdims=True)
    k = axis / np.where(n < 1e-12, 1.0, n)
    th = np.float32(np.radians(angle_deg))
    # Rodrigues rotation of p about unit axis k by angle th
    out = (pts * np.cos(th)
           + np.cross(k, pts) * np.sin(th)
           + k * np.sum(k * pts, axis=-1, keepdims=True) * (1 - np.cos(th)))
    return np.where(n < 1e-12, pts, out).astype(pts.dtype)
