"""Pose-graph optimisation (port of ``caelo_tpu/backend/posegraph.py``).

Poses are ``(R, t)`` tensors; a Gauss-Newton step solves for per-node
tangent increments (rotation right-increment, translation additive, node 0
gauge-fixed) with residuals ``Log(Rm^T Ri^T Rj)`` and ``Ri^T (tj - ti) -
tm`` per edge.

* ``optimize``: the matrix-free solve on the device, ``J^T J v`` through
  ``torch.func.jvp``/``vjp`` and conjugate gradients stopping by the rule
  of ``jax.scipy.sparse.linalg.cg``.
* ``optimize_host``: the exact solve the pipeline calls, host float64 with
  a scipy sparse LU; a numpy copy of the JAX function (its module imports
  JAX).
* ``optimize_sharded``: ``optimize`` with the edges over the ranks of a
  mesh's ``"data"`` dimension and the edge sums all-reduced.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vjp

from ..geometry import se3
from ..parallel.mesh import all_reduce_sum, axis, shard_rows


class PoseGraph(NamedTuple):
    edge_i: torch.Tensor    # (E,) int32 source node
    edge_j: torch.Tensor    # (E,) int32 target node
    rel_R: torch.Tensor     # (E, 3, 3) measured R (node j in node i frame)
    rel_t: torch.Tensor     # (E, 3)
    weight: torch.Tensor    # (E,) nonnegative (0 = padded/disabled edge)
    rot_info: torch.Tensor  # (E,) rotation information weight


def odometry_graph(rel_Rs, rel_ts, weight=1.0, rot_info=100.0) -> PoseGraph:
    """Chain graph from per-frame relative motions."""
    rel_R = torch.as_tensor(rel_Rs)
    n = rel_R.shape[0]
    return PoseGraph(
        edge_i=torch.arange(n, dtype=torch.int32),
        edge_j=torch.arange(1, n + 1, dtype=torch.int32),
        rel_R=rel_R, rel_t=torch.as_tensor(rel_ts),
        weight=torch.full((n,), weight, dtype=torch.float32),
        rot_info=torch.full((n,), rot_info, dtype=torch.float32))


def concat_graphs(a: PoseGraph, b: PoseGraph) -> PoseGraph:
    """Edges of ``a`` then ``b``, each field in the wider of the two
    dtypes."""
    cat = lambda x, y, dt: torch.cat([x.to(dt), y.to(x.device, dt)])
    return PoseGraph(*(cat(x, y, torch.promote_types(x.dtype, y.dtype))
                       for x, y in zip(a, b)))


def _apply_delta(R, t, delta):
    """Right-increment retraction: R exp(dw), t + dt."""
    return se3.matmul3(R, se3.exp_so3(delta[:, 0:3])), t + delta[:, 3:6]


def _residuals(R, t, g: PoseGraph):
    ei, ej = g.edge_i.long(), g.edge_j.long()
    Ri, Rj, ti, tj = R[ei], R[ej], t[ei], t[ej]
    Rij = se3.matmul3(Ri.transpose(-1, -2), Rj)
    r_rot = se3.log_so3(se3.matmul3(g.rel_R.transpose(-1, -2), Rij))
    r_t = (Ri * (tj - ti)[..., :, None]).sum(-2) - g.rel_t
    w = torch.sqrt(torch.clamp_min(g.weight, 0.0))[:, None]
    wr = torch.sqrt(torch.clamp_min(g.weight * g.rot_info, 0.0))[:, None]
    return torch.cat([wr * r_rot, w * r_t], 1)           # (E, 6)


def cg(A, b: torch.Tensor, maxiter: int, tol: float = 1e-5,
       atol: float = 0.0) -> torch.Tensor:
    """Conjugate gradients from ``x0 = 0`` for the SPD operator ``A``,
    stopping as ``jax.scipy.sparse.linalg.cg`` does: once ``||r||^2 <=
    max(tol^2 ||b||^2, atol^2)`` or after ``maxiter`` steps.  Reads the
    residual norm on the host once per step."""
    x = torch.zeros_like(b)
    r = b - A(x)
    p = r
    gamma = (r * r).sum()
    atol2 = max(tol * tol * float((b * b).sum()), atol * atol)
    k = 0
    while float(gamma) > atol2 and k < maxiter:
        Ap = A(p)
        alpha = gamma / (p * Ap).sum()
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_ = (r * r).sum()
        p = r + (gamma_ / gamma) * p
        gamma = gamma_
        k += 1
    return x


def _gn_step(R, t, g: PoseGraph, damping: float, cg_iters: int, reduce):
    """One Gauss-Newton step; ``reduce`` sums the edge terms (``J^T J v``,
    the gradient, the cost) over the ranks that hold the other edges."""
    n = R.shape[0]

    def res_of_delta(delta_flat):
        delta = delta_flat.reshape(n, 6)
        delta = torch.cat([torch.zeros_like(delta[:1]), delta[1:]])  # gauge
        return _residuals(*_apply_delta(R, t, delta), g).reshape(-1)

    zero = torch.zeros(n * 6, dtype=R.dtype, device=R.device)
    r0, vjp_fn = vjp(res_of_delta, zero)

    def JTJv(v):
        _, jv = jvp(res_of_delta, (zero,), (v,))
        (jtjv,) = vjp_fn(jv)
        return reduce(jtjv) + damping * v

    (b,) = vjp_fn(r0)
    delta = cg(JTJv, -reduce(b), maxiter=cg_iters).reshape(n, 6)
    delta = torch.cat([torch.zeros_like(delta[:1]), delta[1:]])
    Rn, tn = _apply_delta(R, t, delta)
    return Rn, tn, reduce((r0 * r0).sum())


def optimize(R0: torch.Tensor, t0: torch.Tensor, graph: PoseGraph,
             n_iters: int = 10, cg_iters: int = 30, damping: float = 1e-4):
    """Gauss-Newton pose-graph solve on the device of ``R0``.  Returns
    ``(R, t, cost)``, ``cost`` the squared residual at the last step's
    start."""
    return _optimize(R0, t0, graph, n_iters, cg_iters, damping,
                     lambda x: x)


def _optimize(R0, t0, graph: PoseGraph, n_iters, cg_iters, damping, reduce):
    dev, dt = R0.device, R0.dtype
    g = PoseGraph(*(x.to(dev) if x.dtype in (torch.int32, torch.int64)
                    else x.to(dev, dt) for x in graph))
    R, t = R0, t0.to(dev, dt)
    cost = torch.zeros((), dtype=dt, device=dev)
    with torch.no_grad():
        for _ in range(n_iters):
            R, t, cost = _gn_step(R, t, g, damping, cg_iters, reduce)
    return R, t, cost


def optimize_sharded(mesh, n_nodes: int, n_iters: int = 10,
                     cg_iters: int = 30, damping: float = 1e-4):
    """Distributed solve: edges sharded over the mesh's ``"data"`` ranks,
    poses replicated, the ``J^T J v`` of every CG step, the gradient and
    the cost all-reduced across the ranks, so every rank takes the same
    steps (the same fixed Gauss-Newton iterations as ``optimize``).

    Returns ``fn(R0, t0, graph)``, called by every data rank with the whole
    graph; each rank keeps its contiguous block of the edges, so pad the
    edge count to a multiple of the data size with weight-0 edges.
    """
    group, _, _ = axis(mesh)

    def solve(R0, t0, graph: PoseGraph):
        if R0.shape[0] != n_nodes:
            raise ValueError(f"{R0.shape[0]} poses for {n_nodes} nodes")
        return _optimize(R0, t0, shard_rows(graph, mesh), n_iters, cg_iters,
                         damping, lambda x: all_reduce_sum(x, group))

    return solve


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else (
        np.asarray(x))


def optimize_host(R0, t0, graph: PoseGraph, n_iters: int = 20,
                  damping: float = 1e-6, tol: float = 1e-12):
    """Exact Gauss-Newton pose-graph solve on host float64 (scipy sparse LU).

    A chain-plus-loops graph has normal-equation condition number O(N^2),
    so matrix-free CG needs ~N iterations; the normal equations are
    block-tridiagonal plus a few loop off-diagonals, and a direct sparse
    factorisation solves them exactly.  Same parameterisation and residuals
    as ``optimize``; analytic Jacobians with the exact SO(3) right-Jacobian
    inverse; a Levenberg-style step control accepts a step only if it
    lowers the cost.

    Returns ``(R (N,3,3) f64, t (N,3) f64, final_cost)``.
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    R = np.asarray(_host(R0), np.float64).copy()
    t = np.asarray(_host(t0), np.float64).copy()
    ei = _host(graph.edge_i).astype(np.int64)
    ej = _host(graph.edge_j).astype(np.int64)
    Rm = _host(graph.rel_R).astype(np.float64)
    tm = _host(graph.rel_t).astype(np.float64)
    weight = _host(graph.weight).astype(np.float64)
    w = np.sqrt(np.maximum(weight, 0.0))
    wr = np.sqrt(np.maximum(
        weight * _host(graph.rot_info).astype(np.float64), 0.0))
    N = R.shape[0]
    E = ei.shape[0]

    def hat(v):
        out = np.zeros(v.shape[:-1] + (3, 3))
        out[..., 0, 1] = -v[..., 2]
        out[..., 0, 2] = v[..., 1]
        out[..., 1, 0] = v[..., 2]
        out[..., 1, 2] = -v[..., 0]
        out[..., 2, 0] = -v[..., 1]
        out[..., 2, 1] = v[..., 0]
        return out

    def log_so3(M):
        tr = np.clip((np.trace(M, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
        th = np.arccos(tr)
        ax = np.stack([M[..., 2, 1] - M[..., 1, 2],
                       M[..., 0, 2] - M[..., 2, 0],
                       M[..., 1, 0] - M[..., 0, 1]], axis=-1)
        s = np.where(th > 1e-7, th / np.maximum(2.0 * np.sin(th), 1e-30), 0.5)
        return ax * s[..., None]

    def exp_so3(v):
        th = np.linalg.norm(v, axis=-1, keepdims=True)
        th_ = np.maximum(th, 1e-30)
        K = hat(v / th_)
        s = np.sin(th)[..., None]
        c = (1.0 - np.cos(th))[..., None]
        eye = np.broadcast_to(np.eye(3), K.shape)
        out = eye + s * K + c * (K @ K)
        return np.where(th[..., None] > 1e-12, out, eye + hat(v))

    def jr_inv(phi):
        """Inverse right Jacobian of SO(3) at phi (batched)."""
        th = np.linalg.norm(phi, axis=-1)
        P = hat(phi)
        eye = np.broadcast_to(np.eye(3), P.shape)
        small = th < 1e-6
        th_ = np.where(small, 1.0, th)
        coef = np.where(
            small, 1.0 / 12.0,
            1.0 / th_**2 - (1.0 + np.cos(th_)) / (2.0 * th_ * np.sin(th_)
                                                  + 1e-300))
        return eye + 0.5 * P + coef[..., None, None] * (P @ P)

    def residuals(R, t):
        A = np.einsum("eji,ejk->eik", R[ei], R[ej])        # Ri^T Rj
        Er = np.einsum("eji,ejk->eik", Rm, A)              # Rm^T Ri^T Rj
        r_rot = log_so3(Er)
        u = np.einsum("eji,ej->ei", R[ei], t[ej] - t[ei])  # Ri^T (tj - ti)
        r_t = u - tm
        return r_rot, r_t, A, u

    def cost_of(r_rot, r_t):
        return float(np.sum((wr[:, None] * r_rot) ** 2)
                     + np.sum((w[:, None] * r_t) ** 2))

    prev_cost = np.inf
    for _ in range(n_iters):
        r_rot, r_t, A, u = residuals(R, t)
        cost = cost_of(r_rot, r_t)
        if np.isfinite(prev_cost) and (
                prev_cost - cost <= tol * max(prev_cost, 1.0)):
            break
        prev_cost = cost
        Jri = jr_inv(r_rot)
        # rotation rows: d r_rot/d wj = Jr^{-1}, d r_rot/d wi = -Jr^{-1} A^T
        drot_dwj = wr[:, None, None] * Jri
        drot_dwi = -np.einsum("eik,ejk->eij", drot_dwj, A)  # -Jri @ A^T
        # translation rows: d r_t/d ti = -Ri^T, d r_t/d tj = Ri^T,
        # d r_t/d wi = [u]x
        RiT = np.swapaxes(R[ei], -1, -2)
        dt_dtj = w[:, None, None] * RiT
        dt_dti = -dt_dtj
        dt_dwi = w[:, None, None] * hat(u)
        # assemble sparse J (6E x 6N): rows [rot(3); trans(3)] per edge,
        # cols [w(3); t(3)] per node
        blocks = [
            (0, ei, 0, drot_dwi), (0, ej, 0, drot_dwj),
            (3, ei, 0, dt_dwi), (3, ei, 3, dt_dti), (3, ej, 3, dt_dtj),
        ]
        rows, cols, vals = [], [], []
        e_base = 6 * np.arange(E)
        rr, cc = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
        for row_off, nodes, col_off, B in blocks:
            rows.append((e_base[:, None, None] + row_off + rr).ravel())
            cols.append((6 * nodes[:, None, None] + col_off + cc).ravel())
            vals.append(B.ravel())
        J = sp.csr_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(6 * E, 6 * N))
        r = np.concatenate(
            [wr[:, None] * r_rot, w[:, None] * r_t], axis=1).ravel()
        # gauge: drop node 0's columns
        Jf = J[:, 6:].tocsc()
        # step control: accept a step only if it lowers the cost, else
        # raise the damping and re-solve
        lam = damping
        JtJ = (Jf.T @ Jf).tocsc()
        b = Jf.T @ r
        stepped = False
        for _ in range(8):
            H = (JtJ + lam * sp.identity(6 * (N - 1))).tocsc()
            delta = spla.spsolve(H, -b)
            if not np.all(np.isfinite(delta)):
                lam *= 100.0
                continue
            d = np.zeros((N, 6))
            d[1:] = delta.reshape(N - 1, 6)
            R_new = R @ exp_so3(d[:, 0:3])
            t_new = t + d[:, 3:6]
            rr2, rt2, _, _ = residuals(R_new, t_new)
            if cost_of(rr2, rt2) <= cost:
                R, t = R_new, t_new
                stepped = True
                break
            lam *= 10.0
        if not stepped:
            break
    r_rot, r_t, _, _ = residuals(R, t)
    return R, t, cost_of(r_rot, r_t)
