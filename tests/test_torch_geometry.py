"""Port parity: rotation algebra, the Horn solve, host pose chaining and the
masking primitives against the JAX package on the same numpy inputs."""
import numpy as np
import torch
import jax.numpy as jnp

from caelo_tpu.geometry import kitti_pose as jkp
from caelo_tpu.geometry import se3 as jse3
from caelo_tpu.ops import masking as jmask
from caelo_tpu_torch.geometry import kitti_pose as tkp
from caelo_tpu_torch.geometry import se3 as tse3
from caelo_tpu_torch.ops import masking as tmask


def _sym4(rng, B):
    A = rng.normal(size=(B, 4, 4)).astype(np.float32)
    return (A + np.swapaxes(A, 1, 2)).astype(np.float32)


def _rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.asarray(jse3.quat_to_rotmat(jnp.asarray(q)), np.float64)


def _same_axis(v, ref):
    """Eigenvectors agree up to sign."""
    s = np.sign(np.sum(v * ref, axis=-1, keepdims=True))
    np.testing.assert_allclose(v * s, ref, atol=1e-5)


def test_jacobi_lanes_matches_jax(rng):
    A = _sym4(rng, 64)
    lanes = np.ascontiguousarray(A.transpose(1, 2, 0))          # (4, 4, B)
    ref = np.asarray(jse3.max_eigvec_sym4x4_lanes(jnp.asarray(lanes)))
    out = tse3.max_eigvec_sym4x4_lanes(torch.from_numpy(lanes)).numpy()
    _same_axis(out.T, ref.T)


def test_jacobi_batched_matches_jax(rng):
    A = _sym4(rng, 24).reshape(2, 12, 4, 4)
    ref = np.asarray(jse3.max_eigvec_sym4x4(jnp.asarray(A)))
    out = tse3.max_eigvec_sym4x4(torch.from_numpy(A)).numpy()
    assert out.shape == (2, 12, 4)
    _same_axis(out, ref)


def test_horn_matches_jax(rng):
    B, N = 5, 40
    p1 = rng.normal(size=(B, N, 3)).astype(np.float32) * 5
    R = _rot(rng, B).astype(np.float32)
    t = rng.normal(size=(B, 3)).astype(np.float32)
    p0 = (np.einsum("bij,bnj->bni", R, p1) + t[:, None]
          + rng.normal(0, 0.01, (B, N, 3))).astype(np.float32)
    w = (rng.uniform(size=(B, N)) < 0.8).astype(np.float32)
    Rj, tj = jse3.solve_rigid_horn(jnp.asarray(p0), jnp.asarray(p1),
                                   jnp.asarray(w))
    Rt, tt = tse3.solve_rigid_horn(torch.from_numpy(p0), torch.from_numpy(p1),
                                   torch.from_numpy(w))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_allclose(Rt.numpy(), R, atol=1e-2)


def test_quat_and_geodesic_match_jax(rng):
    q = rng.normal(size=(7, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    Rj = np.asarray(jse3.quat_to_rotmat(jnp.asarray(q)))
    Rt = tse3.quat_to_rotmat(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    R0, R1 = Rt[:-1], Rt[1:]
    gj = np.asarray(jse3.rotation_geodesic_deg(jnp.asarray(R0), jnp.asarray(R1)))
    gt = tse3.rotation_geodesic_deg(torch.from_numpy(R0),
                                    torch.from_numpy(R1)).numpy()
    np.testing.assert_allclose(gt, gj, atol=1e-3)


def test_chain_poses_and_lidar_rel_match_jax(rng):
    n = 6
    rel_R, rel_t = _rot(rng, n), rng.normal(size=(n, 3))
    R_tr, t_tr = _rot(rng, 1)[0], rng.normal(size=3)
    pose0 = np.concatenate([_rot(rng, 1)[0], rng.normal(size=(3, 1))], 1)
    ref = jkp.chain_poses(rel_R, rel_t, R_tr, t_tr, pose0.reshape(12))
    out = tkp.chain_poses(rel_R, rel_t, R_tr, t_tr, pose0.reshape(12))
    np.testing.assert_array_equal(out, ref)
    Rj, tj = jkp.lidar_rel_to_cam(jnp.asarray(rel_R), jnp.asarray(rel_t),
                                  jnp.asarray(R_tr), jnp.asarray(t_tr))
    Rt, tt = tkp.lidar_rel_to_cam(rel_R, rel_t, R_tr, t_tr)
    np.testing.assert_allclose(Rt, np.asarray(Rj), atol=1e-12)
    np.testing.assert_allclose(tt, np.asarray(tj), atol=1e-12)


def test_masking_matches_jax(rng):
    pts = rng.normal(size=(30, 4)).astype(np.float32)
    for size in (20, 40):
        ref = jmask.pad_points(pts, size)
        out = tmask.pad_points(pts, size)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
    data = rng.integers(0, 100, (50, 3)).astype(np.int32)
    mask = rng.uniform(size=50) < 0.5
    for size in (10, int(mask.sum()), 64):
        ref = jmask.compact(jnp.asarray(data), jnp.asarray(mask), size, fill=-1)
        out = tmask.compact(torch.from_numpy(data), torch.from_numpy(mask),
                            size, fill=-1)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_se3_transform_algebra_matches_jax(rng):
    """apply, compose, inverse and XYZ Euler angles on float32 batches:
    within 1e-6."""
    B, N = 4, 9
    R1, R2 = (_rot(rng, B).astype(np.float32) for _ in range(2))
    t1, t2 = (rng.normal(size=(B, 3)).astype(np.float32) for _ in range(2))
    pts = rng.normal(size=(B, N, 3)).astype(np.float32) * 5
    J = lambda *a: [jnp.asarray(x) for x in a]
    T = lambda *a: [torch.from_numpy(x) for x in a]
    np.testing.assert_allclose(tse3.apply(*T(R1, t1, pts)).numpy(),
                               np.asarray(jse3.apply(*J(R1, t1, pts))),
                               atol=1e-6, rtol=0)
    for a, b in zip(tse3.compose(*T(R1, t1, R2, t2)),
                    jse3.compose(*J(R1, t1, R2, t2))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for a, b in zip(tse3.inverse(*T(R1, t1)), jse3.inverse(*J(R1, t1))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(
        tse3.rotmat_to_euler_xyz_deg(*T(R1)).numpy(),
        np.asarray(jse3.rotmat_to_euler_xyz_deg(*J(R1))), atol=1e-6)


def test_rel_poses_match_jax(rng):
    """poses_to_rt, rel_pose_cam and rel_pose_lidar in host float64,
    against JAX under x64: within 1e-12."""
    n = 5
    poses = np.concatenate([_rot(rng, n), rng.normal(size=(n, 3, 1)) * 10],
                           2).reshape(n, 12)
    R_tr, t_tr = _rot(rng, 1)[0], rng.normal(size=3)
    for a, b in zip(tkp.poses_to_rt(poses),
                    jkp.poses_to_rt(jnp.asarray(poses))):
        np.testing.assert_array_equal(a, np.asarray(b))
    p0, p1 = poses[:-1], poses[1:]
    for a, b in zip(tkp.rel_pose_cam(p0, p1),
                    jkp.rel_pose_cam(jnp.asarray(p0), jnp.asarray(p1))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-12)
    for a, b in zip(tkp.rel_pose_lidar(p0[1], p1[2], R_tr, t_tr),
                    jkp.rel_pose_lidar(jnp.asarray(p0[1]), jnp.asarray(p1[2]),
                                       jnp.asarray(R_tr), jnp.asarray(t_tr))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-12)
