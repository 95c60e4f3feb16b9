"""The port's ``rescue_bursts`` against the JAX package on the CPU, on the
corrupted trajectory of ``tests/test_burst.py``'s splice test, at the map
budget the pipeline uses (``min(2048, IcpConfig.max_points)`` points a
frame).  A file of its own so that its JAX reference run, the suite's
second longest test, takes a worker of its own and does not queue behind
``tests/test_torch_burst.py``'s on one.  When a worker starts it is decided
by the file's line in ``tests/file_weights.json`` (heaviest first), not by
its single test."""
import numpy as np
import torch
import jax.numpy as jnp

from caelo_tpu.backend import burst as jburst
from caelo_tpu.backend import refine_runner as jrr
from caelo_tpu.config import PipelineConfig
from caelo_tpu_torch.backend import burst as tburst
from caelo_tpu_torch.backend import refine_runner as trr
from test_burst import _frame_cloud, _make_world, _rotz
from test_torch_burst import E, ICP_CFG, RES_TOL


def _splice_inputs():
    """test_rescue_bursts_splices_trajectory's sequence: 10 frames through
    a 5 deg/frame turn, frames 2-7 a 100 deg wedge (unhealthy), the
    trajectory straight through the burst."""
    rng = np.random.default_rng(1)
    world = _make_world(rng)
    n_frames = 10
    gt_R, gt_t = [], []
    R, t = np.eye(3), np.zeros(3)
    for k in range(n_frames):
        gt_R.append(R.copy())
        gt_t.append(t.copy())
        t = t + R @ np.array([0.8, 0.0, 0.0])
        R = R @ _rotz(np.radians(5.0))
    healthy = np.ones(n_frames, bool)
    healthy[2:8] = False
    pts, msk = [], []
    for k in range(n_frames):
        p, m = _frame_cloud(world, gt_R[k], gt_t[k], E,
                            wedge_deg=None if healthy[k] else 100.0, rng=rng)
        pts.append(p)
        msk.append(m)
    poses = []
    Rc, tc = np.eye(3), np.zeros(3)
    for k in range(n_frames):
        poses.append(np.hstack([Rc, tc[:, None]]).reshape(12))
        if healthy[min(k + 1, n_frames - 1)] and healthy[k]:
            Rn = gt_R[k].T @ gt_R[k + 1] if k + 1 < n_frames else np.eye(3)
            tn = gt_R[k].T @ (gt_t[k + 1] - gt_t[k]) \
                if k + 1 < n_frames else np.zeros(3)
        else:
            Rn, tn = np.eye(3), np.array([0.8, 0.0, 0.0])
        tc = tc + Rc @ tn
        Rc = Rc @ Rn
    feats = (np.stack(pts), np.stack(msk),
             np.zeros((n_frames, 8, 6), np.float32),
             np.zeros((n_frames, 8), bool))
    return np.stack(poses), feats, healthy, np.stack(gt_t)


def _rel_fn(p0, p1):
    P0 = np.asarray(p0).reshape(3, 4)
    P1 = np.asarray(p1).reshape(3, 4)
    return P0[:, :3].T @ P1[:, :3], P0[:, :3].T @ (P1[:, 3] - P0[:, 3])


def _apply_fn(p0, Rr, tr_):
    P0 = np.asarray(p0).reshape(3, 4)
    return np.hstack([P0[:, :3] @ Rr,
                      (P0[:, :3] @ tr_ + P0[:, 3])[:, None]]).reshape(12)


def test_rescue_bursts_matches_jax():
    """rescue_bursts on the same corrupted trajectory, each package with
    its own make_batched_icp_fn as pair_icp_fn (the closure polish and the
    per-pair polish run), max_span 8 (JAX pads the 7 pairs to 8, not to
    its 16 bucket): same spans, accepted, rejected and closure sources;
    gains within RES_TOL (5e-4 m), poses within 1e-3.  The splice repairs
    the trajectory."""
    poses, feats, healthy, gt_pos = _splice_inputs()
    cfg = PipelineConfig(icp=ICP_CFG)
    ft = trr.RefinementFeatures(*(torch.from_numpy(x) for x in feats))
    fj = jrr.RefinementFeatures(*(jnp.asarray(x) for x in feats))
    pt, st = tburst.rescue_bursts(poses, ft, healthy, _rel_fn, _apply_fn,
                                  cfg, max_span=8,
                                  pair_icp_fn=trr.make_batched_icp_fn(ft, cfg))
    pj, sj = jburst.rescue_bursts(poses, fj, healthy, _rel_fn, _apply_fn,
                                  cfg, max_span=8,
                                  pair_icp_fn=jrr.make_batched_icp_fn(fj, cfg))
    assert st.spans == sj.spans == [(1, 8)]
    assert st.accepted == sj.accepted == [(1, 8)]
    assert st.rejected == sj.rejected
    assert [c[:2] for c in st.closures] == [c[:2] for c in sj.closures]
    assert ([c[2].split("(")[0] for c in st.closures]
            == [c[2].split("(")[0] for c in sj.closures])
    assert "polish" in st.closures[0][2]
    # a gain is a difference of two map-ICP residuals: under a one-ulp change
    # of the inputs those move by 5.1e-4 m on a wedge span (tests/
    # test_torch_burst.py::test_jax_burst_map_icp_conditioning), so the
    # gains carry the bound
    # that the residuals already use
    np.testing.assert_allclose(st.gains, sj.gains, atol=RES_TOL, rtol=0)
    np.testing.assert_allclose(pt, pj, atol=1e-3, rtol=0)
    err = lambda p: np.linalg.norm(p.reshape(-1, 3, 4)[:, :, 3] - gt_pos, 1)
    assert err(pt).max() < 0.35 * err(poses).max()
