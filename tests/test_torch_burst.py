"""The port's burst rescue against the JAX package on the CPU, on the
inputs of ``tests/test_burst.py``: ``burst_map_icp`` (padded to a larger
static span in JAX; the port solves the active frames only, and ends each
frame's ICP at its first frozen trip); ``rescue_bursts`` is in
``tests/test_torch_burst_rescue.py``.  Each test states its tolerance."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from caelo_tpu.backend import burst as jburst
from caelo_tpu.config import IcpConfig
from caelo_tpu_torch.backend import burst as tburst
from test_burst import _frame_cloud, _make_world, _rotz

E = 2048
ICP_CFG = IcpConfig(max_points=E, max_iters=20, min_inliers=60)


def _turn_inputs():
    """test_burst_map_icp_recovers_turn's span: 8 frames through a 6
    deg/frame turn, the 6 interior frames a 90 deg wedge, initialised
    straight."""
    rng = np.random.default_rng(0)
    world = _make_world(rng)
    n_frames = 8
    gt_R, gt_t = [], []
    R, t = np.eye(3), np.zeros(3)
    for k in range(n_frames):
        gt_R.append(R.copy())
        gt_t.append(t.copy())
        t = t + R @ np.array([0.8, 0.0, 0.0])
        R = R @ _rotz(np.radians(6.0))
    pts, msk = [], []
    for k in range(n_frames):
        wedge = None if k in (0, n_frames - 1) else 90.0
        p, m = _frame_cloud(world, gt_R[k], gt_t[k], E, wedge_deg=wedge,
                            rng=rng)
        pts.append(p)
        msk.append(m)
    init_R = np.stack([np.eye(3)] * (n_frames - 1)).astype(np.float32)
    init_t = np.tile([0.8, 0.0, 0.0], (n_frames - 1, 1)).astype(np.float32)
    true_t = np.stack([gt_R[k].T @ (gt_t[k + 1] - gt_t[k])
                       for k in range(n_frames - 1)])
    return np.stack(pts), np.stack(msk), init_R, init_t, true_t


# The rel-translation and per-frame residual bounds of the parity test: at
# most twice the spread of the JAX result itself under a one-ulp nudge of
# its input points, which test_jax_burst_map_icp_conditioning measures.
REL_T_TOL = 5e-3
RES_TOL = 5e-4


def _jax_solve(pts, msk, init_R, init_t):
    """The JAX solve of a span at a static span one slot past its active
    pairs (that frame a copy of the exit anchor)."""
    L = init_R.shape[0]
    pad = lambda a, fill: np.concatenate([a, fill[None]])
    out = jburst.burst_map_icp(
        jnp.asarray(pad(pts, pts[-1])), jnp.asarray(pad(msk, msk[-1])),
        jnp.asarray(pad(init_R, np.eye(3, dtype=np.float32))),
        jnp.asarray(pad(init_t, np.zeros(3, np.float32))),
        jnp.asarray(L, jnp.int32), icp_cfg=ICP_CFG, max_span=L + 1,
        frame_budget=512, thr_scale=2.0)
    return [np.asarray(x) for x in out]


def _count_nn_passes(calls):
    """Wrap the port's nearest_neighbors so each pass appends to ``calls``;
    returns the function that restores it."""
    nn = tburst.nearest_neighbors
    tburst.nearest_neighbors = lambda *a: calls.append(1) or nn(*a)
    return lambda: setattr(tburst, "nearest_neighbors", nn)


@pytest.fixture(scope="module")
def turn():
    """The JAX solve of the turn span at a static span of 8 (the 7 active
    pairs and one slot past them), and the port's solve of the 7 active
    pairs with the early exit, with the number of its correspondence
    passes."""
    pts, msk, init_R, init_t, true_t = _turn_inputs()
    out_j = _jax_solve(pts, msk, init_R, init_t)
    args = [torch.from_numpy(a) for a in (pts, msk, init_R, init_t)]
    calls = []
    restore = _count_nn_passes(calls)
    try:
        out_t = tburst.burst_map_icp(*args, init_R.shape[0], icp_cfg=ICP_CFG,
                                     frame_budget=512, thr_scale=2.0)
    finally:
        restore()
    return args, out_j, out_t, true_t, len(calls)


def test_burst_map_icp_matches_jax(turn):
    """Same per-frame success and closure success; rotations of the rels
    and the closure within 1e-3; rel translations within REL_T_TOL (5e-3
    m) and the per-frame residuals within RES_TOL (5e-4 m); the closure
    residual within 1e-4 m.

    The two looser bounds follow the reference's own float32 conditioning
    on this span (test_jax_burst_map_icp_conditioning): the rels of the
    wedge frames lie in a flat valley, and an ulp can flip one ICP's
    convergence trip.  At the metric level the port holds what
    tests/test_burst.py holds JAX to: interior rels within 0.1 m of the
    true motion.  The JAX slot past span_len passes its input rel through
    and is not ok; the port has no such slot."""
    _, out_j, out_t, true_t, _ = turn
    (rRs, rTs, oks, r0s, r1s, R_cl, t_cl, ok_cl, cl_res) = out_t
    L = rRs.shape[0]
    assert oks.all() and ok_cl
    np.testing.assert_array_equal(oks, out_j[2][:L])
    assert not out_j[2][L]
    np.testing.assert_array_equal(out_j[0][L], np.eye(3))
    for a, b, tol in ((rRs, out_j[0][:L], 1e-3),
                      (rTs, out_j[1][:L], REL_T_TOL),
                      (R_cl, out_j[5], 1e-3), (t_cl, out_j[6], 1e-3)):
        np.testing.assert_allclose(a.numpy(), b, atol=tol, rtol=0)
    assert bool(out_j[7]) == ok_cl
    np.testing.assert_allclose(r0s, out_j[3][:L], atol=RES_TOL, rtol=0)
    np.testing.assert_allclose(r1s, out_j[4][:L], atol=RES_TOL, rtol=0)
    np.testing.assert_allclose(cl_res, out_j[8], atol=1e-4, rtol=0)
    assert (r0s - r1s).mean() > 0.05             # the solve really gained
    err = np.linalg.norm(rTs.numpy() - true_t, axis=1)[1:-1]
    assert err.max() < 0.1, err


def test_jax_burst_map_icp_conditioning(turn):
    """The measurement behind REL_T_TOL and RES_TOL: moving every input
    point of the turn span by one ulp (np.nextafter, upward) moves the JAX
    result itself by at least half of each bound (on the CPU: 3.3e-3 m in
    the rel translations, 5.1e-4 m in the per-frame residuals), so both
    bounds are at most twice the reference's own spread.  The per-frame
    success stays the same."""
    args, out_j, _, _, _ = turn
    pts, msk, init_R, init_t = (a.numpy() for a in args)
    L = init_R.shape[0]
    nudged = _jax_solve(np.nextafter(pts, np.float32(np.inf)), msk, init_R,
                        init_t)
    np.testing.assert_array_equal(nudged[2], out_j[2])
    rel_t_spread = np.abs(nudged[1][:L] - out_j[1][:L]).max()
    res_spread = max(np.abs(nudged[k][:L] - out_j[k][:L]).max()
                     for k in (3, 4))
    assert rel_t_spread >= REL_T_TOL / 2, rel_t_spread
    assert res_spread >= RES_TOL / 2, res_spread


def _icp_vs_map_all_trips(pc, msk, mpts, mmsk, R0, t0, icp_cfg, thr_scale):
    """The map ICP with every one of its max_iters trips run, as the JAX
    fori_loop runs them (a frozen trip still computes its step, then
    applies the identity)."""
    st = tburst.MapIcp(pc, msk, mpts, mmsk, R0, t0, icp_cfg, thr_scale)
    for i in range(icp_cfg.max_iters):
        st.trip(i)
    return st.result()


def test_burst_map_icp_early_exit_equals_all_trips(turn, monkeypatch):
    """Ending each frame's ICP at its first frozen trip (the fixture's
    solve) returns exactly what all max_iters trips return, in fewer
    correspondence passes."""
    args, _, early, _, n_early = turn
    calls = []
    monkeypatch.setattr(tburst, "icp_vs_map", _icp_vs_map_all_trips)
    restore = _count_nn_passes(calls)
    try:
        full = tburst.burst_map_icp(*args, args[2].shape[0],
                                    icp_cfg=ICP_CFG, frame_budget=512,
                                    thr_scale=2.0)
    finally:
        restore()
    assert n_early < len(calls)
    for a, b in zip(early, full):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)
