"""The port's run_full_pipeline against the JAX package on the CPU: 12
out-and-back scans with a 4-frame burst and loop closure on, JAX's RANSAC
draws injected at every stage, and what the pipeline hands refinement and
burst rescue.  (Beside tests/test_torch_loop.py, whose revisiting scene and
draw helpers it shares, so the two heaviest JAX references run on two
workers.)"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation

from caelo_tpu import pipeline as jpipe
from caelo_tpu.frontend import registration as jreg
from caelo_tpu_torch import pipeline as tpipe
from caelo_tpu_torch.models.weights_io import build_models, random_flax_params
from test_torch_loop import CFG, jax_draw, jax_loop_samples, revisit_scans


@pytest.fixture(scope="module")
def nets():
    """random_flax_params(0) (Flax layout, made with numpy: no Flax init to
    compile) for both packages."""
    rp, ep = random_flax_params(0)
    return (rp, ep), build_models(rp, ep, "cpu", CFG)


def jax_anchor_samples(feats, cfg, seed=0):
    """``anchor_samples`` seam of the port: the draw of JAX's burst anchor
    registration, fold_in(key(seed + 31), i) (caelo_tpu/pipeline.py:
    690-707), with the caller's prior and the 5 m gate."""
    acfg = dataclasses.replace(
        cfg, ransac=dataclasses.replace(cfg.ransac, min_inlier_abs=60))
    frame = lambda k: jreg.FrameFeatures(*(jnp.asarray(x[k]) for x in feats))

    def samples(i, j, R_prior, t_prior):
        prior = (jnp.asarray(R_prior, jnp.float32),
                 jnp.asarray(t_prior, jnp.float32))
        return jax_draw(jax.random.fold_in(jax.random.key(seed + 31), i),
                        frame(i), frame(j), acfg, prior, gate_m=5.0)

    return samples


BURST = (3, 4, 5, 6)        # thinned to 40 %: one burst, span (2, 7)


def test_run_full_pipeline_matches_jax(nets, monkeypatch):
    """12 out-and-back scans, scans 3-6 thinned to 40 % (a 4-frame burst
    through the turn-around), loop closure on (min_loop_gap 8), with JAX's
    RANSAC draws injected at every stage (drawn from the features of JAX's
    own front-end window, kept from its run): all four pose arrays within
    1e-3; equal de-jumped frames, refinement stats, burst stats (spans,
    accepted, rejected, closure sources) and loop edges.  Every stage
    runs: the burst span is solved, a closure is accepted and the graph
    solved."""
    import caelo_tpu.frontend.odometry as jodo
    from test_torch_slice import _jax_window_samples

    (rp, ep), (net, enc) = nets
    scans = revisit_scans(thin=BURST)
    R_tr = Rotation.from_euler("xyz", [90, 0, 90], degrees=True).as_matrix()
    t_tr = np.array([0.01, -0.07, -0.27])
    kw = dict(R_tr=R_tr, t_tr=t_tr, cfg=CFG, enable_loop_closure=True,
              min_loop_gap=8, seed=0)
    kept = []
    window = jodo.run_odometry_windowed
    monkeypatch.setattr(jodo, "run_odometry_windowed", lambda *a, **k: (
        lambda out: kept.append(out[1]) or out)(window(*a, **k)))
    jres = jpipe.run_full_pipeline(scans, rp, ep, **kw)
    monkeypatch.undo()
    jfeats = [np.asarray(x) for x in kept[0]]
    samples, _ = _jax_window_samples(jfeats, len(scans), len(scans), 0, CFG)
    tres = tpipe.run_full_pipeline(
        scans, net, enc, samples=samples,
        loop_samples=jax_loop_samples(jfeats, CFG),
        anchor_samples=jax_anchor_samples(jfeats, CFG), **kw)
    np.testing.assert_array_equal(tres.odometry.successes,
                                  jres.odometry.successes)
    for name in ("poses_raw", "poses_dejumped", "poses_refined",
                 "poses_final"):
        np.testing.assert_allclose(getattr(tres, name), getattr(jres, name),
                                   atol=1e-3, rtol=0, err_msg=name)
    assert tres.dejumped_frames == jres.dejumped_frames
    assert (dataclasses.asdict(tres.refine_stats)
            == dataclasses.asdict(jres.refine_stats))
    bt, bj = tres.burst_stats, jres.burst_stats
    assert bt.spans == bj.spans == [(2, 7)]
    assert bt.accepted == bj.accepted and bt.rejected == bj.rejected
    assert bt.accepted + bt.rejected == [(2, 7)] and bt.gains
    src = lambda s: [(a, b, c.split("(")[0]) for a, b, c in s.closures]
    assert src(bt) == src(bj)
    np.testing.assert_allclose(bt.gains, bj.gains, atol=1e-4)
    assert tres.n_loop_closures == jres.n_loop_closures >= 1
    np.testing.assert_array_equal(tres.loop_edge_i, jres.loop_edge_i)
    np.testing.assert_array_equal(tres.loop_edge_j, jres.loop_edge_j)
    assert np.abs(tres.poses_final - tres.poses_refined).max() > 1e-6


def test_run_full_pipeline_keeps_burst_pairs_out_of_refinement(nets,
                                                               monkeypatch):
    """Pairs inside a burst span reach the pairwise refinement marked
    trusted (so it skips them; stage 3b owns them), as the JAX pipeline's
    ``refine_trusted`` does; every other pair keeps the front end's
    ``success & healthy`` trust.  Refinement and rescue are stubbed: this
    checks what the pipeline hands them."""
    from caelo_tpu_torch.backend.burst import BurstStats

    _, (net, enc) = nets
    seen = {}

    def stage_refinement(poses_dj, *a, pair_trusted=None, **k):
        seen["trusted"] = pair_trusted
        return poses_dj, tpipe.refine.RefineStats()

    def rescue_bursts(poses, ref_feats, healthy, *a, **k):
        seen["healthy"] = healthy
        return poses, BurstStats(spans=[(2, 7)])

    monkeypatch.setattr(tpipe, "stage_refinement", stage_refinement)
    monkeypatch.setattr(tpipe, "rescue_bursts", rescue_bursts)
    res = tpipe.run_full_pipeline(revisit_scans(thin=BURST), net, enc,
                                  cfg=CFG, enable_loop_closure=False)
    healthy = seen["healthy"]
    assert not healthy[list(BURST)].any() and healthy.sum() == 8
    want = res.odometry.successes & healthy[:-1] & healthy[1:]
    want[2:7] = True
    np.testing.assert_array_equal(seen["trusted"], want)
    assert res.burst_stats.spans == [(2, 7)]
