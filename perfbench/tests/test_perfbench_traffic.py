"""The loop traffic: made from the seed, the same for the same seed, and
inside the frozen scene."""
import numpy as np
import torch

from perfbench.traffic import loop

PARAMS = {"kind": "loop", "lap_frames": 12, "step_m": 1.2,
          "noise_m": 0.005, "scene_seed": 0}
SENSOR = {"vertical_view_down_deg": -24.8, "vertical_view_up_deg": 2.0,
          "visible_range": 100.0}


def test_same_seed_same_lap_other_seed_other_noise():
    a = loop.make_lap(PARAMS, SENSOR, 4096, 2 ** 31 + 5, "cpu")
    b = loop.make_lap(PARAMS, SENSOR, 4096, 2 ** 31 + 5, "cpu")
    c = loop.make_lap(PARAMS, SENSOR, 4096, 7, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    # the kept points do not depend on the seed; their noise does
    assert torch.equal(a[1], c[1])
    assert not torch.equal(a[0], c[0])
    assert loop.start_frame(PARAMS, 9) == loop.start_frame(PARAMS, 9)


def test_loop_stays_inside_the_scene_and_scans_are_compact():
    R, t = loop.lap_poses(210, 1.2)
    radius = np.linalg.norm(t[:, :2], axis=1)
    assert np.allclose(radius, 210 * 1.2 / (2 * np.pi))
    assert np.abs(t).max() < 60.0            # the scene's boxes: +-60 m
    step = np.linalg.norm(np.diff(t, axis=0), axis=1)
    assert np.allclose(step, step[0]) and abs(step[0] - 1.2) < 1e-3
    assert np.allclose(np.einsum("nij,nkj->nik", R, R), np.eye(3))
    pts, mask = loop.make_lap(PARAMS, SENSOR, 4096, 3, "cpu")
    n = mask.sum(1)
    assert (n > 1000).all()
    for i in range(len(n)):       # kept points first, zero padding after
        assert mask[i, :n[i]].all() and not mask[i, n[i]:].any()
        assert (pts[i, n[i]:] == 0).all()
    r = torch.linalg.vector_norm(pts[..., :3], dim=-1)[mask]
    assert r.max() < 100.1 and r.min() > 1.9
