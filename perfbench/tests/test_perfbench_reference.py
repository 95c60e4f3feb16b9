"""The plain reference agrees with the program's CPU path at the tiny
configuration: features, ISS keypoints, both drivers' registration and
the chain."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from caelo_tpu_torch.config import tiny_test_config
from caelo_tpu_torch.frontend import ransac as program_ransac
from caelo_tpu_torch.frontend.baselines import iss_keypoints
from caelo_tpu_torch.frontend.registration import (extract_frame_features,
                                                   register_pair,
                                                   register_pair_with_prior)
from caelo_tpu_torch.geometry.kitti_pose import chain_poses
from caelo_tpu_torch.models.weights_io import build_models_from_state_dicts
from caelo_tpu_torch.parallel.pipeline import make_sequence_processor
from perfbench import harness
from perfbench.reference import chain, frontend, iss, registration
from perfbench.reference.sizes import Sizes
from perfbench.traffic import loop

CFG = tiny_test_config()
D = json.loads(json.dumps(dataclasses.asdict(CFG)))
ISS = {"k": 64, "salient_radius": 2.0, "nms_radius": 2.0, "gamma_21": 0.975,
       "gamma_32": 0.975, "min_neighbors": 5}


@pytest.fixture(scope="module")
def lap():
    weights = harness.make_weights(5, "cpu", 20)
    net, enc = build_models_from_state_dicts(*weights, "cpu", CFG)
    pts, mask = loop.make_lap({"lap_frames": 6, "step_m": 1.2,
                               "noise_m": 0.005, "scene_seed": 0},
                              D["sensor"], D["max_points"], 5, "cpu")
    return weights, net, enc, pts, mask


class Drawn:
    """Keeps the program's RANSAC draws."""

    def __init__(self, monkeypatch):
        self.got = []
        orig = program_ransac.draw_samples

        def draw(*a, **k):
            out = orig(*a, **k)
            self.got.append(out)
            return out
        monkeypatch.setattr(program_ransac, "draw_samples", draw)


def test_features_bit_equal(lap):
    weights, net, enc, pts, mask = lap
    S = Sizes(D)
    for i in range(3):
        f = extract_frame_features(net, enc, pts[i], mask[i], CFG)
        g = frontend.features(pts[i], mask[i], weights, S)
        for a, b in zip(f, g):
            assert torch.equal(a, b)


def test_iss_keypoints_equal(lap):
    _, _, _, pts, mask = lap
    xyz = pts[0, :, :3].contiguous()
    k = iss_keypoints(xyz, mask[0], n_keypoints=128)
    r = iss.keypoints(xyz, mask[0], ISS, 128)
    assert torch.equal(k.key_pts, r[0]) and torch.equal(k.key_mask, r[1])


def test_window_registration_equal(lap, monkeypatch):
    weights, net, enc, pts, mask = lap
    drawn = Drawn(monkeypatch)
    # a prior gate wide enough that some pair of the tiny window retries
    cfg = dataclasses.replace(CFG, ransac=dataclasses.replace(
        CFG.ransac, min_inlier_abs=10 ** 6))
    feats, regs = make_sequence_processor(cfg)(
        net, enc, pts, mask, torch.Generator().manual_seed(1))
    assert len(drawn.got) == 2                   # the retry ran
    d = json.loads(json.dumps(dataclasses.asdict(cfg)))
    R, t, ok = registration.register_window(tuple(feats[:3]), drawn.got, d)
    assert torch.equal(R, regs.R) and torch.equal(t, regs.t)
    assert torch.equal(ok, regs.success)
    assert registration.register_window(tuple(feats[:3]), drawn.got[:1],
                                        d) is None


def test_step_registration_equal(lap, monkeypatch):
    weights, net, enc, pts, mask = lap
    drawn = Drawn(monkeypatch)
    f0, f1 = (extract_frame_features(net, enc, pts[i], mask[i], CFG)
              for i in (0, 1))
    prev = (np.eye(3), np.zeros(3))
    g = torch.Generator().manual_seed(2)
    reg = register_pair(f0, f1, CFG, generator=g)
    want = reg.R
    if not bool(reg.success):    # the driver's retry with the prior
        prior = tuple(torch.as_tensor(a, dtype=torch.float32) for a in prev)
        reg = register_pair_with_prior(f0, f1, *prior, CFG, generator=g)
        want = reg.R
    R, t, ok = registration.register_step(tuple(f0[:3]), tuple(f1[:3]),
                                          prev, drawn.got, D)
    if bool(reg.success):
        assert np.array_equal(R, want.double().numpy()) and ok
    else:                        # the previous motion where both fail
        assert np.array_equal(R, prev[0]) and not ok


def test_chain_equal():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(20, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    Rs = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (y * w + z * x)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], 1)
    ts = rng.normal(size=(20, 3))
    want = chain_poses(Rs, ts, np.eye(3), np.zeros(3))
    assert np.array_equal(chain.chain_poses(Rs, ts, np.eye(3), np.zeros(3)),
                          want)
    low = chain.chain_poses(Rs, ts, np.eye(3), np.zeros(3), np.float32)
    assert 0 < np.abs(low - want).max() < 1e-4
