"""The benchmark's frozen arithmetic against the program's own counts."""
import dataclasses
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from caelo_tpu_torch.config import tiny_test_config
from caelo_tpu_torch.frontend.matching import match_descriptors
from caelo_tpu_torch.ops.plane_gather import patches_from_planes_bytes
from caelo_tpu_torch.ops.saliency import keypoint_score_bytes
from caelo_tpu_torch.parallel.pipeline import make_sequence_processor
from perfbench import harness, yardstick
from perfbench.traffic import loop


def _window(n=4):
    cfg = tiny_test_config()
    d = json.loads(json.dumps(dataclasses.asdict(cfg)))
    from caelo_tpu_torch.models.weights_io import (
        build_models_from_state_dicts)

    net, enc = build_models_from_state_dicts(
        *harness.make_weights(0, "cpu", 20), "cpu", cfg)
    pts, mask = loop.make_lap({"lap_frames": n, "step_m": 1.2,
                               "noise_m": 0.005, "scene_seed": 0},
                              d["sensor"], d["max_points"], 0, "cpu")
    return cfg, d, net, enc, pts, mask


def test_analytic_flops_equal_the_flop_counter_on_the_ops_it_covers():
    cfg, d, net, enc, pts, mask = _window()
    process = make_sequence_processor(cfg)
    counter = FlopCounterMode(display=False)
    with counter:
        feats, _ = process(net, enc, pts, mask,
                           torch.Generator().manual_seed(0))
    by_op = {str(k): v for k, v in counter.get_flop_counts()["Global"]
             .items()}
    n = pts.shape[0]
    f = yardstick.frame_flops(d)
    assert by_op["aten.convolution"] == n * (f["respond"]
                                             + f["encoder_conv"])
    assert by_op["aten.addmm"] == n * f["encoder_dense"]
    with FlopCounterMode(display=False) as m:
        match_descriptors(feats.descriptors[:-1], feats.mask[:-1],
                          feats.descriptors[1:], feats.mask[1:])
    assert m.get_total_flops() == (n - 1) * yardstick.pair_flops(d)[
        "matching"]


def test_frozen_kernel_bytes_equal_the_programs_formulas():
    g = torch.Generator().manual_seed(0)
    for shape in ((8, 64, 1792), (3, 8, 16, 356)):
        planes = torch.zeros(shape)
        assert yardstick.k1_bytes(planes.shape) == keypoint_score_bytes(
            planes)
    for rows, K in ((81921, 1024), (513, 7)):
        table2 = torch.zeros((rows, 16, 16), dtype=torch.int32)
        slot = torch.randint(-3, rows + 5, (K, 2, 2, 2), generator=g,
                             dtype=torch.int32)
        assert yardstick.k2_bytes(rows, slot) == patches_from_planes_bytes(
            table2, slot)


def test_k1_operations_count_occupied_neighbours():
    counter = torch.zeros((1, 5, 5), dtype=torch.int32)
    counter[0, 2, 2] = counter[0, 2, 3] = 1
    # pixel (2, 2) is a neighbour of the 24 other pixels, (2, 3) of the 19
    # others in cols 1-4: 43 neighbour hits, 45 with the two centres
    assert yardstick.k1_ops(counter, (8, 5, 5)) == (25 * 43 + 2 * 45
                                                    + 12 * 25)
