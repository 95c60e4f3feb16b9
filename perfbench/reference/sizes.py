"""Sizes derived from a configuration file's numbers (the reference's own
arithmetic: HDL-64E ring image, voxel grids, supercells)."""
from __future__ import annotations

import math


class Sizes:
    """The derived sizes of one configuration dict (the ``pipeline`` entry
    of a configuration file)."""

    def __init__(self, cfg: dict):
        s, v = cfg["sensor"], cfg["voxel"]
        self.cfg = cfg
        self.n_lines = s["n_lines"]
        self.az_res = math.radians(s["azimuth_res_deg"])
        self.vertical_res = (math.radians(s["vertical_view_up_deg"])
                             - math.radians(s["vertical_view_down_deg"])
                             ) / (s["n_lines"] - 1)
        self.vertical_pixel_offset = (-math.radians(s["vertical_view_down_deg"])
                                      / self.vertical_res)
        self.img_h = s["n_lines"] + s["safe_edge_top"]
        self.img_w = int(round(2.0 * math.pi / self.az_res))
        self.model_w = self.img_w - s["crop_width"]
        self.edge = s["edge_filter"]
        self.visible_bottom = s["visible_bottom"]
        # voxel pyramid: +-length x +-width x +-height, blocks of
        # block_size voxels, scales voxel_size * ratio
        self.half = (v["visible_length"], v["visible_width"],
                     v["visible_height"])
        self.voxel_sizes = [v["voxel_size"] * r for r in v["scale_ratios"]]
        block = v["voxel_size"] * v["block_size"]
        n_blocks = [int(2 * h / block) for h in self.half]
        g0 = [n * v["block_size"] for n in n_blocks]
        self.grids = [[g // r for g in g0] for r in v["scale_ratios"]]
        self.P = v["patch_size"]
        self.supercells = [[-(-g // self.P) for g in grid]
                           for grid in self.grids]
        self.max_voxels = list(v["max_voxels"])
        self.slots = list(v["bitgrid_slots"])
