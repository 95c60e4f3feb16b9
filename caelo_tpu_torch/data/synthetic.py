"""Synthetic LiDAR scenes, shared with the JAX package.

``caelo_tpu/data/synthetic.py`` is numpy with no JAX in its import chain;
the port imports its scene generators rather than copying them.
(``synthetic_scan_pair`` is left out: it pads through the JAX package's
``ops.masking``, which imports JAX.)
"""
from caelo_tpu.data.synthetic import (make_scene,  # noqa: F401
                                      range_filter, sample_scene_points)
