"""Seconds of ``register_pair`` and ``register_pair_with_prior``, as
``parallel/pipeline.py`` (a window's pairs in one call) or
``frontend/odometry.py`` (one pair a call) calls them, per registered pair
(ms), synchronised at both ends."""
from ._common import per_unit


def read(r):
    return per_unit(r, "register", "pairs")
