"""Seconds of ``voxel/grid.py``'s ``voxelize``, as the front end calls it,
per frame (ms), synchronised at both ends."""
from ._common import per_unit


def read(r):
    return per_unit(r, "voxelize", "extracted")
