"""Seconds of ``voxel/grid.py``'s ``extract_patches`` (the bit-table query
and K2), as the front end calls it, per frame (ms), synchronised at both
ends."""
from ._common import per_unit


def read(r):
    return per_unit(r, "patch_query", "extracted")
