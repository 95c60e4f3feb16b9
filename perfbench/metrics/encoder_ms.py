"""Seconds of the patch encoder's forward calls per frame (ms), from
forward pre- and post-hooks that synchronise the card."""
from ._common import per_unit


def read(r):
    return per_unit(r, "encoder", "extracted")
