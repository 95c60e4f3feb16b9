"""Seconds of the ISS detector (``frontend/ablation.py``'s
``_DETECTORS["iss"]``) per frame (ms), synchronised at both ends."""
from ._common import per_unit


def read(r):
    return per_unit(r, "detector", "extracted")
