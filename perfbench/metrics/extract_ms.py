"""Seconds of the front end's ``extract_frame_features``, as
``parallel/pipeline.py`` (windowed) or ``frontend/odometry.py`` (frame by
frame) calls it, per frame (ms), synchronised at both ends, in the traced
run's span session."""
from ._common import per_unit


def read(r):
    return per_unit(r, "extract", "extracted")
