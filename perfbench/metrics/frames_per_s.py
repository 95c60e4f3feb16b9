"""Frames completed in the measured session over its seconds (host clock),
from the session's start to the last frame's pose on the host: all the
work and all the time, the drain of a grown queue included."""


def read(r):
    return r.rec["frames"] / r.rec["seconds"]
