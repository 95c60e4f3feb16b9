"""The median, over every frame of the measured session, of the time from
when the frame was due to when its pose was on the host (ms)."""
from ._common import np_percentile


def read(r):
    lat = r.rec.get("latencies")
    return np_percentile(lat, 50) * 1e3 if lat else None
