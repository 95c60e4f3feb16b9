"""The 95th percentile, over every frame of the measured session, of the
time from when the frame was due to when its pose was on the host (ms):
the tail a live sensor's user sees, below the rate the driver sustains."""
from ._common import np_percentile


def read(r):
    lat = r.rec.get("latencies")
    return np_percentile(lat, 95) * 1e3 if lat else None
