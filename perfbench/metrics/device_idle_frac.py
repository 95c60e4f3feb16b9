"""1 - the union of the device's kernel, copy and set intervals over the
profiled stretch's seconds (one steady window cycle, or a few frames)."""


def read(r):
    p = r.prof
    return 1.0 - p["busy_s"] / p["window_s"] if p and p["busy_s"] else None
