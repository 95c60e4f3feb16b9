"""Device-busy time per frame of the profiled stretch (ms): the union of
the device's intervals over the frames it holds."""


def read(r):
    p = r.prof
    return p["busy_s"] / p["n_units"] * 1e3 if p and p["busy_s"] else None
