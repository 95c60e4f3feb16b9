"""Seconds from the process's start to the first measured frame: imports,
the kernel library's build or load, weights and traffic from the seed,
the models and the warm-up."""


def read(r):
    return r.setup_s
