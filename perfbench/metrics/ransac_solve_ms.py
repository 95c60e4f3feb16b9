"""Self time of the program's ``caelo.ransac.solve`` span per first-pass
pair (ms) in the profiled stretch: its seconds less its child spans', the
motion-prior retries' included, over the pair spans no
``caelo.register.retry`` holds (``perfbench/program.py``).  Taken under
the profiler, so it holds the profiler's own cost per operation."""
from ..program import first_pass_pairs, per


def read(r):
    return per(r, "caelo.ransac.solve", "self_s", first_pass_pairs(r), 1e3)
