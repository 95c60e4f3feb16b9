"""Self time of the program's ``caelo.frontend.respond`` span per frame (ms)
in the profiled stretch: its seconds less its child spans', over the
stretch's calls of ``caelo.frontend.extract`` (``perfbench/program.py``).
Taken under the profiler, so it holds the profiler's own cost per
operation."""
from ..program import self_ms_per_frame


def read(r):
    return self_ms_per_frame(r, "caelo.frontend.respond")
