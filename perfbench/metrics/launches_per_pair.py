"""Device operations launched under the program's ``caelo.register.pair``
span, the motion-prior retries' included, per first-pass pair (the pair
spans no ``caelo.register.retry`` holds) in the profiled stretch
(``perfbench/program.py``)."""
from ..program import first_pass_pairs, per


def read(r):
    return per(r, "caelo.register.pair", "ops_under", first_pass_pairs(r))
