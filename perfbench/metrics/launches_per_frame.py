"""Device operations (kernels, copies, sets) launched under the program's
``caelo.frontend.extract`` span, per call of it, in the profiled stretch:
the front end's launches a frame, each operation matched by its
correlation id to the runtime call that launched it
(``perfbench/program.py``)."""
from ..program import calls, per


def read(r):
    name = "caelo.frontend.extract"
    return per(r, name, "ops_under", calls(r, name))
