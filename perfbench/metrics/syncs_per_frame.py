"""Host synchronisations (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, blocking
``cudaMemcpy``) a frame in the profiled stretch (``perfbench/program.py``).

Frame by frame (``syncs_per_frame.live``): those under the program's
``caelo.odometry.frame`` span over its calls.  Windowed (the stretch
starts inside a window, so its window span is cut): every one on the main
thread, the harness's closing synchronise among them, over the calls of
``caelo.frontend.extract``."""
from ..program import calls, of_reading, per


def read(r):
    frame = "caelo.odometry.frame"
    if calls(r, frame):
        return per(r, frame, "syncs_under", calls(r, frame))
    n = calls(r, "caelo.frontend.extract")
    return of_reading(r)["syncs_main_thread"] / n if n else None
