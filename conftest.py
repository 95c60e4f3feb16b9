"""What keeps a whole run of ``tests/`` under ``-p xdist -n 6 --dist
loadfile`` inside its clock.  Loaded before ``tests/conftest.py``, which
sets JAX up; nothing here imports JAX.

- Order.  Files are collected heaviest first, by their worker-seconds in
  ``tests/file_weights.json``; a file not in the table weighs the table's
  median.  The workers then take the long files first and the short ones
  fill in at the end.  xdist would re-sort the files by their number of
  tests, so its reorder is turned off.
- Threads.  An xdist worker runs torch, and the processes its tests start,
  on its share of the host's cores.
- Time limits.  In an xdist worker, each phase (setup, call, teardown) of
  a test not marked ``slow`` fails alone after twice its file's weight,
  and no sooner than ``MIN_TIME_LIMIT`` seconds; the processes the phase
  started are killed and waited for until they have exited, and the run
  goes on.

Refresh the table from the junit file of a whole run::

    python conftest.py run.xml
"""
import glob
import json
import os
import signal
import statistics
import time

import pytest

ROOT = os.path.dirname(os.path.abspath(__file__))
TABLE = os.path.join(ROOT, "tests", "file_weights.json")
MIN_TIME_LIMIT = 600.0
KILL_WAIT = 30.0   # seconds a killed process may take to exit
WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")

with open(TABLE) as f:
    WEIGHTS = json.load(f)
MEDIAN = statistics.median(WEIGHTS.values()) if WEIGHTS else 0.0  # unlisted

# With a thread for every core in each of six workers, their spinning
# threads held back the JAX reference runs beside them: on an 8-core host
# the longest test took 1,048 s so, and 558 s with one torch thread a
# worker.
if WORKERS:
    import torch

    THREADS = max(1, (os.cpu_count() or 1) // int(WORKERS))
    os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))  # its children
    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(THREADS)


def weight(item):
    """Worker-seconds of ``item``'s file in a whole run."""
    return WEIGHTS.get(item.nodeid.split("::")[0], MEDIAN)


def pytest_configure(config):
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(config, items):
    items.sort(key=lambda item: -weight(item))


def _descendants(pid):
    found = set()
    for path in glob.glob(f"/proc/{pid}/task/*/children"):
        try:
            with open(path) as f:
                kids = [int(k) for k in f.read().split()]
        except OSError:
            continue
        for kid in kids:
            found |= {kid} | _descendants(kid)
    return found


def _exited(pid):
    """Whether ``pid`` has exited: a zombie, or gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] in ("Z", "X")
    except OSError:
        return True


def _time_limited(item, phase):
    if not WORKERS or item.get_closest_marker("slow"):
        return (yield)
    limit = max(MIN_TIME_LIMIT, 2 * weight(item))
    before = _descendants(os.getpid())

    def expire(signum, frame):
        killed = _descendants(os.getpid()) - before
        for pid in killed:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        # A killed process runs on until its threads and memory are torn
        # down; the next test must find it a zombie or gone.
        deadline = time.monotonic() + KILL_WAIT
        while not all(map(_exited, killed)) and time.monotonic() < deadline:
            time.sleep(0.01)
        pytest.fail(f"{item.nodeid}: {phase} ran past its time limit of "
                    f"{limit:g} s", pytrace=False)

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _time_limited(item, "setup"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _time_limited(item, "call"))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    return (yield from _time_limited(item, "teardown"))


def weights_from_junit(path):
    """Worker-seconds of each test file in a junit file, heaviest first."""
    import xml.etree.ElementTree as ET
    seconds = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        # A test in a class has the class's name after its module's.
        parts = case.get("classname").split(".")
        while len(parts) > 1 and not os.path.isfile(
                os.path.join(ROOT, *parts) + ".py"):
            parts.pop()
        name = "/".join(parts) + ".py"
        seconds[name] = seconds.get(name, 0.0) + float(case.get("time"))
    return {f: round(s, 1)
            for f, s in sorted(seconds.items(), key=lambda fs: -fs[1])}


if __name__ == "__main__":
    import sys
    with open(TABLE, "w") as f:
        json.dump(weights_from_junit(sys.argv[1]), f, indent=1)
        f.write("\n")
