"""The root conftest's file order, thread share and time limits, on
generated test files run by two ``pytest`` subprocesses (one plain, one
with two xdist workers), each with a copy of the conftest, its floor on the
limits cut to 1 s, and a weight table of its own."""
import json
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOOR = "MIN_TIME_LIMIT = 600.0\n"


def _pytest(path, files, weights, *args):
    """Run ``files`` under a copy of the conftest: the result, the seconds
    it took, and the node ids of each worker's results in their order."""
    with open(os.path.join(ROOT, "conftest.py")) as f:
        conftest = f.read()
    assert FLOOR in conftest
    (path / "conftest.py").write_text(
        conftest.replace(FLOOR, "MIN_TIME_LIMIT = 1.0\n"))
    (path / "pytest.ini").write_text("[pytest]\nmarkers =\n    slow: long\n")
    (path / "tests").mkdir()
    (path / "tests" / "file_weights.json").write_text(json.dumps(weights))
    for name, body in files.items():
        (path / "tests" / name).write_text(body)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_XDIST") and k != "OMP_NUM_THREADS"}
    start = time.monotonic()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-v", "-rfE", "tests", *args],
        cwd=path, env=env, capture_output=True, text=True, timeout=120)
    took = time.monotonic() - start
    ran = {}
    for line in r.stdout.splitlines():
        words = line.split()
        if line.startswith("[gw") and "%]" in line:       # [gw0] [ 20%] ...
            ran.setdefault(words[0], []).append(words[-1])
        elif len(words) > 1 and "::" in words[0] and words[1] in (
                "PASSED", "FAILED", "ERROR"):
            ran.setdefault("plain", []).append(words[0])
    return r, took, ran


def _two_tests(tag):
    """Two tests whose names sort against their order in the file."""
    return (f"def test_z_{tag}():\n    pass\n\n\n"
            f"def test_a_{tag}():\n    pass\n")


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """Files a-e (d not in the table, so at its median, 3.0; e's tests in a
    class) and one that outlasts the 1-s limit its weight would give it in
    a worker; one process, with a junit file."""
    path = tmp_path_factory.mktemp("plain")
    files = {f"test_{t}.py": _two_tests(t) for t in "abcd"}
    files["test_e.py"] = "class TestE:\n" + "".join(
        f"    def test_{n}_e(self):\n        pass\n\n" for n in "za")
    files["test_waits.py"] = ("import time\n\n\n"
                              "def test_waits():\n    time.sleep(1.5)\n")
    weights = {"tests/test_a.py": 1.0, "tests/test_b.py": 30.0,
               "tests/test_c.py": 20.0, "tests/test_e.py": 5.0,
               "tests/test_waits.py": 0.5, "tests/test_gone.py": 0.2}
    return (path, *_pytest(path, files, weights, "--junitxml", "run.xml"))


def test_collection_follows_the_weight_table(plain):
    """Heaviest file first, the unlisted file at the table's median, each
    file's tests together and in the file's order."""
    _, r, _, ran = plain
    assert ran["plain"] == [
        *(f"tests/test_{t}.py::test_{n}_{t}" for t in "bc" for n in "za"),
        *(f"tests/test_e.py::TestE::test_{n}_e" for n in "za"),
        *(f"tests/test_{t}.py::test_{n}_{t}" for t in "da" for n in "za"),
        "tests/test_waits.py::test_waits"], r.stdout


def test_a_plain_run_has_no_time_limit(plain):
    _, r, _, _ = plain
    assert r.returncode == 0, r.stdout + r.stderr
    assert "tests/test_waits.py::test_waits PASSED" in r.stdout


def test_weights_from_junit(plain):
    """``python conftest.py run.xml`` rewrites the table: each file's summed
    seconds, heaviest first, a class's tests under their file."""
    path = plain[0]
    subprocess.run([sys.executable, "conftest.py", "run.xml"], cwd=path,
                   check=True, timeout=60)
    weights = json.loads((path / "tests" / "file_weights.json").read_text())
    assert list(weights)[0] == "tests/test_waits.py"
    assert weights["tests/test_waits.py"] >= 1.5
    assert sorted(weights) == [f"tests/test_{t}.py"
                               for t in ("a", "b", "c", "d", "e", "waits")]


OVERRUNS = '''import glob
import os
import time

import pytest
import torch.multiprocessing as mp


def _rank(rank):
    time.sleep(600 if rank else 0)


@pytest.fixture
def slow_fixture():
    time.sleep(30)


def test_sleeps():
    time.sleep(30)


def test_after_sleeps():
    pass


def test_slow_setup(slow_fixture):
    pass


def test_hung_rank():
    """Rank 1 never returns; mp.spawn waits for it, as run_ranks does."""
    mp.spawn(_rank, nprocs=2, join=True)


def test_hung_rank_was_killed():
    """What the worker started is dead by now, a zombie at most."""
    for path in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
        with open(path) as f:
            kids = f.read().split()
        for kid in kids:
            with open(f"/proc/{kid}/cmdline") as f:
                cmd = f.read().replace("\\0", " ")
            with open(f"/proc/{kid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
            assert state == "Z", (kid, state, cmd)


@pytest.mark.slow
def test_slow_marked():
    time.sleep(1.5)


def test_last():
    pass
'''

PHASES = '''import time

import pytest


@pytest.fixture
def timed():
    time.sleep(0.6)
    yield
    time.sleep(0.6)


def test_timed(timed):
    time.sleep(0.6)


def test_next():
    pass
'''


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Two workers, loadfile.  In the table's order the workers start on
    the heavy and the medium file; xdist's own order, by number of tests,
    would start one on the overruns.  Those and the phases weigh 0.5 s, so
    their limit is the 1-s floor; the weighted file's is 3 s."""
    share = max(1, os.cpu_count() // 2)
    check = ("import os\n\nimport torch\n\n\n"
             "def _share():\n"
             f"    assert torch.get_num_threads() == {share}\n"
             f"    assert torch.get_num_interop_threads() == {share}\n"
             f"    assert os.environ['OMP_NUM_THREADS'] == '{share}'\n\n\n")
    files = {
        "test_heavy.py": check + "def test_heavy():\n    _share()\n",
        "test_medium.py": check + "def test_medium():\n    _share()\n",
        "test_light.py": check + "".join(
            f"def test_light_{i}():\n    _share()\n\n\n" for i in range(3)),
        "test_weighted.py": ("import time\n\n\n"
                             "def test_weighted():\n    time.sleep(2)\n"),
        "test_overruns.py": OVERRUNS, "test_phases.py": PHASES}
    weights = {"tests/test_heavy.py": 100.0, "tests/test_medium.py": 50.0,
               "tests/test_weighted.py": 1.5, "tests/test_light.py": 1.0,
               "tests/test_overruns.py": 0.5, "tests/test_phases.py": 0.5}
    return _pytest(tmp_path_factory.mktemp("xdist"), files, weights,
                   "-p", "xdist", "-n", "2", "--dist", "loadfile")


def test_xdist_keeps_the_weight_order(workers):
    r, _, ran = workers
    assert sorted(tests[0] for tests in ran.values()) == [
        "tests/test_heavy.py::test_heavy",
        "tests/test_medium.py::test_medium"], r.stdout


def test_an_xdist_worker_takes_its_share_of_threads(workers):
    """Each worker runs torch, and the processes its tests start, on its
    share of the host's cores: half of them here."""
    r, _, _ = workers
    for name in ("test_heavy.py::test_heavy", "test_medium.py::test_medium",
                 *(f"test_light.py::test_light_{i}" for i in range(3))):
        assert f"PASSED tests/{name}" in r.stdout, r.stdout


def test_an_overrun_fails_alone(workers):
    """A call and a setup past their 1-s limit fail and are named; the
    ranks of a test are killed when it fails, not when its worker ends;
    the tests after them run, and the run ends well before the sleeps
    would."""
    r, took, _ = workers
    out = r.stdout + r.stderr
    assert r.returncode == 1, out
    assert "2 failed, 12 passed, 1 error" in out, out
    for name, phase in (("test_sleeps", "call"), ("test_slow_setup", "setup"),
                        ("test_hung_rank", "call")):
        assert (f"tests/test_overruns.py::{name}: {phase} ran past its time "
                "limit of 1 s") in out
    assert "PASSED tests/test_overruns.py::test_after_sleeps" in out
    assert "PASSED tests/test_overruns.py::test_hung_rank_was_killed" in out
    assert "PASSED tests/test_overruns.py::test_last" in out
    assert took < 60, took


def test_each_phase_has_its_own_limit(workers):
    """Setup, call and teardown each take 0.6 s of a 1-s limit, 1.8 s in
    all: the test passes, and so does the one after it."""
    r, _, _ = workers
    assert "PASSED tests/test_phases.py::test_timed" in r.stdout
    assert "PASSED tests/test_phases.py::test_next" in r.stdout


def test_the_limit_is_twice_the_file_weight(workers):
    """The weighted file's 1.5 s give its test 3 s: its 2-s sleep passes."""
    r, _, _ = workers
    assert "PASSED tests/test_weighted.py::test_weighted" in r.stdout


def test_a_slow_test_has_no_time_limit(workers):
    r, _, _ = workers
    assert "PASSED tests/test_overruns.py::test_slow_marked" in r.stdout
