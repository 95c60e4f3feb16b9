"""The open loop's latency arithmetic on a synthetic schedule with a
stall: every frame is timed from when it was due, so a stall is paid by
the frames queued behind it, and the 95th percentile is over all
frames."""
import time
import types

import numpy as np

from perfbench import harness
from perfbench.entries import framewise
from perfbench.metrics import frame_p50_ms, frame_p95_ms

RATE, N, STALL_AT, STALL_S, WORK_S = 20.0, 30, 3, 0.3, 0.005


def fake_run_odometry(scans, *args, progress=None, **kwargs):
    for i, _ in enumerate(scans):
        time.sleep(STALL_S if i == STALL_AT else WORK_S)
        progress(i)
    z = np.zeros((0,))
    return types.SimpleNamespace(poses=z, rel_Rs=z, rel_ts=z, successes=z)


def test_latency_counts_from_the_due_time_and_p95_covers_all():
    run = types.SimpleNamespace(
        frames=[(None, None)] * 4, cuda=False, seed=0, net=None, enc=None,
        cfg=None, workload={"arrival": {"rate_hz": RATE}})
    entry = object.__new__(framewise.Entry)
    entry.run, entry.pos, entry.rate = run, 0, RATE
    entry.feature_fn = lambda *a: None
    entry.odometry = types.SimpleNamespace(run_odometry=fake_run_odometry)
    rec = entry.session(N / RATE)
    lat = np.array(rec["latencies"])
    assert rec["attempted"] == N and rec["failed"] == 0 and len(lat) == N
    # frame 4 was due 50 ms after frame 3 began its 300 ms stall
    assert lat[STALL_AT] >= STALL_S
    assert lat[STALL_AT + 1] >= STALL_S - 1 / RATE
    assert lat[STALL_AT + 1] > lat[STALL_AT + 2] > lat[STALL_AT + 3]
    assert np.median(lat[STALL_AT + 10:]) < 0.05
    r = harness.Reading(run, rec=rec)
    assert frame_p95_ms.read(r) == np.percentile(lat, 95) * 1e3
    assert frame_p50_ms.read(r) == np.percentile(lat, 50) * 1e3
    # 30 frames: the 95th percentile lies between the third and the second
    # worst (0.95 * 29 = 27.55), not at the stall's maximum
    s = np.sort(lat) * 1e3
    assert s[27] <= frame_p95_ms.read(r) <= s[28] < s[29]
