"""The comparison that decides ``correct``, driven through a whole run of
each cell at small shapes on the CPU (the harness's look for a card left
out): the program passes, the control (the reference in TF32 with a
float32 chain, in the program's place) fails, and so does the program
with each fault a cell can have planted where it is produced."""
import functools

import pytest
import torch

from perfbench import check, control, harness

from .smallcells import tiny

CELLS = {"hdl64-offline-w64": 0.1, "iss-offline": 6.0,
         "hdl64-live-5hz": 2.5}
PIPE = "caelo_tpu_torch.parallel.pipeline"
ODO = "caelo_tpu_torch.frontend.odometry"


def measure(cell, seed=2 ** 31 + 11):
    cfg, wl = tiny(cell)
    out = harness.measure(cell, seed, CELLS[cell], False, "cpu", 0.0,
                          config=cfg, workload=wl)
    return out


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_program_passes_and_the_control_fails(cell):
    out = measure(cell)
    assert out["correct"], out["checks"]
    cfg, wl = tiny(cell)
    r = control.readings(cell, 7, CELLS[cell], "cpu", cfg, wl)
    assert check.verdict(r["program"], wl["limits"])
    assert not check.verdict(r["control"], wl["limits"]), r["control"]


def _identity(fn):
    """RANSAC that returns the pose it started from, the identity."""
    @functools.wraps(fn)
    def still(*args, **kwargs):
        reg = fn(*args, **kwargs)
        return reg._replace(R=torch.eye(3).expand_as(reg.R).clone(),
                            t=torch.zeros_like(reg.t))
    return still


def _half_keypoints(fn):
    """Half of each frame's keypoints left out."""
    @functools.wraps(fn)
    def half(*args, **kwargs):
        f = fn(*args, **kwargs)
        keep = torch.arange(f.mask.shape[-1]) < f.mask.shape[-1] // 2
        return f._replace(mask=f.mask & keep,
                          descriptors=f.descriptors * keep[:, None])
    return half


def _altered_descriptor(fn):
    """One descriptor entry altered where it is produced."""
    @functools.wraps(fn)
    def altered(*args, **kwargs):
        d = fn(*args, **kwargs).clone()
        d[0, 0] += 1e-3
        return d
    return altered


def _altered_pose(fn):
    """A registration's translation altered by a centimetre."""
    @functools.wraps(fn)
    def altered(*args, **kwargs):
        res = fn(*args, **kwargs)
        return res._replace(t=res.t + 1e-2)
    return altered


def _altered_chain(fn):
    """The last pose of a call altered by a tenth of a millimetre."""
    @functools.wraps(fn)
    def altered(*args, **kwargs):
        poses = fn(*args, **kwargs)
        poses[-1, 3] += 1e-4
        return poses
    return altered


FAULTS = [
    ("hdl64-offline-w64", "caelo_tpu_torch.frontend.registration:"
     "ransac_rigid", _identity),
    ("hdl64-offline-w64", f"{PIPE}:extract_frame_features", _half_keypoints),
    ("hdl64-offline-w64", "caelo_tpu_torch.frontend.registration:"
     "describe_keypoints", _altered_descriptor),
    ("hdl64-offline-w64", "caelo_tpu_torch.frontend.registration:"
     "ransac_rigid", _altered_pose),
    ("hdl64-offline-w64", f"{ODO}:chain_poses", _altered_chain),
    ("hdl64-live-5hz", "caelo_tpu_torch.frontend.registration:"
     "ransac_rigid", _identity),
    ("hdl64-live-5hz", f"{ODO}:extract_frame_features", _half_keypoints),
    ("hdl64-live-5hz", "caelo_tpu_torch.frontend.registration:"
     "ransac_rigid", _altered_pose),
    ("iss-offline", "caelo_tpu_torch.frontend.registration:ransac_rigid",
     _identity),
    ("iss-offline", "caelo_tpu_torch.frontend.ablation:"
     "features_from_keypoints", _half_keypoints),
    ("iss-offline", "caelo_tpu_torch.frontend.ablation:describe_keypoints",
     _altered_descriptor),
    ("iss-offline", "caelo_tpu_torch.frontend.registration:ransac_rigid",
     _altered_pose),
]


@pytest.mark.parametrize("cell,target,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_a_planted_fault_makes_the_run_incorrect(cell, target, fault):
    from perfbench.capture import Patches

    with Patches() as p:
        assert p.set(target, fault)
        out = measure(cell)
    assert not out["correct"], out["checks"]


def _tf32_on():
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True


def _leaves_tf32_on(fn):
    """The program's last call leaves TF32 on for the process."""
    @functools.wraps(fn)
    def on(*args, **kwargs):
        _tf32_on()
        return fn(*args, **kwargs)
    return on


def test_the_reference_sets_full_float32_whatever_the_program_left(
        monkeypatch):
    from perfbench.capture import Patches
    from perfbench.reference import frontend, registration

    def state():
        return (torch.get_float32_matmul_precision(),
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    seen = []

    def spy(fn):
        def watched(*args, **kwargs):
            seen.append(state())
            return fn(*args, **kwargs)
        return watched

    monkeypatch.setattr(frontend, "conv", spy(frontend.conv))
    monkeypatch.setattr(registration, "matmul", spy(registration.matmul))
    saved = state()
    try:
        with Patches() as p:
            assert p.set(f"{ODO}:chain_poses", _leaves_tf32_on)
            out = measure("hdl64-live-5hz")
        assert out["correct"], out["checks"]
        assert seen and set(seen) == {("highest", False, False)}
        # the program's setting is back once the check is done
        assert state() == ("high", True, True)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]
