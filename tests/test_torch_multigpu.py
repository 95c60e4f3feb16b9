"""The port's sharded paths on 4 gloo ranks against the JAX package's on 4
of the conftest's virtual CPU devices, on the same numpy-seeded inputs at
``tiny_test_config``: the data-parallel feature extractor, the halo
exchange, the row-sharded ScanContext correlation and the edge-sharded
pose graph.  One spawn of the 4 ranks
(``caelo_tpu_torch.parallel.dryrun.sharded_paths``, which also checks each
path in rank 0 against the port's one-device function) serves the module.

Tolerances: extractor keypoints exact and descriptors rtol/atol 1e-5 (as
tests/test_torch_slice.py); halo total rtol 1e-6 and left_last 1e-6;
ScanContext score and yaw exact against the port's one-device matrix, the
score within 1e-5 of JAX's and the yaw equal wherever the two best shifts
are not within 1e-5 of a tie; pose graph (``dryrun.square_graph``, a drifted
chain with a loop edge) translations within 1e-2, as tests/test_posegraph.py
holds JAX's sharded solve, and cost within ``dryrun.POSEGRAPH_COST_RTOL``
(5e-3) relative: the solve ends at a cost of about 2e-3, not at 0.

The ranks are asked for as gloo CPU ranks: the dry run, ``run_ranks`` and
``python -m caelo_tpu_torch.parallel.dryrun`` default to NCCL ranks on the
card, and the last refuses a host without enough CUDA devices unless given
``--platform cpu``."""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from caelo_tpu.backend.posegraph import PoseGraph as JGraph
from caelo_tpu.backend.posegraph import optimize_sharded as joptimize_sharded
from caelo_tpu.config import tiny_test_config
from caelo_tpu.parallel.mesh import make_mesh as jmake_mesh
from caelo_tpu.parallel.pipeline import (
    make_batched_feature_extractor as jextractor,
    make_sharded_sc_correlation as jsc_corr,
    neighbor_pose_exchange as jhalo)
from caelo_tpu_torch.parallel import dryrun
from caelo_tpu_torch.parallel.mesh import (backend_for,
                                            initialize_distributed, run_ranks)

N_RANKS = 4
PATHS = ("mesh", "extract", "halo", "posegraph", "sc")


@pytest.fixture(scope="module")
def inputs():
    return dryrun.dryrun_inputs(N_RANKS, "cpu")


@pytest.fixture(scope="module")
def port(inputs):
    """Rank 0's gathered results of the paths; each rank has checked its
    path against the port's one-device function."""
    ranks = run_ranks(dryrun.sharded_paths, N_RANKS,
                      args=(inputs, PATHS, "cpu"), device_type="cpu")
    ranks[0]["meshes"] = [r["mesh"] for r in ranks]
    return ranks[0]


@pytest.fixture(scope="module")
def mesh():
    return jmake_mesh(n_data=N_RANKS, n_model=1,
                      devices=jax.devices()[:N_RANKS])


def test_meshes(port):
    """The port's meshes have the JAX mesh's dimension sizes and lay the
    ranks out row-major, as JAX lays out its devices; a mesh over rank 0
    alone leaves the other ranks out; the world's data mesh of
    ``stage_refinement`` is made once per world."""
    jm = jmake_mesh(n_data=2, n_model=2, devices=jax.devices()[:N_RANKS])
    for m in port["meshes"]:
        assert m["world_mesh_reused"]
        assert m["flat"] == (N_RANKS, 1)
        assert m["tp"] == (jm.shape["data"], jm.shape["model"]) == (2, 2)
    assert [m["tp_coordinate"] for m in port["meshes"]] == [
        [0, 0], [0, 1], [1, 0], [1, 1]]
    assert [m["first_coordinate"] for m in port["meshes"]] == [
        [0, 0], None, None, None]


def test_backend_and_single_process_init():
    """gloo for CPU ranks; NCCL for CUDA ranks, or an error where the build
    lacks it (never a silent gloo); one process needs no process group."""
    assert backend_for("cpu") == "gloo"
    if torch.distributed.is_nccl_available():
        assert backend_for("cuda") == "nccl"
    else:
        with pytest.raises(RuntimeError):
            backend_for("cuda")
    assert initialize_distributed("localhost:1", num_processes=1) is None
    assert not torch.distributed.is_initialized()


def test_feature_extractor_matches_jax(inputs, port, mesh):
    cfg = tiny_test_config()
    fj = jextractor(mesh, cfg)(inputs["respond"], inputs["encoder"],
                               jnp.asarray(inputs["pts"]),
                               jnp.asarray(inputs["mask"]))
    ft = port["extract"]
    assert ft.key_pts.shape == (N_RANKS, cfg.keypoint.n_keypoints, 3)
    assert ft.mask.sum() > 50 * N_RANKS
    np.testing.assert_array_equal(ft.mask, np.asarray(fj.mask))
    np.testing.assert_array_equal(ft.key_pixels, np.asarray(fj.key_pixels))
    np.testing.assert_array_equal(ft.key_pts, np.asarray(fj.key_pts))
    np.testing.assert_allclose(ft.descriptors, np.asarray(fj.descriptors),
                               rtol=1e-5, atol=1e-5)


def test_halo_exchange_matches_jax(inputs, port, mesh):
    total, left = port["halo"]
    tj, lj = jhalo(mesh)(jnp.asarray(inputs["poses"]))
    np.testing.assert_allclose(total, float(tj), rtol=1e-6)
    np.testing.assert_allclose(left, np.asarray(lj).reshape(N_RANKS, 12),
                               atol=1e-6, rtol=0)


def _sims(scs, i, j, shifts):
    """float64 whole-matrix cosine similarity of frames i and j at each
    sector shift of j."""
    a = scs[i].astype(np.float64).ravel()
    return [a @ np.roll(scs[j], -s, -1).astype(np.float64).ravel()
            / np.linalg.norm(a) / np.linalg.norm(scs[j]) for s in shifts]


def test_sc_correlation_matches_jax(inputs, port, mesh):
    scs = inputs["scs"]
    sc = port["sc"]
    score, yaw = sc["score"], sc["yaw"]
    np.testing.assert_array_equal(score, sc["one_device"]["score"])
    np.testing.assert_array_equal(yaw, sc["one_device"]["yaw"])
    sj, yj = (np.asarray(x) for x in jsc_corr(mesh)(jnp.asarray(scs)))
    np.testing.assert_allclose(score, sj, atol=1e-5, rtol=0)
    S = scs.shape[-1]
    shift = lambda y: int(np.round(y / (2 * np.pi) * S)) % S
    for i, j in zip(*np.nonzero(np.abs(yaw - yj) > 1e-6)):
        a, b = _sims(scs, i, j, (shift(yaw[i, j]), shift(yj[i, j])))
        assert abs(a - b) < 1e-5, (i, j, a, b)


def test_sharded_pose_graph_matches_jax(inputs, port, mesh):
    """On the square graph with its loop edge the solve moves the poses
    (over 0.1 m) and ends at a cost of about 2e-3, so a solve that does
    nothing, or a rank that sums only its own edges' cost, fails."""
    pg = port["posegraph"]
    assert np.abs(pg["t"] - inputs["t0"]).max() > 0.1
    np.testing.assert_allclose(pg["t"], pg["one_device"]["t"], atol=1e-2)
    np.testing.assert_allclose(pg["cost"], pg["one_device"]["cost"],
                               rtol=dryrun.POSEGRAPH_COST_RTOL)
    g = JGraph(*(jnp.asarray(inputs["graph"][f]) for f in JGraph._fields))
    Rj, tj, cj = joptimize_sharded(mesh, n_nodes=len(inputs["R0"]),
                                   n_iters=4, cg_iters=40)(
        jnp.asarray(inputs["R0"]), jnp.asarray(inputs["t0"]), g)
    np.testing.assert_allclose(pg["t"], np.asarray(tj), atol=1e-2)
    np.testing.assert_allclose(pg["cost"], float(cj),
                               rtol=dryrun.POSEGRAPH_COST_RTOL)


def test_dry_run_defaults_to_the_card():
    for fn in (run_ranks, dryrun.dryrun_multigpu, dryrun.dryrun_inputs,
               dryrun.sharded_paths):
        assert inspect.signature(fn).parameters["device_type"].default == (
            "cuda"), fn.__name__
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "caelo_tpu_torch.parallel.dryrun", "2"],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode != 0
    assert "--platform cpu" in out.stderr and not out.stdout
