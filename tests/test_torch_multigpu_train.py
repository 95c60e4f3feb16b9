"""The port's data- and tensor-parallel patch-AE steps and span-sharded ICP
on 4 gloo ranks against the JAX package's sharded functions on 4 of the
conftest's virtual CPU devices, on the same numpy-seeded inputs at
``tiny_test_config``, and ``cli scaling`` on 2 gloo ranks.  One spawn of
the 4 ranks (``caelo_tpu_torch.parallel.dryrun.sharded_paths``, which also
checks each path in rank 0 against the port's one-device function) serves
the module.

Tolerances: the DP losses of two steps within rtol 1e-5 of JAX's sharded
step (as tests/test_multichip.py holds JAX's against its one-device step)
and of the port's one-device step, the DP + TP loss (a 2 x 2 mesh, the
state sharded after one one-device step, its Adam moments with it) within
rtol 1e-5 of the port's second one-device step; the sharded ICP exact
against the port's one-device solves at the same span batch, and against
JAX's as tests/test_torch_refine.py holds the batched ICP: success equal,
corrections within 1e-4, residuals within 1e-5 m, the refined poses
within 1e-4."""
import contextlib
import io
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax

from caelo_tpu.backend import refine as jrefine
from caelo_tpu.backend.refine_runner import RefinementFeatures as JFeatures
from caelo_tpu.config import tiny_test_config
from caelo_tpu.models.patch_encoder import VoxelPatchAE as JVoxelAE
from caelo_tpu.parallel.mesh import make_mesh as jmake_mesh
from caelo_tpu.parallel.pipeline import make_sharded_icp_fn as jsharded_icp
from caelo_tpu.training import train as jtrain
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from caelo_tpu_torch import cli
from caelo_tpu_torch.models.patch_encoder import VoxelPatchAE
from caelo_tpu_torch.training import train as ttrain
from caelo_tpu_torch.parallel import dryrun
from caelo_tpu_torch.parallel.mesh import run_ranks

N_RANKS = 4


@pytest.fixture(scope="module")
def inputs():
    return dryrun.dryrun_inputs(N_RANKS, "cpu")


@pytest.fixture(scope="module")
def port(inputs):
    return run_ranks(dryrun.sharded_paths, N_RANKS,
                     args=(inputs, ("train", "icp"), "cpu"),
                     device_type="cpu")[0]


@pytest.fixture(scope="module")
def mesh():
    return jmake_mesh(n_data=N_RANKS, n_model=1,
                      devices=jax.devices()[:N_RANKS])


def test_dp_and_tp_steps_match(inputs, port, mesh):
    params = jax.tree.map(jnp.asarray, inputs["ae"])
    state = jtrain.TrainState(params, optax.adam(1e-3).init(params),
                              jnp.zeros((), jnp.int32))
    state = jtrain.shard_train_state(state, mesh)
    step, bshard = jtrain.make_sharded_train_step(JVoxelAE(),
                                                  jtrain.patch_loss, mesh)
    batch = jax.device_put(jnp.asarray(inputs["ae_batch"]), bshard)
    losses = []
    for _ in range(2):
        state, loss = step(state, batch)
        losses.append(float(loss))
    train = port["train"]
    np.testing.assert_allclose(train["dp"], losses, rtol=1e-5)
    np.testing.assert_allclose(train["dp"], train["one_device"], rtol=1e-5)
    np.testing.assert_allclose(train["tp"], train["one_device"], rtol=1e-5)
    assert train["tp"][1] < train["tp"][0]


def test_sharded_icp_matches_jax(inputs, port, mesh):
    cfg = tiny_test_config()
    feats = JFeatures(*(jnp.asarray(inputs["icp_feats"][f])
                        for f in JFeatures._fields))
    fn = jsharded_icp(feats, mesh, cfg, spans_per_device=dryrun.SPANS_PER_DEVICE)
    out_j = fn(*inputs["icp_spans"])
    out_t = port["icp"]["spans"]
    np.testing.assert_array_equal(out_t[2], out_j[2])
    assert out_t[2].any()
    for k, tol in ((0, 1e-4), (1, 1e-4), (3, 1e-5), (4, 1e-5)):
        np.testing.assert_allclose(out_t[k], out_j[k], atol=tol, rtol=0)
    pj, sj = jrefine.refine_odometry_batched(
        inputs["icp_poses"], fn, dryrun._rel, dryrun._apply, cfg=cfg.refine)
    assert port["icp"]["refined"] == list(sj.refined)
    np.testing.assert_allclose(port["icp"]["poses"], pj, atol=1e-4, rtol=0)


def test_tp_spec_matches_jax():
    """Every parameter of the patch AE is placed over "model" as JAX places
    its Flax counterpart: a (in, out) kernel split by outputs is a (out,
    in) weight split on axis 0, split by inputs one split on axis 1; the
    biases of the output-split layers are split with their rows (JAX
    replicates them; the port's column-parallel layer keeps its own)."""
    flax = {"encoder.fn1": ("encoder", "fn1"), "encoder.fn2": ("encoder", "fn2"),
            "fn3": ("fn3",), "fn4": ("fn4",), "conv2_1": ("conv2_1",),
            "encoder.conv1": ("encoder", "conv1")}
    key = jax.tree_util.DictKey
    for name, path in flax.items():
        spec = jtrain._tp_spec_for_path([key("params"), *map(key, path),
                                         key("kernel")])
        weight = ttrain._tp_spec_for_path(f"{name}.weight")
        bias = ttrain._tp_spec_for_path(f"{name}.bias")
        if spec == P(None, "model"):
            assert weight == Shard(0) and bias == Shard(0), name
        elif spec == P("model", None):
            assert weight == Shard(1) and bias == Replicate(), name
        else:
            assert spec == P() and weight == bias == Replicate(), name
    convs = [n for n, _ in VoxelPatchAE().named_parameters() if "conv" in n
             or n.startswith("out.")]
    assert len(convs) == 12
    assert all(ttrain._tp_spec_for_path(n) == Replicate() for n in convs)


def test_cli_scaling_on_cpu_ranks():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(["scaling", "--platform", "cpu", "--ranks", "2",
                         "--frames-per-device", "1"]) == 0
    sweep = json.loads(out.getvalue())["sweep"]
    assert [r["devices"] for r in sweep] == [1, 2]
    for r in sweep:
        assert set(r) == {"devices", "frames", "frames_per_s", "dt_s",
                          "efficiency"}
        assert r["frames"] == r["devices"]
        assert r["dt_s"] > 0 and r["frames_per_s"] > 0
    assert sweep[0]["efficiency"] == 1.0
