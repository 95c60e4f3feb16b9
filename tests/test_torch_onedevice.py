"""The rest of the one-device port against the JAX package on the CPU: the
block-sparse layout (``voxel/blocks.py``) and ``dedup_int_rows`` exactly,
the se3 converters to float32 tolerance, ``describe``, and the threaded
staging of ``run_odometry_windowed`` (bit-identical to staging each window
when it is due, a disk-backed reader read off the main thread, a
producer's exception raised in the caller)."""
import threading

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from caelo_tpu.config import VoxelConfig
from caelo_tpu.geometry import se3 as jse3
from caelo_tpu.models.patch_encoder import PatchEncoder as JEncoder
from caelo_tpu.models.patch_encoder import describe as jdescribe
from caelo_tpu.ops import masking as jmask
from caelo_tpu.voxel import blocks as jblocks
from caelo_tpu_torch.config import tiny_test_config
from caelo_tpu_torch.data.scancache import NpyScanReader
from caelo_tpu_torch.data.synthetic import (make_scene, range_filter,
                                            sample_scene_points)
from caelo_tpu_torch.frontend import odometry as todo
from caelo_tpu_torch.geometry import se3 as tse3
from caelo_tpu_torch.models.patch_encoder import describe as tdescribe
from caelo_tpu_torch.models.weights_io import build_models, random_flax_params
from caelo_tpu_torch.ops import masking as tmask
from caelo_tpu_torch.ops.masking import pad_points
from caelo_tpu_torch.voxel import blocks as tblocks

VC = VoxelConfig()
T = torch.from_numpy


# ------------------------------------------------------------- blocks
def _block_voxels(rng):
    """Voxels of tests/test_blocks.py's three blocks and of 40 random ones,
    deduped, shuffled, with invalid rows spread among them."""
    bs = VC.block_size
    blocks = np.concatenate([[[10, 20, 5], [10, 21, 5], [100, 100, 11]],
                             rng.integers(0, (150, 150, 20), (40, 3))])
    vox = np.concatenate([b * bs + rng.integers(0, bs, (rng.integers(1, 9),
                                                        3)) for b in blocks])
    vox = rng.permutation(np.unique(vox, axis=0)).astype(np.int32)
    n = 2 * len(vox)
    allv = np.zeros((n, 3), np.int32)
    mask = np.zeros(n, bool)
    slots = np.sort(rng.choice(n, len(vox), replace=False))
    allv[slots], mask[slots] = vox, True
    allv[~mask] = rng.integers(0, 9000, (n - len(vox), 3))    # junk rows
    return allv, mask


@pytest.mark.parametrize("max_blocks", [64, 16])
def test_build_blocks_matches_jax(rng, max_blocks):
    """build_blocks with room for every block and with fewer slots than
    blocks: every field equal to JAX's, the CSR offsets of empty slots
    pointing at the end; each block's voxels in input order."""
    allv, mask = _block_voxels(rng)
    ref = jblocks.build_blocks(jnp.asarray(allv), jnp.asarray(mask), VC,
                               max_blocks=max_blocks)
    out = tblocks.build_blocks(T(allv), T(mask), VC, max_blocks=max_blocks)
    for name, a, b in zip(out._fields, out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    n = int(out.n_blocks)
    assert n == 43 and out.block_mask.sum() == min(n, max_blocks)
    if max_blocks > n:
        assert (out.offsets[n:] == int(mask.sum())).all()
    first = out.voxels[out.offsets[0]:out.offsets[1]].numpy()
    rows = [i for i in range(len(allv)) if mask[i]
            and (allv[i] // VC.block_size == first[0] // VC.block_size).all()]
    np.testing.assert_array_equal(first, allv[rows])


def test_block_crop_and_partition_match_jax(rng):
    """interior_block_mask and partition_blocks (default halo and halo 9,
    2 and 3 parts) on blocks across the grid, some slots empty: equal to
    JAX's."""
    ids = np.concatenate([[[0, 50, 10], [4, 50, 10], [152, 50, 10],
                           [77, 0, 0], [78, 0, 0], [155, 0, 0]],
                          rng.integers(0, (156, 156, 23), (30, 3))]
                         ).astype(np.int32)
    m = rng.uniform(size=len(ids)) < 0.8
    np.testing.assert_array_equal(
        tblocks.interior_block_mask(T(ids), T(m), VC).numpy(),
        np.asarray(jblocks.interior_block_mask(jnp.asarray(ids),
                                               jnp.asarray(m), VC)))
    for n_parts, halo in ((2, None), (3, 9)):
        got = tblocks.partition_blocks(T(ids), T(m), n_parts, VC, halo)
        want = jblocks.partition_blocks(jnp.asarray(ids), jnp.asarray(m),
                                        n_parts, VC, halo)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -------------------------------------------------------------- dedup
@pytest.mark.parametrize("size,n_keys", [(150, None), (150, 2), (20, None),
                                         (8, 1)])
def test_dedup_int_rows_matches_jax(rng, size, n_keys):
    """dedup_int_rows on rows with many repeats and invalid rows: equal to
    JAX's, with all keys and with fewer keys than columns (stable order of
    the rest), with room for every row and with fewer slots (count beyond
    size)."""
    rows = rng.integers(0, 4, (200, 3)).astype(np.int32)
    mask = rng.uniform(size=200) < 0.8
    got = tmask.dedup_int_rows(T(rows), T(mask), size, n_keys)
    want = jmask.dedup_int_rows(jnp.asarray(rows), jnp.asarray(mask), size,
                                n_keys)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if n_keys is None:
        n_unique = len(np.unique(rows[mask], axis=0))
        assert int(got[2]) == n_unique
        assert int(got[1].sum()) == min(size, n_unique)
    empty = tmask.dedup_int_rows(T(rows), T(np.zeros(200, bool)), size)
    assert int(empty[2]) == 0 and not empty[1].any()


# ---------------------------------------------------------------- se3
def test_se3_converters_match_jax(rng):
    """euler_xyz_to_rotmat, rotmat_to_quat (up to sign), angle_axis_to_quat
    and quat_to_angle_axis (the identity's axis zero) within 1e-6 of JAX
    on float32 inputs, 1e-5 for the quaternion from the Jacobi solve; the
    quaternion round trip."""
    ang = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    R = tse3.euler_xyz_to_rotmat(T(ang))
    np.testing.assert_allclose(
        R.numpy(), np.asarray(jse3.euler_xyz_to_rotmat(jnp.asarray(ang))),
        atol=1e-6, rtol=0)
    q = tse3.rotmat_to_quat(R).numpy()
    qj = np.asarray(jse3.rotmat_to_quat(jnp.asarray(R.numpy())))
    sign = np.sign((q * qj).sum(-1, keepdims=True))
    np.testing.assert_allclose(q * sign, qj, atol=1e-5, rtol=0)
    assert (q[:, 0] >= 0).all()
    np.testing.assert_allclose(tse3.quat_to_rotmat(T(q)).numpy(), R.numpy(),
                               atol=1e-5)
    axis = rng.normal(size=(64, 3)).astype(np.float32)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    theta = rng.uniform(0, np.pi, 64).astype(np.float32)
    qa = tse3.angle_axis_to_quat(T(theta), T(axis)).numpy()
    np.testing.assert_allclose(qa, np.asarray(jse3.angle_axis_to_quat(
        jnp.asarray(theta), jnp.asarray(axis))), atol=1e-6, rtol=0)
    qa[0] = [1.0, 0.0, 0.0, 0.0]                    # the identity
    got = tse3.quat_to_angle_axis(T(qa))
    want = jse3.quat_to_angle_axis(jnp.asarray(qa))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    assert float(got[0][0]) == 0.0 and not got[1][0].any()
    np.testing.assert_allclose(got[0][1:].numpy(), theta[1:], atol=1e-3)


def test_correct_beam_angle_matches_jax(rng):
    """The tensor correct_beam_angle within 1e-5 m of JAX's (points out to
    80 m) and of the port's numpy twin; a point on the z axis unmoved."""
    pts = rng.uniform(-80, 80, (512, 3)).astype(np.float32)
    pts[0] = [0.0, 0.0, 4.0]
    got = tse3.correct_beam_angle(T(pts)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jse3.correct_beam_angle(jnp.asarray(pts))), atol=1e-5,
        rtol=0)
    np.testing.assert_allclose(got, tse3.correct_beam_angle_np(pts),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[0], pts[0])
    assert np.abs(got - pts).max() > 1e-2


# ----------------------------------------------------------- describe
@pytest.mark.parametrize("batch_chunk", [None, 24])
def test_describe_matches_jax(rng, batch_chunk):
    """describe on three scales of random occupancy patches with
    random_flax_params(0): the 60-dim descriptors within 1e-5 of JAX's, in
    one call per scale and 24 patches at a time."""
    _, ep = random_flax_params(0)
    patches3 = [(rng.uniform(size=(64, 16, 16, 16)) < 0.1).astype(np.float32)
                for _ in range(3)]
    want = np.asarray(jdescribe(JEncoder().apply, ep,
                                [jnp.asarray(p) for p in patches3]))
    _, enc = build_models(*random_flax_params(0), "cpu")
    got = tdescribe(enc, [T(p) for p in patches3], batch_chunk).numpy()
    assert got.shape == (64, 60)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ staging
CFG = tiny_test_config()


def _scans(n=3):
    scene = make_scene(seed=0, n_boxes=25, extent=30.0)
    world = sample_scene_points(scene, seed=0, n_points=CFG.max_points)
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        t = np.array([0.8 * i, 0.05 * i, 0.0])
        local = range_filter((world - t).astype(np.float32), CFG.sensor)
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        out.append(pad_points(np.concatenate([local, refl], 1),
                              CFG.max_points))
    return out


@pytest.fixture(scope="module")
def staging(tmp_path_factory):
    """3 scans in windows of 2 (two windows): staged when due from the
    list, and by the producer thread from an NpyScanReader over the same
    scans, with the names of the threads that read the reader."""
    scans = _scans()
    net, enc = build_models(*random_flax_params(0), "cpu", CFG)
    run = lambda seq, threaded: todo.run_odometry_windowed(
        seq, net, enc, cfg=CFG, window=2, seed=0, keep_features=True,
        threaded_staging=threaded)
    base = str(tmp_path_factory.mktemp("staging") / "seq")
    np.save(base + ".pts.npy", np.stack([p for p, _ in scans]))
    np.save(base + ".msk.npy", np.stack([m for _, m in scans]))
    readers = set()
    get = NpyScanReader.__getitem__
    NpyScanReader.__getitem__ = lambda self, i: (
        readers.add(threading.current_thread().name), get(self, i))[1]
    try:
        threaded = run(NpyScanReader(base), True)
    finally:
        NpyScanReader.__getitem__ = get
    return dict(scans=scans, run=run, base=base, sync=run(scans, False),
                threaded=threaded, readers=readers)


def _assert_same(a, b):
    (ra, fa), (rb, fb) = a, b
    for name in ("poses", "rel_Rs", "rel_ts", "successes", "n_inliers",
                 "thresholds"):
        np.testing.assert_array_equal(getattr(ra, name), getattr(rb, name),
                                      err_msg=name)
    for (a0, a1), (b0, b1) in zip(ra.inlier_pairs, rb.inlier_pairs):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)
    for x, y in zip(fa, fb):
        assert torch.equal(x, y)


def test_threaded_staging_equals_synchronous(staging):
    """run_odometry_windowed with the producer thread (over the disk cache)
    and with each window staged when it is due (over the list): every
    output bit-identical."""
    assert staging["sync"][0].successes.any()
    _assert_same(staging["threaded"], staging["sync"])


def test_npy_reader_staged_off_the_main_thread(staging):
    """The NpyScanReader of the threaded run was read by the staging thread
    alone, and it holds the list's scans bit for bit."""
    assert staging["readers"] == {"window-staging"}
    reader = NpyScanReader(staging["base"])
    for (p, m), (q, n) in zip(reader, staging["scans"]):
        np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(m, n)


class _Broken:
    """Scans whose frame 1 cannot be read: the first window fails."""

    def __init__(self, scans):
        self.scans = scans

    def __len__(self):
        return len(self.scans)

    def __getitem__(self, i):
        if i == 1:
            raise OSError("frame 1: unreadable")
        return self.scans[i]


def test_staging_error_reaches_the_caller(staging):
    """A read that fails in the producer thread is raised by
    run_odometry_windowed in the calling thread (no hang: the call ends
    within 60 s), and the producer thread is gone."""
    box = {}

    def call():
        try:
            staging["run"](_Broken(staging["scans"]), True)
        except OSError as exc:
            box["exc"] = exc

    th = threading.Thread(target=call, daemon=True)
    th.start()
    th.join(60)
    assert not th.is_alive()
    assert "frame 1" in str(box["exc"])
    assert not any(t.name == "window-staging" for t in threading.enumerate())


def test_staging_stops_with_its_consumer():
    """A consumer that stops after the first window stops the producer: no
    staging thread is left once the generator is closed."""
    scans = [(np.zeros((8, 4), np.float32), np.ones(8, bool))] * 9
    gen = todo.staged_windows(scans, len(scans), 3, threaded=True)
    start, stop, pts, msk = next(gen)
    assert (start, stop, tuple(pts.shape), tuple(msk.shape)) == (
        0, 3, (3, 8, 4), (3, 8))
    gen.close()
    assert not any(t.name == "window-staging" for t in threading.enumerate())
