"""The port imports nothing of the JAX package and nothing of JAX, and its own
copies of the JAX package's host modules agree with the originals: the
config field by field (one listed exception) and its four constructors, the
synthetic and ray-cast generators bit for bit, the beam-angle fix, the
calibration reader, the native loader's source, the scan-cache reader, the
artifact store's on-disk layout both ways, and de-jump and batched
refinement on a seeded input; the example drivers' host-only copies (the
validation rows' keys, the KITTI golden row and its tolerances, and the
hard benchmark's gate constants) equal the JAX scripts'."""
import ast
import dataclasses
import glob
import os

import numpy as np
import pytest

import caelo_tpu.backend.refine as jrefine
import caelo_tpu.config as jcfg
import caelo_tpu.data.artifacts as jart
import caelo_tpu.data.hard_synthetic as jhard
import caelo_tpu.data.native_loader as jnative
import caelo_tpu.data.scancache as jcache
import caelo_tpu.data.synthetic as jsyn
import caelo_tpu.geometry.kitti_pose as jkp
import caelo_tpu.geometry.se3 as jse3
import caelo_tpu_torch.backend.refine as trefine
import caelo_tpu_torch.config as tcfg
import caelo_tpu_torch.data.artifacts as tart
import caelo_tpu_torch.data.hard_synthetic as thard
import caelo_tpu_torch.data.native_loader as tnative
import caelo_tpu_torch.data.scancache as tcache
import caelo_tpu_torch.data.synthetic as tsyn
import caelo_tpu_torch.geometry.kitti_pose as tkp
import caelo_tpu_torch.geometry.se3 as tse3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, "caelo_tpu_torch", "**", "*.py"),
              recursive=True)
    + [os.path.join(REPO, "chip_smoke.py")]
    + glob.glob(os.path.join(REPO, "tools", "*.py")))
FORBIDDEN = ("caelo_tpu", "jax", "jaxlib", "flax")
# the one default in which the port's config differs from the JAX package's
EXCEPTIONS = {("VoxelConfig", "use_pallas_plane_gather"): (True, False)}
CLASSES = ("SensorConfig", "KeypointConfig", "VoxelConfig", "RansacConfig",
           "IcpConfig", "RefineConfig", "PipelineConfig")


def _imported_modules(tree):
    """Every absolute module name an ``import`` or ``from ... import`` names,
    at any depth (inside functions too)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_files_found():
    assert "chip_smoke.py" in PORT_FILES
    for f in ("config.py", "cli.py", "data/kitti.py", "data/native_loader.py",
              "data/scancache.py", "training/train.py",
              "training/drivers.py", "examples/register_pair_demo.py",
              "examples/train_from_scratch_study.py",
              "examples/hard_benchmark.py", "examples/loop_closure_demo.py",
              "examples/collect_validation.py", "examples/kitti_golden.py"):
        assert os.path.join("caelo_tpu_torch", f) in PORT_FILES, f
    assert len(PORT_FILES) > 30


def _fields(cls):
    return [(f.name, f.default, f.default_factory) for f in
            dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CLASSES)
def test_config_defaults_match_jax(name):
    """Field names, order and defaults equal, but for the listed exception."""
    t, j = getattr(tcfg, name), getattr(jcfg, name)
    tf, jf = _fields(t), _fields(j)
    assert [f[0] for f in tf] == [f[0] for f in jf]
    for (field, dt, ft), (_, dj, fj) in zip(tf, jf):
        if (name, field) in EXCEPTIONS:
            assert (dt, dj) == EXCEPTIONS[(name, field)]
        elif dataclasses.is_dataclass(dt):
            a, b = dataclasses.asdict(dt), dataclasses.asdict(dj)
            for (cls, f), want in EXCEPTIONS.items():
                if type(dt).__name__ == cls:
                    assert (a.pop(f), b.pop(f)) == want
            assert a == b, field
        else:
            assert (dt, ft) == (dj, fj), field


def test_config_values_and_properties_match_jax():
    """The default and tiny configs as nested dicts, and the derived shapes
    the pipeline reads, equal the JAX package's."""
    for make in (lambda m: m.PipelineConfig(), lambda m: m.tiny_test_config(),
                 lambda m: m.small_test_config(), lambda m: m.ci_config()):
        t, j = make(tcfg), make(jcfg)
        dt, dj = dataclasses.asdict(t), dataclasses.asdict(j)
        assert (dt["voxel"].pop("use_pallas_plane_gather"),
                dj["voxel"].pop("use_pallas_plane_gather")) == (True, False)
        assert dt == dj
        for p in ("img_h", "img_w", "model_h", "model_w", "azimuth_res",
                  "vertical_res", "vertical_pixel_offset"):
            assert getattr(t.sensor, p) == getattr(j.sensor, p), p
        for p in ("voxel_sizes", "n_blocks", "grid_shape0", "patch_radius",
                  "crop_blocks", "origin"):
            assert getattr(t.voxel, p) == getattr(j.voxel, p), p
        for s in range(3):
            assert t.voxel.grid_shape(s) == j.voxel.grid_shape(s)


def test_synthetic_generators_bit_equal():
    sensor = tcfg.SensorConfig()
    for seed in (0, 3):
        st, sj = tsyn.make_scene(seed), jsyn.make_scene(seed)
        assert st.keys() == sj.keys()
        for k in st:
            np.testing.assert_array_equal(st[k], sj[k])
        wt = tsyn.sample_scene_points(st, seed, n_points=20000)
        wj = jsyn.sample_scene_points(sj, seed, n_points=20000)
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_array_equal(tsyn.range_filter(wt - 1.5, sensor),
                                      jsyn.range_filter(wj - 1.5, sensor))


@pytest.mark.parametrize("beam_error_deg", [0.0, 0.3])
def test_synthetic_scan_pair_bit_equal(beam_error_deg):
    for make in (tcfg.tiny_test_config, tcfg.small_test_config):
        cfg_t, cfg_j = make(), getattr(jcfg, make.__name__)()
        got = tsyn.synthetic_scan_pair(2, cfg_t, beam_error_deg=beam_error_deg)
        want = jsyn.synthetic_scan_pair(2, cfg_j, beam_error_deg=beam_error_deg)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_correct_beam_angle_np_bit_equal():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-50, 50, (1000, 3)).astype(np.float32)
    pts[:3, :2] = 0.0                       # on the z axis: left as they are
    for deg in (0.22, -0.5):
        got = tse3.correct_beam_angle_np(pts, deg)
        np.testing.assert_array_equal(got, jse3.correct_beam_angle_np(pts, deg))
        np.testing.assert_array_equal(got[:3], pts[:3])
        assert not np.array_equal(got[3:], pts[3:])


def test_load_calib_tr_and_rt_to_poses_match_jax(tmp_path):
    """Both calib.txt formats (``key: values`` rows with a Tr row, and the
    stripped numeric table whose 5th row is Tr); rt_to_poses on a batch."""
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(5, 12))
    raw = tmp_path / "calib.txt"
    raw.write_text("".join(f"{k}: " + " ".join(f"{v:.12f}" for v in r) + "\n"
                           for k, r in zip(("P0", "P1", "P2", "P3", "Tr"),
                                           rows)))
    stripped = tmp_path / "calib_.txt"
    stripped.write_text("".join(" ".join(f"{v:.12f}" for v in r) + "\n\n"
                                for r in rows))
    for path in (raw, stripped):
        got, want = tkp.load_calib_tr(str(path)), jkp.load_calib_tr(str(path))
        for a, b in zip(got, want):
            assert a.dtype == np.float64
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[0], rows[4].reshape(3, 4)[:, :3],
                                   atol=1e-12)
    R, t = rng.normal(size=(4, 3, 3)), rng.normal(size=(4, 3))
    np.testing.assert_array_equal(tkp.rt_to_poses(R, t),
                                  np.asarray(jkp.rt_to_poses(R, t)))


def test_native_loader_source_is_a_copy():
    for path in (tnative.SRC, jnative._SRC):
        assert os.path.exists(path), path
    with open(tnative.SRC, "rb") as a, open(jnative._SRC, "rb") as b:
        assert a.read() == b.read()


def test_npy_scan_reader_matches_jax(tmp_path):
    """Both readers return the same frames and masks from ``.npy`` stacks
    (version 1.0 and 2.0 headers) and refuse an index out of range."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(4, 50, 4)).astype(np.float32)
    msk = rng.uniform(size=(4, 50)) < 0.7
    for version in ((1, 0), (2, 0)):
        base = str(tmp_path / f"seq{version[0]}")
        for suffix, arr in ((".pts.npy", pts), (".msk.npy", msk)):
            with open(base + suffix, "wb") as f:
                np.lib.format.write_array(f, arr, version=version)
        rt, rj = tcache.NpyScanReader(base), jcache.NpyScanReader(base)
        assert len(rt) == len(rj) == 4
        for i in (0, 3, -2):
            for a, b, want in zip(rt[i], rj[i], (pts[i], msk[i])):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, want)
        np.testing.assert_array_equal(rt.mask(2), rj.mask(2))
        with pytest.raises(IndexError):
            rt[4]


def test_raycast_generators_bit_equal():
    """circuit_trajectory, make_city, terrain_height and raycast_scan (one
    scan at a 2 deg azimuth step, with cars and terrain) equal the JAX
    package's."""
    kw = dict(n_frames=40, side=30.0, yaw_rate_deg=6.0)
    pt, pj = thard.circuit_trajectory(**kw), jhard.circuit_trajectory(**kw)
    np.testing.assert_array_equal(pt, pj)
    ct, cj = (m.make_city(seed=1, side=30.0, n_cars=3) for m in (thard, jhard))
    for k in ("boxes", "poles", "side"):
        np.testing.assert_array_equal(ct[k], cj[k])
    assert ct["cars"] == cj["cars"]
    for k in ct["terrain"]:
        np.testing.assert_array_equal(ct["terrain"][k], cj["terrain"][k])
    x = np.linspace(-20, 20, 57, dtype=np.float32)
    np.testing.assert_array_equal(thard.terrain_height(ct, x, x[::-1]),
                                  jhard.terrain_height(cj, x, x[::-1]))
    sensor = tcfg.SensorConfig()
    for frame in (0, 17):
        st = thard.raycast_scan(ct, pt[frame], frame, sensor, az_step_deg=2.0,
                                seed=1, dropout=0.3)
        sj = jhard.raycast_scan(cj, pj[frame], frame, sensor, az_step_deg=2.0,
                                seed=1, dropout=0.3)
        assert st.shape[0] > 500
        np.testing.assert_array_equal(st, sj)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_artifact_store_read_by_the_other_package(tmp_path, writer):
    """A store written by one package is read, frame by frame and stage by
    stage, by the other; get_or_compute loads instead of recomputing."""
    w, r = ((tart, jart) if writer == "port" else (jart, tart))
    ws, rs = (m.ArtifactStore(str(tmp_path / "store")) for m in (w, r))
    rng = np.random.default_rng(0)
    arrays = {i: {"a": rng.normal(size=(3, 4)).astype(np.float32),
                  "m": rng.uniform(size=7) < 0.5} for i in range(3)}
    for i, arr in arrays.items():
        ws.save("features", "00", i, **arr)
    ws.save("meta", "00", "calib", n_frames=np.asarray(3))
    assert rs.frames_done("features", "00") == 3
    assert ws.path("features", "00", 2) == rs.path("features", "00", 2)
    for i, arr in arrays.items():
        got = rs.load("features", "00", i)
        assert got.keys() == arr.keys()
        for k in arr:
            np.testing.assert_array_equal(got[k], arr[k])
    assert int(rs.load("meta", "00", "calib")["n_frames"]) == 3
    out = rs.get_or_compute("features", "00", 1, lambda: {"a": np.zeros(1)})
    np.testing.assert_array_equal(out["a"], arrays[1]["a"])
    assert r.STAGES == w.STAGES


def _rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _trajectory(rng, n=30):
    """A turning trajectory (N, 12) with two injected motion jumps."""
    poses, R, t = [], np.eye(3), np.zeros(3)
    for k in range(n):
        poses.append(np.concatenate([R, t[:, None]], 1).reshape(12))
        step = np.array([1.0, 0.05, 0.0]) + rng.normal(0, 0.01, 3)
        if k in (9, 21):
            step = step + np.array([1.5, -0.8, 0.1])
        t = t + R @ step
        R = R @ _rot(np.radians(1.5 if 10 < k < 20 else 0.2)
                     + rng.normal(0, 1e-3))
    return np.stack(poses)


def _rel(p0, p1):
    P0, P1 = np.asarray(p0).reshape(3, 4), np.asarray(p1).reshape(3, 4)
    return P0[:, :3].T @ P1[:, :3], P0[:, :3].T @ (P1[:, 3] - P0[:, 3])


def _apply(p0, R, t):
    P0 = np.asarray(p0).reshape(3, 4)
    return np.hstack([P0[:, :3] @ R,
                      (P0[:, :3] @ t + P0[:, 3])[:, None]]).reshape(12)


def _icp(idx_i, idx_j, relRs, relTs, thr_scale=1.0):
    """A deterministic batched ICP: small corrections, a failure on every
    fifth span at the first rung, and residual gains that pass or fail the
    gain gate by span."""
    n = len(idx_i)
    key = (np.asarray(idx_i) * 7 + np.asarray(idx_j) * 3) % 11
    dRs = np.stack([_rot(np.radians(0.05 * (k - 5))) for k in key])
    dts = np.stack([[0.01 * (k - 5), -0.005 * k, 0.002] for k in key])
    oks = (key % 5 != 0) | (thr_scale >= 4.0)
    r0 = np.full(n, 0.5)
    r1 = np.where(key % 3 == 0, 0.49, 0.3)
    return dRs, dts, oks, r0, r1


def test_fix_jump_poses_matches_jax():
    rng = np.random.default_rng(0)
    poses = _trajectory(rng)
    trusted = rng.uniform(size=len(poses) - 1) < 0.6
    for pair_trusted in (None, trusted):
        pt, ft = trefine.fix_jump_poses(poses, pair_trusted=pair_trusted)
        pj, fj = jrefine.fix_jump_poses(poses, pair_trusted=pair_trusted)
        np.testing.assert_array_equal(pt, pj)
        assert ft == fj
    assert trefine.fix_jump_poses(poses)[1]               # jumps were found


@pytest.mark.parametrize("trusted", [False, True])
def test_refine_odometry_batched_matches_jax(trusted):
    """The port's copy of refine_odometry_batched against the JAX package's
    on the same poses, inlier chains and batched ICP: identical poses and
    the same refined, failed, rejected and skipped spans."""
    rng = np.random.default_rng(1)
    poses = _trajectory(rng)
    n = len(poses)
    pairs = []
    for _ in range(n - 1):
        base = rng.choice(40, 20, replace=False)
        pairs.append((base, rng.permutation(base)))
    pair_trusted = (rng.uniform(size=n - 1) < 0.5) if trusted else None
    out = [m.refine_odometry_batched(poses, _icp, _rel, _apply, pairs,
                                     pair_trusted=pair_trusted)
           for m in (trefine, jrefine)]
    (pt, st), (pj, sj) = out
    np.testing.assert_array_equal(pt, pj)
    assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    assert st.refined and (st.failed or st.rejected)


def _jax_script_ast(name):
    with open(os.path.join(REPO, "examples", f"{name}.py")) as f:
        return ast.parse(f.read())


def _assigned(tree, name):
    """The literal value the module-level ``name = ...`` of ``tree``
    binds."""
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_example_constants_are_copies():
    """``collect_validation.KEYS``, ``kitti_golden``'s GOLDEN, TOL_SUCCESS
    and TOL_REL equal the JAX scripts' (read from their source: the
    scripts stay unimported here); every gate constant of the port's
    ``hard_benchmark`` is a number literal of the JAX script's ``main``."""
    from caelo_tpu_torch.examples import (collect_validation, hard_benchmark,
                                          kitti_golden)

    cv = _jax_script_ast("collect_validation")
    assert collect_validation.KEYS == _assigned(cv, "KEYS")
    kg = _jax_script_ast("kitti_golden")
    for name in ("GOLDEN", "TOL_SUCCESS", "TOL_REL"):
        assert getattr(kitti_golden, name) == _assigned(kg, name), name
    main = next(n for n in _jax_script_ast("hard_benchmark").body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    literals = {n.value for n in ast.walk(main)
                if isinstance(n, ast.Constant)
                and isinstance(n.value, (int, float))}
    for name in ("CIRCUIT_FRAMES", "CLEAN_ATE_M", "DAMAGE_M", "REPAIR_RATIO",
                 "REPAIR_SHARE", "NO_HARM_RATIO", "NO_HARM_M", "RRE_DEG",
                 "RTE_M", "SUCCESS", "SUCCESS_REFINED", "LOOP_PRECISION",
                 "LOOP_RECALL", "LOOP_ATE_SHRINK"):
        assert getattr(hard_benchmark, name) in literals, name
