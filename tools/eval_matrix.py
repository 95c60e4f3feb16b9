"""Cross-method registration evaluation matrix of the PyTorch port: one row
per keypoint x descriptor combination (the reference's keypoint study,
``EvalOnReg_KeyPts.py:73-204``), each run through the port's own
``odometry --keypoints`` command and scored with its ``eval/metrics.py``.

Builds a KITTI-format tree (the smooth synthetic scene, or with ``--hard``
the ray-cast circuit with turns and moving cars), writes external keypoint
trees from the port's CAE-LO features in the third-party layouts (3DFeatNet:
35 float32 columns, xyz and a 32-dim descriptor; USIP: keypoints only,
stored rotated by R90^T), then runs the rows:

  cae-lo             CAE-LO keypoints and descriptors (the windowed path)
  iss / harris /     baseline keypoints + CAE-LO descriptors
  sift / random
  ext-3dfeatnet      external keypoints + the file's descriptors
  ext-usip           external keypoints (R90 storage) + CAE-LO descriptors

Writes a JSON of ``rows`` (RRE, RTE, success, ATE, seconds and
``per_scenario`` success counts per row), ``win_loss`` (pairs row a solved
and row b did not), ``note``, the device and the total seconds.

    python3 tools/eval_matrix.py --weights-random            # on the card
    python3 tools/eval_matrix.py --weights-random --platform cpu --frames 4

``--weights-random`` answers the ``.h5`` loaders with
``random_flax_params(0)`` (for checkouts without the shipped weights).  The
default output is ``runs/eval_matrix_torch.json``.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from caelo_tpu_torch import cli  # noqa: E402
from caelo_tpu_torch.models import weights_io  # noqa: E402

ROWS = ("cae-lo", "iss", "harris", "sift", "random", "ext-3dfeatnet",
        "ext-usip")


def _write_tree(root, scans, gt):
    """``scans`` (padded points and masks) as KITTI sequence 00: unpadded
    ``.bin`` files, ground-truth ``poses/00.txt``, identity ``Tr``."""
    seq_dir = os.path.join(root, "sequences", "00")
    vel_dir = os.path.join(seq_dir, "velodyne")
    os.makedirs(vel_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    for i, (pts, mask) in enumerate(scans):
        np.asarray(pts)[np.asarray(mask)].astype(np.float32).tofile(
            os.path.join(vel_dir, f"{i:06d}.bin"))
    np.savetxt(os.path.join(root, "poses", "00.txt"), gt)
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        tr = np.eye(3, 4).reshape(-1)
        for k in ("P0", "P1", "P2", "P3", "Tr"):
            f.write(k + ": " + " ".join(f"{v:.6e}" for v in tr) + "\n")
    return gt


def build_kitti_tree(root, frames, cfg, seed=0):
    """The smooth synthetic sequence (``examples/eval_matrix.py``'s): one
    scene seen from a path that drifts and yaws, 5 mm of noise."""
    from caelo_tpu_torch.data.synthetic import (make_scene, range_filter,
                                                sample_scene_points)

    world = sample_scene_points(make_scene(seed=seed), seed=seed,
                                n_points=cfg.max_points)
    rng = np.random.default_rng(seed)
    scans, poses = [], []
    for i in range(frames):
        yaw = 0.02 * i
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        t = np.array([1.1 * i, 0.05 * i ** 1.5, 0.0])
        local = range_filter(((world - t) @ R).astype(np.float32), cfg.sensor)
        local = local + rng.normal(0, 0.005, local.shape).astype(np.float32)
        refl = rng.uniform(0, 1, (local.shape[0], 1)).astype(np.float32)
        pts = np.concatenate([local, refl], 1).astype(np.float32)
        scans.append((pts, np.ones(len(pts), bool)))
        poses.append(np.concatenate([R, t.reshape(3, 1)], 1).reshape(12))
    return _write_tree(root, scans, np.stack(poses))


def build_hard_kitti_tree(root, frames, cfg, seed=0):
    """The hard ray-cast circuit (turns, moving cars, occlusion) on which
    weak detectors fail."""
    from caelo_tpu_torch.data.hard_synthetic import generate_benchmark

    scans, poses = generate_benchmark(n_frames=frames, seed=seed, cfg=cfg)
    return _write_tree(root, scans, np.asarray(poses).reshape(frames, 12))


def export_external_trees(root, kitti_root, frames, cfg, device):
    """The port's CAE-LO features of every scan as the 3DFeatNet tree
    (xyz and the first 32 descriptor dimensions) and the USIP tree
    (keypoints stored rotated by R90^T)."""
    import torch
    from caelo_tpu_torch.data.external import R90
    from caelo_tpu_torch.data.kitti import KittiOdometry
    from caelo_tpu_torch.frontend.registration import extract_frame_features

    respond, encoder = cli._reference_models(device, cfg)
    d3 = os.path.join(root, "3dfeatnet", "00")
    du = os.path.join(root, "usip", "00")
    os.makedirs(d3, exist_ok=True)
    os.makedirs(du, exist_ok=True)
    ds = KittiOdometry(kitti_root, cfg)
    for i, (pts, mask) in enumerate(ds.iter_scans("00", 0, frames)):
        f = extract_frame_features(respond, encoder,
                                   torch.from_numpy(pts).to(device),
                                   torch.from_numpy(mask).to(device), cfg)
        m = f.mask.cpu().numpy()
        kp = f.key_pts.cpu().numpy()[m]
        desc = f.descriptors.cpu().numpy()[m][:, :32]
        np.concatenate([kp, desc], 1).astype(np.float32).tofile(
            os.path.join(d3, f"{i:06d}.bin"))
        (R90.T @ kp.T).T.astype(np.float32).tofile(
            os.path.join(du, f"{i:06d}.bin"))


def scenario_labels(gt):
    """'turn' where the ground truth yaws more than 0.5 deg between frames,
    else 'straight' (the reference's per-scenario counts,
    ``EvalOnReg_KeyPts.py:178-188``)."""
    P = gt.reshape(-1, 3, 4)
    rel = np.einsum("nji,njk->nik", P[:-1, :, :3], P[1:, :, :3])
    yaw = np.degrees(np.abs(np.arctan2(rel[:, 1, 0], rel[:, 0, 0])))
    return np.where(yaw > 0.5, "turn", "straight")


def run_row(row, kitti_root, ext_root, out_dir, platform):
    argv = ["odometry", "--data", kitti_root, "--seq", "00", "--out",
            os.path.join(out_dir, row), "--frames", "-1", "--platform",
            platform]
    if row.startswith("ext-"):
        fmt = row[4:]
        argv += ["--keypoints", "external", "--external-dir",
                 os.path.join(ext_root, fmt), "--external-fmt", fmt]
    else:
        argv += ["--keypoints", row]
    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"row {row}: odometry exited {rc}")
    return os.path.join(out_dir, row, "poses_", "00.txt")


def score(gt, est_path):
    """``(summary, per-pair success)``: RRE / RTE / success rate and ATE;
    a pair succeeds under 1 deg and 0.5 m."""
    from caelo_tpu_torch.eval.metrics import (absolute_trajectory_error,
                                              registration_summary,
                                              relative_pose_errors)

    est = np.loadtxt(est_path).reshape(-1, 12)
    errs = relative_pose_errors(gt, est, np.eye(3), np.zeros(3))
    out = registration_summary(errs)
    out.update(absolute_trajectory_error(gt, est))
    succ = (np.asarray(errs.rre_deg) < 1.0) & (np.asarray(errs.rte_m) < 0.5)
    return out, succ


def _card():
    """The card's nvidia-smi name and power limit, or None off the card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default=os.path.join("runs",
                                                  "eval_matrix_torch.json"))
    ap.add_argument("--rows", default=",".join(ROWS))
    ap.add_argument("--platform", default="cuda",
                    help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--hard", action="store_true",
                    help="the hard ray-cast circuit (turns, moving cars)")
    ap.add_argument("--weights-random", action="store_true",
                    help="answer the .h5 loaders with random_flax_params(0)")
    args = ap.parse_args(argv)

    t_start = time.time()
    device = cli._device(args)
    if args.weights_random:
        rp, ep = weights_io.random_flax_params(0)
        weights_io.load_respond_layer_params = lambda path=None: rp
        weights_io.load_patch_encoder_params = lambda path=None: ep
    cfg = cli.PipelineConfig()
    work = args.workdir or tempfile.mkdtemp(prefix="eval_matrix_")
    kitti_root = os.path.join(work, "kitti")
    ext_root = os.path.join(work, "external")
    out_dir = os.path.join(work, "rows")
    print(f"workdir: {work}", file=sys.stderr)
    build = build_hard_kitti_tree if args.hard else build_kitti_tree
    gt = build(kitti_root, args.frames, cfg)
    export_external_trees(ext_root, kitti_root, args.frames, cfg, device)
    scen = scenario_labels(gt)
    t_rows = time.time()

    table, succ_by_row = {}, {}
    for row in args.rows.split(","):
        t0 = time.time()
        est = run_row(row, kitti_root, ext_root, out_dir, args.platform)
        table[row], succ = score(gt, est)
        succ_by_row[row] = succ
        table[row]["seconds"] = time.time() - t0
        table[row]["per_scenario"] = {
            lab: {"success": int(succ[scen == lab].sum()),
                  "pairs": int((scen == lab).sum())}
            for lab in ("straight", "turn")}
        print(f"\n{row}: RRE {table[row]['rre_deg']:.4f} deg  "
              f"RTE {table[row]['rte_m']:.4f} m  "
              f"success {table[row]['success_rate'] * 100:.1f}%  "
              f"ATE {table[row]['ate_rmse']:.3f} m  "
              f"({table[row]['seconds']:.1f} s)", file=sys.stderr)

    win_loss = {a: {b: int((succ_by_row[a] & ~succ_by_row[b]).sum())
                    for b in table if b != a} for a in table}
    out = {"frames": args.frames, "hard": bool(args.hard), "rows": table,
           "win_loss": win_loss,
           "note": ("hard ray-cast circuit (turns + dynamic cars)"
                    if args.hard else "smooth synthetic sequence")
           + "; external trees in 3DFeatNet 35-col / USIP rotated-keypoint "
             "layouts written from the port's CAE-LO features; "
           + ("random weights (random_flax_params(0))"
              if args.weights_random else "shipped weights"),
           "device": str(device),
           "card": _card() if device.type == "cuda" else None,
           "setup_seconds": t_rows - t_start,
           "seconds": time.time() - t_start}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
