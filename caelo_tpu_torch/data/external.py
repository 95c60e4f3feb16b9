"""Loaders for third-party keypoint/descriptor file trees (the port's copy of
``caelo_tpu/data/external.py``, which imports no JAX; held to it by
``tests/test_torch_external.py``).

The reference scores 3DFeatNet / USIP outputs straight from their binary
file formats for the 9-row evaluation matrix (``Dirs.py:35-41``,
``EvalOnReg_KeyPts.py:73-204``, ``PclKeyPts.py:130-149``,
``GenerateTrajactory.m:57-199``, ``Scripts/Utils.m:4-27,57-75``).  This
module reads the same formats into padded ``FrameFeatures`` of numpy arrays
so any external method runs through the odometry / registration-evaluation
stack:

* **row .bin** -- float32 rows of ``m`` columns (``Utils.loadPointCloud`` /
  ``Utils.load_descriptors``): 3DFeatNet descriptor files are ``m=35``
  (xyz + 32-dim descriptor); USIP keypoints ``m=3``; generic descriptor
  files ``m = 3 + d``.
* **R90 convention fix** -- USIP-convention data is stored rotated; the
  reference rotates it back with ``EulerAngle2RotateMat(-pi/2, 0, -pi/2)``
  (``PclKeyPts.py:146-149``, ``GenerateTrajactory.m:41,181``).
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _r90() -> np.ndarray:
    """R90 built exactly like the reference's EulerAngle2RotateMat chain."""
    ax, az = -np.pi / 2, -np.pi / 2
    Rx = np.array([[1, 0, 0],
                   [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    Rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0],
                   [0, 0, 1]])
    return Rz @ Rx


R90 = _r90()


def load_point_bin(path: str, cols: int) -> np.ndarray:
    """Float32 row file (``Utils.loadPointCloud``/``load_descriptors``):
    returns ``(N, cols)``; raises if the file size does not divide evenly
    (``Utils.m:72``)."""
    raw = np.fromfile(path, dtype=np.float32)
    if raw.size % cols != 0:
        raise ValueError(
            f"{path}: {raw.size} floats not divisible by {cols} columns"
        )
    return raw.reshape(-1, cols)


def load_3dfeatnet(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """3DFeatNet descriptor file: 35 cols = xyz + 32-dim descriptor
    (``PclKeyPts.py:136-138``, ``EvalOnReg_KeyPts.py`` method 1)."""
    data = load_point_bin(path, 35)
    return data[:, :3], data[:, 3:]


def load_usip_keypoints(path: str, apply_r90: bool = True) -> np.ndarray:
    """USIP keypoint file: 3 cols, stored in the rotated USIP frame
    (``PclKeyPts.py:140-149``)."""
    kp = load_point_bin(path, 3)
    if apply_r90:
        kp = (R90 @ kp.T).T.astype(np.float32)
    return kp


def load_descriptors_only(path: str, dim: int) -> np.ndarray:
    """Descriptor-only file (``GenerateTrajactory.m:193-196``: USIP's
    separate descriptor tree, ``FEATURE_DIM_2`` cols per row)."""
    return load_point_bin(path, dim)


def load_xyz_descriptors(path: str, dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """Combined file: ``3 + dim`` cols (``Utils.load_descriptors`` default
    layout)."""
    data = load_point_bin(path, 3 + dim)
    return data[:, :3], data[:, 3:]


class ExternalSequence:
    """Per-frame external keypoints/descriptors as padded FrameFeatures.

    Directory layout mirrors the reference's external trees
    (``Dirs.py:35-41``): ``<root>/<seq>/<frame:06d>.bin``.  ``fmt`` picks
    the binary layout:

    * ``"3dfeatnet"`` -- one file, 35 cols (xyz + 32-d descriptor)
    * ``"xyzdesc"``   -- one file, ``3 + desc_dim`` cols
    * ``"usip"``      -- keypoints under ``root``, optional separate
      descriptor tree ``desc_root`` with ``desc_dim`` cols per row;
      keypoints get the R90 fix
    """

    def __init__(self, root: str, seq: str = "", fmt: str = "3dfeatnet",
                 desc_root: str | None = None, desc_dim: int = 32,
                 n_slots: int = 1024, apply_r90: bool | None = None):
        self.root = root
        self.seq = seq
        self.fmt = fmt
        self.desc_root = desc_root
        self.desc_dim = desc_dim
        self.n_slots = n_slots
        self.apply_r90 = (fmt == "usip") if apply_r90 is None else apply_r90

    def _path(self, root: str, frame: int) -> str:
        return os.path.join(root, self.seq, f"{frame:06d}.bin")

    def n_frames(self) -> int:
        d = os.path.join(self.root, self.seq)
        return len([f for f in os.listdir(d) if f.endswith(".bin")])

    def load(self, frame: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns raw ``(key_pts (N, 3), descriptors (N, d))``."""
        p = self._path(self.root, frame)
        if self.fmt == "3dfeatnet":
            kp, desc = load_3dfeatnet(p)
        elif self.fmt == "xyzdesc":
            kp, desc = load_xyz_descriptors(p, self.desc_dim)
        elif self.fmt == "usip":
            kp = load_usip_keypoints(p, self.apply_r90)
            if self.desc_root is not None:
                desc = load_descriptors_only(
                    self._path(self.desc_root, frame), self.desc_dim
                )
                if len(desc) != len(kp):
                    raise ValueError(
                        f"frame {frame}: {len(kp)} keypoints vs "
                        f"{len(desc)} descriptors"
                    )
            else:
                desc = None
        else:
            raise ValueError(self.fmt)
        if self.apply_r90 and self.fmt != "usip":
            kp = (R90 @ kp.T).T.astype(np.float32)
        return kp.astype(np.float32), (
            None if desc is None else desc.astype(np.float32)
        )

    def features(self, frame: int):
        """Padded ``FrameFeatures`` of numpy arrays for the matching /
        evaluation stack.

        Descriptor-less formats return the bare pair ``(key_pts, mask)``:
        describe them with ``frontend.ablation.features_from_keypoints``
        (evaluation-matrix rows 'X keypts + CAE-LO desc')."""
        from ..frontend.registration import FrameFeatures

        kp, desc = self.load(frame)
        K = self.n_slots
        n = min(len(kp), K)
        kp_p = np.zeros((K, 3), np.float32)
        kp_p[:n] = kp[:n]
        mask = np.zeros((K,), bool)
        mask[:n] = True
        if desc is None:
            return kp_p, mask
        d_p = np.zeros((K, desc.shape[1]), np.float32)
        d_p[:n] = desc[:n]
        return FrameFeatures(
            key_pts=kp_p, descriptors=d_p, mask=mask,
            key_pixels=np.zeros((K, 2), np.int32),
        )
