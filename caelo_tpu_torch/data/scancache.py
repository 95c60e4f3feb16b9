"""Disk-backed scan sequences with O(window) host memory (the port's copy
of ``caelo_tpu/data/scancache.py``).

A sequence is a pair of plain ``.npy`` stacks read frame by frame with
positional file reads: unlike an ``np.load(mmap_mode=...)`` view held for
the whole run, a seek and read never maps the file into the process, so
resident memory stays at the working set (one window of frames) instead of
growing to the whole sequence as pages are touched.  ``run_odometry_windowed``
and ``run_full_pipeline`` index such a reader lazily.

``write_benchmark_cache`` generates the hard-synthetic benchmark in chunks
straight into preallocated ``.npy`` files (``np.lib.format.open_memmap``),
so generation RAM is O(chunk) too.
"""
from __future__ import annotations

import os

import numpy as np

from .hard_synthetic import generate_benchmark


class NpyScanReader:
    """Sequence view over cached ``<base>.pts.npy`` / ``<base>.msk.npy``
    stacks; ``reader[i] -> (pts (P, 4) f32, mask (P,) bool)`` via positional
    reads (no persistent mapping)."""

    def __init__(self, base: str):
        self.p_path = base + ".pts.npy"
        self.m_path = base + ".msk.npy"
        self.p_shape, self.p_dtype, self.p_off = self._header(self.p_path)
        self.m_shape, self.m_dtype, self.m_off = self._header(self.m_path)
        if self.p_shape[0] != self.m_shape[0]:
            raise ValueError(f"{base}: {self.p_shape[0]} point frames but "
                             f"{self.m_shape[0]} mask frames")
        self.p_frame = int(np.prod(self.p_shape[1:]))
        self.m_frame = int(np.prod(self.m_shape[1:]))

    @staticmethod
    def _header(path):
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            read_hdr = (np.lib.format.read_array_header_1_0
                        if version == (1, 0)
                        else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_hdr(f)
            if fortran:
                raise ValueError(f"{path}: Fortran-ordered stack")
            return shape, dtype, f.tell()

    def __len__(self):
        return self.p_shape[0]

    def _read(self, path, off, frame_elems, dtype, shape, i):
        with open(path, "rb") as f:
            f.seek(off + i * frame_elems * dtype.itemsize)
            buf = np.fromfile(f, dtype=dtype, count=frame_elems)
        return buf.reshape(shape[1:])

    def __getitem__(self, i):
        if i < 0:
            i += len(self)
        if not (0 <= i < len(self)):
            raise IndexError(i)
        pts = self._read(self.p_path, self.p_off, self.p_frame,
                         self.p_dtype, self.p_shape, i)
        msk = self._read(self.m_path, self.m_off, self.m_frame,
                         self.m_dtype, self.m_shape, i)
        return pts, msk

    def mask(self, i):
        """Mask-only read (the pipeline's sensor-health gate scans every
        frame's mask; reading the 70x-larger point payload for it would
        stream the whole sequence twice)."""
        return self._read(self.m_path, self.m_off, self.m_frame,
                          self.m_dtype, self.m_shape, i)

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def write_benchmark_cache(base: str, n_frames: int, cfg, seed: int = 0,
                          lap_frames: int | None = None,
                          degraded_spans=None, chunk: int = 256,
                          progress=None) -> np.ndarray:
    """Generate the hard-synthetic benchmark into ``<base>.pts.npy`` /
    ``<base>.msk.npy`` / ``<base>.gt.npy`` in ``chunk``-frame pieces
    (bit-identical to one full ``generate_benchmark`` call: the per-frame
    RNG is seeded per frame).  Returns ``poses_gt``."""
    d = os.path.dirname(os.path.abspath(base))
    os.makedirs(d, exist_ok=True)
    created = False
    poses_gt = None
    for a in range(0, n_frames, chunk):
        b = min(a + chunk, n_frames)
        scans, poses_gt = generate_benchmark(
            n_frames=n_frames, seed=seed, cfg=cfg, lap_frames=lap_frames,
            degraded_spans=degraded_spans, frame_range=(a, b))
        if not created:
            p0, m0 = scans[0]
            for suffix, arr in ((".pts.npy", p0), (".msk.npy", m0)):
                mm = np.lib.format.open_memmap(
                    base + suffix, mode="w+", dtype=arr.dtype,
                    shape=(n_frames,) + arr.shape)
                del mm
            created = True
        # re-open r+ per chunk and drop the mapping after: a long-lived w+
        # map accumulates every written (dirty) page in RSS
        pts_mm = np.lib.format.open_memmap(base + ".pts.npy", mode="r+")
        msk_mm = np.lib.format.open_memmap(base + ".msk.npy", mode="r+")
        for k, (p, m) in enumerate(scans):
            pts_mm[a + k] = p
            msk_mm[a + k] = m
        pts_mm.flush()
        msk_mm.flush()
        del pts_mm, msk_mm
        if progress is not None:
            progress(b)
    np.save(base + ".gt.npy", poses_gt)
    return poses_gt
