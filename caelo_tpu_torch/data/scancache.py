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
so generation RAM is O(chunk) too.  ``write_benchmark_cache_parallel``
writes the same files, byte for byte, from several processes: the
sequence-scale cache (4,541 frames, ~9.5 GB) at 0.35-0.78 s a frame would
take most of an hour on one core.
"""
from __future__ import annotations

import math
import os
import shutil

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


PARALLEL_CHUNK = 32     # frames a writer process ray-casts before it exits


def default_writer_procs() -> int:
    """One fewer than the cores this process may run on."""
    return max(1, len(os.sched_getaffinity(0)) - 1)


def _new_stack(path, n_frames, frame0):
    """An ``.npy`` stack of ``n_frames`` frames shaped like ``frame0``, with
    ``frame0`` first and zeros after (``open_memmap(mode="w+")``'s header,
    without mapping the file); returns the offset of its data."""
    header = {"descr": np.lib.format.dtype_to_descr(frame0.dtype),
              "fortran_order": False, "shape": (n_frames,) + frame0.shape}
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        off = f.tell()
        f.write(np.ascontiguousarray(frame0).tobytes())
        f.truncate(off + n_frames * frame0.nbytes)
    return off


def _write_chunk(stacks, a, b, n_frames, cfg, seed, lap_frames):
    """Ray-cast frames ``[a, b)`` and write them in place into ``stacks``,
    ``(path, data offset)`` pairs, with positional writes."""
    scans, _ = generate_benchmark(n_frames=n_frames, seed=seed, cfg=cfg,
                                  lap_frames=lap_frames, frame_range=(a, b))
    for (path, off), frames in zip(stacks, zip(*scans)):
        block = np.ascontiguousarray(np.stack(frames))
        with open(path, "r+b") as f:
            f.seek(off + a * block[0].nbytes)
            f.write(block.tobytes())
    return b - a


def write_benchmark_cache_parallel(base: str, n_frames: int, cfg,
                                   seed: int = 0,
                                   lap_frames: int | None = None,
                                   procs: int | None = None,
                                   progress=None) -> np.ndarray:
    """``write_benchmark_cache(base, n_frames, cfg, seed, lap_frames)``'s
    three files, byte for byte, ray-cast by ``procs`` spawned processes
    (default ``default_writer_procs()``); ``progress(frames written)``
    after each chunk.  Returns ``poses_gt``.

    Frame 0 is cast here (its shapes and dtypes make the stacks); the rest
    goes out in chunks of at most ``PARALLEL_CHUNK`` frames, each to a
    process of its own that writes it with positional writes and exits.
    Short-lived processes are deliberate: on an H100 host whose root
    filesystem is 9p, runs whose ray-cast processes each lived through 64
    frames or more lost the machine to memory 200-500 s in, while
    processes on 32-frame chunks wrote the whole 4,541-frame cache twice.
    The cause was not found.  The files are written under ``<base>.part``
    names and renamed at the end, the point stack last, so an interrupted
    run leaves no ``.pts.npy`` that passes for a whole cache.  Fails before
    writing if the disk lacks the room."""
    from concurrent.futures import ProcessPoolExecutor, as_completed
    from multiprocessing import get_context

    if procs is None:
        procs = default_writer_procs()
    suffixes = (".pts.npy", ".msk.npy", ".gt.npy")
    final = [base + s for s in suffixes]
    tmp = [base + ".part" + s for s in suffixes]
    d = os.path.dirname(os.path.abspath(base))
    os.makedirs(d, exist_ok=True)
    scans, poses_gt = generate_benchmark(
        n_frames=n_frames, seed=seed, cfg=cfg, lap_frames=lap_frames,
        frame_range=(0, 1))
    (p0, m0), = scans
    need = n_frames * (p0.nbytes + m0.nbytes) + poses_gt.nbytes
    free = shutil.disk_usage(d).free
    if free < need:
        raise OSError(f"{d}: {free / 1e9:.1f} GB free, the cache needs "
                      f"{need / 1e9:.1f} GB")
    stacks = [(path, _new_stack(path, n_frames, arr))
              for path, arr in zip(tmp, (p0, m0))]
    chunk = max(1, min(PARALLEL_CHUNK, math.ceil((n_frames - 1) / procs)))
    with ProcessPoolExecutor(procs, mp_context=get_context("spawn"),
                             max_tasks_per_child=1) as pool:
        futures = [pool.submit(_write_chunk, stacks, a,
                               min(a + chunk, n_frames), n_frames, cfg,
                               seed, lap_frames)
                   for a in range(1, n_frames, chunk)]
        done = 1
        for f in as_completed(futures):
            done += f.result()
            if progress is not None:
                progress(done)
    if done != n_frames:
        raise AssertionError(f"wrote {done} of {n_frames} frames")
    np.save(tmp[2], poses_gt)
    for t, f in reversed(list(zip(tmp, final))):
        os.replace(t, f)
    return poses_gt
