"""Fixed-shape masking primitives (port of ``caelo_tpu/ops/masking.py``).

Ragged data stays a fixed-size buffer plus a validity mask, as in the JAX
package: it keeps every shape static and the device free of host syncs.
"""
from __future__ import annotations

import numpy as np
import torch


def pad_points(pts: np.ndarray, size: int, fill: float = 0.0):
    """Host-side: pad/truncate an ``(N, C)`` array to ``(size, C)`` and return
    the validity mask.  Used at the data-loading boundary only."""
    n = min(pts.shape[0], size)
    out = np.full((size, pts.shape[1]), fill, dtype=np.float32)
    out[:n] = pts[:n]
    mask = np.zeros((size,), dtype=bool)
    mask[:n] = True
    return out, mask


def compact(data: torch.Tensor, mask: torch.Tensor, size: int, fill=0):
    """Stable-compact masked rows to the front of a fixed-size buffer.

    The replacement for ``data[mask][:size]`` that needs no host sync: each
    valid row's output rank is a cumulative sum; rows beyond ``size`` and
    invalid rows go to a trash row that is cut off.

    Returns ``(out, out_mask, count)`` where ``count`` is the number of
    valid inputs (possibly > ``size``).
    """
    ranks = torch.cumsum(mask.to(torch.int32), 0) - 1
    dest = torch.where(mask & (ranks < size), ranks, size).long()
    out = torch.full((size + 1,) + data.shape[1:], fill, dtype=data.dtype,
                     device=data.device)
    out[dest] = data
    out_mask = torch.zeros(size + 1, dtype=torch.bool, device=data.device)
    out_mask[dest] = mask
    return out[:size], out_mask[:size], mask.sum(dtype=torch.int32)


def dedup_int_rows(rows: torch.Tensor, mask: torch.Tensor, size: int,
                   n_keys: int | None = None):
    """Deduplicate integer rows (e.g. voxel coordinates) into a fixed-size
    buffer.

    Rows are sorted lexicographically by their first ``n_keys`` columns
    (default: all), stably, as ``lax.sort(num_keys=...)`` sorts them:
    one stable sort per key column, last key first.  Invalid rows become
    INT32_MAX in every column and sort to the end.  A row is kept where it
    differs from its predecessor in any column.

    Args:
      rows: ``(N, K)`` int32, nonnegative entries for valid rows.
      mask: ``(N,)`` bool validity.
      size: output capacity.

    Returns ``(out_rows, out_mask, count)``; ``count`` is the number of
    unique valid rows (it may exceed ``size``: the excess is dropped).
    """
    N, K = rows.shape
    n_keys = K if n_keys is None else n_keys
    big = torch.iinfo(torch.int32).max
    keyed = torch.where(mask[:, None], rows, big)
    order = torch.arange(N, device=rows.device)
    for c in reversed(range(n_keys)):
        order = order[torch.sort(keyed[order, c], stable=True).indices]
    srows = keyed[order]
    first = torch.ones(N, dtype=torch.bool, device=rows.device)
    first[1:] = (srows[1:] != srows[:-1]).any(1)
    return compact(srows, first & (srows[:, 0] < big), size, fill=0)
