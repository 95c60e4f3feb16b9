"""The port's two kernels (K1 saliency stencil, K2 plane gather): their plain
PyTorch versions against the Pallas kernels in interpret mode and a numpy
oracle, and the wrappers' CPU dispatch.  The CUDA kernels themselves are
tested on the card by tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from caelo_tpu.ops.pallas_nms import saliency_map_pallas
from caelo_tpu.ops.pallas_patches import gather_planes_pallas
from caelo_tpu_torch.ops.plane_gather import gather_planes, gather_planes_plain
from caelo_tpu_torch.ops.saliency import saliency_map, saliency_map_plain


def _oracle(resp, occ):
    """numpy min-neighbour-diff over the 5x5 window (the oracle of
    tests/test_pallas_kernels.py)."""
    H, W, _ = resp.shape
    rp = np.pad(resp, ((2, 2), (2, 2), (0, 0)))
    op = np.pad(occ, 2)
    md = np.full((H, W), np.inf, np.float32)
    cnt = np.zeros((H, W), np.int32)
    for dy in range(5):
        for dx in range(5):
            if dy == 2 and dx == 2:
                continue
            nb = rp[dy:dy + H, dx:dx + W]
            o = op[dy:dy + H, dx:dx + W]
            md = np.minimum(md, np.where(o, ((nb - resp) ** 2).sum(-1), np.inf))
            cnt += o
    return md, cnt


def _respond(rng, kind, H=16, W=256, C=8):
    if kind == "normal":
        return rng.normal(size=(H, W, C)).astype(np.float32)
    # realistic magnitude: relu'd respond values of ~0-50 (random-weight
    # respond maps of metre-scale xyz input), many exact zeros
    return np.maximum(rng.normal(0, 15, (H, W, C)), 0).astype(np.float32)


def _assert_saliency_close(md, cnt, md_ref, cnt_ref):
    np.testing.assert_array_equal(cnt, cnt_ref)
    fin = np.isfinite(md_ref)
    np.testing.assert_array_equal(np.isfinite(md), fin)
    np.testing.assert_allclose(md[fin], md_ref[fin], atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("kind", ["normal", "realistic"])
def test_saliency_plain_matches_pallas_and_oracle(rng, kind):
    resp = _respond(rng, kind)
    occ = rng.uniform(size=resp.shape[:2]) < 0.6
    md_p, cnt_p = saliency_map_pallas(jnp.asarray(resp), jnp.asarray(occ),
                                      interpret=True)
    md_o, cnt_o = _oracle(resp, occ)
    md, cnt = saliency_map_plain(
        torch.from_numpy(resp).permute(2, 0, 1), torch.from_numpy(occ))
    md, cnt = md.numpy(), cnt.numpy()
    _assert_saliency_close(md, cnt, np.asarray(md_p), np.asarray(cnt_p))
    _assert_saliency_close(md, cnt, md_o, cnt_o)


def test_saliency_plain_batched_matches_per_frame(rng):
    planes = torch.from_numpy(rng.normal(size=(3, 8, 12, 40)).astype(np.float32))
    occ = torch.from_numpy(rng.uniform(size=(3, 12, 40)) < 0.5)
    md, cnt = saliency_map_plain(planes, occ)
    for b in range(3):
        md_b, cnt_b = saliency_map_plain(planes[b], occ[b])
        assert torch.equal(md[b], md_b) and torch.equal(cnt[b], cnt_b)


def test_saliency_wrapper_takes_plain_on_cpu(rng):
    planes = torch.from_numpy(rng.normal(size=(8, 10, 30)).astype(np.float32))
    occ = torch.from_numpy(rng.uniform(size=(10, 30)) < 0.5)
    before = saliency_map.launches
    md, cnt = saliency_map(planes, occ)
    md_ref, cnt_ref = saliency_map_plain(planes, occ)
    assert torch.equal(md, md_ref) and torch.equal(cnt, cnt_ref)
    assert saliency_map.launches == before      # counts kernel launches only
    with pytest.raises(TypeError):
        saliency_map(planes.double(), occ)
    with pytest.raises(ValueError):
        saliency_map(planes, occ[:, :-1])


def test_plane_gather_plain_matches_pallas(rng):
    S, P, K = 300, 16, 32
    table2 = rng.integers(-2**31, 2**31 - 1, (S + 1, P, P)).astype(np.int32)
    table2[S] = 0                       # zero plane for missing cells
    slot = rng.integers(0, S + 1, (K, 2, 2, 2)).astype(np.int32)
    ref = gather_planes_pallas(jnp.asarray(table2), jnp.asarray(slot),
                               interpret=True)
    out = gather_planes_plain(torch.from_numpy(table2), torch.from_numpy(slot))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), table2[slot])


def test_plane_gather_wrapper_takes_plain_on_cpu(rng):
    S, P = 50, 16
    table2 = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, (S + 1, P, P)).astype(np.int32))
    slot = torch.from_numpy(rng.integers(0, S + 1, (5, 2, 2, 2)).astype(np.int32))
    slot[0, 0, 0, 0] = -4               # out of range: clamped like JAX
    slot[1, 1, 1, 1] = S + 7
    before = gather_planes.launches
    out = gather_planes(table2, slot)
    assert gather_planes.launches == before
    assert torch.equal(out, gather_planes_plain(table2, slot))
    assert torch.equal(out[0, 0, 0, 0], table2[0])
    assert torch.equal(out[1, 1, 1, 1], table2[S])
    with pytest.raises(TypeError):
        gather_planes(table2.long(), slot)
