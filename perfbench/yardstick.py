"""The benchmark's fixed arithmetic: the card's peaks, the FLOPs a window
needs by the configuration's shapes, and the bytes and operations each
hand-written kernel must move and do.

Counted the same whatever implements the work, so a later change that
moves a convolution or a matmul into its own kernel does not change the
count.
"""
from __future__ import annotations

import torch

# NVIDIA's data sheet for the H100 SXM at 700 W, dense: float32 outside the
# tensor cores (the program turns TF32 off), HBM3 bytes per second
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peak(device_name: str) -> dict:
    """The card's peaks; an unknown card stops the run rather than assume
    an H100's."""
    if device_name not in PEAKS:
        raise SystemExit(f"perfbench: no peaks for {device_name!r}")
    return PEAKS[device_name]


def frame_flops(cfg: dict) -> dict:
    """FLOPs of one frame's front end by part: the respond net's 3x3 and
    1x1 convolutions over the network's input window, and the patch
    encoder's three 3x3x3 convolutions and two dense layers on three
    scales of ``n_keypoints`` patches (a multiply-add is two)."""
    s = cfg["sensor"]
    H = s["n_lines"]
    W = int(round(360.0 / s["azimuth_res_deg"])) - s["crop_width"]
    K = cfg["keypoint"]["n_keypoints"]
    P = cfg["voxel"]["patch_size"]
    code = cfg["descriptor_dim"] // 3
    conv = lambda n_out, c_in, c_out, taps: 2 * n_out * c_in * c_out * taps
    respond = conv(H * W, 3, 32, 9) + conv(H * W, 32, 8, 1)
    enc_conv = (conv(P ** 3, 1, 8, 27) + conv((P // 2) ** 3, 8, 16, 27)
                + conv((P // 4) ** 3, 16, 32, 27))
    enc_dense = 2 * (32 * (P // 4) ** 3 * 200 + 200 * code)
    return {"respond": respond, "encoder_conv": 3 * K * enc_conv,
            "encoder_dense": 3 * K * enc_dense}


def pair_flops(cfg: dict) -> dict:
    """FLOPs of one pair's registration by part: the (K, D) x (D, K)
    descriptor-distance product of matching, and RANSAC's scoring of every
    hypothesis on every pair (per pair and hypothesis: 9 multiplies and 9
    adds for R p + t, 3 differences, 3 squares and 3 sums)."""
    K = cfg["keypoint"]["n_keypoints"]
    H = cfg["ransac"]["n_hypotheses"]
    return {"matching": 2 * K * K * cfg["descriptor_dim"],
            "ransac_scoring": 27 * H * K}


def k1_bytes(planes_shape) -> int:
    """Bytes K1 (the saliency and gate kernel) must move on planes ``(C,
    H, W)`` or ``(B, C, H, W)``, each once: the float32 planes; per pixel
    the int32 occupancy counter and the float32 z and range read, the
    float32 score and saliency written."""
    C, H, W = planes_shape[-3:]
    n_pix = H * W * (planes_shape[0] if len(planes_shape) == 4 else 1)
    return n_pix * C * 4 + n_pix * (4 + 8 + 8)


def k1_ops(counter: torch.Tensor, planes_shape, radius: int = 2) -> int:
    """float32 operations K1 must do: per occupied neighbour in the
    ``(2r+1)^2`` window (centre left out) 8 differences, 8 squares, 8 sums
    and a min, per occupied window pixel (centre in) a z min and a max, and
    ~12 per pixel for the square root and gates."""
    H, W = planes_shape[-2:]
    occ = (counter[..., :H, :W] > 0).to(torch.float32)
    occ = occ.reshape(-1, 1, H, W)
    k = 2 * radius + 1
    box = torch.nn.functional.conv2d(
        occ, torch.ones((1, 1, k, k), device=occ.device), padding=radius)
    n_window = int(box.sum())                      # occupied, centre in
    n_nb = int((box - occ).sum())
    return 25 * n_nb + 2 * n_window + 12 * occ.numel()


def k2_bytes(n_table_rows: int, slot: torch.Tensor, patch: int = 16) -> int:
    """Bytes K2 (the bit-table plane gather) must move, each once: the
    distinct 16 x 16 int32 table planes its slots name, the int32 slots
    and offsets, and the float32 patches written."""
    K = slot.shape[0]
    rows = torch.unique(slot.clamp(0, n_table_rows - 1)).numel()
    return rows * patch * patch * 4 + K * (8 + 3) * 4 + K * patch ** 3 * 4


def k2_ops(slot: torch.Tensor, patch: int = 16) -> int:
    """Operations K2 must do: ~3 integer operations a patch value (shift,
    and, convert), counted at the float32 rate."""
    return 3 * slot.shape[0] * patch ** 3
