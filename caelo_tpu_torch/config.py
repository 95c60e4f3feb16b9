"""The pipeline configuration of the port: frozen dataclasses.

A copy of ``caelo_tpu/config.py`` (every dataclass and
``tiny_test_config``), kept in the port so that the port imports nothing of
the JAX package and an edit there cannot silently change the port.  The
field names and defaults are the JAX package's, with one exception:
``VoxelConfig.use_pallas_plane_gather`` defaults to True here.  The port's
plane-gather kernel (``csrc/plane_gather.cu``) writes the finished patch,
bit-identical to the indexing route and no slower on the card, so the port
takes it on its default path; the JAX package keeps its TPU kernel off by
default.  ``tests/test_torch_imports.py`` holds the two configs equal field
by field apart from that one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Velodyne HDL-64 spherical-ring intrinsics.

    Mirrors the constants of reference ``SphericalRing.py:33-58``: 64 beam
    lines, 0.2 deg azimuth resolution, vertical FOV [-24.8, +2.0] deg, a
    5-row safety margin on top and an 8-column crop on the right.
    """

    n_lines: int = 64
    azimuth_res_deg: float = 0.20
    vertical_view_down_deg: float = -24.8
    vertical_view_up_deg: float = 2.0
    safe_edge_top: int = 5
    crop_width: int = 8            # CropWidth_SphericalRing
    edge_filter: int = 8           # Size4FilterTopEdge
    visible_bottom: float = 10.0   # min keypoint range (m)
    visible_range: float = 100.0
    # Velodyne beam-angle intrinsic fix, applied at scan load when nonzero
    # (reference applies 0.22 deg in its data path: GenerateTrajactory.m:186-190,
    # Transformations.py:28-39).  0.0 = off.
    beam_correction_deg: float = 0.0

    @property
    def azimuth_res(self) -> float:
        return math.radians(self.azimuth_res_deg)

    @property
    def vertical_res(self) -> float:
        return (
            math.radians(self.vertical_view_up_deg)
            - math.radians(self.vertical_view_down_deg)
        ) / (self.n_lines - 1)

    @property
    def vertical_pixel_offset(self) -> float:
        return -math.radians(self.vertical_view_down_deg) / self.vertical_res

    @property
    def img_h(self) -> int:
        # ImgH = nLines + SafeEdgeWidth4Top (SphericalRing.py:56)
        return self.n_lines + self.safe_edge_top

    @property
    def img_w(self) -> int:
        # ImgW = 360deg / azimuth resolution (SphericalRing.py:57)
        return int(round(2.0 * math.pi / self.azimuth_res))

    @property
    def model_h(self) -> int:
        """Height of the image fed to the respond net (rows 0..n_lines)."""
        return self.n_lines

    @property
    def model_w(self) -> int:
        """Width of the image fed to the respond net (cols 0..img_w-crop)."""
        return self.img_w - self.crop_width


@dataclasses.dataclass(frozen=True)
class KeypointConfig:
    """Saliency / NMS parameters (reference ``SphericalRing.py:113-218``)."""

    n_keypoints: int = 1024          # nFixedKeyPts
    window: int = 5                  # 5x5 neighborhood
    min_neighbors: int = 5           # occupied-neighbor gate
    norm_diff_threshold: float = 0.2
    extend_radius: int = 6           # 13x13 window for extended keypoints
    max_extended: int = 32768        # fixed-size buffer for extended keypoints
    # Ground-speckle suppression (see ops/nms.py): candidates below this
    # sensor-frame height are keypoints only if their 5x5 window's vertical
    # extent exceeds ground_extent_m.  The beam rings on near-flat ground
    # are sensor-locked (each frame samples different physical points at
    # the same sensor-relative spot), so salient speckle there biases the
    # consensus translation toward zero.  A surface-normal (|n_z|) gate was
    # measured strictly worse at 520-frame scale (it also removes the
    # rotation-stabilizing horizontal structure above sensor-ground level).
    # <= -100 disables (parity with the reference, which has no such gate).
    ground_z_max: float = -1.2
    ground_extent_m: float = 0.3
    # Use the fused saliency-and-gate kernel K1 (ops/saliency.py,
    # csrc/saliency.cu) on a CUDA device; a CPU tensor takes its plain
    # version either way.  False runs the all-plain PyTorch path.
    use_pallas_nms: bool = True


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    """Three-scale voxel pyramid (reference ``Voxel.py:14-52``).

    Scene bounds +-100 x +-100 x +-15 m, base voxel 0.02 m, scale ratios
    1/8/32, blocks of 64 voxels (1.28 m).  All capacities are padded static
    sizes for TPU-friendly fixed shapes.
    """

    voxel_size: float = 0.02
    scale_ratios: Tuple[int, int, int] = (1, 8, 32)
    patch_size: int = 16
    block_size: int = 64
    visible_length: float = 100.0   # +-x
    visible_width: float = 100.0    # +-y
    visible_height: float = 15.0    # +-z
    # static per-scale capacities for the deduped occupied-voxel lists.
    # Coarse-scale caps are sized ABOVE measured full-res occupancy
    # (~99.6k / ~85k / ~40k at scales 0/1/2 on KITTI-like ~100k-pt scans,
    # occupancy_stats): the previous (131072, 65536, 16384) silently
    # truncated 23% of scale-1 and 59% of scale-2 voxels — and because the
    # list is supercell-SORTED, the drop was systematic (one side of the
    # scene), quietly degrading the coarse descriptor context.
    max_voxels: Tuple[int, int, int] = (131072, 98304, 49152)
    # per-scale neighbor candidates for patch gather (reference used 496-NN,
    # Voxel.py:182; we use an MXU-friendly 512 via approx_max_k)
    patch_knn: int = 512
    # patch gather algorithm: "window" = sorted-supercell range queries
    # (exact box query, ~10x faster on TPU); "knn" = distance matmul +
    # approx_max_k (the direct analog of the reference's 496-NN)
    patch_method: str = "window"
    # per-scale per-supercell candidate caps for the window method; voxels
    # beyond the cap in one 16^3-aligned supercell are dropped.  Sized from
    # measured occupancy on KITTI-like scans (per-supercell max 64/195/439);
    # patch cost is linear in these, so do not oversize.
    supercell_caps: Tuple[int, int, int] = (96, 256, 512)
    # keypoints per lax.map chunk in the window query: bounds the candidate
    # gather temp ((chunk, 8, cap) int32) so a 64-frame window vmap
    # doesn't materialize multi-GB buffers.  0 = one unchunked call.
    patch_query_chunk: int = 128
    # voxelize() returns occupied lists sorted by (supercell id, packed
    # local coords); with this set the patch-gather paths skip their own
    # per-scale sort (one fused sort instead of two).  Only disable when
    # feeding extract_patches a pyramid NOT produced by voxelize.
    presorted_pyramid: bool = True
    # per-scale supercell-slot capacity for the bit-grid patch path
    # (0 = use the windowed-gather path for that scale).  Measured occupied
    # supercells on KITTI-like scans: ~69k / ~2.4k / ~80 at scales 0/1/2
    # (occupancy_stats exports the live numbers per run).  The bit table is
    # slots*256 int32 words (~84 MB/frame at scale 0 — bounded by the
    # 16-frame production window); scale 0 uses a sorted-unique-id binary
    # search for its slot lookup instead of the dense id map (which would
    # be 143 MB/frame there).
    bitgrid_slots: Tuple[int, int, int] = (81920, 6144, 512)
    # The plane-gather kernel K2 (ops/plane_gather.py, csrc/plane_gather.cu):
    # one launch per scale gathers each keypoint's 8 covering word planes and
    # writes its finished 16^3 patch.  On by default in the port (off in the
    # JAX package): the patches are bit-identical to the indexing route.
    use_pallas_plane_gather: bool = True

    @property
    def voxel_sizes(self) -> Tuple[float, float, float]:
        return tuple(self.voxel_size * r for r in self.scale_ratios)

    @property
    def block_real_size(self) -> float:
        return self.voxel_size * self.block_size

    @property
    def n_blocks(self) -> Tuple[int, int, int]:
        return (
            int(2 * self.visible_length / self.block_real_size),
            int(2 * self.visible_width / self.block_real_size),
            int(2 * self.visible_height / self.block_real_size),
        )

    @property
    def grid_shape0(self) -> Tuple[int, int, int]:
        nb = self.n_blocks
        return tuple(n * self.block_size for n in nb)

    def grid_shape(self, scale: int) -> Tuple[int, int, int]:
        g = self.grid_shape0
        r = self.scale_ratios[scale]
        return tuple(s // r for s in g)

    @property
    def patch_radius(self) -> int:
        return self.patch_size // 2

    @property
    def crop_blocks(self) -> int:
        # CropBlocks = ScaleRatios[2]*PatchRadius/BlockSize (Voxel.py:41)
        return int(self.scale_ratios[2] * self.patch_radius / self.block_size)

    @property
    def origin(self) -> Tuple[float, float, float]:
        """World coordinate of voxel (0,0,0) corner."""
        return (-self.visible_length, -self.visible_width, -self.visible_height)


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Batched-RANSAC parameters.

    Semantics follow reference ``Match.py:162-218``: 4-point hypotheses,
    residual threshold 0.4 m escalating x2 up to 1.6, >=max(100, 20%)
    inliers to accept, least-squares refit on the final inlier set.  The
    reference runs 100-500 *sequential* trials; we evaluate a fixed batch of
    hypotheses for every threshold rung in parallel on the MXU.
    """

    n_hypotheses: int = 2048
    sample_size: int = 4
    residual_thresholds: Tuple[float, float, float] = (0.4, 0.8, 1.6)
    min_inlier_abs: int = 100
    min_inlier_frac: float = 0.2
    # Post-refit tightening iterations: re-gate inliers at the smallest
    # rung the refit pose supports and refit again.  Recovers from ladder
    # escalation admitting consistently-displaced matches (moving objects)
    # into the refit; 0 = reference behavior (single refit, Match.py:280-283).
    refit_iters: int = 2
    # Hypotheses are sampled from the best `sample_top_frac` of pairs by
    # descriptor distance (residuals still evaluated on ALL pairs).  The
    # reference samples uniformly from up to 500 sequential trials
    # (Match.py:182-184); batched hypotheses are nearly free on the MXU, so
    # we run 2048 and bias the draw toward confident matches.
    sample_top_frac: float = 0.5


@dataclasses.dataclass(frozen=True)
class IcpConfig:
    """ICP parameters (reference ``MyICP.py:28-201``)."""

    max_iters: int = 30
    inlier_threshold: float = 0.5
    plane_inlier_threshold: float = 2.0
    decay: float = 0.9
    plane_decay: float = 0.5
    small_shift_threshold: float = 0.05
    epsilon: float = 1e-3
    min_inliers: int = 100
    max_points: int = 8192           # fixed-size subsample per cloud
    max_planar: int = 2048           # reference nMaxPts=2000, rounded up
    # Correspondence search is the chunked XLA distance matmul.  A Pallas
    # streaming-argmin kernel was A/B'd fetch-synced on v5e and LOST
    # (1.93 vs 1.81 ms/call, PALLAS_AB.json) — and could not batch under
    # vmap for the Jacobi refine path — so it was deleted (r4).


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Pose-refinement back-end gates (reference ``RefinePoses.py``)."""

    jump_euler_deg: float = 2.0      # de-jump detection (RefinePoses.py:239)
    jump_trans_m: float = 0.5
    accept_euler_deg: float = 10.0   # refinement acceptance (RefinePoses.py:309)
    accept_trans_m: float = 5.0
    # Skip refinement entirely for spans whose odometry pairs were all
    # TRUSTED (successful high-inlier registrations): below the sensor's
    # resampling floor ICP has no unbiased signal — correspondences between
    # sensor-locked resamplings of the same surfaces genuinely align better
    # at a slightly wrong pose, so "corrections" inject compounding
    # rotation error (measured: ATE 0.32 m raw -> 2-11 m refined on the
    # hard benchmark).  Untrusted spans — refinement's real job — keep the
    # reference gates above.  False = reference behavior (refine all).
    skip_trusted_spans: bool = True
    max_transfer_frames: int = 20    # keyframe chain cap (RefinePoses.py:374-400)
    # Residual-gain acceptance for batched refinement corrections: an ICP
    # correction is applied only when it reduces the saturated mean
    # point-to-nearest residual by >= residual_gain_frac of its initial
    # value or >= residual_gain_floor_m absolute.  A genuine rescue (wrong
    # init) gains a lot; on marginal data (degraded frames near the
    # sensor's resampling floor) ICP converges to a sensor-locked biased
    # optimum whose "gain" is noise — accepting those turns refinement
    # into a random walk whose sign flips with the RNG draw (measured:
    # the same degraded benchmark rescued at one window seed and degraded
    # at another).  0 disables.
    residual_gain_frac: float = 0.1
    residual_gain_floor_m: float = 0.02
    # Distribute an accepted multi-frame span correction smoothly over the
    # intermediate frames (``backward_update``) instead of dumping it all on
    # the span endpoint.  The reference implements this but ships it
    # commented out (``BackwardUpdatePoses``, RefinePoses.py:149-229,
    # disabled at :325-327); here it is live by default — endpoint-only
    # updates leave a kink at frame j-1 -> j that the distributed form
    # removes.
    backward_distribute: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    sensor: SensorConfig = SensorConfig()
    keypoint: KeypointConfig = KeypointConfig()
    voxel: VoxelConfig = VoxelConfig()
    ransac: RansacConfig = RansacConfig()
    icp: IcpConfig = IcpConfig()
    refine: RefineConfig = RefineConfig()
    max_points: int = 131072         # padded scan size (KITTI ~120k pts)
    descriptor_dim: int = 60         # 3 scales x 20-dim code
    # Physical-plausibility gate on accepted relative poses: a per-pair
    # motion beyond these bounds is impossible for a road vehicle at scan
    # rate (10 Hz: 40 deg/frame = 400 deg/s, 6 m/frame = 216 km/h), so a
    # "successful" registration violating them is a consensus on aliased
    # structure; it is demoted to a failure (constant-velocity fallback +
    # refinement rescue).  0 disables.
    max_rel_rot_deg: float = 40.0
    max_rel_trans_m: float = 6.0
    # Lowe-style match distinctiveness gate: a frame-1 keypoint's best
    # frame-0 match is kept only if best_dist <= ratio * second_best_dist.
    # 0 disables (reference parity: plain argmin, Match.py:257-263).
    match_ratio: float = 0.0
    # Motion-prior fallback: when a pair fails plain registration, retry with
    # candidate matches gated to this radius (m) around the constant-velocity
    # prediction (GenerateTrajactory.m:210 semantics).  0 disables.
    prior_gate_m: float = 3.0
    # Model compute dtype for inference ("float32" | "bfloat16").  bf16 runs
    # the conv stacks at the MXU's native width; descriptors are cast back to
    # float32 for matching.  Golden bit-compat tests require float32.
    compute_dtype: str = "float32"
    # Patch-encoder activations.  The *shipped* reference artifact uses tanh
    # everywhere (TrainedModels/EncoderModel4VoxelPatch.h5 — authoritative,
    # SURVEY.md section 2.1), but the reference training recipe
    # (AE4VoxelPatch.py:184-213) produces relu convs + a linear code, so
    # from-scratch-trained checkpoints need these knobs to run inference.
    encoder_activation: str = "tanh"
    encoder_code_activation: str = "tanh"
    # Patch-encoder batch chunk: the merged 3-scale encoder call runs as a
    # lax.map over chunks of this many patches so the conv activations stay
    # bounded when the per-frame program is vmapped over a large window
    # (64 frames x 3072 patches x 16^3 x 8ch f32 = 25.7 GB unchunked — OOMs
    # a 16 GB v5e).  0 = single unchunked call.
    encoder_chunk: int = 1024


def tiny_test_config() -> PipelineConfig:
    """Minimal shapes for compile-speed-bound checks (multichip dry runs).

    A coarse 16-line sensor and tiny capacities: the graph structure is
    identical to production, only the static shapes shrink.
    """
    return PipelineConfig(
        sensor=SensorConfig(
            n_lines=16, azimuth_res_deg=1.0, safe_edge_top=2,
            crop_width=4, edge_filter=2, visible_bottom=5.0,
        ),
        keypoint=KeypointConfig(n_keypoints=128, max_extended=2048),
        voxel=VoxelConfig(max_voxels=(4096, 2048, 512), patch_knn=64),
        ransac=RansacConfig(n_hypotheses=64, min_inlier_abs=20),
        icp=IcpConfig(max_points=512, max_planar=128, max_iters=5),
        max_points=4096,
    )
