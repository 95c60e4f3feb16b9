// K1: keypoint-saliency stencil (min squared respond difference to the
// occupied 5x5 neighbours), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel caelo_tpu/ops/pallas_nms.py::saliency_map_pallas
// (body _nms_kernel), dispatched by caelo_tpu/ops/nms.py::select_keypoints.
//
// For every pixel p of a (H, W) respond image with C channel planes:
//   min_d2[p] = min over the 24 non-centre offsets o of the 5x5 window, at
//               occupied neighbours only, of sum_c (r[c, p+o] - r[c, p])^2
//               (+inf when no neighbour is occupied; outside the image
//               counts as unoccupied)
//   n_occ[p]  = number of occupied neighbours, excluding p itself.
//
// What bounds it on the card: bytes.  Per frame it reads 8 planes of
// 64 x 1792 f32 (3.7 MB) plus the occupancy and writes 0.9 MB, against
// ~24 x 8 x 3 = 576 flops per pixel (66 Mflop/frame) -- far below the
// H100's flop:byte balance, so the design only has to read each input byte
// from device memory about once.
//
// Design: one thread per output pixel; a block owns a 32 x 8 tile and first
// stages the tile plus its 2-pixel halo of all C planes and of the
// occupancy in shared memory (36 x 12 x (8 x 4 + 1) B = 14 KB), zero-filled
// outside the image.  The 24 offsets then read shared memory only, with the
// centre pixel's C values in registers.  Reading NCHW planes means the
// respond conv's output feeds the kernel with no transpose.  A leading frame
// axis rides gridDim.z, so one launch can cover a whole window.  The TPU
// kernel's whole-image VMEM residency becomes the per-block halo tile: blocks
// run in parallel and share nothing.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 2;
constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kSmemW = kTileW + 2 * kRadius;
constexpr int kSmemH = kTileH + 2 * kRadius;

template <int C>
__global__ void __launch_bounds__(kTileW * kTileH)
saliency_kernel(const float* __restrict__ resp, const uint8_t* __restrict__ occ,
                float* __restrict__ min_d2, int32_t* __restrict__ n_occ,
                int H, int W) {
  __shared__ float s_resp[C][kSmemH][kSmemW];
  __shared__ uint8_t s_occ[kSmemH][kSmemW];

  const size_t plane = static_cast<size_t>(H) * W;
  const float* r = resp + blockIdx.z * C * plane;
  const uint8_t* o = occ + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW - kRadius;
  const int y0 = blockIdx.y * kTileH - kRadius;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  for (int i = tid; i < kSmemH * kSmemW; i += kTileW * kTileH) {
    const int sy = i / kSmemW, sx = i % kSmemW;
    const int y = y0 + sy, x = x0 + sx;
    const bool inside = y >= 0 && y < H && x >= 0 && x < W;
    const size_t off = inside ? static_cast<size_t>(y) * W + x : 0;
    s_occ[sy][sx] = inside ? (o[off] != 0) : 0;
#pragma unroll
    for (int c = 0; c < C; ++c) s_resp[c][sy][sx] = inside ? r[c * plane + off] : 0.f;
  }
  __syncthreads();

  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  if (x >= W || y >= H) return;
  const int ty = threadIdx.y + kRadius, tx = threadIdx.x + kRadius;

  float centre[C];
#pragma unroll
  for (int c = 0; c < C; ++c) centre[c] = s_resp[c][ty][tx];

  float best = INFINITY;
  int count = 0;
#pragma unroll
  for (int dy = -kRadius; dy <= kRadius; ++dy) {
#pragma unroll
    for (int dx = -kRadius; dx <= kRadius; ++dx) {
      if (dy == 0 && dx == 0) continue;
      if (!s_occ[ty + dy][tx + dx]) continue;
      float d2 = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float d = s_resp[c][ty + dy][tx + dx] - centre[c];
        d2 += d * d;
      }
      best = fminf(best, d2);
      ++count;
    }
  }
  const size_t out = blockIdx.z * plane + static_cast<size_t>(y) * W + x;
  min_d2[out] = best;
  n_occ[out] = count;
}

}  // namespace

// resp (B, C, H, W) f32, occ (B, H, W) uint8/bool -> min_d2 (B, H, W) f32,
// n_occ (B, H, W) int32.  Only C == 8 (the respond layer's width) is
// instantiated; the wrapper checks.  Returns cudaGetLastError().
extern "C" int caelo_saliency_map(const void* resp, const void* occ, void* min_d2,
                                  void* n_occ, int B, int C, int H, int W,
                                  void* stream) {
  if (C != 8) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTileW, kTileH);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  saliency_kernel<8><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(resp), static_cast<const uint8_t*>(occ),
      static_cast<float*>(min_d2), static_cast<int32_t*>(n_occ), H, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* caelo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
