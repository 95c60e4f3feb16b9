// K1: keypoint saliency and gates in one pass, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel caelo_tpu/ops/pallas_nms.py::saliency_map_pallas
// (body _nms_kernel), dispatched by caelo_tpu/ops/nms.py::select_keypoints,
// and takes into the same pass everything select_keypoints does after it
// and before the top-k (the XLA code of caelo_tpu/ops/nms.py:77-132).
//
// For every pixel p of a (H, W) respond image with C = 8 channel planes:
//   occ[p]     = counter[p] > 0 (a bool occupancy in saliency_map mode)
//   min_d2[p]  = min over the 24 non-centre offsets o of the 5x5 window, at
//                occupied neighbours only, of sum_c (r[c, p+o] - r[c, p])^2
//                (+inf when none; outside the image counts as unoccupied)
//   n_occ[p]   = number of occupied neighbours, excluding p itself
//   saliency   = sqrt(min_d2 finite ? min_d2 : 0)
//   zext[p]    = max - min of z over the occupied pixels of the 5x5 window,
//                centre included (0 when none)
//   good[p]    = occ & n_occ >= min_neighbors & saliency > thr
//                & range >= min_range & inside the edge crop & min_d2 finite
//                [& (z >= ground_z_max | zext > ground_extent)]
//   score[p]   = good ? saliency : -inf
// It writes score and saliency; min_d2, n_occ and zext only when their
// pointers are not null.  With a null image it is the TPU kernel's function
// alone (min_d2 and n_occ).
//
// What bounds it on the card: bytes.  Per (8, 64, 1792) frame it reads
// 3.67 MB of planes, 0.46 MB of counter and 0.92 MB of z and range and
// writes 0.92 MB (score, saliency), ~6 MB or ~1.8 us at 3.35 TB/s, against
// ~66 Mflop of float32 arithmetic (~1 us at 67 TFLOP/s).
//
// Design: one thread per output pixel; a block owns a 64 x 8 tile and stages
// the tile plus its 2-pixel halo of all 8 planes in shared memory (12 rows
// of 72 floats per plane, 27 KB), the interior and halo alike as 16-byte
// cp.async copies whose out-of-image source size 0 gives the zero padding;
// the staged columns start 4 left of the tile so every copy stays 16-byte
// aligned.  Occupancy and z of the halo go to shared memory beside them.  The
// 24 offsets then read shared memory only, with the centre's 8 values in
// registers, and the gates run on values already in registers, so nothing
// between the respond conv and the top-k touches device memory but this
// kernel's reads and its two output maps.  The planes are read as the
// respond conv writes them (NCHW) and z and range straight out of the
// (ImgH, ImgW, 5) ring image.  A leading frame axis rides gridDim.z.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kC = 8;
constexpr int kRadius = 2;
constexpr int kTileW = 64;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kLead = 4;                         // staged columns left of the tile
constexpr int kSmemW = kTileW + 2 * kLead;       // 72: 18 vectors of 4 floats
constexpr int kSmemH = kTileH + 2 * kRadius;     // 12
constexpr int kVecs = kSmemW / 4;

struct Args {
  const float* planes;       // (B, C, H, W)
  const void* occ;           // counter (int32) or occupancy (uint8)
  long long occ_fs;          // frame stride, elements
  int occ_rs;                // row stride, elements
  const float* img_z;        // z channel of the ring image, or null
  const float* img_r;        // range channel
  long long img_fs;          // frame / row / pixel strides of the image
  int img_rs, img_ps;
  float* score;              // (B, H, W) outputs; null where not asked
  float* saliency;
  float* min_d2;
  int32_t* n_occ;
  float* zext;
  int H, W;
  int row_lo, row_hi, col_lo, col_hi;   // edge crop, half-open
  int min_neighbors;
  float sal_thr, min_range, ground_z_max, ground_extent;
  int ground_gate;
  int vec_ok;                // W % 4 == 0 and planes 16-byte aligned
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <typename OccT>
__global__ void __launch_bounds__(kThreads)
keypoint_score_kernel(const Args a) {
  __shared__ __align__(16) float s_resp[kC][kSmemH][kSmemW];
  __shared__ float s_z[kSmemH][kSmemW];
  __shared__ uint8_t s_occ[kSmemH][kSmemW];

  const int f = blockIdx.z;
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  const float* r = a.planes + f * kC * plane;
  const OccT* o = static_cast<const OccT*>(a.occ) + f * a.occ_fs;
  const int xs = blockIdx.x * kTileW - kLead;    // image column of staged col 0
  const int ys = blockIdx.y * kTileH - kRadius;  // image row of staged row 0
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const bool gate = a.img_z != nullptr;

  // planes: 8 x 12 x 18 vectors of 4 floats
  for (int i = tid; i < kC * kSmemH * kVecs; i += kThreads) {
    const int c = i / (kSmemH * kVecs);
    const int sy = (i / kVecs) % kSmemH;
    const int v = i % kVecs;
    const int y = ys + sy, x = xs + 4 * v;
    float* dst = &s_resp[c][sy][4 * v];
    const bool row_in = y >= 0 && y < a.H;
    if (a.vec_ok) {
      const bool in = row_in && x >= 0 && x < a.W;   // W % 4 == 0: whole vector
      const float* src = in ? r + c * plane + static_cast<size_t>(y) * a.W + x : r;
      cp_async16(dst, src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = row_in && x + e >= 0 && x + e < a.W;
        dst[e] = in ? r[c * plane + static_cast<size_t>(y) * a.W + x + e] : 0.f;
      }
    }
  }
  // occupancy and (with the gates) z of the staged window
  for (int i = tid; i < kSmemH * kSmemW; i += kThreads) {
    const int sy = i / kSmemW, sx = i % kSmemW;
    const int y = ys + sy, x = xs + sx;
    const bool in = y >= 0 && y < a.H && x >= 0 && x < a.W;
    const bool oc = in && o[static_cast<size_t>(y) * a.occ_rs + x] > OccT(0);
    s_occ[sy][sx] = oc;
    if (gate)
      s_z[sy][sx] = oc ? a.img_z[f * a.img_fs + static_cast<size_t>(y) * a.img_rs
                                 + static_cast<size_t>(x) * a.img_ps]
                       : 0.f;
  }
  if (a.vec_ok) cp_async_wait_all();
  __syncthreads();

  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  if (x >= a.W || y >= a.H) return;
  const int ty = threadIdx.y + kRadius, tx = threadIdx.x + kLead;

  float centre[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) centre[c] = s_resp[c][ty][tx];

  float best = INFINITY, zmin = INFINITY, zmax = -INFINITY;
  int count = 0;
#pragma unroll
  for (int dy = -kRadius; dy <= kRadius; ++dy) {
#pragma unroll
    for (int dx = -kRadius; dx <= kRadius; ++dx) {
      if (!s_occ[ty + dy][tx + dx]) continue;
      const float z = s_z[ty + dy][tx + dx];
      zmin = fminf(zmin, z);
      zmax = fmaxf(zmax, z);
      if (dy == 0 && dx == 0) continue;
      // square, then add in channel order, unfused: the plain version's
      // rounding
      float d2 = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float d = s_resp[c][ty + dy][tx + dx] - centre[c];
        d2 = __fadd_rn(d2, __fmul_rn(d, d));
      }
      best = fminf(best, d2);
      ++count;
    }
  }

  const size_t out = f * plane + static_cast<size_t>(y) * a.W + x;
  if (a.min_d2) a.min_d2[out] = best;
  if (a.n_occ) a.n_occ[out] = count;
  if (!gate) return;
  const float ext = zmin <= zmax ? zmax - zmin : 0.f;
  if (a.zext) a.zext[out] = ext;
  const bool finite = best < INFINITY;
  const float sal = sqrtf(finite ? best : 0.f);
  const float rng = a.img_r[f * a.img_fs + static_cast<size_t>(y) * a.img_rs
                            + static_cast<size_t>(x) * a.img_ps];
  bool good = s_occ[ty][tx] && count >= a.min_neighbors && sal > a.sal_thr
              && rng >= a.min_range && y >= a.row_lo && y < a.row_hi
              && x >= a.col_lo && x < a.col_hi && finite;
  if (a.ground_gate)
    good = good && (!(s_z[ty][tx] < a.ground_z_max) || ext > a.ground_extent);
  a.score[out] = good ? sal : -INFINITY;
  a.saliency[out] = sal;
}

}  // namespace

// planes (B, 8, H, W) f32 contiguous; occ (B, ...) uint8/bool occupancy
// (occ_is_counter 0) or int32 counter (1) with the given frame and row
// strides; img_z / img_r point at the z and range channels of the
// (B, ImgH, ImgW, 5) ring image (null: K1's own function only).  Outputs
// (B, H, W); null where not asked.  Returns cudaGetLastError().
extern "C" int caelo_keypoint_score(
    const void* planes, const void* occ, int occ_is_counter, long long occ_fs,
    int occ_rs, const void* img_z, const void* img_r, long long img_fs,
    int img_rs, int img_ps, void* score, void* saliency, void* min_d2,
    void* n_occ, void* zext, int B, int C, int H, int W, int row_lo,
    int row_hi, int col_lo, int col_hi, int min_neighbors, float sal_thr,
    float min_range, int ground_gate, float ground_z_max, float ground_extent,
    void* stream) {
  if (C != kC) return static_cast<int>(cudaErrorInvalidValue);
  if (img_z != nullptr && (score == nullptr || saliency == nullptr || img_r == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return static_cast<int>(cudaGetLastError());
  Args a;
  a.planes = static_cast<const float*>(planes);
  a.occ = occ;
  a.occ_fs = occ_fs;
  a.occ_rs = occ_rs;
  a.img_z = static_cast<const float*>(img_z);
  a.img_r = static_cast<const float*>(img_r);
  a.img_fs = img_fs;
  a.img_rs = img_rs;
  a.img_ps = img_ps;
  a.score = static_cast<float*>(score);
  a.saliency = static_cast<float*>(saliency);
  a.min_d2 = static_cast<float*>(min_d2);
  a.n_occ = static_cast<int32_t*>(n_occ);
  a.zext = static_cast<float*>(zext);
  a.H = H;
  a.W = W;
  a.row_lo = row_lo;
  a.row_hi = row_hi;
  a.col_lo = col_lo;
  a.col_hi = col_hi;
  a.min_neighbors = min_neighbors;
  a.sal_thr = sal_thr;
  a.min_range = min_range;
  a.ground_z_max = ground_z_max;
  a.ground_extent = ground_extent;
  a.ground_gate = ground_gate;
  a.vec_ok = W % 4 == 0 && reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (occ_is_counter)
    keypoint_score_kernel<int32_t><<<grid, block, 0, s>>>(a);
  else
    keypoint_score_kernel<uint8_t><<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* caelo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
