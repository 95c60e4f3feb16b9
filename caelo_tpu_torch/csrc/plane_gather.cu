// K2: bit-table plane gather that writes the finished occupancy patch,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel caelo_tpu/ops/pallas_patches.py::gather_planes_pallas
// (body _gather_kernel), dispatched by
// caelo_tpu/voxel/grid.py::_patches_one_scale_bitgrid at all three scales,
// and takes into the same pass what that function computes after the
// gather (the z-combine of the two z-adjacent planes, the x and y window
// alignment and the bit unpack, caelo_tpu/voxel/grid.py:512-530).
//
// table2 is (S + 1, 16, 16) int32 words of 16 z-bits per (supercell, x, y)
// column, its last row the zero plane; slot is (K, 2, 2, 2) int32, the
// table rows of each keypoint's 2x2x2 covering supercells; off is (K, 3)
// int32, the patch window's offset o in its first supercell.  For the patch
// column (a, b), X = o.x + a and Y = o.y + b pick the supercell
// (X / 16, Y / 16) and its column (X % 16, Y % 16); the 16-bit z-window is
// (wA >> o.z | wB << (16 - o.z)) & 0xFFFF of the two z-adjacent planes, and
//   patch[k, a, b, c] = (window >> c) & 1     (K, 16, 16, 16) float32.
// A slot outside [0, S] is clamped into it, as JAX's gather clamps, so no
// read leaves the table.
//
// What bounds it on the card: bytes.  At K = 1024 a scale reads 8 planes of
// 1 KB per keypoint (8.4 MB, fewer where keypoints share supercells) and
// writes 16 KB of patch per keypoint (16.8 MB): ~7.5 us at 3.35 TB/s.  The
// indexing route moved the (K, 2, 2, 2, 16, 16) int32 planes and ~15
// int32 temporaries of the same size through device memory before it wrote
// the patch.
//
// Design: one 256-thread block per keypoint.  The block stages its 8
// covering planes (8 KB) in shared memory as coalesced 16-byte cp.async
// copies (each plane one contiguous 1 KB row), then every thread writes
// four 16-byte float4 stores of the patch, consecutive threads on
// consecutive addresses, each built from one column's z-window read out of
// shared memory.  The TPU version's 8-slot group DMA with a masked-sum row
// select, and its K % 16 restriction, existed only for Mosaic's (8, 128)
// HBM tiling and are gone.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 16;                 // patch side: 16 z-bits per word
constexpr int kWords = kP * kP;        // words per plane
constexpr int kPlanes = 8;             // covering supercells per keypoint
constexpr int kThreads = 256;
constexpr int kOutVecs = kP * kP * kP / 4;   // float4 per patch

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
patches_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ slot,
               const int32_t* __restrict__ off, float4* __restrict__ out,
               int max_slot) {
  __shared__ __align__(16) uint32_t s_plane[kPlanes][kWords];
  const int k = blockIdx.x;
  const int t = threadIdx.x;

  for (int i = t; i < kPlanes * kWords / 4; i += kThreads) {
    const int p = i / (kWords / 4), v = i % (kWords / 4);
    const int s = min(max(__ldg(slot + kPlanes * k + p), 0), max_slot);
    cp_async16(&s_plane[p][4 * v], table + static_cast<size_t>(s) * kWords + 4 * v);
  }
  // masked into [0, 15] so that no read leaves the block's 8 planes
  const int ox = __ldg(off + 3 * k) & (kP - 1);
  const int oy = __ldg(off + 3 * k + 1) & (kP - 1);
  const int oz = __ldg(off + 3 * k + 2) & (kP - 1);
  cp_async_wait_all();
  __syncthreads();

  float4* dst = out + static_cast<size_t>(k) * kOutVecs;
#pragma unroll
  for (int q = 0; q < kOutVecs / kThreads; ++q) {
    const int f = q * kThreads + t;    // float4 index: column f / 4, quarter f % 4
    const int col = f >> 2, c0 = (f & 3) * 4;
    const int X = ox + (col >> 4), Y = oy + (col & (kP - 1));
    // slot order (i, j, l): plane i * 4 + j * 2 + l
    const int p = (X >> 4) * 4 + (Y >> 4) * 2;
    const int w = (X & (kP - 1)) * kP + (Y & (kP - 1));
    const uint32_t wA = s_plane[p][w], wB = s_plane[p + 1][w];
    const uint32_t win = ((wA >> oz) | (oz > 0 ? wB << (kP - oz) : 0u)) & 0xFFFFu;
    dst[f] = make_float4(static_cast<float>((win >> c0) & 1u),
                         static_cast<float>((win >> (c0 + 1)) & 1u),
                         static_cast<float>((win >> (c0 + 2)) & 1u),
                         static_cast<float>((win >> (c0 + 3)) & 1u));
  }
}

}  // namespace

// table (max_slot + 1, 16, 16) int32, 16-byte aligned; slot (K, 2, 2, 2)
// int32; off (K, 3) int32 with every entry in [0, 15] -> out (K, 16, 16, 16)
// float32.  Returns cudaGetLastError().
extern "C" int caelo_patches_from_planes(const void* table, const void* slot,
                                         const void* off, void* out, int K,
                                         int max_slot, void* stream) {
  if (K == 0) return static_cast<int>(cudaGetLastError());
  patches_kernel<<<K, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(slot),
      static_cast<const int32_t*>(off), static_cast<float4*>(out), max_slot);
  return static_cast<int>(cudaGetLastError());
}
