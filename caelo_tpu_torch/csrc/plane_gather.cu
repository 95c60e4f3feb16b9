// K2: bit-table plane gather for the patch query, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel caelo_tpu/ops/pallas_patches.py::gather_planes_pallas
// (body _gather_kernel), dispatched by
// caelo_tpu/voxel/grid.py::_patches_one_scale_bitgrid at all three scales.
//
//   out[k, i, j, l] = table2[slot[k, i, j, l]]      (one 16 x 16 int32 plane)
//
// table2 is (S + 1, 16, 16) int32 whose last row is the zero plane; slot is
// (K, 2, 2, 2) int32.  A slot outside [0, S] is clamped into it, as JAX's
// gather clamps, so no read leaves the table.
//
// What bounds it on the card: bytes, and the number of independent
// transactions.  At scale 0 a frame copies 1024 x 8 planes of 1 KB (8 MB in,
// 8 MB out) out of an 84 MB table; nothing is computed.
//
// Design: one block per (keypoint, covering cell) row; its 64 threads each
// move one 16-byte int4, so every plane is one fully coalesced 1 KB read and
// one 1 KB write.  The TPU version's 8-slot group DMA with a masked-sum row
// select, and its K % 16 restriction, existed only for Mosaic's (8, 128) HBM
// tiling and are dropped: a Hopper block can address any 16-byte-aligned row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_planes_kernel(const int4* __restrict__ table,
                                     const int32_t* __restrict__ slot,
                                     int4* __restrict__ out, int max_slot,
                                     int vecs_per_plane) {
  const int row = blockIdx.x;
  const int s = min(max(__ldg(slot + row), 0), max_slot);
  const int4* src = table + static_cast<size_t>(s) * vecs_per_plane;
  int4* dst = out + static_cast<size_t>(row) * vecs_per_plane;
  for (int i = threadIdx.x; i < vecs_per_plane; i += blockDim.x) dst[i] = __ldg(src + i);
}

}  // namespace

// table (max_slot + 1, words_per_plane) int32, 16-byte aligned; slot
// (n_rows,) int32 -> out (n_rows, words_per_plane) int32.  words_per_plane
// must be a multiple of 4 (the wrapper checks).  Returns cudaGetLastError().
extern "C" int caelo_gather_planes(const void* table, const void* slot, void* out,
                                   int n_rows, int max_slot, int words_per_plane,
                                   void* stream) {
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  const int vecs = words_per_plane / 4;
  const int threads = vecs < 64 ? vecs : 64;
  gather_planes_kernel<<<n_rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), static_cast<const int32_t*>(slot),
      static_cast<int4*>(out), max_slot, vecs);
  return static_cast<int>(cudaGetLastError());
}
