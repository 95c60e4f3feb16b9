// K4: the k nearest points of every point of a scan, scored and selected in
// one pass, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package's caelo_tpu/frontend/baselines.py
// (_knn_neighbors) scores a chunk of queries against the scan by a matmul and
// selects with lax.approx_max_k inside XLA.  The plain PyTorch version
// (caelo_tpu_torch/frontend/baselines.py::_knn_neighbors_plain) writes a
// (512, N) float32 score matrix per chunk and runs three elementwise
// launches, torch.topk's radix select and two sorts on it: ~10,500 launches
// and ~430 ms a 131,072-point scan.  This kernel writes no score.
//
// Inputs, in the order the wrapper sorted the points (along a Morton curve,
// the masked points last; the result does not depend on it): pp (N, 4)
// float32 rows (x, y, z, -p2m), p2m = |p|^2, or 1e12 for a masked point;
// perm (N,) int32, each row's index in the scan; p2 (N,) float32, |p|^2 in
// the scan's order; start (ceil(N / 128),) int32, the tile each block visits
// first; boxes (ceil(N / 256), 8) float32, each tile's bounding box and
// lift (see beyond).  out (N, k) int64, in the scan's order.
//
// Score: the plain version's float32 formula with its rounding, bit for bit.
// For query i and point j, with q2 = p2[i] (torch's per-chunk sum of the
// query's squares has the same bits) and d the dot product as the card's
// float32 GEMM (TF32 off) sums three terms, from +0,
//   d = fma(qz, pz, fma(qy, py, fma(qx, px, 0))),
//   s = ((2 d) - p2m[j]) - q2,
// each step rounded once: 2 d is exact, so fma(2, d, -p2m[j]) is the plain
// version's 2 d - p2m[j].  Every operation is an explicit __fmaf_rn /
// __fsub_rn, so nvcc contracts nothing (no fast math; _build.py).  A score
// is never -0 (d starts from +0 and x - x is +0), so the plain version's two
// orders of signed zeros (its top-k puts +0 above -0, its stable sort ties
// them) never meet.
//
// Selection: the k best under the strict order "score descending, then index
// ascending", torch.topk's choice among ties at the k-th place on the card
// and the order in which the plain version's two sorts return a row.  A
// point's 64-bit key is the radix select's order-preserving image of its
// score (NaN above everything) over the complement of its index, so a
// larger key is a better point and no two points tie.
//
// What bounds it on the card: operations.  Every pair scored would be N^2
// pairs (1.72e10 at N = 131,072) of eight float32 operations (an FMA
// counting two): 2.05 ms at 67 TFLOP/s; the bytes (2 MB in, 64 MB of
// indices out) take 0.02 ms.  Design: a block owns 128 queries, adjacent on
// the curve, one a thread, each with its best-k keys as a min-heap in
// shared memory (slot-major, so a warp's accesses fall in distinct banks).
// It visits the scan's 256-point tiles from its own outward, one to the
// right and one to the left in turn, each through shared memory, double-
// buffered through registers, every thread reading the same point (a
// broadcast).  The threshold is the heap's root: a score below it is dropped
// by one compare, eight scores sharing a branch; a score that passes
// replaces the root and sifts down (log2 k steps).  Before a tile is
// loaded, each query bounds the best score any of its points can reach from
// the tile's box (beyond); a tile that no query of the block can use is
// skipped whole.  Near tiles come first, so the heaps hold near neighbours
// early and ~95 % of the tiles are skipped at k 64.  The thresholds only
// rise, so the result is the same as scoring every pair.  At the end each
// thread heap-sorts its keys and writes its row.  One template per k
// rounded up to 32, 64 or 128: the heap's shared memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQueries = 128;   // a block: threads, one query each
constexpr int kTile = 256;      // points a tile
constexpr int kGroup = 8;       // scores under one branch
static_assert(kTile % kQueries == 0 && kTile % kGroup == 0, "tile shape");

typedef unsigned long long Key;

// torch's radix-select image of a float (NaN above +inf) in the high word,
// the complement of the index in the low word
__device__ __forceinline__ Key make_key(float s, int j) {
  const unsigned x = __float_as_uint(s);
  const unsigned flip = (x & 0x80000000u) ? 0xffffffffu : 0x80000000u;
  const unsigned hi = s != s ? 0xffffffffu : x ^ flip;
  return (static_cast<Key>(hi) << 32) | static_cast<unsigned>(~j);
}

// the score of a key's high word; NaN for the empty key 0, so that every
// score passes the threshold while a heap is filling
__device__ __forceinline__ float key_score(Key key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  return __uint_as_float((hi & 0x80000000u) ? hi ^ 0x80000000u : ~hi);
}

// sift `key` down from node i of the min-heap heap[0..size) of thread t,
// into the hole at i; returns the root
__device__ __forceinline__ Key sift_down(Key* heap, int t, int i, int size,
                                        Key key) {
  while (true) {
    int c = 2 * i + 1;
    if (c >= size) break;
    Key cv = heap[c * kQueries + t];
    if (c + 1 < size) {
      const Key c2 = heap[(c + 1) * kQueries + t];
      if (c2 < cv) {
        cv = c2;
        ++c;
      }
    }
    if (key <= cv) break;
    heap[i * kQueries + t] = cv;
    i = c;
  }
  heap[i * kQueries + t] = key;
  return heap[t];
}

// the i-th tile a block visits: its first tile, then outward, one tile to
// the right and one to the left in turn, then the longer side to its end
__device__ __forceinline__ int visit(int i, int first, int n_tiles) {
  const int left = first, right = n_tiles - 1 - first;
  const int m = min(left, right);
  if (i <= 2 * m) {
    const int d = (i + 1) >> 1;
    return (i & 1) ? first + d : first - d;
  }
  return right > left ? first + (i - m) : first - (i - m);
}

// True when no point of the tile can score at or above thr for this query.
// The tile's box is (lo x, y, z, lift) and (hi x, y, z, -), lift the tile's
// largest p2 - p2m plus its share of the rounding bound (the wrapper's
// _knn_tile_boxes); eq, the query's share, is 2^-17 q2.  A point's computed
// score is at most -D^2 + lift + eq, D the query's distance to the box,
// whose computed square is shrunk by 2^-18 for its own rounding.  A NaN in
// the box or the query makes the compare false.
__device__ __forceinline__ bool beyond(const float4* __restrict__ boxes,
                                       int tile, float qx, float qy, float qz,
                                       float eq, float thr) {
  const float4 lo = __ldg(boxes + 2 * tile), hi = __ldg(boxes + 2 * tile + 1);
  const float dx = fmaxf(fmaxf(lo.x - qx, qx - hi.x), 0.f);
  const float dy = fmaxf(fmaxf(lo.y - qy, qy - hi.y), 0.f);
  const float dz = fmaxf(fmaxf(lo.z - qz, qz - hi.z), 0.f);
  const float d2 = dx * dx + dy * dy + dz * dz;
  return thr > (lo.w + eq) - d2 * (1.0f - 0x1p-18f);
}

// the first visit from i on whose tile some query of the block may score
// at or above its threshold; n_tiles if none.  Block-wide: every thread
// calls it.
__device__ __forceinline__ int next_visit(int i, int first, int n_tiles,
                                          const float4* __restrict__ boxes,
                                          bool active, float qx, float qy,
                                          float qz, float eq, float thr) {
  for (; i < n_tiles; ++i)
    if (!__syncthreads_and(!active || beyond(boxes, visit(i, first, n_tiles),
                                             qx, qy, qz, eq, thr)))
      break;
  return i;
}

__device__ __forceinline__ void fetch(const float4* __restrict__ pp,
                                      const int* __restrict__ perm, int n,
                                      int tile, float4 (&v)[kTile / kQueries],
                                      int (&ix)[kTile / kQueries]) {
#pragma unroll
  for (int r = 0; r < kTile / kQueries; ++r) {
    const int g = tile * kTile + r * kQueries + threadIdx.x;
    v[r] = g < n ? __ldg(pp + g) : make_float4(0.f, 0.f, 0.f, -INFINITY);
    ix[r] = g < n ? __ldg(perm + g) : 0;
  }
}

template <int KCAP>
__global__ void __launch_bounds__(kQueries)
knn_select_kernel(const float4* __restrict__ pp, const int* __restrict__ perm,
                  const float* __restrict__ p2, const int* __restrict__ start,
                  const float4* __restrict__ boxes,
                  long long* __restrict__ out, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  Key* heap = reinterpret_cast<Key*>(smem);         // [KCAP][kQueries]
  float4* tiles = reinterpret_cast<float4*>(heap + KCAP * kQueries);
  int* tile_ix = reinterpret_cast<int*>(tiles + 2 * kTile);  // [2][kTile] each

  const int t = threadIdx.x;
  const int pos = blockIdx.x * kQueries + t;
  const bool active = pos < n;
  float qx = 0.f, qy = 0.f, qz = 0.f, q2 = 0.f;
  int orig = 0;
  if (active) {
    const float4 q = __ldg(pp + pos);
    qx = q.x;
    qy = q.y;
    qz = q.z;
    orig = __ldg(perm + pos);
    q2 = __ldg(p2 + orig);
  }
  const float eq = 0x1p-17f * q2;
  for (int i = 0; i < k; ++i) heap[i * kQueries + t] = 0ull;
  // a thread past the end keeps a root no key beats
  Key root = active ? 0ull : ~0ull;
  float thr = active ? key_score(0ull) : INFINITY;

  const int n_tiles = (n + kTile - 1) / kTile;
  const int first = min(__ldg(start + blockIdx.x), n_tiles - 1);
  float4 v[kTile / kQueries];
  int ix[kTile / kQueries];
  fetch(pp, perm, n, first, v, ix);
#pragma unroll
  for (int r = 0; r < kTile / kQueries; ++r) {
    tiles[r * kQueries + t] = v[r];
    tile_ix[r * kQueries + t] = ix[r];
  }
  __syncthreads();

  // i: the visit in shared memory, buf its buffer.  The next visit is
  // chosen before i is scored: the thresholds only rise, so a tile ruled
  // out then stays out.
  for (int i = 0, buf = 0;; buf ^= 1) {
    const int tile = visit(i, first, n_tiles);
    const int nxt = next_visit(i + 1, first, n_tiles, boxes, active, qx, qy,
                               qz, eq, thr);
    if (nxt < n_tiles) fetch(pp, perm, n, visit(nxt, first, n_tiles), v, ix);
    const float4* sp = tiles + buf * kTile;
    const int* si = tile_ix + buf * kTile;
    const int cnt = min(kTile, n - tile * kTile);
    for (int j0 = 0; j0 < cnt; j0 += kGroup) {
      float s[kGroup];
      bool hit = false;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float4 p = sp[j0 + g];
        float d = __fmaf_rn(qx, p.x, 0.0f);
        d = __fmaf_rn(qy, p.y, d);
        d = __fmaf_rn(qz, p.z, d);
        s[g] = __fsub_rn(__fmaf_rn(2.0f, d, p.w), q2);
        hit |= !(s[g] < thr);
      }
      if (hit) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (!(s[g] < thr) && j0 + g < cnt) {
            const Key key = make_key(s[g], si[j0 + g]);
            if (key > root) {
              root = sift_down(heap, t, 0, k, key);
              thr = key_score(root);
            }
          }
        }
      }
    }
    if (nxt >= n_tiles) break;
#pragma unroll
    for (int r = 0; r < kTile / kQueries; ++r) {
      tiles[(buf ^ 1) * kTile + r * kQueries + t] = v[r];
      tile_ix[(buf ^ 1) * kTile + r * kQueries + t] = ix[r];
    }
    __syncthreads();
    i = nxt;
  }

  if (!active) return;
  // heap sort: the root, the least key, goes to the end each time, so the
  // slots end in descending order
  for (int end = k - 1; end > 0; --end) {
    const Key least = heap[t];
    const Key last = heap[end * kQueries + t];
    heap[end * kQueries + t] = least;
    sift_down(heap, t, 0, end, last);
  }
  long long* row = out + static_cast<long long>(orig) * k;
  for (int i = 0; i < k; ++i)
    row[i] = static_cast<long long>(
        static_cast<unsigned>(~static_cast<unsigned>(heap[i * kQueries + t])));
}

template <int KCAP>
int launch(const void* pp, const void* perm, const void* p2, const void* start,
           const void* boxes, void* out, int n, int k, cudaStream_t stream) {
  const int smem = static_cast<int>(KCAP * kQueries * sizeof(Key) +
                                    2 * kTile * (sizeof(float4) + sizeof(int)));
  // the opt-in above 48 KB, on the current device
  const cudaError_t e = cudaFuncSetAttribute(
      knn_select_kernel<KCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (n + kQueries - 1) / kQueries;
  knn_select_kernel<KCAP><<<blocks, kQueries, smem, stream>>>(
      static_cast<const float4*>(pp), static_cast<const int*>(perm),
      static_cast<const float*>(p2), static_cast<const int*>(start),
      static_cast<const float4*>(boxes), static_cast<long long*>(out), n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pp (n, 4) float32, perm (n,) int32, p2 (n,) float32, start
// (ceil(n / 128),) int32, boxes (ceil(n / 256), 8) float32 -> out (n, k)
// int64, all contiguous; 1 <= k <= 128 and k <= n.  Returns
// cudaGetLastError().
extern "C" int caelo_knn_select(const void* pp, const void* perm,
                                const void* p2, const void* start,
                                const void* boxes, void* out, int n, int k,
                                void* stream) {
  if (k < 1 || k > 128 || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 32) return launch<32>(pp, perm, p2, start, boxes, out, n, k, s);
  if (k <= 64) return launch<64>(pp, perm, p2, start, boxes, out, n, k, s);
  return launch<128>(pp, perm, p2, start, boxes, out, n, k, s);
}
