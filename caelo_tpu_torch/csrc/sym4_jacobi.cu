// K3: the eigenvector of the largest eigenvalue of a batch of symmetric 4x4
// matrices by cyclic Jacobi, one thread per matrix, hand-written for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package runs these rotations inside XLA
// (caelo_tpu/geometry/se3.py::max_eigvec_sym4x4_lanes), fused by jit; eager
// PyTorch issues every Givens rotation as ~33 elementwise launches, ~1,600 a
// solve, and RANSAC solves four times a pair (the hypotheses, the refit and
// its two tightenings).  This kernel is those launches in one.
//
// A is (4, 4, B) float32 with element strides (si, sj, sb), the batch on the
// last axis; out is (4, B) float32, contiguous.  For each lane b, V = I and
// `sweeps` sweeps of the rotations (0,1) (0,2) (0,3) (1,2) (1,3) (2,3), each
//   theta = 0.5 * atan2(2 a_pq, a_pp - a_qq),  c = cos(theta), s = sin(theta)
// applied to rows p and q of A, then to columns p and q of A, then to
// columns p and q of V, as
//   x_p' = c x_p + s x_q,   x_q' = -s x_p + c x_q;
// then the column of V at the diagonal's argmax (the first maximum, a NaN
// above all, as torch.argmax picks), over its Euclidean norm.
//
// Arithmetic: the plain version's operations (caelo_tpu_torch/geometry/
// se3.py::max_eigvec_sym4x4_lanes_plain) in its order, each rounded as its
// eager launch rounds it, so that the kernel's result is the plain version's
// on the same card bit for bit: every product and sum is __fmul_rn /
// __fadd_rn, so none contracts into a fused multiply-add; atan2f, cosf and
// sinf are CUDA's math library functions, which torch's CUDA kernels call;
// no fast math (_build.py's flags).  -s * x is -(s * x) exactly.  The norm
// sums the four squares in the order of torch.linalg.vector_norm's CUDA
// reduction over the (4, B) vectors: with B > 1 one thread a lane, serially,
// ((x0^2 + x1^2) + x2^2) + x3^2; with B = 1 one element a thread and a
// shuffle tree at offsets 2 then 1, (x0^2 + x2^2) + (x1^2 + x3^2).  The
// kernel follows torch's choice from B alone; a torch whose reduction
// chooses otherwise fails the card tests against the plain version.
//
// What bounds it on the card: a lane reads 64 bytes and writes 16, and does
// ~3,800 float32 operations (48 rotations of 72 products and sums, three
// transcendental calls each counted as one); at the offline window's
// 129,024 lanes that is 3.1 us of bytes and 7.2 us of operations.  Each
// lane's 48 rotations are a serial chain of atan2f, cosf and sinf, so at the
// live sizes (1 and 2,048 lanes) the chain's latency sets the time.
// Design: A's and V's 32 entries live in registers, the six rotations of a
// sweep are unrolled so that every index is a compile-time constant, thread
// b reads A[i][j][b] and writes out[k][b], so a warp's loads and stores are
// coalesced in the callers' lane-last layout; 128-thread blocks, no shared
// memory, no allocation and no synchronisation.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

// (x_p, x_q) <- (c x_p + s x_q, -s x_p + c x_q), each operation rounded
__device__ __forceinline__ void rotate(float& xp, float& xq, float c, float s) {
  const float p = __fadd_rn(__fmul_rn(c, xp), __fmul_rn(s, xq));
  const float q = __fadd_rn(-__fmul_rn(s, xp), __fmul_rn(c, xq));
  xp = p;
  xq = q;
}

template <int P, int Q>
__device__ __forceinline__ void givens(float (&a)[4][4], float (&v)[4][4]) {
  const float theta = __fmul_rn(
      0.5f, atan2f(__fmul_rn(2.0f, a[P][Q]), __fsub_rn(a[P][P], a[Q][Q])));
  const float c = cosf(theta);
  const float s = sinf(theta);
#pragma unroll
  for (int j = 0; j < 4; ++j) rotate(a[P][j], a[Q][j], c, s);
#pragma unroll
  for (int i = 0; i < 4; ++i) rotate(a[i][P], a[i][Q], c, s);
#pragma unroll
  for (int i = 0; i < 4; ++i) rotate(v[i][P], v[i][Q], c, s);
}

__global__ void __launch_bounds__(kThreads)
max_eigvec_kernel(const float* __restrict__ A, float* __restrict__ out,
                  long long B, long long si, long long sj, long long sb,
                  int sweeps) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  float a[4][4], v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[i][j] = __ldg(A + i * si + j * sj + b * sb);
      v[i][j] = i == j ? 1.0f : 0.0f;
    }
  }
#pragma unroll 1
  for (int k = 0; k < sweeps; ++k) {
    givens<0, 1>(a, v);
    givens<0, 2>(a, v);
    givens<0, 3>(a, v);
    givens<1, 2>(a, v);
    givens<1, 3>(a, v);
    givens<2, 3>(a, v);
  }
  // torch.argmax: a NaN beats any number, the first of equals wins
  int m = 0;
  float best = a[0][0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const float d = a[i][i];
    if (!isnan(best) && (isnan(d) || d > best)) {
      best = d;
      m = i;
    }
  }
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = m == 0 ? v[i][0] : m == 1 ? v[i][1] : m == 2 ? v[i][2] : v[i][3];
  float sq[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) sq[i] = __fmul_rn(x[i], x[i]);
  const float sum = B == 1
      ? __fadd_rn(__fadd_rn(sq[0], sq[2]), __fadd_rn(sq[1], sq[3]))
      : __fadd_rn(__fadd_rn(__fadd_rn(sq[0], sq[1]), sq[2]), sq[3]);
  const float norm = __fsqrt_rn(sum);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i * B + b] = __fdiv_rn(x[i], norm);
}

}  // namespace

// A (4, 4, B) float32 at element strides (si, sj, sb) -> out (4, B) float32,
// contiguous; sweeps >= 0.  Returns cudaGetLastError().
extern "C" int caelo_max_eigvec_sym4x4(const void* A, void* out, long long B,
                                       long long si, long long sj,
                                       long long sb, int sweeps,
                                       void* stream) {
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (B + kThreads - 1) / kThreads;
  max_eigvec_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<float*>(out), B, si, sj, sb,
      sweeps);
  return static_cast<int>(cudaGetLastError());
}
