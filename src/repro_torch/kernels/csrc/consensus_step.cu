// Dense consensus gossip for Hopper (sm_90a): out = P @ G, with P the (m, m)
// fp32 mixing matrix (possibly (I - eps*La)^E with the variation mask folded
// into its columns) and G the (m, n) matrix of flat per-agent gradients.
//
// Replaces the Pallas TPU kernel consensus_step_pallas
// (src/repro/kernels/consensus_step.py:36, body _consensus_kernel at :21),
// which keeps the whole (m, m) P resident in VMEM and runs one fp32 HIGHEST
// (m, m) x (m, block_n) MXU product per n-block. On Hopper a block has at
// most 227 KB of shared memory, and P alone is 4 MB at m = 1024, so P is
// streamed in chunks like G.
//
// Numerics. G is read as fp32 (fp32, bf16 or fp16 buffers), every product
// and sum is fp32, and only the store rounds to G's dtype. TF32 stays off:
// this is CUDA-core fp32, no tensor cores. Each output is ONE sequential
// chain in ascending l,
//     acc = -0.0;  acc = acc + P[i, l] * G[l, j]   for l = 0, 1, ..., m - 1,
// spelled __fmul_rn / __fadd_rn so nothing contracts into an FMA (-0.0 is
// the exact additive identity, so the first step yields P[i, 0] * G[0, j]
// bit for bit). A zero entry of P adds a signed zero, which leaves a
// non-zero sum unchanged; so this kernel is bitwise equal (up to the sign
// of an exact zero) to consensus_gather over the full neighbour list
// (neighbor_list(topo, k_max=m)) with P's entries as weights: the dense /
// sparse contract of DESIGN.md §14 on the card. It is not bitwise equal to
// torch.matmul (cuBLAS sums in another order).
//
// Bound. 2*m*m*n FLOP over m*m*4 + m*n*(s + s) bytes (s = 4 for fp32): at
// (1024, 9347) fp32 that is 19.6 GFLOP (293 us at 67 TFLOP/s) against
// 80.8 MB (24 us at 3.35 TB/s): compute-bound. Without FMAs every mul-add
// is two issued instructions, so the reachable floor is twice that, ~590 us.
// At m = 7 it is launch latency.
//
// Design. A block owns a TM x TN = 32 x 256 output tile and loops over l in
// chunks of TL = 32: it stages P[rows, l-chunk] (transposed, so one thread
// reads its 4 rows as one float4) and G[l-chunk, cols] (as fp32) in shared
// memory, and each of its 256 threads keeps a 4 x 8 register tile of
// outputs (rows 4*ty.., columns tx + 32*c), so a warp reads 32 neighbouring
// G values and one broadcast P float4 per l. The chunk loop stops at m: no
// padded term enters a sum. No double buffering, no wgmma: a simple kernel
// first.

#include "flat_common.cuh"

namespace {

using namespace repro_flat;

constexpr int kTM = 32;            // output rows per block
constexpr int kTN = 256;           // output columns per block
constexpr int kTL = 32;            // l per shared-memory chunk
constexpr int kRows = 4;           // rows per thread
constexpr int kCols = kTN / 32;    // columns per thread (8)
static_assert(kThreads == (kTM / kRows) * 32, "8 row groups x 32 lanes");

template <typename T>
__global__ void __launch_bounds__(kThreads)
consensus_step_kernel(const float* __restrict__ P, const T* __restrict__ G,
                      T* __restrict__ out, int64_t m, int64_t n) {
  __shared__ __align__(16) float p_s[kTL][kTM];   // p_s[l][row]
  __shared__ float g_s[kTL][kTN];
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  const int64_t row0 = (int64_t)blockIdx.y * kTM;
  const int64_t col0 = (int64_t)blockIdx.x * kTN;

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = -0.0f;

  for (int64_t l0 = 0; l0 < m; l0 += kTL) {
    const int lmax = (int)(m - l0 < kTL ? m - l0 : kTL);
    // P[row0 + r, l0 + l] -> p_s[l][r]; 1024 entries, 4 per thread; a warp
    // writes one p_s row (no bank conflict) from 32 rows of P (L2-resident)
    for (int e = threadIdx.x; e < kTL * kTM; e += kThreads) {
      const int r = e % kTM, l = e / kTM;
      const int64_t gr = row0 + r, gl = l0 + l;
      p_s[l][r] = (gr < m && gl < m) ? P[gr * m + gl] : 0.0f;
    }
    // G[l0 + l, col0 + c] -> g_s[l][c]; coalesced along the columns
    for (int e = threadIdx.x; e < kTL * kTN; e += kThreads) {
      const int l = e / kTN, c = e % kTN;
      const int64_t gl = l0 + l, gc = col0 + c;
      g_s[l][c] = (gl < m && gc < n) ? load_f32(G + gl * n + gc) : 0.0f;
    }
    __syncthreads();
    for (int l = 0; l < lmax; ++l) {
      const float4 p4 = *reinterpret_cast<const float4*>(&p_s[l][ty * kRows]);
      const float pr[kRows] = {p4.x, p4.y, p4.z, p4.w};
      float gv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) gv[c] = g_s[l][tx + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(pr[r], gv[c]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t gr = row0 + ty * kRows + r;
    if (gr >= m) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int64_t gc = col0 + tx + 32 * c;
      if (gc < n) store_f32(out + gr * n + gc, acc[r][c]);
    }
  }
}

template <typename T>
int launch(const float* P, const void* G, void* out, int64_t m, int64_t n,
           cudaStream_t stream) {
  const int64_t bx = (n + kTN - 1) / kTN;
  const int64_t by = (m + kTM - 1) / kTM;
  if (bx > 0x7fffffff || by > 65535) return (int)cudaErrorInvalidValue;
  consensus_step_kernel<T><<<dim3((unsigned)bx, (unsigned)by), kThreads, 0,
                             stream>>>(P, static_cast<const T*>(G),
                                       static_cast<T*>(out), m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// out = P @ G for a row-major fp32 (m, m) P and row-major (m, n) G and out
// (dtype: 0 float32, 1 bfloat16, 2 float16); out must not overlap G.
// Returns 0 or a cudaError_t.
extern "C" int repro_consensus_step(const float* P, const void* G, void* out,
                                    int64_t m, int64_t n, int dtype,
                                    void* stream) {
  if (m <= 0 || n <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(P, G, out, m, n, s);
  if (dtype == 1) return launch<__nv_bfloat16>(P, G, out, m, n, s);
  return launch<__half>(P, G, out, m, n, s);
}
