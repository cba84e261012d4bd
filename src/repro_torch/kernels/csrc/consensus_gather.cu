// Sparse neighbour-list consensus gossip for Hopper (sm_90a): one round
//     out[i, j] = sum_k w[i, k] * g[idx[i, k], j]
// over agent i's padded closed neighbourhood (the NeighborList layout of
// repro_torch.core.topology: valid entries ascending with the agent itself
// included, padding = the agent's own row with weight exactly 0.0).
//
// Replaces the Pallas TPU kernel consensus_gather_pallas
// (src/repro/kernels/consensus_gather.py:51, body _gather_kernel at :29). The
// TPU version scalar-prefetches idx so a BlockSpec index map can DMA any row
// of g, and carries a VMEM scratch row across the innermost k grid dimension.
// On Hopper blocks carry nothing from one to the next, so the k loop lives
// inside the block, in registers.
//
// Numerics. g is read as fp32 (fp32, bf16 or fp16 buffers), the sum is one
// fp32 chain per output in ascending k,
//     acc = -0.0;  acc = acc + w[i, k] * g[idx[i, k], j]   for k = 0..k_max-1,
// spelled __fmul_rn / __fadd_rn (no FMA contraction; -0.0 is the exact
// additive identity, so the first step gives w[i, 0] * g[idx[i, 0], j]), and
// only the store rounds to g's dtype. That is operation for operation the
// plain version (w[:, 0] * g32[idx[:, 0]], then `out + w[:, k] * g32[idx[:,
// k]]` for k = 1..), so the kernel is bitwise equal to it. Padding slots are
// gathered unconditionally, as on the TPU: their weight 0.0 adds an exact
// zero.
//
// Preconditions (not checked per launch: the host checks idx once when the
// strategy builds its NeighborList): 0 <= idx < m; out does not overlap g.
//
// Bound. Each source row read once and each output row written once: at
// least 2*m*n*s bytes (s = 4 for fp32), 76.6 MB at (1024, 9347) = 22.9 us
// at 3.35 TB/s, and 748 MB at (10000, 9347) = 223 us; k_max*m*n*2 FLOP is
// far below the card's rate. Without reuse, the k_max reads per output row
// would move (k_max + 1)*m*n*s bytes (383 MB, 114 us at (1024, 9347), k = 9).
//
// Design. A block covers one row i and a tile of 1024 columns (4 per thread,
// 256 apart, so a warp reads 32 neighbouring values of a source row); it
// stages idx[i, :] and w[i, :] in shared memory, 256 slots at a time, and
// loops over k with the sums in registers. blockIdx.x is the row, the
// fastest-varying grid index, so the blocks in flight at one time cover
// consecutive rows at one column tile: neighbouring rows share most of their
// source rows, and those are read from L2 rather than from device memory.

#include "flat_common.cuh"

namespace {

using namespace repro_flat;

constexpr int kPer = 4;                      // columns per thread
constexpr int kTileCols = kThreads * kPer;   // 1024 columns per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
consensus_gather_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                        const float* __restrict__ w, T* __restrict__ out,
                        int64_t n, int k_max) {
  __shared__ int idx_s[kThreads];
  __shared__ float w_s[kThreads];
  const int64_t i = blockIdx.x;
  const int64_t col0 = (int64_t)blockIdx.y * kTileCols + threadIdx.x;
  float acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = -0.0f;

  for (int k0 = 0; k0 < k_max; k0 += kThreads) {
    const int kn = k_max - k0 < kThreads ? k_max - k0 : kThreads;
    if (threadIdx.x < kn) {
      idx_s[threadIdx.x] = idx[i * k_max + k0 + threadIdx.x];
      w_s[threadIdx.x] = w[i * k_max + k0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      const T* src = g + (int64_t)idx_s[k] * n;
      const float wk = w_s[k];
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int64_t col = col0 + (int64_t)c * kThreads;
        if (col < n)
          acc[c] = __fadd_rn(acc[c], __fmul_rn(wk, load_f32(src + col)));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int64_t col = col0 + (int64_t)c * kThreads;
    if (col < n) store_f32(out + i * n + col, acc[c]);
  }
}

template <typename T>
int launch(const void* g, const int* idx, const float* w, void* out,
           int64_t m, int64_t n, int k_max, cudaStream_t stream) {
  const int64_t tiles = (n + kTileCols - 1) / kTileCols;
  if (m > 0x7fffffff || tiles > 65535) return (int)cudaErrorInvalidValue;
  consensus_gather_kernel<T><<<dim3((unsigned)m, (unsigned)tiles), kThreads,
                               0, stream>>>(
      static_cast<const T*>(g), idx, w, static_cast<T*>(out), n, k_max);
  return (int)cudaGetLastError();
}

}  // namespace

// One gossip round over an (m, k_max) int32 neighbour list idx with fp32
// weights w, on row-major (m, n) g and out (dtype: 0 float32, 1 bfloat16,
// 2 float16). Returns 0 or a cudaError_t.
extern "C" int repro_consensus_gather(const void* g, const int* idx,
                                      const float* w, void* out, int64_t m,
                                      int64_t n, int k_max, int dtype,
                                      void* stream) {
  if (m <= 0 || n <= 0 || k_max <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(g, idx, w, out, m, n, k_max, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, idx, w, out, m, n, k_max, s);
  return launch<__half>(g, idx, w, out, m, n, k_max, s);
}
