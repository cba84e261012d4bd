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
// and sum is fp32, and only the store rounds to G's dtype. Each output is
// ONE sequential chain in ascending l (mul_add below),
//     acc = -0.0;  acc = acc + P[i, l] * G[l, j]   for l = 0, 1, ..., m - 1,
// spelled __fmul_rn / __fadd_rn so nothing contracts into an FMA (-0.0 is
// the exact additive identity, so the first step yields P[i, 0] * G[0, j]
// bit for bit). A zero entry of P adds a signed zero, which leaves a
// non-zero sum unchanged; so this kernel is bitwise equal (up to the sign
// of an exact zero) to consensus_gather over the full neighbour list
// (neighbor_list(topo, k_max=m)) with P's entries as weights: the dense /
// sparse contract of DESIGN.md §14 on the card. It is not bitwise equal to
// torch.matmul (cuBLAS sums in another order). Hence, in both kernels below:
// every thread walks l from 0 to m - 1 for each of its outputs, with no
// split of l across threads or blocks, no tree over l, no tile of P skipped
// for being zero (a NaN or Inf of G in a row whose P column is 0 must come
// out as NaN, as in torch.matmul), no FMA and no tensor cores.
//
// Bound. 2*m*m*n FLOP over m*m*4 + m*n*(s + s) bytes (s = 4 for fp32): at
// (1024, 9347) fp32 that is 19.6 GFLOP (293 us at 67 TFLOP/s) against
// 80.8 MB (24 us at 3.35 TB/s): compute-bound. Without FMAs every mul-add
// is two issued instructions (FMUL, FADD), and an SM issues 128 fp32 lanes
// a clock, so the reachable floor is twice that: 9.80 G mul-adds = 19.6 G
// instructions over 132 x 128 x 1.98 GHz = 586 us. At m = 7 it is launch
// latency.
//
// Design, m > 32: a register-blocked SIMT product. A block of 256 threads
// (16 x 16) owns a kBM x 96 output tile (kBM = 128, or 64 for m <= 64);
// each thread keeps kTR x 6 accumulators (8 x 6 = 48 registers), its rows
// ty*4 + {0..3} (+ 64) and its columns tx*2 + {0, 1} (+ 32, + 64). Per l it
// reads its kTR P values as float4s and its 6 G values as float2s from
// shared memory: at kBM = 128, 5 shared loads for 96 fp32 instructions, each
// a single wavefront (P: two distinct addresses a warp, broadcast; G: 128
// contiguous bytes). l runs in chunks of 16 through a 3-stage ring in shared
// memory: P is copied transposed (p_s[l][row], rows padded to kBM + 4),
// each thread taking 8 (4) consecutive l of one row and a warp 32 rows, so
// a warp's stores hit 32 banks; G row by row, 16 columns a thread-row. No
// TMA: its row stride must be a multiple of 16 bytes, and n = 9,347 fp32 is
// not (nor is P's stride at odd m), so fp32 tiles arrive by 4-byte cp.async
// from one pointer a thread plus immediate offsets, two chunks ahead of the
// one being computed; bf16 / fp16 G (2-byte aligned rows) is loaded into
// registers before a chunk is computed and stored, converted to fp32,
// after it. One __syncthreads per chunk. Waves at (1024, 9347): 8 row
// tiles x 98 column tiles = 784 blocks, 2.97 waves at 2 blocks per SM
// (a 128 x 128 tile gives 592 blocks, 2.24 waves: a last wave a quarter
// full, and a last column tile of 3 columns).
//
// Design, m <= 32: no row tiling. All of P sits in shared memory
// (p_s[l][i], at most 32 x 32 floats); each thread owns one column j,
// loads its m values G[0..m-1, j] at once (coalesced across the warp; G is
// read exactly once) and keeps its m accumulators in registers. 64 threads
// a block, so (7, 9347) runs 147 blocks.
//
// Runs. A sweep stacks S independent runs: G and out (S, m, n), P one
// shared (m, m) matrix (p_stride 0) or one per run (p_stride m * m). The
// run is the grid's last axis (blockIdx.z tiled, blockIdx.y small); each
// run's blocks are the blocks of a launch on its slice alone, so every
// output keeps its chain and its bits. One launch for all runs.

#include "flat_common.cuh"

namespace {

using namespace repro_flat;

constexpr int kBK = 16;              // l per ring stage
constexpr int kStages = 3;           // ring depth
constexpr int kTC = 6;               // output columns per thread
constexpr int kBN = 16 * kTC;        // output columns per block (96)
constexpr int kSmallM = 32;          // m <= kSmallM: the small-m kernel
constexpr int kSmallThreads = 64;

// The one step of every output's chain.
__device__ __forceinline__ float mul_add(float acc, float p, float g) {
  return __fadd_rn(acc, __fmul_rn(p, g));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// A 4-byte cp.async from global to shared memory, issued only where pred
// holds (a predicated instruction, not a branch).
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n" ::"r"(dst),
      "l"(src), "r"((int)pred)
      : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The exact fp32 value of a 16-bit element's bits.
template <typename T> __device__ __forceinline__ float bits_f32(unsigned short b);
template <> __device__ __forceinline__ float bits_f32<__nv_bfloat16>(
    unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}
template <> __device__ __forceinline__ float bits_f32<__half>(
    unsigned short b) {
  return __half2float(__ushort_as_half(b));
}

template <typename T, int kTR>
__global__ void __launch_bounds__(kThreads, 2)
consensus_step_kernel_tiled(const float* __restrict__ P,
                            const T* __restrict__ G, T* __restrict__ out,
                            int64_t m, int64_t n, int64_t p_stride) {
  P += (int64_t)blockIdx.z * p_stride;
  G += (int64_t)blockIdx.z * m * n;
  out += (int64_t)blockIdx.z * m * n;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kBM = 16 * kTR;
  constexpr int kPS = kBM + 4;                // p_s row stride
  constexpr int kGS = kBN + 16;               // g_s row stride
  constexpr int kPPer = kBK * kBM / kThreads;   // P copies per thread
  constexpr int kGPer = kBN / 16;               // G copies per thread
  static_assert(kTR % 4 == 0 && kBK == 16 && kThreads == 256 &&
                kBN % 32 == 0, "tiling");
  __shared__ __align__(16) float p_s[kStages][kBK][kPS];
  __shared__ __align__(16) float g_s[kStages][kBK][kGS];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t row0 = (int64_t)blockIdx.y * kBM;
  const int64_t col0 = (int64_t)blockIdx.x * kBN;
  const int chunks = (int)((m + kBK - 1) / kBK);

  // Copies. P: lane x of warp w takes l = (w % 2) * 8 + x % 8 and rows
  // (w / 2) * 4 + x / 8 + 16 k, so a warp reads 8 consecutive l (32 bytes)
  // of 4 rows per copy and writes p_s at banks 4 l + row, 32 apart. G:
  // thread t takes row t / 16 and columns t % 16 + 16 k (two rows of 16
  // columns a warp; rows kGS apart hit other banks). Each thread's copies
  // are one pointer plus fixed offsets. Copies outside P or G are skipped,
  // not zero-filled: they feed only outputs that are not stored (rows >= m,
  // columns >= n) or l >= m, which no chain reaches.
  const int lane = tid % 32, warp = tid / 32;
  const int pl = (warp % 2) * 8 + lane % 8;
  const int prow = (warp / 2) * 4 + lane / 8;
  const int64_t p_rows = m - row0 - prow;     // copy k needs 16 k < p_rows
  const float* p_src = P + (row0 + prow) * m + pl;
  const int64_t p_step = 16 * m;              // 16 rows of P
  const unsigned p_dst = smem_addr(&p_s[0][pl][prow]);
  const int gl_row = tid / 16, gl_col = tid % 16;
  const int64_t g_cols = n - col0 - gl_col;   // copy k needs 16 k < g_cols
  const int64_t g_base = gl_row * n + col0 + gl_col;
  const unsigned g_dst = smem_addr(&g_s[0][gl_row][gl_col]);
  constexpr unsigned kPStage = sizeof(p_s[0]), kGStage = sizeof(g_s[0]);

  auto load_p = [&](int s, int64_t l0) {
    const bool l_ok = l0 + pl < m;
    const float* src = p_src + l0;
#pragma unroll
    for (int k = 0; k < kPPer; ++k) {
      cp_async4(p_dst + s * kPStage + 64 * k, src, l_ok && 16 * k < p_rows);
      src += p_step;
    }
  };
  auto load_g = [&](int s, int64_t l0) {      // fp32: cp.async
    const T* src = G + g_base + l0 * n;
    const bool row_ok = l0 + gl_row < m;
#pragma unroll
    for (int k = 0; k < kGPer; ++k)
      cp_async4(g_dst + s * kGStage + 64 * k, src + 16 * k,
                row_ok && 16 * k < g_cols);
  };
  unsigned short g_raw[kGPer];                // 16-bit: via registers
  auto fetch_g = [&](int64_t l0) {
    const unsigned short* src =
        reinterpret_cast<const unsigned short*>(G) + g_base + l0 * n;
    const bool row_ok = l0 + gl_row < m;
#pragma unroll
    for (int k = 0; k < kGPer; ++k)
      g_raw[k] = row_ok && 16 * k < g_cols ? src[16 * k] : 0;
  };
  auto store_g = [&](int s) {
    if constexpr (!kF32) {
#pragma unroll
      for (int k = 0; k < kGPer; ++k)
        g_s[s][gl_row][gl_col + 16 * k] = bits_f32<T>(g_raw[k]);
    }
  };
  auto load_stage = [&](int s, int chunk) {
    const int64_t l0 = (int64_t)chunk * kBK;
    load_p(s, l0);
    if constexpr (kF32) {
      load_g(s, l0);
    } else {
      fetch_g(l0);
    }
  };

  float acc[kTR][kTC];
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int c = 0; c < kTC; ++c) acc[r][c] = -0.0f;

  auto step = [&](int s, int l) {
    float pr[kTR], gv[kTC];
#pragma unroll
    for (int h = 0; h < kTR / 4; ++h) {
      const float4 v =
          *reinterpret_cast<const float4*>(&p_s[s][l][h * 64 + ty * 4]);
      pr[4 * h] = v.x;
      pr[4 * h + 1] = v.y;
      pr[4 * h + 2] = v.z;
      pr[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int h = 0; h < kTC / 2; ++h) {
      const float2 v =
          *reinterpret_cast<const float2*>(&g_s[s][l][h * 32 + tx * 2]);
      gv[2 * h] = v.x;
      gv[2 * h + 1] = v.y;
    }
#pragma unroll
    for (int r = 0; r < kTR; ++r)
#pragma unroll
      for (int c = 0; c < kTC; ++c) acc[r][c] = mul_add(acc[r][c], pr[r], gv[c]);
  };

  // Prologue: chunks 0 .. kStages - 2 in flight (one commit group each).
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) {
      load_stage(s, s);
      store_g(s);
    }
    cp_async_commit();
  }
  int s_comp = 0, s_next = kStages - 1;       // the stage chunk c - 1 used
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();   // chunk c has landed (this thread's part)
    __syncthreads();                // ... everyone's; chunk c - 1 is done
    const bool more = c + kStages - 1 < chunks;
    if (more) load_stage(s_next, c + kStages - 1);
    cp_async_commit();
    const int64_t left = m - (int64_t)c * kBK;
    if (left >= kBK) {
#pragma unroll
      for (int l = 0; l < kBK; ++l) step(s_comp, l);
    } else {
#pragma unroll 1
      for (int l = 0; l < (int)left; ++l) step(s_comp, l);
    }
    if (more) store_g(s_next);
    s_comp = s_comp + 1 == kStages ? 0 : s_comp + 1;
    s_next = s_next + 1 == kStages ? 0 : s_next + 1;
  }

#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int64_t gr = row0 + (r / 4) * 64 + ty * 4 + r % 4;
    if (gr >= m) continue;
#pragma unroll
    for (int c = 0; c < kTC; ++c) {
      const int64_t gc = col0 + (c / 2) * 32 + tx * 2 + c % 2;
      if (gc < n) store_f32(out + gr * n + gc, acc[r][c]);
    }
  }
}

template <typename T, int kM>
__global__ void __launch_bounds__(kSmallThreads)
consensus_step_kernel_small(const float* __restrict__ P,
                            const T* __restrict__ G, T* __restrict__ out,
                            int m, int64_t n, int64_t p_stride) {
  __shared__ __align__(16) float p_s[kM][kM];     // p_s[l][i] = P[i, l]
  P += (int64_t)blockIdx.y * p_stride;
  G += (int64_t)blockIdx.y * m * n;
  out += (int64_t)blockIdx.y * m * n;
  const int64_t j = (int64_t)blockIdx.x * kSmallThreads + threadIdx.x;
  float g[kM];
#pragma unroll
  for (int l = 0; l < kM; ++l)
    g[l] = (l < m && j < n) ? load_f32(G + l * n + j) : 0.0f;
  for (int e = threadIdx.x; e < kM * kM; e += kSmallThreads) {
    const int i = e / kM, l = e % kM;
    p_s[l][i] = (i < m && l < m) ? P[i * m + l] : 0.0f;
  }
  __syncthreads();
  if (j >= n) return;
  float acc[kM];
#pragma unroll
  for (int i = 0; i < kM; ++i) acc[i] = -0.0f;
#pragma unroll
  for (int l = 0; l < kM; ++l) {
    if (l >= m) break;
#pragma unroll
    for (int i = 0; i < kM; i += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(&p_s[l][i]);
      acc[i] = mul_add(acc[i], p4.x, g[l]);
      acc[i + 1] = mul_add(acc[i + 1], p4.y, g[l]);
      acc[i + 2] = mul_add(acc[i + 2], p4.z, g[l]);
      acc[i + 3] = mul_add(acc[i + 3], p4.w, g[l]);
    }
  }
#pragma unroll
  for (int i = 0; i < kM; ++i)
    if (i < m) store_f32(out + i * n + j, acc[i]);
}

template <typename T>
int launch(const float* P, const void* G, void* out, int64_t runs,
           int64_t m, int64_t n, int64_t p_stride, cudaStream_t stream) {
  const T* g = static_cast<const T*>(G);
  T* o = static_cast<T*>(out);
  if (runs > 65535) return (int)cudaErrorInvalidValue;
  if (m <= kSmallM) {
    const int64_t blocks = (n + kSmallThreads - 1) / kSmallThreads;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const int mi = (int)m;
    const dim3 grid((unsigned)blocks, (unsigned)runs);
    if (m <= 8)      // the paper's m = 7: 8 accumulators, not 32
      consensus_step_kernel_small<T, 8>
          <<<grid, kSmallThreads, 0, stream>>>(P, g, o, mi, n, p_stride);
    else
      consensus_step_kernel_small<T, 32>
          <<<grid, kSmallThreads, 0, stream>>>(P, g, o, mi, n, p_stride);
    return (int)cudaGetLastError();
  }
  const int bm = m <= 64 ? 64 : 128;
  const int64_t bx = (n + kBN - 1) / kBN;
  const int64_t by = (m + bm - 1) / bm;
  if (bx > 0x7fffffff || by > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)bx, (unsigned)by, (unsigned)runs);
  if (bm == 64)
    consensus_step_kernel_tiled<T, 4><<<grid, kThreads, 0, stream>>>(
        P, g, o, m, n, p_stride);
  else
    consensus_step_kernel_tiled<T, 8><<<grid, kThreads, 0, stream>>>(
        P, g, o, m, n, p_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// out[s] = P[s] @ G[s] for `runs` row-major (m, n) slices of G and out
// (dtype: 0 float32, 1 bfloat16, 2 float16) and row-major fp32 (m, m)
// matrices P + s * p_stride (p_stride 0: one P shared by every run, or
// m * m); out must not overlap G. The kernel is picked from m: m <= 32 the
// small-m kernel, else the tiled one (64-row tiles up to m = 64, 128-row
// tiles above). Returns 0 or a cudaError_t.
extern "C" int repro_consensus_step(const float* P, const void* G, void* out,
                                    int64_t runs, int64_t m, int64_t n,
                                    int64_t p_stride, int dtype,
                                    void* stream) {
  if (runs <= 0 || m <= 0 || n <= 0 || dtype < 0 || dtype > 2 ||
      p_stride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(P, G, out, runs, m, n, p_stride, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(P, G, out, runs, m, n, p_stride, s);
  return launch<__half>(P, G, out, runs, m, n, p_stride, s);
}
