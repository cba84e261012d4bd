// Sliding-window causal attention (flash schedule, online softmax) for
// Hopper (sm_90a).
//
// For each (b, h) and query i, with key positions j and query positions
// both counted from 0:
//     s[i, j] = (q_i . k_j) * D^-1/2                  (fp32)
//     s[i, j] = -1e30  where (causal and j > i) or (window and j <= i - W)
//     o_i     = sum_j softmax_j(s[i, :]) v_j          (fp32, cast to q's type)
// q is (B, Sq, H, D); k and v are (B, Sk, KV, D), not repeated: head h
// reads KV head h / (H / KV), the mapping of the JAX package's _repeat_kv
// (each KV head repeated H / KV times in a row). Inputs are fp32 or bf16;
// D is 64, 120, 128 or 256. The softmax weights p keep fp32 accuracy for
// p @ v in both kernels below, as in the TPU kernel (the JAX model's own
// flash_attention rounds them to q's type first).
//
// Replaces the Pallas TPU kernel swa_attention_pallas
// (src/repro/kernels/swa_attention.py:80, body _swa_kernel at :25). That
// kernel walks a grid (B, H, q blocks, kv blocks) with the kv axis
// sequential and carries the running max, denominator and accumulator in
// VMEM scratch; kv blocks outside [q_lo - W + 1, q_hi] are skipped. Hopper
// blocks run in no order, so here the kv axis is a loop inside the block,
// which visits only the kv tiles that overlap that range (the same skip: the
// work is O(Sq * W), not O(Sq * Sk)). Unlike the TPU kernel, any Sq and Sk
// are taken: rows past Sq are computed on zeros and not stored, keys past
// Sk get weight 0. The caller refuses shapes with a query row that has no
// key in its window (Sq >= Sk + W): its softmax is over no key at all.
// repro_swa_attention picks the kernel by dtype, a static choice. Both
// kernels also write, where the caller passes an lse buffer (training),
// each row's log-sum-exp m + ln l in fp32: the residual of JAX's
// _flash_fwd (src/repro/models/attention.py:219-221) that the backward
// (swa_attention_bwd.cu) reads. Serving passes null and the write is
// skipped.
//
// bf16: swa_attention_hopper_kernel. Bound: 2*D FLOP per unmasked (i, j)
// pair for q.k and 2 * 2*D for p*v, which runs twice (below), against q, k,
// v read and o written once. At the prefill shape (1, 8192, 32 heads / 8
// KV, D 120, W 4096) that is 805M pairs, 580 GFLOP on the bf16 tensor cores
// (0.59 ms at 989 TFLOP/s) against 157 MB (47 us at 3.35 TB/s): operations
// bound it, and the exponentials (805M, 0.21 ms on the SFU) come next. The
// CUDA-core kernel it replaces spent its time on shared-memory operands and
// fp32 FMAs (30 TFLOP/s); this one keeps the tensor cores fed:
// - one block of 384 threads per unit (b, h, 128-row q tile), the q tiles
//   with the most kv tiles first, so the short causal tiles fill the tail.
//   Two consumer warpgroups of 64 query rows and a producer warpgroup in
//   which one thread issues TMA; setmaxnreg moves registers from the
//   producer (56 a thread; 40 at D = 256) to the consumers (224; 232),
//   ptxas -v: 168 at entry, no spill (at every D);
// - the producer loads the q tile once and each 128-key k and v tile into a
//   ring of kStages slots by TMA (4-d tensor maps over (D, heads, S, B),
//   boxes of 64 columns x 128 rows with the 128-byte swizzle; columns past D
//   and rows past S arrive as zeros, so D = 120 is padded to 128 for free).
//   Each slot has mbarriers for its load and its release (k right after its
//   q k^T, v after its p v), so the next tiles load while this one
//   computes. 161 KB of dynamic shared memory, one block per SM;
// - a consumer computes s = q k^T with wgmma (bf16 operands from shared
//   memory, fp32 accumulators: 8 m64n128k16), masks only the tiles a mask
//   reaches, runs the online softmax on the accumulator registers (the row
//   max across the four threads of a row by shuffles) and accumulates
//   o += p v with wgmma, p from registers and v (MN-major) from shared
//   memory. Tile i's q k^T is issued together with tile i - 1's p v, and
//   tile i's softmax runs while that p v is on the tensor cores;
// - p keeps fp32 accuracy: p_hi = bf16(p) and p_lo = bf16(p - p_hi) both go
//   through the tensor cores into one fp32 accumulator (|p - p_hi - p_lo| <=
//   2^-17 p), 16 m64n128k16 per tile instead of 8;
// - within a q tile the blocks run the heads that share a KV head side by
//   side (their k and v meet in the L2).
// The mbarrier, TMA and wgmma helpers are hopper_common.cuh's, shared with
// the backward.
// D = 64 (whisper-small; Geometry<64>): kBoxes = 1, one 64-column box a row,
// 128-key tiles; s = q k^T is 4 m64n128k16, o one m64n64 accumulator (32
// registers) that takes p_hi v and p_lo v as m64n64k16 (16 a tile). The q
// tile and each k and v tile are 16 KB (81 KB with the 2-stage ring). Two
// blocks an SM would need <= 85 registers a thread, and s, p_hi, p_lo and o
// alone take 160; a 4-stage ring measured no faster (346.5 vs 349.0 us at
// the encoder's shape, NVIDIA H100 80GB HBM3 at 700 W): the consumers'
// per-tile chain, not the loads, holds it. A tile
// does half the tensor-core work of D = 128 per exponential, so the SFU's
// exponentials weigh twice as much: at the encoder's (8, 1500, 12 / 12)
// they take ~55 us against ~84 us of tensor-core FLOP. A decode step's
// cross-attention (Sq = 1 against Sk = 1500) computes a whole 128-row q
// tile for its one row; its bound is the bytes of K and V.
// D = 256 (gemma-7b, recurrentgemma-9b; Geometry<256>): kBoxes = 4 and
// 64-key tiles, so the 64 KB q tile and two stages of 32 KB k and v tiles
// fit (193 KB); s = q k^T is 16 m64n64k16, o two m64n128 halves (128
// registers a thread) that each take p_hi v and p_lo v, 16 m64n128k16 a
// tile. Work per pair is the same as at D = 128 per column; the tiles are
// half as deep in keys, so the softmax's share of a tile's time doubles.
//
// fp32: swa_attention_kernel, on the CUDA cores (fp32 q.k on the tensor
// cores would need TF32, which the port's numerics rule out). One block of
// 256 threads per (b, h, 64-row q tile). The q tile and each 64-row k and v
// tile are staged in shared memory (row stride D + 4 floats: float4 reads
// of 8 neighbouring rows fall in distinct banks), 112-119 KB of dynamic
// shared memory (212 KB at D = 256, 68 KB at D = 64). Thread (ty, tx)
// of a 16 x 16 grid owns query rows 4ty..4ty+3: it computes their scores
// against keys tx + 16c (c < 4) with fp32 FMAs, the row max and sum go
// across the 16 threads of the row by warp shuffles, p goes through shared
// memory, and the thread accumulates columns 64cg + 4tx..64cg + 4tx + 3 of
// its rows' outputs, one group of 4 per 64 columns of D (16 registers at
// D = 64, 32 at D = 120 / 128, 64 at D = 256). Bound: 4*D FLOP per pair at
// 67 TFLOP/s fp32; every product is a shared-memory operand, so the
// shared-memory loads, not the FMAs, limit its inner loops.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace repro_hopper;

constexpr float kMasked = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// --- fp32: CUDA cores ----------------------------------------------------

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPS = kBK + 4;     // row stride of the p tile (floats)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// 64 rows of D elements (row r at src + r * stride) into dst (row stride
// D + 4); rows at or past `valid` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int valid) {
  constexpr int kC = D / 4;
  for (int idx = threadIdx.x; idx < 64 * kC; idx += kThreads) {
    const int r = idx / kC, c = (idx - r * kC) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid) x = load4(src + r * stride + c);
    store4(dst + r * (D + 4) + c, x);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
swa_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                     int window, int causal, float scale) {
  constexpr int DP = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // kBQ x DP
  float* k_s = q_s + kBQ * DP;     // kBK x DP
  float* v_s = k_s + kBK * DP;     // kBK x DP
  float* p_s = v_s + kBK * DP;     // kBQ x kPS

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int q_hi = min(q0 + kBQ, Sq) - 1;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KV * D;
  const float* q_blk = q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;
  const float* k_bh = k + (int64_t)b * Sk * kv_stride + (int64_t)g * D;
  const float* v_bh = v + (int64_t)b * Sk * kv_stride + (int64_t)g * D;

  load_tile<D>(q_s, q_blk, q_stride, Sq - q0);

  // The kv tiles that overlap [q0 - W + 1, q_hi] (the Pallas block skip).
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_hi) : Sk - 1;

  // Column group cg holds the thread's columns 64cg + 4tx .. + 3.
  constexpr int kCG = (D + 63) / 64;
  float m[4], l[4], acc[4][4 * kCG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4 * kCG; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = (lo / kBK) * kBK; k0 <= hi; k0 += kBK) {
    __syncthreads();   // the previous tile's k, v and p have been read
    load_tile<D>(k_s, k_bh + k0 * kv_stride, kv_stride, Sk - k0);
    load_tile<D>(v_s, v_bh + k0 * kv_stride, kv_stride, Sk - k0);
    __syncthreads();

    // s = q k^T for rows 4ty + i, keys tx + 16c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(q_s + (4 * ty + i) * DP + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) ka[c] = load4(k_s + (tx + 16 * c) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[i][c];
          x = fmaf(qa[i].x, ka[c].x, x);
          x = fmaf(qa[i].y, ka[c].y, x);
          x = fmaf(qa[i].z, ka[c].z, x);
          x = fmaf(qa[i].w, ka[c].w, x);
          s[i][c] = x;
        }
    }

    // mask, online softmax, p to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        float x = s[i][c] * scale;
        if (kp >= Sk) {
          x = -INFINITY;                      // no such key: weight 0
        } else if ((causal && kp > qp) || (window > 0 && kp <= qp - window)) {
          x = kMasked;
        }
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        p_s[(4 * ty + i) * kPS + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kCG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p v for rows 4ty + i, columns 64cg + 4tx..
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = load4(p_s + (4 * ty + i) * kPS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = v_s + (c + cc) * DP;
#pragma unroll
        for (int cg = 0; cg < kCG; ++cg) {
          const float4 va = 64 * cg + 4 * tx < D
                                ? load4(vr + 64 * cg + 4 * tx)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y
                          : cc == 2 ? pa[i].z : pa[i].w;
            float* a = acc[i] + 4 * cg;
            a[0] = fmaf(p, va.x, a[0]);
            a[1] = fmaf(p, va.y, a[1]);
            a[2] = fmaf(p, va.z, a[2]);
            a[3] = fmaf(p, va.w, a[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((int64_t)b * H + h) * Sq + r] = m[i] + logf(den);
    float* out = o + ((int64_t)b * Sq + r) * q_stride + (int64_t)h * D;
#pragma unroll
    for (int cg = 0; cg < kCG; ++cg) {
      const float* a = acc[i] + 4 * cg;
      if (64 * cg + 4 * tx < D)
        store4(out + 64 * cg + 4 * tx, make_float4(a[0] / den, a[1] / den,
                                                   a[2] / den, a[3] / den));
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Sk, int H, int KV, int window,
               int causal, float scale, cudaStream_t stream) {
  constexpr int kSmem = (3 * 64 * (D + 4) + kBQ * kPS) * (int)sizeof(float);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        swa_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  swa_attention_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk, H,
      KV, window, causal, scale);
  return (int)cudaGetLastError();
}

// --- bf16: tensor cores, TMA, a K/V ring ---------------------------------

constexpr int kRows = 128;               // q rows per block
constexpr int kStages = 2;               // K/V ring depth
constexpr int kConsumers = 256;          // two warpgroups of 64 query rows
constexpr int kHThreads = kConsumers + 128;  // + the producer warpgroup

// The tile geometry of head size D. D is padded to kBoxes 64-column TMA
// boxes (128 bytes a row). D = 120 / 128: 128-key tiles, o one m64n128
// accumulator (64 registers) beside s (64) and p_hi / p_lo (32 each), 161
// KB of shared memory, registers 128 x 56 + 256 x 224 after setmaxnreg.
// D = 64: o one m64n64 accumulator (32 registers), 16 KB tiles, 81 KB.
// D = 256: a 128-row q tile is 64 KB, so the kv tiles hold 64 keys (32 KB:
// q and two stages of k and v take 193 KB); o is two m64n128 halves (128
// registers) beside s (32) and p_hi / p_lo (16 each), the same 192 as at
// D = 128, and the consumers take 232 registers (128 x 40 + 256 x 232 <=
// 65,536).
template <int D>
struct Geometry {
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kKeys = kBoxes > 2 ? 64 : 128;   // keys per kv tile
  static constexpr int kHalves = (kBoxes + 1) / 2;       // halves of o
  static constexpr int kN = kBoxes == 1 ? 64 : 128;     // columns of a half
  static constexpr int kO = kN / 2;          // o registers of a half
  static constexpr int kS = kKeys / 2;       // score registers a thread
  static constexpr int kP = kKeys / 4;       // p_hi (and p_lo) registers
  static constexpr int kQTile = kBoxes * kRows * 128;    // bytes
  static constexpr int kKvTile = kBoxes * kKeys * 128;
  static constexpr int kSmem = 1024 + kQTile + 2 * kStages * kKvTile;
  static constexpr int kProducerRegs = kBoxes > 2 ? 40 : 56;
  static constexpr int kConsumerRegs = kBoxes > 2 ? 232 : 224;
};

// s = q k^T for 64 query rows x kKeys keys: K = D in 16-column steps, four
// per 128-byte box (both operands K-major).
template <int kBoxes, int kKeys>
__device__ __forceinline__ void issue_qk(float (&s)[kKeys / 2],
                                         uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < 4 * kBoxes; ++kk) {
    const uint64_t dq = kmajor_desc(q_addr, kRows, 0, kk);
    const uint64_t dk = kmajor_desc(k_addr, kKeys, 0, kk);
    if constexpr (kKeys == 128)
      wgmma_ss_n128(s, dq, dk, kk > 0);
    else
      wgmma_ss_n64(s, dq, dk, kk > 0);
  }
  wgmma_commit();
}

// acc += p_hi v + p_lo v: K = kKeys keys in 16-row steps of v (MN-major);
// half hf of o takes v's columns 128hf.. (boxes 2hf and 2hf + 1), each an
// n128 product, or at D = 64 (kO = 32) the one box as an n64 product.
template <int kHalves, int kO, int kKeys>
__device__ __forceinline__ void issue_pv(float (&acc)[kHalves][kO],
                                         const uint32_t (&p_hi)[kKeys / 4],
                                         const uint32_t (&p_lo)[kKeys / 4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      const uint64_t dv = mnmajor_desc(v_addr + hf * 2 * kKeys * 128, kKeys,
                                       kk);
      if constexpr (kO == 64) {
        wgmma_rs_n128(acc[hf], p_hi + 4 * kk, dv);
        wgmma_rs_n128(acc[hf], p_lo + 4 * kk, dv);
      } else {
        wgmma_rs_n64(acc[hf], p_hi + 4 * kk, dv);
        wgmma_rs_n64(acc[hf], p_lo + 4 * kk, dv);
      }
    }
  }
  wgmma_commit();
}

template <int kHalves, int kO>
__device__ __forceinline__ void fence_acc(float (&acc)[kHalves][kO]) {
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf) fence_regs(acc[hf]);
}

// A thread's two query rows: running max (log2 domain) and its own part of
// each row's sum (the four threads of a row add theirs at the end).
struct Rows {
  float m_a, m_b, l_a, l_b;
};

// Scores to p in place for one 64 x kKeys tile, in the log2 domain, masked
// where some mask reaches the warpgroup's rows r_wg..r_wg + 63. The thread
// holds rows r_a (accumulator elements 4j, 4j + 1) and r_a + 8 (4j + 2,
// 4j + 3) at keys k0 + 8j + col0 + {0, 1}, j < kKeys / 8. Updates the
// running max and sums, and returns the factors that rescale the earlier
// output.
template <int kKeys>
__device__ __forceinline__ void softmax_tile(float (&s)[kKeys / 2], Rows& st,
                                             float& al_a, float& al_b, int k0,
                                             int r_wg, int r_a, int col0,
                                             int Sk, int window, int causal,
                                             float scale_log2) {
  constexpr int kS = kKeys / 2;
  const bool masked = k0 + kKeys > Sk || (causal && k0 + kKeys - 1 > r_wg) ||
                      (window > 0 && k0 <= r_wg + 63 - window);
  float mx_a = kMasked, mx_b = kMasked;
#pragma unroll
  for (int e = 0; e < kS; ++e) {
    float x = s[e] * scale_log2;
    if (masked) {
      const int kp = k0 + 8 * (e / 4) + col0 + (e & 1);
      const int qp = r_a + ((e & 2) ? 8 : 0);
      if (kp >= Sk) {
        x = -INFINITY;                        // no such key: weight 0
      } else if ((causal && kp > qp) || (window > 0 && kp <= qp - window)) {
        x = kMasked;
      }
    }
    s[e] = x;
    if (e & 2) mx_b = fmaxf(mx_b, x);
    else mx_a = fmaxf(mx_a, x);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(st.m_a, mx_a), mn_b = fmaxf(st.m_b, mx_b);
  al_a = fast_exp2(st.m_a - mn_a);
  al_b = fast_exp2(st.m_b - mn_b);
  st.m_a = mn_a;
  st.m_b = mn_b;
  float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
  for (int e = 0; e < kS; ++e) {
    s[e] = fast_exp2(s[e] - ((e & 2) ? mn_b : mn_a));
    if (e & 2) sum_b += s[e];
    else sum_a += s[e];
  }
  st.l_a = st.l_a * al_a + sum_a;
  st.l_b = st.l_b * al_b + sum_b;
}

// o rows r_a and r_a + 8 of (b, h), where below Sq: the accumulator over
// the row sums (the four threads of a row add their parts first), bf16.
// Half hf's element 4j + .. is column 2 kO hf + 8j + col0 + ...
template <int D, int kHalves, int kO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ o,
                                          float* __restrict__ lse,
                                          const float (&acc)[kHalves][kO],
                                          const Rows& st, int b, int h,
                                          int r_a, int col0, int Sq, int H) {
  float l_a = st.l_a, l_b = st.l_b;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.0f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.0f / fmaxf(l_b, 1e-30f);
  // lse = m + ln l in the natural domain: the running max is kept in the
  // log2 domain, so lse = ln 2 * (m2 + log2 l).
  if (lse != nullptr && col0 == 0) {
    float* row = lse + ((int64_t)b * H + h) * Sq;
    if (r_a < Sq)
      row[r_a] = kLn2 * (st.m_a + log2f(fmaxf(l_a, 1e-30f)));
    if (r_a + 8 < Sq)
      row[r_a + 8] = kLn2 * (st.m_b + log2f(fmaxf(l_b, 1e-30f)));
  }
  const int64_t q_stride = (int64_t)H * D;
  __nv_bfloat16* out_a = o + ((int64_t)b * Sq + r_a) * q_stride +
                         (int64_t)h * D + col0;
  __nv_bfloat16* out_b = out_a + 8 * q_stride;
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf) {
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      const int c = 2 * kO * hf + 8 * j;
      if (c + col0 >= D) continue;
      const float* a = acc[hf] + 4 * j;
      if (r_a < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out_a + c) =
            __floats2bfloat162_rn(a[0] * inv_a, a[1] * inv_a);
      if (r_a + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(out_b + c) =
            __floats2bfloat162_rn(a[2] * inv_b, a[3] * inv_b);
    }
  }
}

// One block's work: a (b, h, 128-row q tile) and the kKeys-key kv tiles that
// overlap [q0 - W + 1, q_hi] (the Pallas block skip). Blocks are numbered
// with the q tiles that visit the most kv tiles first (the short causal
// tiles fill the tail), and within a q tile the heads that share a KV head
// side by side (their k and v meet in the L2).
struct Unit {
  int b, h, q0, t0, n_tiles;
};

template <int kKeys>
__device__ __forceinline__ Unit unit_of(int u, int n_q, int B, int H, int Sq,
                                        int Sk, int window, int causal) {
  Unit w;
  const int bh = u % (B * H);
  w.h = bh % H;
  w.b = bh / H;
  w.q0 = (n_q - 1 - u / (B * H)) * kRows;
  const int q_hi = min(w.q0 + kRows, Sq) - 1;
  const int lo = window > 0 ? max(0, w.q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_hi) : Sk - 1;
  w.t0 = lo / kKeys;
  w.n_tiles = hi / kKeys - w.t0 + 1;
  return w;
}

// One block per unit, in the geometry of head size D (Geometry<D>).
template <int D>
__global__ void __launch_bounds__(kHThreads, 1)
swa_attention_hopper_kernel(__grid_constant__ const CUtensorMap tq,
                            __grid_constant__ const CUtensorMap tk,
                            __grid_constant__ const CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int B, int Sq,
                            int Sk, int H, int KV, int window, int causal,
                            float scale_log2) {
  using G = Geometry<D>;
  constexpr int kKeys = G::kKeys;
  static_assert(D > 64 * (G::kBoxes - 1) && D <= 64 * G::kBoxes, "head size");
  extern __shared__ uint8_t smem_raw[];
  // Full barriers (the producer's TMA) and release barriers (the consumer
  // warps) of the q tile and of the kStages slots of the k and v ring; k is
  // released right after its s = q k^T, v after its p v.
  __shared__ __align__(8) uint64_t bar_q, bar_k[kStages], bar_v[kStages],
      free_k[kStages], free_v[kStages];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + G::kQTile;              // kStages tiles
  uint8_t* v_s = k_s + kStages * G::kKvTile;   // kStages tiles
  const Unit w = unit_of<kKeys>(blockIdx.x, (Sq + kRows - 1) / kRows, B, H,
                                Sq, Sk, window, causal);

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&free_k[s], kConsumers / 32);
      mbar_init(&free_v[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Tile n of the unit sits in ring slot n % kStages, in use for the
  // (n / kStages)-th time.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    // Producer warpgroup (one thread works): q, then the kv tiles into the
    // ring as slots free.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        G::kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      const int g = w.h / (H / KV);
      mbar_expect_tx(&bar_q, G::kQTile);
      for (int c = 0; c < G::kBoxes; ++c)
        tma_load(q_s + c * kRows * 128, &tq, &bar_q, c * kBoxCols, w.h, w.q0,
                 w.b);
      for (int n = 0; n < w.n_tiles; ++n) {
        const int s = n % kStages;
        const uint32_t par = (n / kStages - 1) & 1;   // the slot's last use
        const int k0 = (w.t0 + n) * kKeys;
        if (n >= kStages) mbar_wait(&free_k[s], par);
        mbar_expect_tx(&bar_k[s], G::kKvTile);
        for (int c = 0; c < G::kBoxes; ++c)
          tma_load(k_s + s * G::kKvTile + c * kKeys * 128, &tk, &bar_k[s],
                   c * kBoxCols, g, k0, w.b);
        if (n >= kStages) mbar_wait(&free_v[s], par);
        mbar_expect_tx(&bar_v[s], G::kKvTile);
        for (int c = 0; c < G::kBoxes; ++c)
          tma_load(v_s + s * G::kKvTile + c * kKeys * 128, &tv, &bar_v[s],
                   c * kBoxCols, g, k0, w.b);
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg .. + 63, the thread's
    // rows q0 + row0 and q0 + row0 + 8. Tile i's s = q k^T runs on the
    // tensor cores while tile i - 1's p v is still in flight, and the
    // softmax of tile i then overlaps that p v.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
        G::kConsumerRegs));
    const int wg = warp / 4;
    const int row0 = 64 * wg + 16 * (warp % 4) + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = smem_u32(q_s) + wg * 64 * 128;
    const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
    const int r_wg = w.q0 + 64 * wg, r_a = w.q0 + row0;
    float acc[G::kHalves][G::kO], s[G::kS];
    uint32_t p_hi[G::kP], p_lo[G::kP];
    float al_a, al_b;
#pragma unroll
    for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
      for (int e = 0; e < G::kO; ++e) acc[hf][e] = 0.0f;
#pragma unroll
    for (int e = 0; e < G::kS; ++e) s[e] = 0.0f;

    Rows st{kMasked, kMasked, 0.0f, 0.0f};
    mbar_wait(&bar_q, 0);
    mbar_wait(&bar_k[0], 0);
    wgmma_fence();
    issue_qk<G::kBoxes, kKeys>(s, q_addr, k_addr);
    wgmma_wait<0>();
    fence_regs(s);
    release(&free_k[0], lane);
    softmax_tile<kKeys>(s, st, al_a, al_b, w.t0 * kKeys, r_wg, r_a, col0, Sk,
                        window, causal, scale_log2);
    split_bf16(s, p_hi, p_lo);
    for (int i = 1; i < w.n_tiles; ++i) {
      const int sn = i % kStages, sp = (i - 1) % kStages;
      mbar_wait(&bar_k[sn], (i / kStages) & 1);
      mbar_wait(&bar_v[sp], ((i - 1) / kStages) & 1);
      fence_acc(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
      issue_qk<G::kBoxes, kKeys>(s, q_addr, k_addr + sn * G::kKvTile);  // i
      issue_pv<G::kHalves, G::kO, kKeys>(acc, p_hi, p_lo,
                                         v_addr + sp * G::kKvTile);   // i - 1
      wgmma_wait<1>();
      fence_regs(s);
      release(&free_k[sn], lane);
      softmax_tile<kKeys>(s, st, al_a, al_b, (w.t0 + i) * kKeys, r_wg, r_a,
                          col0, Sk, window, causal, scale_log2);
      wgmma_wait<0>();
      fence_acc(acc);
      release(&free_v[sp], lane);
#pragma unroll
      for (int hf = 0; hf < G::kHalves; ++hf)
#pragma unroll
        for (int e = 0; e < G::kO; ++e) acc[hf][e] *= (e & 2) ? al_b : al_a;
      split_bf16(s, p_hi, p_lo);
    }
    // The last tile's p v.
    const int last = w.n_tiles - 1, sl = last % kStages;
    mbar_wait(&bar_v[sl], (last / kStages) & 1);
    fence_acc(acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
    issue_pv<G::kHalves, G::kO, kKeys>(acc, p_hi, p_lo,
                                       v_addr + sl * G::kKvTile);
    wgmma_wait<0>();
    fence_acc(acc);
    store_rows<D, G::kHalves, G::kO>(o, lse, acc, st, w.b, w.h, r_a, col0, Sq,
                                     H);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Sk, int H, int KV, int window,
                int causal, float scale, cudaStream_t stream) {
  using G = Geometry<D>;
  const int64_t n_units = (int64_t)((Sq + kRows - 1) / kRows) * B * H;
  if (n_units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return (int)bound;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode_map(enc, &tq, q, B, Sq, H, D, kRows) ||
      !encode_map(enc, &tk, k, B, Sk, KV, D, G::kKeys) ||
      !encode_map(enc, &tv, v, B, Sk, KV, D, G::kKeys))
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        swa_attention_hopper_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  swa_attention_hopper_kernel<D><<<(unsigned)n_units, kHThreads, G::kSmem,
                                   stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, B, Sq, Sk, H, KV,
      window, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// Both kernels of head size D, by dtype.
template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KV, int window, int causal,
           float scale, int dtype, cudaStream_t stream) {
  return dtype == 0 ? launch_f32<D>(q, k, v, o, lse, B, Sq, Sk, H, KV, window,
                                    causal, scale, stream)
                    : launch_bf16<D>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                     window, causal, scale, stream);
}

}  // namespace

// Attention over contiguous q (B, Sq, H, D) and k, v (B, Sk, KV, D), all of
// one dtype (0 = fp32, 1 = bf16), into o (B, Sq, H, D) of that dtype and,
// unless lse is null, each row's fp32 log-sum-exp into lse (B, H, Sq).
// window <= 0 means no window; causal is 0 or 1; D is 64, 120, 128 or 256;
// H a multiple of KV; the pointers 16-byte aligned. Returns 0 or a
// cudaError_t.
extern "C" int repro_swa_attention(const void* q, const void* k, const void* v,
                                   void* o, void* lse_out, int64_t B, int64_t Sq, int64_t Sk,
                                   int64_t H, int64_t KV, int64_t D,
                                   int64_t window, int causal, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV ||
      B > 65535 || H > 65535 || Sq > 0x7fffffff - kRows || Sk > 0x7fffffff ||
      window > 0x7fffffff || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int w = window > 0 ? (int)window : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = (int)B, sq = (int)Sq, sk = (int)Sk, h = (int)H, kv = (int)KV;
  float* lse = static_cast<float*>(lse_out);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, b, sq, sk, h, kv, w, causal, scale,
                        dtype, s);
    case 120:
      return launch<120>(q, k, v, o, lse, b, sq, sk, h, kv, w, causal, scale,
                         dtype, s);
    case 128:
      return launch<128>(q, k, v, o, lse, b, sq, sk, h, kv, w, causal, scale,
                         dtype, s);
    case 256:
      return launch<256>(q, k, v, o, lse, b, sq, sk, h, kv, w, causal, scale,
                         dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
