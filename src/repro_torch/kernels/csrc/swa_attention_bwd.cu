// The backward of sliding-window causal attention (flash schedule) for
// Hopper (sm_90a).
//
// For each (b, h) with the forward's log-sum-exp lse (B, H, Sq), query and
// key positions both counted from 0 and the forward's mask (key j is seen
// by query i unless (causal and j > i) or (window and j <= i - W)):
//     delta_i = sum_d do_id o_id                      (fp32)
//     p_ij    = exp(s_ij * D^-1/2 - lse_i)            (0 where masked)
//     dv_j   += p_ij do_i          dp_ij = do_i . v_j
//     ds_ij   = p_ij (dp_ij - delta_i) D^-1/2
//     dq_i   += ds_ij k_j          dk_j += ds_ij q_i
// q, o, do, dq are (B, Sq, H, D); k, v, dk, dv (B, Sk, KV, D), not
// repeated: head h reads KV head h / (H / KV), so dk and dv of a KV head
// sum over the H / KV query heads of its group (the gradient of the JAX
// package's _repeat_kv). Inputs are fp32 or bf16, D is 64, 120, 128 or 256
// (D = 256: kernels of their own, below); every product accumulates in fp32
// and the results are cast to the input type. Sq and Sk may differ and the
// mask may be off (causal 0, no window: the encoder's self-attention and
// the cross-attention of whisper-small); every walk below covers both.
//
// Replaces no Pallas kernel: the JAX package's training attention is the
// jnp flash_attention custom VJP, whose backward _flash_bwd
// (src/repro/models/attention.py:224-260) scans the kv chunks with the
// same formulas. The port's forward is the hand-written swa_attention
// kernel, so its gradient is written by hand as well.
//
// Every call is a fixed walk with no atomics, so a shape's result repeats
// bitwise: a dq kernel, then a dk / dv kernel, on one stream.
//
// bf16: tensor cores (swa_bwd_dq_hopper_kernel, swa_bwd_dkdv_hopper_kernel).
// Bound: five products of 2*D FLOP per unmasked (i, j) pair (s, dp, dv, dq,
// dk) on the bf16 tensor cores; at the LM step's (2, 1024, 32 / 8 heads of
// 120) that is 40 GFLOP (41 us at 989 TFLOP/s) against 79 MB of q, k, v, o,
// do, lse and dq, dk, dv (24 us): operations bound it. The design executes
// about twice that: the dq kernel computes s and dp once more (7 products
// in all), p and ds keep fp32 accuracy as bf16 hi + lo (dv, dq and dk run
// twice: 10 products), D = 120 is padded to 128 and the diagonal tiles are
// computed whole. Both kernels have one shape:
// - one block of 384 threads per unit, the units that walk the most tiles
//   first: a producer warpgroup in which one thread issues TMA (4-d tensor
//   maps, 64-column x 64-row boxes with the 128-byte swizzle; columns past
//   D and rows past S arrive as zeros) and two consumer warpgroups;
//   setmaxnreg moves registers from the producer (24 a thread) to the
//   consumers (240);
// - the unit's own rows load once; the producer streams the other side's
//   64-row tiles through a ring of kStages slots (an mbarrier each for its
//   load and its release);
// - dq: a unit is (b, h, 128 query rows); each consumer warpgroup takes 64
//   of the rows, and both work on every streamed k / v tile (a tile none of
//   whose keys its rows see, it skips), into a 64 x D fp32 accumulator (64
//   registers a thread; 32 at D = 64). Per tile: s = q k^T and dp = do v^T
//   by m64n64k16 wgmmas (both operands K-major in shared memory; 8 k-steps,
//   4 at D = 64), p = exp2(s D^-1/2 log2 e - lse log2 e) and ds = p (dp -
//   delta) D^-1/2 in registers, then dq += ds k by m64n128k16 wgmmas
//   (m64n64k16 at D = 64, whose tiles are one 64-column box: an n128
//   product would read a box that is not there) with ds from registers and
//   the k tile as the MN-major B operand. Its consumers also form delta (from o and
//   do) and lse log2 e for their rows and write both, padded to whole
//   128-row tiles (lse past Sq is +inf, so p is 0 there), to the fp32
//   scratch from which the dk / dv kernel's producer loads them;
// - dk / dv: a unit is (b, KV head, 64 keys) holding dk and dv (two
//   accumulators, 128 registers a thread; 64 at D = 64); the q, do, lse and
//   delta tiles of each query head of the group stream in order, and the
//   two consumer warpgroups take them in turn (even ones the first, odd
//   ones the second). Per tile: s^T = k q^T and dp^T = v do^T, p^T and ds^T, then
//   dv += p^T do and dk += ds^T q with the q and do tiles as MN-major B.
//   At the end the second warpgroup's sums pass through shared memory to
//   the first, which adds them (always in that order) and stores bf16.
//   256 units at the LM step's shape, so 64-key units (and not 128) keep
//   the causal work of 132 SMs even;
// - p and ds enter every product that uses them as bf16 hi = bf16(x) plus
//   lo = bf16(x - hi) (|x - hi - lo| <= 2^-17 |x|): the card's error rule
//   needs it, one bf16 rounding breaks it (tests/test_torch_swa.py). A
//   warpgroup runs score products, elementwise and accumulating products in
//   turn, the other warpgroup filling the tensor cores meanwhile; in dk /
//   dv at D = 120 / 128, s, dp and the four split fragments beside the two
//   accumulators leave too few registers for ptxas to keep its wgmmas in
//   flight together (it serialises them, C7512); at D = 64 the halved
//   accumulators leave enough (168 registers, no spill, no C7512);
// - masks are applied only on the tiles they reach; units walk only the
//   tiles inside the window: O(S * W) work.
//
// fp32: swa_bwd_dq_kernel and swa_bwd_dkdv_kernel on the CUDA cores (fp32
// products on the tensor cores would need TF32, which the port's numerics
// rule out), the same two-kernel walk with 64-row tiles: the dq kernel
// stages q, do and (first) o in shared memory, writes delta for its rows,
// then walks the kv tiles of its window (s and dp for 4 query rows x 4 keys
// a thread, ds through shared memory, dq += ds k into 32 registers a
// thread); the dk / dv kernel stages k and v, then walks the group's query
// heads and the q tiles that see its keys (p and ds through shared memory,
// dv += p^T do and dk += ds^T q into 64 registers a thread). Tiles are fp32
// with a row stride of D + 4 floats: 150 KB and 167 KB of dynamic shared
// memory, one block per SM. At D = 256 a thread covers four column groups
// (64 and 128 accumulator registers) and the kernels stage one streamed
// tile at a time (kLean: 213 KB each). Bound: 14*D FLOP per pair with the
// recomputation, at 67 TFLOP/s; every operand of the inner loops comes from
// shared memory, so the shared-memory loads, not the FMAs, limit them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

using namespace repro_hopper;

// --- fp32: CUDA cores ----------------------------------------------------

constexpr int kT = 64;           // rows of a q tile and of a k tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPS = kT + 4;      // row stride of the p / ds tiles (floats)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float x) {
  x = fmaf(a.x, b.x, x);
  x = fmaf(a.y, b.y, x);
  x = fmaf(a.z, b.z, x);
  return fmaf(a.w, b.w, x);
}

__device__ __forceinline__ float lane4(float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// 64 rows of D elements (row r at src + r * stride) into dst (row stride
// D + 4); rows at or past `valid` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t stride, int valid) {
  for (int idx = threadIdx.x; idx < kT * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[r * (D + 4) + c] = r < valid ? src[r * stride + c] : 0.0f;
  }
}

__device__ __forceinline__ bool seen(int qp, int kp, int Sq, int Sk,
                                     int window, int causal) {
  return qp < Sq && kp < Sk && !(causal && kp > qp) &&
         !(window > 0 && kp <= qp - window);
}

// Column groups of 64 a thread row covers: its columns are 64 g + 4 tx ..
// 64 g + 4 tx + 3 for g < kGroups (those below D).
template <int D>
constexpr int kGroups = (D + 63) / 64;

// Row r's 4 x (4 kGroups) accumulator into dst.
template <int D>
__device__ __forceinline__ void store_row(float* dst,
                                          const float (&acc)[4 * kGroups<D>],
                                          int tx) {
#pragma unroll
  for (int g = 0; g < kGroups<D>; ++g) {
    if (64 * g + 4 * tx >= D) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[64 * g + 4 * tx + c] = acc[4 * g + c];
  }
}

// acc[i][4g..4g+3] += a_i * (row's columns 64 g + 4tx ..), for the 4 rows
// of a thread, over the 64 rows of `rows` weighted by w_s (row stride
// kPS): acc[i] += sum_r w_s[(4ty + i) * kPS + r] * rows[r].
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][4 * kGroups<D>],
                                           const float* w_s, const float* rows,
                                           int tx, int ty) {
  constexpr int DP = D + 4, NG = kGroups<D>;
#pragma unroll 2
  for (int r = 0; r < kT; r += 4) {
    float4 wa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wa[i] = load4(w_s + (4 * ty + i) * kPS + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float* row = rows + (r + rr) * DP;
      float4 a[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g)
        a[g] = 64 * g + 4 * tx < D ? load4(row + 64 * g + 4 * tx)
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = lane4(wa[i], rr);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          acc[i][4 * g] = fmaf(w, a[g].x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(w, a[g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(w, a[g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(w, a[g].w, acc[i][4 * g + 3]);
        }
      }
    }
  }
}

// x[i][c] = a row (4ty + i) . b row (tx + 16c): one 64 x 64 score tile.
template <int D>
__device__ __forceinline__ void one_score(float (&x)[4][4], const float* a,
                                          const float* b, int tx, int ty) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 aa[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) aa[i] = load4(a + (4 * ty + i) * DP + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) bb[c] = load4(b + (tx + 16 * c) * DP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[i][c] = dot4(aa[i], bb[c], x[i][c]);
  }
}

// x[i][c] = a row (4ty + i) . b row (tx + 16c), y likewise for (a2, b2):
// two 64 x 64 score tiles in one pass over D.
template <int D>
__device__ __forceinline__ void two_scores(float (&x)[4][4], float (&y)[4][4],
                                           const float* a, const float* b,
                                           const float* a2, const float* b2,
                                           int tx, int ty) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = y[i][c] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 aa[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) aa[i] = load4(a + (4 * ty + i) * DP + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) bb[c] = load4(b + (tx + 16 * c) * DP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[i][c] = dot4(aa[i], bb[c], x[i][c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) aa[i] = load4(a2 + (4 * ty + i) * DP + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) bb[c] = load4(b2 + (tx + 16 * c) * DP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) y[i][c] = dot4(aa[i], bb[c], y[i][c]);
  }
}

// D = 256 does not fit four staged 64 x (D + 4) tiles (266 KB), so there the
// kernels stage one streamed tile at a time ("lean"): dq loads v, forms dp,
// then k, forms s and ds and accumulates ds k with k still staged; dk / dv
// stage do, form dp^T, then q, form s^T, p^T and ds^T, accumulate ds^T q,
// then stage do again for p^T do. The sums' order is the same as with
// both tiles staged.
template <int D>
constexpr bool kLean = D > 128;

// One block an SM (the staged tiles take most of its shared memory), so
// ptxas may give a thread up to 255 registers.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
swa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ delta, float* __restrict__ dq, int Sq,
                  int Sk, int H, int KV, int window, int causal, float scale) {
  constexpr int DP = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // kT x DP
  float* do_s = q_s + kT * DP;       // kT x DP
  float* k_s = do_s + kT * DP;       // kT x DP (o first, for delta)
  // kT x DP; lean: v shares k's tile
  float* v_s = kLean<D> ? k_s : k_s + kT * DP;
  float* ds_s = v_s + kT * DP;       // kT x kPS
  float* lse_s = ds_s + kT * kPS;    // kT
  float* dl_s = lse_s + kT;          // kT

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;   // long tiles first
  const int q_hi = min(q0 + kT, Sq) - 1;
  const int nq = q_hi - q0 + 1;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KV * D;
  const int64_t q_off = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;
  const int64_t row0 = ((int64_t)b * H + h) * Sq + q0;   // lse / delta
  const float* k_bh = k + (int64_t)b * Sk * kv_stride + (int64_t)g * D;
  const float* v_bh = v + (int64_t)b * Sk * kv_stride + (int64_t)g * D;

  load_tile<D>(q_s, q + q_off, q_stride, nq);
  load_tile<D>(do_s, dout + q_off, q_stride, nq);
  load_tile<D>(k_s, o + q_off, q_stride, nq);
  __syncthreads();
  {  // delta = sum_d do * o: four threads a row
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    float x = 0.0f;
    for (int c = part; c < D; c += 4)
      x = fmaf(do_s[r * DP + c], k_s[r * DP + c], x);
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (part == 0) {
      dl_s[r] = x;
      lse_s[r] = r < nq ? lse[row0 + r] : 0.0f;
      if (r < nq) delta[row0 + r] = x;
    }
  }

  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_hi) : Sk - 1;
  float acc[4][4 * kGroups<D>];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kGroups<D>; ++c) acc[i][c] = 0.0f;

  for (int k0 = (lo / kT) * kT; k0 <= hi; k0 += kT) {
    float s[4][4], dp[4][4];
    __syncthreads();   // o (first tile), the previous k, v and ds are read
    if constexpr (kLean<D>) {
      load_tile<D>(v_s, v_bh + k0 * kv_stride, kv_stride, Sk - k0);
      __syncthreads();
      one_score<D>(dp, do_s, v_s, tx, ty);
      __syncthreads();
      load_tile<D>(k_s, k_bh + k0 * kv_stride, kv_stride, Sk - k0);
      __syncthreads();
      one_score<D>(s, q_s, k_s, tx, ty);
    } else {
      load_tile<D>(k_s, k_bh + k0 * kv_stride, kv_stride, Sk - k0);
      load_tile<D>(v_s, v_bh + k0 * kv_stride, kv_stride, Sk - k0);
      __syncthreads();
      two_scores<D>(s, dp, q_s, k_s, do_s, v_s, tx, ty);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = tx + 16 * c;
        const float p = seen(q0 + r, k0 + kc, Sq, Sk, window, causal)
                            ? expf(s[i][c] * scale - lse_s[r])
                            : 0.0f;
        ds_s[r * kPS + kc] = p * (dp[i][c] - dl_s[r]) * scale;
      }
    }
    __syncthreads();
    accumulate<D>(acc, ds_s, k_s, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r < nq) store_row<D>(dq + q_off + r * q_stride, acc[i], tx);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
swa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int Sq, int Sk, int H, int KV,
                    int window, int causal, float scale) {
  constexpr int DP = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // kT x DP
  float* v_s = k_s + kT * DP;        // kT x DP
  float* q_s = v_s + kT * DP;        // kT x DP
  // kT x DP; lean: do shares q's tile
  float* do_s = kLean<D> ? q_s : q_s + kT * DP;
  float* p_s = do_s + kT * DP;       // kT x kPS: p^T (keys x query rows)
  // kT x kPS: ds^T; lean: shares p's tile
  float* ds_s = kLean<D> ? p_s : p_s + kT * kPS;
  float* lse_s = ds_s + kT * kPS;    // kT
  float* dl_s = lse_s + kT;          // kT

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int g = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kT;
  const int k_hi = min(k0 + kT, Sk) - 1;
  const int rep = H / KV;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KV * D;
  const int64_t kv_off = ((int64_t)b * Sk + k0) * kv_stride + (int64_t)g * D;

  load_tile<D>(k_s, k + kv_off, kv_stride, k_hi - k0 + 1);
  load_tile<D>(v_s, v + kv_off, kv_stride, k_hi - k0 + 1);

  // The query rows that see a key of this tile.
  const int lo = causal ? k0 : 0;
  const int hi = window > 0 ? min(Sq - 1, k_hi + window - 1) : Sq - 1;
  float dk_acc[4][4 * kGroups<D>], dv_acc[4][4 * kGroups<D>];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * kGroups<D>; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    const int64_t row_h = ((int64_t)b * H + h) * Sq;
    for (int q0 = (lo / kT) * kT; q0 <= hi; q0 += kT) {
      const int nq = min(kT, Sq - q0);
      const int64_t q_off = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;
      float s[4][4], dp[4][4];
      __syncthreads();   // the previous q, do, p and ds are read
      if constexpr (kLean<D>)
        load_tile<D>(do_s, dout + q_off, q_stride, nq);
      else {
        load_tile<D>(q_s, q + q_off, q_stride, nq);
        load_tile<D>(do_s, dout + q_off, q_stride, nq);
      }
      if (threadIdx.x < kT) {
        const int r = threadIdx.x;
        lse_s[r] = r < nq ? lse[row_h + q0 + r] : 0.0f;
        dl_s[r] = r < nq ? delta[row_h + q0 + r] : 0.0f;
      }
      __syncthreads();

      // s^T and dp^T: keys 4ty + i against query rows tx + 16c
      if constexpr (kLean<D>) {
        one_score<D>(dp, v_s, do_s, tx, ty);
        __syncthreads();
        load_tile<D>(q_s, q + q_off, q_stride, nq);
        __syncthreads();
        one_score<D>(s, k_s, q_s, tx, ty);
      } else {
        two_scores<D>(s, dp, k_s, q_s, v_s, do_s, tx, ty);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = 4 * ty + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = tx + 16 * c;
          const float p = seen(q0 + r, k0 + kr, Sq, Sk, window, causal)
                              ? expf(s[i][c] * scale - lse_s[r])
                              : 0.0f;
          s[i][c] = p;
          dp[i][c] = p * (dp[i][c] - dl_s[r]) * scale;
          if constexpr (!kLean<D>) {
            p_s[kr * kPS + r] = p;
            ds_s[kr * kPS + r] = dp[i][c];
          }
        }
      }
      if constexpr (kLean<D>) {
        // ds^T q with q staged, then p^T do with do staged again
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) ds_s[(4 * ty + i) * kPS + tx + 16 * c] =
              dp[i][c];
        __syncthreads();
        accumulate<D>(dk_acc, ds_s, q_s, tx, ty);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) p_s[(4 * ty + i) * kPS + tx + 16 * c] =
              s[i][c];
        load_tile<D>(do_s, dout + q_off, q_stride, nq);
        __syncthreads();
        accumulate<D>(dv_acc, p_s, do_s, tx, ty);
      } else {
        __syncthreads();
        accumulate<D>(dv_acc, p_s, do_s, tx, ty);
        accumulate<D>(dk_acc, ds_s, q_s, tx, ty);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = 4 * ty + i;
    if (k0 + kr > k_hi) continue;
    store_row<D>(dk + kv_off + kr * kv_stride, dk_acc[i], tx);
    store_row<D>(dv + kv_off + kr * kv_stride, dv_acc[i], tx);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
               int window, int causal, float scale, cudaStream_t stream) {
  constexpr int DP = D + 4;
  // Staged tiles: dq q, do, k, v (lean: k and v share one); dk / dv k, v,
  // q, do (lean: q and do share one) and p, ds (lean: one).
  constexpr int kTiles = kLean<D> ? 3 : 4;
  constexpr int kSmemDq =
      (kTiles * kT * DP + kT * kPS + 2 * kT) * (int)sizeof(float);
  constexpr int kSmemDkdv =
      (kTiles * kT * DP + (kLean<D> ? 1 : 2) * kT * kPS + 2 * kT) *
      (int)sizeof(float);
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        swa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemDq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(swa_bwd_dkdv_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemDkdv);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const dim3 grid_q((unsigned)((Sq + kT - 1) / kT), (unsigned)H, (unsigned)B);
  swa_bwd_dq_kernel<D><<<grid_q, kThreads, kSmemDq, stream>>>(
      tq, tk, tv, static_cast<const float*>(o), tdo, lse, delta,
      static_cast<float*>(dq), Sq, Sk, H, KV, window, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((unsigned)((Sk + kT - 1) / kT), (unsigned)KV, (unsigned)B);
  swa_bwd_dkdv_kernel<D><<<grid_k, kThreads, kSmemDkdv, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Sk, H, KV, window, causal, scale);
  return (int)cudaGetLastError();
}

// --- bf16: tensor cores, TMA, a tile ring --------------------------------

constexpr int kQRows = 2 * kT;            // q rows of a dq block
constexpr int kStages = 4;                // ring depth
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kHThreads = kConsumers + 128;  // + the producer warpgroup
// Registers a thread after setmaxnreg: 128 x 24 + 256 x 240 <= 65,536.
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// A slot's 64 lse * log2 e and 64 delta (512 bytes), padded so that the
// slots stay 1024-byte aligned for the swizzle.
constexpr int kStatBytes = 1024;
constexpr float kLog2e = 1.4426950408889634f;

// D = 64, 120 or 128: a row is kBoxes 64-column boxes (D = 120 padded to
// 128), a 64-row tile kTileB bytes, the dq / dk / dv accumulators m64nN
// fragments of N = 64 kBoxes columns (kAccN = N / 2 registers a thread),
// and a product that contracts over D kSteps 16-column k-steps.
template <int D>
constexpr int kBoxes = (D + kBoxCols - 1) / kBoxCols;
template <int D>
constexpr int kTileB = kBoxes<D> * kT * 128;
template <int D>
constexpr int kAccN = 32 * kBoxes<D>;
template <int D>
constexpr int kSteps = 4 * kBoxes<D>;

// acc (64 x N, fp32) += a (64 x 16, bf16 pairs in registers) x b (16 x N,
// MN-major in shared memory), N = 2 R: the m64n64k16 or m64n128k16 wgmma.
template <int R>
__device__ __forceinline__ void wgmma_rs(float (&acc)[R], const uint32_t* a,
                                         uint64_t db) {
  static_assert(R == 32 || R == 64, "an m64n64 or m64n128 accumulator");
  if constexpr (R == 32)
    wgmma_rs_n64(acc, a, db);
  else
    wgmma_rs_n128(acc, a, db);
}

// delta (fp32 sum of do * o) and lse * log2 e of query row r of (b, h),
// from the four lanes of a row (part = lane % 4, 16-byte loads); past Sq
// delta is 0 and lse * log2 e is +inf. Every lane of the warp calls it.
template <int D>
__device__ __forceinline__ void row_stats(const __nv_bfloat16* __restrict__ o,
                                          const __nv_bfloat16* __restrict__ dout,
                                          const float* __restrict__ lse, int b,
                                          int h, int r, int Sq, int H,
                                          int part, float& lse2, float& dl) {
  float x = 0.0f;
  if (r < Sq) {
    const int64_t base = (((int64_t)b * Sq + r) * H + h) * D;
    for (int c = part; c < D / 8; c += 4) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + base + 8 * c);
      const uint4 g = *reinterpret_cast<const uint4*>(dout + base + 8 * c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fa = __bfloat1622float2(a2[i]);
        const float2 fg = __bfloat1622float2(g2[i]);
        x = fmaf(fg.x, fa.x, x);
        x = fmaf(fg.y, fa.y, x);
      }
    }
  }
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  dl = x;
  lse2 = r < Sq ? lse[((int64_t)b * H + h) * Sq + r] * kLog2e : INFINITY;
}

// Rows r_a and r_a + 8 (where below S) of an fp32 64 x (2 N) accumulator
// (N = 32: 64 columns, 64: 128) into a (B, S, heads, D) bf16 tensor at (b,
// head): columns c0 + 8j + col0 + {0, 1} (c0: 128 for the second half of a
// D = 256 row).
template <int D, int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ out,
                                          const float (&acc)[N], int b,
                                          int head, int r_a, int col0, int S,
                                          int heads, int c0 = 0) {
  const int64_t stride = (int64_t)heads * D;
  __nv_bfloat16* out_a =
      out + ((int64_t)b * S + r_a) * stride + (int64_t)head * D + c0 + col0;
  __nv_bfloat16* out_b = out_a + 8 * stride;
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    if (c0 + 8 * j + col0 >= D) continue;
    if (r_a < S)
      *reinterpret_cast<__nv_bfloat162*>(out_a + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (r_a + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(out_b + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The two consumer warpgroups' sums, first + second: the second warpgroup
// (wg 1) writes its accumulators to buf, the first adds them to its own.
// buf holds N x 128 floats; element e of thread t at e * 128 + t.
template <int N>
__device__ __forceinline__ void combine(float (&acc)[N], float* buf, int wg,
                                        int t) {
  named_sync(1, kConsumers);          // both are done with the ring
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < N; ++e) buf[e * 128 + t] = acc[e];
  }
  named_sync(1, kConsumers);
  if (wg == 0) {
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] += buf[e * 128 + t];
  }
}

// dq kernel: one block per (b, h, 128-row q tile), the first consumer
// warpgroup on its rows 0..63, the second on 64..127; the K/V tiles stream.
template <int D>
__global__ void __launch_bounds__(kHThreads, 1)
swa_bwd_dq_hopper_kernel(__grid_constant__ const CUtensorMap tq,
                         __grid_constant__ const CUtensorMap tk,
                         __grid_constant__ const CUtensorMap tv,
                         __grid_constant__ const CUtensorMap tdo,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, float* __restrict__ ws,
                         __nv_bfloat16* __restrict__ dq, int B, int Sq, int Sk,
                         int H, int KV, int window, int causal, float scale,
                         float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // Full barriers (the producer's TMA) of q / do and of the ring's slots,
  // release barriers of the slots (the eight consumer warps).
  __shared__ __align__(8) uint64_t bar_q, full[kStages], empty[kStages];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  constexpr int kTile = kTileB<D>, kAcc = kAccN<D>;
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* do_s = q_s + 2 * kTile;         // q and do: 128 rows each
  uint8_t* ring = do_s + 2 * kTile;        // kStages x (k tile, v tile)

  const int n_q = (Sq + kQRows - 1) / kQRows;
  const int bh = blockIdx.x % (B * H);
  const int h = bh % H, b = bh / H;
  const int q0 = (n_q - 1 - (int)blockIdx.x / (B * H)) * kQRows;  // long first
  const int q_hi = min(q0 + kQRows, Sq) - 1;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_hi) : Sk - 1;
  const int t0 = lo / kT, n_tiles = hi / kT - t0 + 1;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    // Producer: q and do, then the k and v tiles into the ring as slots free.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      const int g = h / (H / KV);
      // The second 64 rows only where some lie below Sq (the second
      // warpgroup computes nothing otherwise).
      const int n_boxes = q0 + kT < Sq ? 2 : 1;
      mbar_expect_tx(&bar_q, 2 * n_boxes * kTile);
      for (int c = 0; c < kBoxes<D>; ++c)
        for (int r = 0; r < n_boxes * kT; r += kT) {
          const int off = c * kQRows * 128 + r * 128;
          tma_load(q_s + off, &tq, &bar_q, c * kBoxCols, h, q0 + r, b);
          tma_load(do_s + off, &tdo, &bar_q, c * kBoxCols, h, q0 + r, b);
        }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(&empty[s], (n / kStages - 1) & 1);
        uint8_t* slot = ring + s * 2 * kTile;
        const int k0 = (t0 + n) * kT;
        mbar_expect_tx(&full[s], 2 * kTile);
        for (int c = 0; c < kBoxes<D>; ++c) {
          tma_load(slot + c * kT * 128, &tk, &full[s], c * kBoxCols, g, k0, b);
          tma_load(slot + kTile + c * kT * 128, &tv, &full[s],
                   c * kBoxCols, g, k0, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4;
  const int r_wg = q0 + kT * wg;                       // the warpgroup's rows
  const int r_a = r_wg + 16 * (warp % 4) + lane / 4;   // and r_a + 8
  const int col0 = 2 * (lane % 4);
  float ls_a, ls_b, dl_a, dl_b;
  row_stats<D>(o, dout, lse, b, h, r_a, Sq, H, lane % 4, ls_a, dl_a);
  row_stats<D>(o, dout, lse, b, h, r_a + 8, Sq, H, lane % 4, ls_b, dl_b);
  if (lane % 4 == 0) {
    // For the dk / dv kernel: lse * log2 e, then delta, (B * H, sq_pad).
    const int64_t sq_pad = (int64_t)n_q * kQRows;
    const int64_t plane = (int64_t)B * H * sq_pad;
    float* row = ws + (int64_t)bh * sq_pad + r_a;
    row[0] = ls_a;
    row[8] = ls_b;
    row[plane] = dl_a;
    row[plane + 8] = dl_b;
  }

  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  float acc[kAcc], s[32], dp[32];
  uint32_t ds_hi[16], ds_lo[16];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;

  mbar_wait(&bar_q, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int sl = n % kStages;
    mbar_wait(&full[sl], (n / kStages) & 1);
    const int k0 = (t0 + n) * kT;
    // A tile of which this warpgroup's rows see no key adds nothing.
    const bool none = r_wg >= Sq || (causal && k0 > r_wg + kT - 1) ||
                      (window > 0 && k0 + kT - 1 <= r_wg - window);
    if (!none) {
      const uint32_t k_addr = smem_u32(ring + sl * 2 * kTile);
      const uint32_t v_addr = k_addr + kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps<D>; ++kk)
        wgmma_ss_n64(s, kmajor_desc(q_addr, kQRows, kT * wg, kk),
                     kmajor_desc(k_addr, kT, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < kSteps<D>; ++kk)
        wgmma_ss_n64(dp, kmajor_desc(do_addr, kQRows, kT * wg, kk),
                     kmajor_desc(v_addr, kT, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const bool masked = k0 + kT > Sk || (causal && k0 + kT - 1 > r_wg) ||
                          (window > 0 && k0 <= r_wg + kT - 1 - window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const bool rb = e & 2;
        float p = fast_exp2(fmaf(s[e], scale_log2, -(rb ? ls_b : ls_a)));
        if (masked) {
          const int kp = k0 + 8 * (e / 4) + col0 + (e & 1);
          const int qp = r_a + (rb ? 8 : 0);
          if (kp >= Sk || (causal && kp > qp) ||
              (window > 0 && kp <= qp - window))
            p = 0.0f;
        }
        dp[e] = p * (dp[e] - (rb ? dl_b : dl_a)) * scale;
      }
      split_bf16(dp, ds_hi, ds_lo);
      fence_regs(acc);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dk_desc = mnmajor_desc(k_addr, kT, kk);
        wgmma_rs(acc, ds_hi + 4 * kk, dk_desc);
        wgmma_rs(acc, ds_lo + 4 * kk, dk_desc);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
    }
    release(&empty[sl], lane);
  }
  store_acc<D>(dq, acc, b, h, r_a, col0, Sq, H);
}

// dk / dv kernel: one block per (b, KV head, 64-key tile); the q, do, lse
// and delta tiles of each query head of the group stream, in order.
template <int D>
__global__ void __launch_bounds__(kHThreads, 1)
swa_bwd_dkdv_hopper_kernel(__grid_constant__ const CUtensorMap tq,
                           __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv,
                           __grid_constant__ const CUtensorMap tdo,
                           const float* __restrict__ ws,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int B, int Sq,
                           int Sk, int H, int KV, int window, int causal,
                           float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, full[kStages], empty[kStages];
  constexpr int kTile = kTileB<D>, kAcc = kAccN<D>;
  uint8_t* k_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* v_s = k_s + kTile;
  // kStages x (q tile, do tile, 64 lse * log2 e and 64 delta)
  uint8_t* ring = v_s + kTile;
  constexpr int kSlot = 2 * kTile + kStatBytes;

  const int64_t sq_pad = (int64_t)((Sq + kQRows - 1) / kQRows) * kQRows;
  const int bg = blockIdx.x % (B * KV);
  const int g = bg % KV, b = bg / KV;
  const int k0 = ((int)blockIdx.x / (B * KV)) * kT;      // long first
  const int k_hi = min(k0 + kT, Sk) - 1;
  const int rep = H / KV;
  // The query rows that see a key of this tile, in whole q tiles.
  const int lo = causal ? k0 : 0;
  const int hi = window > 0 ? min(Sq - 1, k_hi + window - 1) : Sq - 1;
  const int tq0 = lo / kT;
  const int nt = lo <= hi ? hi / kT - tq0 + 1 : 0;       // q tiles a head
  const int n_tiles = rep * nt;

  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      const int64_t plane = (int64_t)B * H * sq_pad;
      mbar_expect_tx(&bar_kv, 2 * kTile);
      for (int c = 0; c < kBoxes<D>; ++c) {
        tma_load(k_s + c * kT * 128, &tk, &bar_kv, c * kBoxCols, g, k0, b);
        tma_load(v_s + c * kT * 128, &tv, &bar_kv, c * kBoxCols, g, k0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(&empty[s], (n / kStages - 1) & 1);
        uint8_t* slot = ring + s * kSlot;
        const int h = g * rep + n / nt, q0 = (tq0 + n % nt) * kT;
        const float* stat = ws + ((int64_t)b * H + h) * sq_pad + q0;
        mbar_expect_tx(&full[s], 2 * kTile + 2 * kT * 4);
        for (int c = 0; c < kBoxes<D>; ++c) {
          tma_load(slot + c * kT * 128, &tq, &full[s], c * kBoxCols, h, q0, b);
          tma_load(slot + kTile + c * kT * 128, &tdo, &full[s],
                   c * kBoxCols, h, q0, b);
        }
        bulk_load(slot + 2 * kTile, stat, kT * 4, &full[s]);
        bulk_load(slot + 2 * kTile + kT * 4, stat + plane, kT * 4,
                  &full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int row_l = 16 * (warp % 4) + lane / 4;   // keys row_l, row_l + 8
  const int col0 = 2 * (lane % 4);
  const int kp_a = k0 + row_l;
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  float dk_acc[kAcc], dv_acc[kAcc], s[32], dp[32];
  uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) dk_acc[e] = dv_acc[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 16; ++e) p_hi[e] = p_lo[e] = ds_hi[e] = ds_lo[e] = 0u;

  mbar_wait(&bar_kv, 0);
  for (int n = wg; n < n_tiles; n += 2) {
    const int sl = n % kStages;
    mbar_wait(&full[sl], (n / kStages) & 1);
    uint8_t* slot = ring + sl * kSlot;
    const uint32_t q_addr = smem_u32(slot), do_addr = q_addr + kTile;
    const float* lse_s = reinterpret_cast<const float*>(slot + 2 * kTile);
    const float* dl_s = lse_s + kT;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps<D>; ++kk)
      wgmma_ss_n64(s, kmajor_desc(k_addr, kT, 0, kk),
                   kmajor_desc(q_addr, kT, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kSteps<D>; ++kk)
      wgmma_ss_n64(dp, kmajor_desc(v_addr, kT, 0, kk),
                   kmajor_desc(do_addr, kT, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // s^T and dp^T: keys kp_a + {0, 8} (rows) x query rows q0 + 8j + col0 +
    // {0, 1} (columns).
    const int q0 = (tq0 + n % nt) * kT;
    const bool masked = (causal && k0 + kT - 1 > q0) ||
                        (window > 0 && q0 + kT - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + col0);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * j + col0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * j + i;
        const bool c1 = i & 1;
        float p = fast_exp2(fmaf(s[e], scale_log2, -(c1 ? l2.y : l2.x)));
        if (masked) {
          const int qp = q0 + 8 * j + col0 + (c1 ? 1 : 0);
          const int kp = kp_a + ((i & 2) ? 8 : 0);
          if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
            p = 0.0f;
        }
        s[e] = p;
        dp[e] = p * (dp[e] - (c1 ? d2.y : d2.x)) * scale;
      }
    }
    split_bf16(s, p_hi, p_lo);
    split_bf16(dp, ds_hi, ds_lo);
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d_do = mnmajor_desc(do_addr, kT, kk);
      wgmma_rs(dv_acc, p_hi + 4 * kk, d_do);
      wgmma_rs(dv_acc, p_lo + 4 * kk, d_do);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d_q = mnmajor_desc(q_addr, kT, kk);
      wgmma_rs(dk_acc, ds_hi + 4 * kk, d_q);
      wgmma_rs(dk_acc, ds_lo + 4 * kk, d_q);
    }
    wgmma_commit();
    // Wait here, not at the next tile: s, dp, the four split fragments and
    // the two accumulators in flight together would take 256 registers.
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    release(&empty[sl], lane);
  }
  float* buf = reinterpret_cast<float*>(ring);
  combine(dv_acc, buf, wg, t);
  combine(dk_acc, buf + kAcc * 128, wg, t);
  if (wg == 0) {
    store_acc<D>(dv, dv_acc, b, g, kp_a, col0, Sk, KV);
    store_acc<D>(dk, dk_acc, b, g, kp_a, col0, Sk, KV);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* ws, void* dq,
                void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
                int window, int causal, float scale, cudaStream_t stream) {
  constexpr int kSmemDq = 1024 + (4 + 2 * kStages) * kTileB<D>;
  constexpr int kSmemDkdv =
      1024 + 2 * kTileB<D> + kStages * (2 * kTileB<D> + kStatBytes);
  const int64_t n_q = (Sq + kQRows - 1) / kQRows, n_k = (Sk + kT - 1) / kT;
  if (n_q * B * H > 0x7fffffff || n_k * B * KV > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return (int)bound;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_map(enc, &tq, q, B, Sq, H, D, kT) ||
      !encode_map(enc, &tk, k, B, Sk, KV, D, kT) ||
      !encode_map(enc, &tv, v, B, Sk, KV, D, kT) ||
      !encode_map(enc, &tdo, dout, B, Sq, H, D, kT))
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        swa_bwd_dq_hopper_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(swa_bwd_dkdv_hopper_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemDkdv);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const float scale_log2 = scale * kLog2e;
  swa_bwd_dq_hopper_kernel<D><<<(unsigned)(n_q * B * H), kHThreads, kSmemDq,
                                stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, ws,
      static_cast<__nv_bfloat16*>(dq), B, Sq, Sk, H, KV, window, causal, scale,
      scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  swa_bwd_dkdv_hopper_kernel<D><<<(unsigned)(n_k * B * KV), kHThreads,
                                  kSmemDkdv, stream>>>(
      tq, tk, tv, tdo, ws, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, Sq, Sk, H, KV, window, causal, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

// --- bf16 at D = 256 (gemma-7b, recurrentgemma-9b) -------------------------
//
// A 64-row tile is four boxes (32 KB), so the D <= 128 geometry no longer
// fits (dq: 128 q and do rows and a 4-slot k / v ring are 385 KB), and a
// 64 x 256 fp32 accumulator takes 128 registers a thread. Both kernels keep
// the shape above (a TMA producer warpgroup, two consumer warpgroups, 64-row
// tiles, p and ds as bf16 hi + lo, a fixed order) with a 2-slot ring:
// - dq (swa_bwd_dq_hopper_d256_kernel): a unit is (b, h, 64 query rows),
//   q and do 64 KB, the ring 128 KB (193 KB). The two warpgroups take the
//   streamed k / v tiles in turn (the first the even ones, in slot 0; the
//   second the odd ones, in slot 1), each into its own 64 x 256 dq (two
//   m64n128 halves); at the end the second's sums pass through shared
//   memory to the first, which adds them (always in that order) and stores.
// - dk / dv (swa_bwd_dkdv_hopper_d256_kernel): a unit is (b, KV head, 64
//   keys), k and v 64 KB, the ring 2 x (q, do, stats) 130 KB (195 KB). Both
//   warpgroups take every streamed tile: the first forms s^T and p^T and
//   accumulates dv += p^T do, the second forms s^T and dp^T, ds^T and
//   accumulates dk += ds^T q (s^T is formed twice: one product more than at
//   D = 128). Each holds one 64 x 256 accumulator and stores it.
// Registers: the accumulator (128), s and dp (32 each) and a split fragment
// (16 + 16) under the consumers' 240.
constexpr int kTile256 = 4 * kT * 128;    // a 64-row tile of 256 columns
constexpr int kStages256 = 2;             // ring slots
constexpr int kSlot256 = 2 * kTile256 + kStatBytes;   // dk / dv: q, do, stats

// s (64 x 64) = a b^T over 256 columns, both 64-row tiles K-major.
__device__ __forceinline__ void issue_s256(float (&s)[32], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 16; ++kk)
    wgmma_ss_n64(s, kmajor_desc(a, kT, 0, kk), kmajor_desc(b, kT, 0, kk),
                 kk > 0);
}

// acc (64 x 256, two halves) += x b for x = hi + lo (64 x 64 from
// registers) and b a 64-row tile of 256 columns (MN-major).
__device__ __forceinline__ void issue_acc256(float (&acc)[2][64],
                                             const uint32_t (&hi)[16],
                                             const uint32_t (&lo)[16],
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint64_t d = mnmajor_desc(b + hf * 2 * kT * 128, kT, kk);
      wgmma_rs_n128(acc[hf], hi + 4 * kk, d);
      wgmma_rs_n128(acc[hf], lo + 4 * kk, d);
    }
  }
}

__global__ void __launch_bounds__(kHThreads, 1)
swa_bwd_dq_hopper_d256_kernel(__grid_constant__ const CUtensorMap tq,
                              __grid_constant__ const CUtensorMap tk,
                              __grid_constant__ const CUtensorMap tv,
                              __grid_constant__ const CUtensorMap tdo,
                              const __nv_bfloat16* __restrict__ o,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              float* __restrict__ ws,
                              __nv_bfloat16* __restrict__ dq, int B, int Sq,
                              int Sk, int H, int KV, int window, int causal,
                              float scale, float scale_log2) {
  constexpr int D = 256;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, full[kStages256], empty[kStages256];
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* do_s = q_s + kTile256;
  uint8_t* ring = do_s + kTile256;         // kStages256 x (k tile, v tile)

  const int n_q = (Sq + kT - 1) / kT;
  const int bh = blockIdx.x % (B * H);
  const int h = bh % H, b = bh / H;
  const int q0 = (n_q - 1 - (int)blockIdx.x / (B * H)) * kT;   // long first
  const int q_hi = min(q0 + kT, Sq) - 1;
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_hi) : Sk - 1;
  const int t0 = lo / kT, n_tiles = hi / kT - t0 + 1;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages256; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);             // one warpgroup takes a slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      const int g = h / (H / KV);
      mbar_expect_tx(&bar_q, 2 * kTile256);
      for (int c = 0; c < 4; ++c) {
        tma_load(q_s + c * kT * 128, &tq, &bar_q, c * kBoxCols, h, q0, b);
        tma_load(do_s + c * kT * 128, &tdo, &bar_q, c * kBoxCols, h, q0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages256;
        if (n >= kStages256) mbar_wait(&empty[s], (n / kStages256 - 1) & 1);
        uint8_t* slot = ring + s * 2 * kTile256;
        const int k0 = (t0 + n) * kT;
        mbar_expect_tx(&full[s], 2 * kTile256);
        for (int c = 0; c < 4; ++c) {
          tma_load(slot + c * kT * 128, &tk, &full[s], c * kBoxCols, g, k0, b);
          tma_load(slot + kTile256 + c * kT * 128, &tv, &full[s],
                   c * kBoxCols, g, k0, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int r_a = q0 + 16 * (warp % 4) + lane / 4;    // and r_a + 8
  const int col0 = 2 * (lane % 4);
  float ls_a, ls_b, dl_a, dl_b;
  row_stats<D>(o, dout, lse, b, h, r_a, Sq, H, lane % 4, ls_a, dl_a);
  row_stats<D>(o, dout, lse, b, h, r_a + 8, Sq, H, lane % 4, ls_b, dl_b);
  if (wg == 0 && lane % 4 == 0) {
    // For the dk / dv kernel: lse * log2 e, then delta, (B * H, sq_pad).
    const int64_t sq_pad = (int64_t)((Sq + kQRows - 1) / kQRows) * kQRows;
    const int64_t plane = (int64_t)B * H * sq_pad;
    float* row = ws + (int64_t)bh * sq_pad + r_a;
    row[0] = ls_a;
    row[8] = ls_b;
    row[plane] = dl_a;
    row[plane + 8] = dl_b;
  }

  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  float acc[2][64], s[32], dp[32];
  uint32_t ds_hi[16], ds_lo[16];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[0][e] = acc[1][e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;

  mbar_wait(&bar_q, 0);
  for (int n = wg; n < n_tiles; n += 2) {
    const int sl = n % kStages256;
    mbar_wait(&full[sl], (n / kStages256) & 1);
    const int k0 = (t0 + n) * kT;
    const uint32_t k_addr = smem_u32(ring + sl * 2 * kTile256);
    const uint32_t v_addr = k_addr + kTile256;
    wgmma_fence();
    issue_s256(s, q_addr, k_addr);
    issue_s256(dp, do_addr, v_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const bool masked = k0 + kT > Sk || (causal && k0 + kT - 1 > q0) ||
                        (window > 0 && k0 <= q0 + kT - 1 - window);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const bool rb = e & 2;
      float p = fast_exp2(fmaf(s[e], scale_log2, -(rb ? ls_b : ls_a)));
      if (masked) {
        const int kp = k0 + 8 * (e / 4) + col0 + (e & 1);
        const int qp = r_a + (rb ? 8 : 0);
        if (kp >= Sk || (causal && kp > qp) ||
            (window > 0 && kp <= qp - window))
          p = 0.0f;
      }
      dp[e] = p * (dp[e] - (rb ? dl_b : dl_a)) * scale;
    }
    split_bf16(dp, ds_hi, ds_lo);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    wgmma_fence();
    issue_acc256(acc, ds_hi, ds_lo, k_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    release(&empty[sl], lane);
  }
  float* buf = reinterpret_cast<float*>(ring);
  combine(acc[0], buf, wg, t);
  combine(acc[1], buf + 64 * 128, wg, t);
  if (wg == 0) {
    store_acc<D>(dq, acc[0], b, h, r_a, col0, Sq, H, 0);
    store_acc<D>(dq, acc[1], b, h, r_a, col0, Sq, H, 128);
  }
}

__global__ void __launch_bounds__(kHThreads, 1)
swa_bwd_dkdv_hopper_d256_kernel(__grid_constant__ const CUtensorMap tq,
                                __grid_constant__ const CUtensorMap tk,
                                __grid_constant__ const CUtensorMap tv,
                                __grid_constant__ const CUtensorMap tdo,
                                const float* __restrict__ ws,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int B, int Sq,
                                int Sk, int H, int KV, int window, int causal,
                                float scale, float scale_log2) {
  constexpr int D = 256;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, full[kStages256], empty[kStages256];
  uint8_t* k_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* v_s = k_s + kTile256;
  uint8_t* ring = v_s + kTile256;          // kStages256 x (q, do, stats)

  const int64_t sq_pad = (int64_t)((Sq + kQRows - 1) / kQRows) * kQRows;
  const int bg = blockIdx.x % (B * KV);
  const int g = bg % KV, b = bg / KV;
  const int k0 = ((int)blockIdx.x / (B * KV)) * kT;      // long first
  const int k_hi = min(k0 + kT, Sk) - 1;
  const int rep = H / KV;
  const int lo = causal ? k0 : 0;
  const int hi = window > 0 ? min(Sq - 1, k_hi + window - 1) : Sq - 1;
  const int tq0 = lo / kT;
  const int nt = lo <= hi ? hi / kT - tq0 + 1 : 0;       // q tiles a head
  const int n_tiles = rep * nt;

  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < kStages256; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // both warpgroups take a slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      const int64_t plane = (int64_t)B * H * sq_pad;
      mbar_expect_tx(&bar_kv, 2 * kTile256);
      for (int c = 0; c < 4; ++c) {
        tma_load(k_s + c * kT * 128, &tk, &bar_kv, c * kBoxCols, g, k0, b);
        tma_load(v_s + c * kT * 128, &tv, &bar_kv, c * kBoxCols, g, k0, b);
      }
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % kStages256;
        if (n >= kStages256) mbar_wait(&empty[s], (n / kStages256 - 1) & 1);
        uint8_t* slot = ring + s * kSlot256;
        const int h = g * rep + n / nt, q0 = (tq0 + n % nt) * kT;
        const float* stat = ws + ((int64_t)b * H + h) * sq_pad + q0;
        mbar_expect_tx(&full[s], 2 * kTile256 + 2 * kT * 4);
        for (int c = 0; c < 4; ++c) {
          tma_load(slot + c * kT * 128, &tq, &full[s], c * kBoxCols, h, q0, b);
          tma_load(slot + kTile256 + c * kT * 128, &tdo, &full[s],
                   c * kBoxCols, h, q0, b);
        }
        bulk_load(slot + 2 * kTile256, stat, kT * 4, &full[s]);
        bulk_load(slot + 2 * kTile256 + kT * 4, stat + plane, kT * 4,
                  &full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp / 4;                 // 0: dv, 1: dk
  const int row_l = 16 * (warp % 4) + lane / 4;   // keys row_l, row_l + 8
  const int col0 = 2 * (lane % 4);
  const int kp_a = k0 + row_l;
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  float acc[2][64], s[32], dp[32];
  uint32_t x_hi[16], x_lo[16];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[0][e] = acc[1][e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.0f;

  mbar_wait(&bar_kv, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int sl = n % kStages256;
    mbar_wait(&full[sl], (n / kStages256) & 1);
    uint8_t* slot = ring + sl * kSlot256;
    const uint32_t q_addr = smem_u32(slot), do_addr = q_addr + kTile256;
    const float* lse_s = reinterpret_cast<const float*>(slot + 2 * kTile256);
    const float* dl_s = lse_s + kT;
    wgmma_fence();
    issue_s256(s, k_addr, q_addr);
    if (wg == 1) issue_s256(dp, v_addr, do_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // s^T and dp^T: keys kp_a + {0, 8} (rows) x query rows q0 + 8j + col0 +
    // {0, 1} (columns).
    const int q0 = (tq0 + n % nt) * kT;
    const bool masked = (causal && k0 + kT - 1 > q0) ||
                        (window > 0 && q0 + kT - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + col0);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + 8 * j + col0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * j + i;
        const bool c1 = i & 1;
        float p = fast_exp2(fmaf(s[e], scale_log2, -(c1 ? l2.y : l2.x)));
        if (masked) {
          const int qp = q0 + 8 * j + col0 + (c1 ? 1 : 0);
          const int kp = kp_a + ((i & 2) ? 8 : 0);
          if ((causal && kp > qp) || (window > 0 && kp <= qp - window))
            p = 0.0f;
        }
        if (wg == 0)
          s[e] = p;
        else
          dp[e] = p * (dp[e] - (c1 ? d2.y : d2.x)) * scale;
      }
    }
    if (wg == 0)
      split_bf16(s, x_hi, x_lo);
    else
      split_bf16(dp, x_hi, x_lo);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(x_hi);
    fence_regs(x_lo);
    wgmma_fence();
    issue_acc256(acc, x_hi, x_lo, wg == 0 ? do_addr : q_addr);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(x_hi);
    fence_regs(x_lo);
    release(&empty[sl], lane);
  }
  __nv_bfloat16* out = wg == 0 ? dv : dk;
  store_acc<D>(out, acc[0], b, g, kp_a, col0, Sk, KV, 0);
  store_acc<D>(out, acc[1], b, g, kp_a, col0, Sk, KV, 128);
}

int launch_bf16_d256(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* ws, void* dq, void* dk, void* dv, int B, int Sq,
                     int Sk, int H, int KV, int window, int causal,
                     float scale, cudaStream_t stream) {
  constexpr int D = 256;
  constexpr int kSmemDq = 1024 + 2 * kTile256 + kStages256 * 2 * kTile256;
  constexpr int kSmemDkdv = 1024 + 2 * kTile256 + kStages256 * kSlot256;
  const int64_t n_q = (Sq + kT - 1) / kT, n_k = (Sk + kT - 1) / kT;
  if (n_q * B * H > 0x7fffffff || n_k * B * KV > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return (int)bound;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_map(enc, &tq, q, B, Sq, H, D, kT) ||
      !encode_map(enc, &tk, k, B, Sk, KV, D, kT) ||
      !encode_map(enc, &tv, v, B, Sk, KV, D, kT) ||
      !encode_map(enc, &tdo, dout, B, Sq, H, D, kT))
    return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        swa_bwd_dq_hopper_d256_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(swa_bwd_dkdv_hopper_d256_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemDkdv);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const float scale_log2 = scale * kLog2e;
  swa_bwd_dq_hopper_d256_kernel<<<(unsigned)(n_q * B * H), kHThreads, kSmemDq,
                                  stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, ws,
      static_cast<__nv_bfloat16*>(dq), B, Sq, Sk, H, KV, window, causal, scale,
      scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  swa_bwd_dkdv_hopper_d256_kernel<<<(unsigned)(n_k * B * KV), kHThreads,
                                    kSmemDkdv, stream>>>(
      tq, tk, tv, tdo, ws, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, Sq, Sk, H, KV, window, causal, scale,
      scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// Gradients of attention over contiguous q, o, do (B, Sq, H, D) and k, v
// (B, Sk, KV, D), all of one dtype (0 = fp32, 1 = bf16), with the
// forward's fp32 lse (B, H, Sq): dq (B, Sq, H, D), dk, dv (B, Sk, KV, D) in
// that dtype. delta is fp32 scratch of 2 * B * H * ceil(Sq / 128) * 128
// floats. window <= 0 means no window; causal is 0 or 1; D is 64, 120, 128
// or 256; H a multiple of KV; the pointers 16-byte aligned. Two launches on
// `stream`.
// Returns 0 or a cudaError_t.
extern "C" int repro_swa_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
    int64_t D, int64_t window, int causal, float scale, int dtype,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV ||
      B > 65535 || H > 65535 || Sq > 0x7fffffff - kT ||
      Sk > 0x7fffffff - kT || window > 0x7fffffff ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int w = window > 0 ? (int)window : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = (int)B, sq = (int)Sq, sk = (int)Sk, h = (int)H, kv = (int)KV;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define REPRO_BWD(fn, DD)                                                     \
  fn<DD>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, sk, h, kv, w, causal,    \
         scale, s)
  if (D == 64)
    return dtype == 0 ? REPRO_BWD(launch_f32, 64) : REPRO_BWD(launch_bf16, 64);
  if (D == 120)
    return dtype == 0 ? REPRO_BWD(launch_f32, 120) : REPRO_BWD(launch_bf16, 120);
  if (D == 128)
    return dtype == 0 ? REPRO_BWD(launch_f32, 128) : REPRO_BWD(launch_bf16, 128);
  if (D == 256)
    return dtype == 0 ? REPRO_BWD(launch_f32, 256)
                      : launch_bf16_d256(q, k, v, o, dout, l, dl, dq, dk, dv, b,
                                         sq, sk, h, kv, w, causal, scale, s);
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}
