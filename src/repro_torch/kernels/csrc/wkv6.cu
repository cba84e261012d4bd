// WKV6 recurrence (the RWKV6 time-mix hot loop) for Hopper (sm_90a).
//
// Per (b, h), over t, with r_t, k_t, v_t, w_t the (D,) rows of step t:
//     y_t[j] = sum_i r_t[i] * (S[i, j] + u[i] * k_t[i] * v_t[j])
//     S      <- diag(w_t) S + k_t v_t^T
// r, k, v, w are (B, T, H, D) fp32, u is (H, D), the state S is (B, H, D, D)
// fp32 keyed [key i][value j], D = 64. Returns y (B, T, H, D) and the final
// state; the final state may be written over the initial one (in place).
//
// Replaces the Pallas TPU kernel wkv6_pallas (src/repro/kernels/wkv6.py:56,
// body _wkv6_kernel at :25). That kernel runs a grid of (B*H, T/chunk) and
// carries S in a VMEM scratch from one chunk to the next, which works
// because a TPU runs the grid in order. Hopper blocks run in no order, so
// here the chunk grid becomes a loop over t inside one block, and the block
// takes no chunk size.
//
// Bound. Per call 4*B*T*H*D*4 bytes in (r, k, v, w), B*T*H*D*4 out (y), the
// state in and out (2*B*H*D*D*4), and the function's 5*B*T*H*D*(D+1) FLOP.
// At the prefill shape (8, 512, 32, 64) that is 176 MB (52.6 us at
// 3.35 TB/s) against 2.73 GFLOP (40.7 us at 67 TFLOP/s fp32): bytes bound
// it; at (1, 4096, 32, 64), 169 MB (50.4 us). At decode (T = 1) the state
// I/O (16 KB per (b, h) each way) and the launch latency bound it: 8.4 MB
// at B = 8 is 2.5 us. On the CUDA cores the floor is the instruction
// stream: at least 3 instructions per (i, j) term and step (below), which
// at 1 x 4096 is 1.6 G thread-instructions, 48 us at 128 a clock per SM on
// 132 SMs at 1.98 GHz.
//
// Design: a state-parallel recurrence. Column j of S depends on column j
// alone, so the grid is (b, h, column tile) blocks of kCols value columns
// (4 or 2 tiles a head), which fills the card at B = 1; every tile of a head
// reads that head's r, k and w rows, the re-reads coming from L2. Inside a
// block the sum over i is split 8 ways: thread (slice s, columns jc .. jc +
// kJ - 1) keeps S[i, j] for the 8 keys i = 32 q + 4 s + e (q < 2, e < 4) of
// its kJ columns in registers for the whole T loop, so the state crosses
// device memory twice per call. Per step and term it spends one FMA on the
// chain (S <- w S + kv, kv = k v one multiply) and one FMA for its part of
// r . S. The bonus factors out by slice,
//     y_t[j] = sum_s (sum_{i in s} r_t[i] S[i, j] + v_t[j] b_s),
//     b_s = sum_{i in s} r_t[i] u[i] k_t[i],
// with each b_s computed once per step and block from the staged rows.
//
// Steps are staged in shared memory a stage (8 kGroups steps) at a time: a
// stage holds each step's r, k, w rows and the tile's v columns (every row
// is 256 contiguous bytes of the (B, T, H, D) layout), copied with 16-byte
// cp.async (4-byte where a pointer is not 16-byte aligned) into a ring of 3
// to 7 stages, so the next ring - 1 stages load while one computes (the
// ring is as deep as the block's share of the SM's shared memory allows).
// One __syncthreads per stage. Each step leaves every thread one partial y
// per column; after the stage a reduce-scatter over the 8 slice lanes (xor
// shuffles 4, 2, 1) leaves lane s the sum of step 8 g + s of each group g,
// which it stores, off the state's chain. The steps of a full stage run
// without a guard, so their loads and FMAs interleave.
//
// The block's shape is picked by grid size from measurements (PERF.md): one
// column a thread and 32-step stages where each SM holds one block (B = 1:
// 128 blocks of 4 warps), 32-column tiles of four columns a thread and
// 16-step stages beyond (B = 8: 512 blocks of 2 warps, 4 an SM). A sequence
// of one stage skips the ring and computes b_s in each thread (one
// barrier); T <= 8 takes 16-column tiles of two columns a thread that way.
// A decode step over many (b, h) pairs (B = 8) takes wkv6_kernel_decode:
// one block per (b, h), one thread per column with all 64 keys, so the
// state moves as whole rows; the 8 slices' parts are summed in the same
// tree there.
//
// Numerics: every step's y and state come from the same operations in the
// same order whatever the block shape, the kernel, the stage a step falls
// in, the ring depth or the copy width, so a sequence cut anywhere and
// chained through the state is bitwise one run, and a (b, h) gives the same
// bits at any batch size. The order is not the plain version's einsum, so
// kernel and plain agree to fp32 rounding, not bitwise. Built with nvcc's
// default --fmad=true (no --use_fast_math); the FMAs are spelled fmaf, so
// no contraction is left to the compiler.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "flat_common.cuh"

namespace {

constexpr int kD = 64;                  // head size
constexpr int kSlices = 8;              // the sum over i split 8 ways
constexpr int kI = kD / kSlices;        // keys a thread holds
constexpr int kMinRing = 3, kMaxRing = 7;
constexpr unsigned kFull = 0xffffffffu;

// A block's shape: kCols value columns (kD / kCols tiles a head), kJ of
// them a thread, kGroups groups of kSlices steps a stage, and kMinBlocks
// resident on an SM (a cap on registers). None of them changes any
// arithmetic.
template <int kCols_, int kJ_, int kGroups_, int kMinBlocks_>
struct Tile {
  static constexpr int kCols = kCols_, kJ = kJ_, kGroups = kGroups_;
  static constexpr int kMinBlocks = kMinBlocks_;
  static constexpr int kTiles = kD / kCols;
  static constexpr int kThreads = kCols / kJ * kSlices;
  static constexpr int kTB = kSlices * kGroups;      // steps a stage
  static constexpr int kRow = 3 * kD + kCols;        // floats a staged step
  static constexpr int kStage = kTB * kRow;          // floats a stage
  static constexpr int kBonus = kTB * kSlices;       // floats of b_s a stage
  static constexpr size_t smem(int ring) {
    return ((size_t)ring * kStage + 2 * kBonus) * sizeof(float);
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_at_most(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    default: cp_async_wait<kMaxRing - 2>(); break;
  }
}

// kJ consecutive floats at p (kVec: p is aligned to their size).
template <int kJ, bool kVec>
__device__ __forceinline__ void load_cols(const float* p, float* x) {
  if constexpr (kVec && kJ == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (kVec && kJ == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x; x[1] = q.y;
  } else {
#pragma unroll
    for (int jx = 0; jx < kJ; ++jx) x[jx] = p[jx];
  }
}

template <int kJ, bool kVec>
__device__ __forceinline__ void store_cols(float* p, const float* x) {
  if constexpr (kVec && kJ == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (kVec && kJ == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int jx = 0; jx < kJ; ++jx) p[jx] = x[jx];
  }
}

// The keys of slice s: i = 32 q + 4 s + e for ii = 4 q + e.
__device__ __forceinline__ int key_of(int ii, int s) {
  return (ii / 4) * 32 + 4 * s + ii % 4;
}

// b_s of one step: sum over slice s's keys of r u k, in key order.
__device__ __forceinline__ float slice_bonus(const float (&rr)[kI],
                                             const float (&kk)[kI],
                                             const float (&uu)[kI]) {
  float sum = rr[0] * (uu[0] * kk[0]);
#pragma unroll
  for (int ii = 1; ii < kI; ++ii) sum = fmaf(rr[ii], uu[ii] * kk[ii], sum);
  return sum;
}

// The r and k values of slice s's keys in one staged step.
__device__ __forceinline__ void slice_rk(const float* row, int s,
                                         float (&rr)[kI], float (&kk)[kI]) {
#pragma unroll
  for (int q = 0; q < kI / 4; ++q) {
    const int off = q * 32 + 4 * s;
    const float4 r4 = *reinterpret_cast<const float4*>(row + off);
    const float4 k4 = *reinterpret_cast<const float4*>(row + kD + off);
    rr[4 * q] = r4.x; rr[4 * q + 1] = r4.y; rr[4 * q + 2] = r4.z;
    rr[4 * q + 3] = r4.w;
    kk[4 * q] = k4.x; kk[4 * q + 1] = k4.y; kk[4 * q + 2] = k4.z;
    kk[4 * q + 3] = k4.w;
  }
}

// The steps of one stage for a thread of slice s with columns jc..: the
// state update and p[jx][tt] = sum_i r S + v_j b_s, the thread's part of
// y[tt][j] (b_s: its slice's part of the bonus, read from bs, or, kInline,
// computed here by the same operations). kAll: all kTB steps are there (no
// guard, so the steps interleave); else only the first nt.
template <class Cfg, bool kAll, bool kInline>
__device__ __forceinline__ void stage_steps(
    const float* st, const float* bs, const float (&uu)[kI], int s, int jc,
    int nt, float (&S)[kI][Cfg::kJ], float (&p)[Cfg::kJ][Cfg::kTB]) {
  constexpr int kJ = Cfg::kJ;
#pragma unroll
  for (int tt = 0; tt < Cfg::kTB; ++tt) {
#pragma unroll
    for (int jx = 0; jx < kJ; ++jx) p[jx][tt] = 0.0f;
    if (kAll || tt < nt) {
      const float* row = st + tt * Cfg::kRow;
      float vj[kJ], rr[kI], kk[kI], ww[kI];
      load_cols<kJ, true>(row + 3 * kD + jc, vj);
      slice_rk(row, s, rr, kk);
#pragma unroll
      for (int q = 0; q < kI / 4; ++q) {
        const float4 w4 = *reinterpret_cast<const float4*>(row + 2 * kD +
                                                           q * 32 + 4 * s);
        ww[4 * q] = w4.x; ww[4 * q + 1] = w4.y; ww[4 * q + 2] = w4.z;
        ww[4 * q + 3] = w4.w;
      }
      const float b_s =
          kInline ? slice_bonus(rr, kk, uu) : bs[tt * kSlices + s];
#pragma unroll
      for (int ii = 0; ii < kI; ++ii) {
#pragma unroll
        for (int jx = 0; jx < kJ; ++jx) {
          p[jx][tt] = ii == 0 ? rr[ii] * S[ii][jx]
                              : fmaf(rr[ii], S[ii][jx], p[jx][tt]);
          S[ii][jx] = fmaf(ww[ii], S[ii][jx], kk[ii] * vj[jx]);
        }
      }
#pragma unroll
      for (int jx = 0; jx < kJ; ++jx)
        p[jx][tt] = fmaf(vj[jx], b_s, p[jx][tt]);
    }
  }
}

// Sum p over the 8 slice lanes (lane bits 0..2) so that lane s keeps step
// g * 8 + s of each group g: halves at xor 4, quarters at 2, one at 1. Every
// step's sum is the same tree over the slices, whichever lane keeps it.
template <class Cfg>
__device__ __forceinline__ void reduce_scatter(
    float (&p)[Cfg::kJ][Cfg::kTB], int s,
    float (&z)[Cfg::kGroups][Cfg::kJ]) {
#pragma unroll
  for (int jx = 0; jx < Cfg::kJ; ++jx) {
#pragma unroll
    for (int g = 0; g < Cfg::kGroups; ++g) {
      float* pp = p[jx] + g * kSlices;
#pragma unroll
      for (int o = kSlices / 2; o >= 1; o /= 2) {
        const bool up = (s & o) != 0;
#pragma unroll
        for (int q = 0; q < o; ++q) {
          const float send = up ? pp[q] : pp[q + o];
          const float keep = up ? pp[q + o] : pp[q];
          pp[q] = keep + __shfl_xor_sync(kFull, send, o);
        }
      }
      z[g][jx] = pp[0];
    }
  }
}

// kVec: r, k, v, w, s0 and sT are 16-byte aligned (16-byte copies, vector
// state accesses); else 4-byte copies and scalar accesses. kShort: T fits
// one stage (decode): no ring, one barrier, b_s computed by each thread.
template <class Cfg, bool kVec, bool kShort>
__global__ void __launch_bounds__(Cfg::kThreads, Cfg::kMinBlocks)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0,
            float* __restrict__ y, float* sT, int64_t T, int64_t H,
            int ring) {
  constexpr int kCols = Cfg::kCols, kJ = Cfg::kJ, kTB = Cfg::kTB;
  constexpr int kThreads = Cfg::kThreads, kRow = Cfg::kRow;
  extern __shared__ __align__(16) float smem[];
  float* bsl = smem + ring * Cfg::kStage;         // [2][kTB][kSlices]

  const int t = threadIdx.x;
  const int s = t % kSlices;                      // slice: keys 32 q + 4 s + e
  const int jc = (t / kSlices) * kJ;              // first column in the tile
  const int64_t bh = blockIdx.x / Cfg::kTiles;
  const int c0 = (int)(blockIdx.x % Cfg::kTiles) * kCols;
  const int64_t b = bh / H, h = bh % H;
  const int64_t stride = H * kD;                  // floats between steps
  const int64_t adv = kTB * stride;               // ... between stages
  const int64_t base = (b * T * H + h) * kD;      // (b, t = 0, h, 0)
  const int64_t nst = (T + kTB - 1) / kTB;
  const int ahead = ring - 1;                     // stages in flight
  auto steps_in = [&](int64_t n) {
    const int64_t left = T - n * kTB;
    return (int)(left < kTB ? left : kTB);
  };

  // Stage n into ring slot `slot` (n mod ring): one commit group per stage,
  // empty past the end, so that group n is always stage n.
  auto issue = [&](int64_t n, int slot) {
    if (n < nst) {
      float* dst = smem + slot * Cfg::kStage;
      const int nt = steps_in(n);
      const int64_t g0 = base + n * adv;
      constexpr int kW = kVec ? 4 : 1;            // floats a copy
      constexpr int kRk = kTB * kD / kW;          // copies of each of r, k, w
      constexpr int kV = kTB * kCols / kW;        // copies of v
#pragma unroll
      for (int x = 0; x < (kRk + kThreads - 1) / kThreads; ++x) {
        const int c = t + x * kThreads;
        const int tt = c / (kD / kW), i = c % (kD / kW) * kW;
        if ((kRk % kThreads == 0 || c < kRk) && tt < nt) {
          const int64_t g = g0 + tt * stride + i;
          float* d = dst + tt * kRow + i;
          if constexpr (kVec) {
            cp_async16(d, r + g);
            cp_async16(d + kD, k + g);
            cp_async16(d + 2 * kD, w + g);
          } else {
            cp_async4(d, r + g);
            cp_async4(d + kD, k + g);
            cp_async4(d + 2 * kD, w + g);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < (kV + kThreads - 1) / kThreads; ++x) {
        const int c = t + x * kThreads;
        const int tt = c / (kCols / kW), j = c % (kCols / kW) * kW;
        if ((kV % kThreads == 0 || c < kV) && tt < nt) {
          float* d = dst + tt * kRow + 3 * kD + j;
          const float* g = v + g0 + tt * stride + c0 + j;
          if constexpr (kVec) {
            cp_async16(d, g);
          } else {
            cp_async4(d, g);
          }
        }
      }
    }
    cp_async_commit();
  };

  for (int n = 0; n < (kShort ? 1 : ahead); ++n) issue(n, n);

  // u of this thread's slice keys, and its part of the state
  float uu[kI];
#pragma unroll
  for (int ii = 0; ii < kI; ++ii) uu[ii] = u[h * kD + key_of(ii, s)];
  float S[kI][kJ];
  const int64_t s_off = bh * kD * kD + c0 + jc;
#pragma unroll
  for (int ii = 0; ii < kI; ++ii)
    load_cols<kJ, kVec>(s0 + s_off + key_of(ii, s) * kD, S[ii]);
  float* yp = y + base + (int64_t)s * stride + c0 + jc;   // step s of stage 0

  // y of stage n's steps from p: reduce-scatter, then lane s stores step
  // g * 8 + s of each group g
  auto store_y = [&](float (&p)[kJ][kTB], int nt) {
    float z[Cfg::kGroups][kJ];
    reduce_scatter<Cfg>(p, s, z);
#pragma unroll
    for (int g = 0; g < Cfg::kGroups; ++g)
      if (g * kSlices + s < nt)
        store_cols<kJ, true>(yp + (int64_t)g * kSlices * stride, z[g]);
  };

  // b_s = sum over slice s's keys of r u k for each step of stage n, into
  // bsl[n & 1][tt][s]; item c is step c / 8 of slice c % 8 = t % 8 = s, so
  // each thread uses its own uu.
  auto bonus = [&](int64_t n, int slot) {
    const float* st = smem + slot * Cfg::kStage;
    float* out = bsl + (n & 1) * Cfg::kBonus;
    constexpr int kItems = Cfg::kBonus;
#pragma unroll
    for (int x = 0; x < (kItems + kThreads - 1) / kThreads; ++x) {
      const int c = t + x * kThreads;
      if (kItems % kThreads == 0 || c < kItems) {
        float rr[kI], kk[kI];
        slice_rk(st + (c / kSlices) * kRow, s, rr, kk);
        out[c] = slice_bonus(rr, kk, uu);
      }
    }
  };

  if constexpr (kShort) {
    cp_async_wait<0>();
    __syncthreads();
    float p[kJ][kTB];
    stage_steps<Cfg, false, true>(smem, nullptr, uu, s, jc, (int)T, S, p);
    store_y(p, (int)T);
  } else {
    cp_async_wait_at_most(ahead - 1);       // stage 0 has landed
    __syncthreads();
    bonus(0, 0);

    int cur = 0;                            // slot of stage n
    for (int64_t n = 0; n < nst; ++n, yp += adv) {
      // stage n + 1 has landed (this thread, then all), b_s of stage n is
      // written, and stage n - 1's slot is free
      cp_async_wait_at_most(ahead - 2);
      __syncthreads();
      const int nxt = cur + 1 == ring ? 0 : cur + 1;
      issue(n + ahead, cur == 0 ? ring - 1 : cur - 1);   // (n + ahead) % ring
      if (n + 1 < nst) bonus(n + 1, nxt);

      const int nt = steps_in(n);
      const float* st = smem + cur * Cfg::kStage;
      const float* bs = bsl + (n & 1) * Cfg::kBonus;
      float p[kJ][kTB];
      if (nt == kTB) {
        stage_steps<Cfg, true, false>(st, bs, uu, s, jc, nt, S, p);
      } else {
        stage_steps<Cfg, false, false>(st, bs, uu, s, jc, nt, S, p);
      }
      store_y(p, nt);
      cur = nxt;
    }
  }

#pragma unroll
  for (int ii = 0; ii < kI; ++ii)
    store_cols<kJ, kVec>(sT + s_off + key_of(ii, s) * kD, S[ii]);
}

// One decode step (T = 1) for a grid of many (b, h) pairs: one block per
// (b, h), one thread per value column j holding all 64 keys of column j, so
// the state moves as whole 256-byte rows. The arithmetic is the tile
// kernel's, operation for operation: slice s's part p_s = sum over its keys
// in key order of r S, plus v_j b_s, then the reduce-scatter's tree
// ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)), so a step gives the same
// bits here as there.
__global__ void __launch_bounds__(kD)
wkv6_kernel_decode(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* s0,
                   float* __restrict__ y, float* sT, int64_t H) {
  __shared__ __align__(16) float rkw[3][kD];
  __shared__ float b_s[kSlices];
  const int j = threadIdx.x;
  const int64_t bh = blockIdx.x, h = bh % H;
  float S[kD];
  const float* src = s0 + bh * kD * kD + j;
#pragma unroll
  for (int i = 0; i < kD; ++i) S[i] = src[i * kD];
  const int64_t row = bh * kD;            // (b, t = 0, h) of (B, 1, H, D)
  rkw[0][j] = r[row + j];
  rkw[1][j] = k[row + j];
  rkw[2][j] = w[row + j];
  const float vj = v[row + j];
  __syncthreads();
  if (j < kSlices) {
    float rr[kI], kk[kI], uu[kI];
#pragma unroll
    for (int ii = 0; ii < kI; ++ii) {
      const int i = key_of(ii, j);
      rr[ii] = rkw[0][i];
      kk[ii] = rkw[1][i];
      uu[ii] = u[h * kD + i];
    }
    b_s[j] = slice_bonus(rr, kk, uu);
  }
  __syncthreads();
  float p[kSlices];
#pragma unroll
  for (int sl = 0; sl < kSlices; ++sl) {
#pragma unroll
    for (int ii = 0; ii < kI; ++ii) {
      const int i = key_of(ii, sl);
      const float ri = rkw[0][i], ki = rkw[1][i], wi = rkw[2][i];
      p[sl] = ii == 0 ? ri * S[i] : fmaf(ri, S[i], p[sl]);
      S[i] = fmaf(wi, S[i], ki * vj);
    }
    p[sl] = fmaf(vj, b_s[sl], p[sl]);
  }
  y[row + j] =
      ((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7]));
  float* dst = sT + bh * kD * kD + j;
#pragma unroll
  for (int i = 0; i < kD; ++i) dst[i * kD] = S[i];
}

// Once per device and instantiation: allow the deepest ring's dynamic shared
// memory, and ask for the largest shared-memory carveout, so that 8 blocks
// of a large grid fit on one SM.
template <class Cfg, bool kVec, bool kShort>
void set_attributes(int device) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices ||
      done[device].load(std::memory_order_relaxed))
    return;
  cudaFuncSetAttribute(wkv6_kernel<Cfg, kVec, kShort>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)Cfg::smem(kMaxRing));
  cudaFuncSetAttribute(wkv6_kernel<Cfg, kVec, kShort>,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  done[device].store(true, std::memory_order_relaxed);
}

struct Args {
  const float *r, *k, *v, *w, *u, *s0;
  float *y, *sT;
  int64_t B, T, H;
};

template <class Cfg, bool kVec, bool kShort>
int launch_one(const Args& a, int ring, int device, cudaStream_t stream) {
  set_attributes<Cfg, kVec, kShort>(device);
  const int64_t blocks = a.B * a.H * Cfg::kTiles;
  wkv6_kernel<Cfg, kVec, kShort>
      <<<(unsigned)blocks, Cfg::kThreads, Cfg::smem(ring), stream>>>(
          a.r, a.k, a.v, a.w, a.u, a.s0, a.y, a.sT, a.T, a.H, ring);
  return (int)cudaGetLastError();
}

// The ring is as deep as this block's share of an SM's 228 KB of shared
// memory allows (1 KB a block reserved), 3 to 7 stages, and no deeper than
// the sequence; a sequence of one stage takes the short path.
template <class Cfg>
int launch(const Args& a, int64_t sms, bool vec, int device,
           cudaStream_t stream) {
  const int64_t nst = (a.T + Cfg::kTB - 1) / Cfg::kTB;
  if (nst == 1) {
    return vec ? launch_one<Cfg, true, true>(a, 1, device, stream)
               : launch_one<Cfg, false, true>(a, 1, device, stream);
  }
  const int64_t blocks = a.B * a.H * Cfg::kTiles;
  const int64_t per_sm = (blocks + sms - 1) / sms;
  const int64_t share = 228 * 1024 / per_sm - 1024 - (int64_t)Cfg::smem(0);
  int64_t ring = share / (Cfg::kStage * (int64_t)sizeof(float));
  if (ring > nst + 1) ring = nst + 1;
  if (ring > kMaxRing) ring = kMaxRing;
  if (ring < kMinRing) ring = kMinRing;
  return vec ? launch_one<Cfg, true, false>(a, (int)ring, device, stream)
             : launch_one<Cfg, false, false>(a, (int)ring, device, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// WKV6 over contiguous fp32 r, k, v, w (B, T, H, D), u (H, D) and s0
// (B, H, D, D); writes y (B, T, H, D) and the final state sT (B, H, D, D),
// which may be s0 itself. D must be 64, T >= 1. Returns 0 or a cudaError_t.
extern "C" int repro_wkv6(const float* r, const float* k, const float* v,
                          const float* w, const float* u, const float* s0,
                          float* y, float* sT, int64_t B, int64_t T,
                          int64_t H, int64_t D, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D != kD || B * H * kD > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) device = -1;
  const int sms_asked = repro_flat::sm_count(device);
  const int64_t sms = sms_asked > 0 ? sms_asked : 132;
  const bool vec = aligned16(r) && aligned16(k) && aligned16(v) &&
                   aligned16(w) && aligned16(s0) && aligned16(sT);
  const Args a{r, k, v, w, u, s0, y, sT, B, T, H};
  // The block by grid size, as measured on the H100 (PERF.md): a decode
  // step over many (b, h) pairs takes the whole-column kernel; short
  // sequences (T <= 8) 16-column tiles of two columns a thread in one
  // stage; up to one (b, h, 16-column tile) block an SM, one column a
  // thread and 32-step stages; beyond that 32-column tiles of four columns
  // a thread and 16-step stages.
  const int64_t pairs = B * H;
  if (T == 1 && 2 * pairs > sms) {
    wkv6_kernel_decode<<<(unsigned)pairs, kD, 0, st>>>(r, k, v, w, u, s0, y,
                                                       sT, H);
    return (int)cudaGetLastError();
  }
  if (T <= 8) return launch<Tile<16, 2, 1, 8>>(a, sms, vec, device, st);
  if (4 * pairs <= sms)
    return launch<Tile<16, 1, 4, 1>>(a, sms, vec, device, st);
  return launch<Tile<32, 4, 2, 4>>(a, sms, vec, device, st);
}
