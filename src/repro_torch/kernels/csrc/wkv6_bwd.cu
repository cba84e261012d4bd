// The backward of the WKV6 recurrence (csrc/wkv6.cu) for Hopper (sm_90a).
//
// Forward, per (b, h) over t, with S_{t-1} the state before step t:
//     y_t[j] = sum_i r_t[i] (S_{t-1}[i, j] + u[i] k_t[i] v_t[j])
//     S_t    = diag(w_t) S_{t-1} + k_t v_t^T
// Given dy and G_T = dL/dS_T (the gradient of the returned final state; a
// null pointer means zero), with G_t = dL/dS_t and c_t = dy_t . v_t:
//     G_{t-1}  = diag(w_t) G_t + r_t dy_t^T
//     dr_t[i]  = sum_j dy_t[j] S_{t-1}[i, j] + u[i] k_t[i] c_t
//     dk_t[i]  = sum_j G_t[i, j] v_t[j] + r_t[i] u[i] c_t
//     dv_t[j]  = sum_i G_t[i, j] k_t[i] + (sum_i r_t[i] u[i] k_t[i]) dy_t[j]
//     dw_t[i]  = sum_j G_t[i, j] S_{t-1}[i, j]
//     du[i]    = sum_{b, t} r_t[i] k_t[i] c_t        ds0 = G_0
// r, k, v, w, dy, dr, dk, dv, dw are (B, T, H, D) fp32, u and du (H, D), the
// states (B, H, D, D) keyed [key i][value j], D = 64.
//
// Replaces no Pallas kernel: the JAX package trains wkv blocks by autograd
// through wkv_scan's lax.scan (src/repro/models/rwkv6.py:64-80), which has
// no Pallas backward. The port's forward is the hand-written wkv6 kernel,
// so its gradient is written by hand as well.
//
// Bound. Per call 5 (B, T, H, D) fp32 tensors in (r, k, v, w, dy) and 4
// out, u and du, and three states (s0, G_T in, ds0 out): at (2, 1024, 32,
// 64) 154 MB, 46 us at 3.35 TB/s. Operations: per step and (i, j) the
// state's recomputation (2 FLOP), G's update (2) and the four sums dr, dk,
// dv, dw (2 each), 12 D^2 + O(D) FLOP a step: 3.26 GFLOP, 48.7 us at
// 67 TFLOP/s fp32. So operations bound it, just.
//
// What held the first version of this kernel (a block per (b, h, 16
// keys), the whole T walked in turn) back: 256 blocks, each ~3 T dependent
// steps, and each step waited on its own loads of w, k, r, v, dy from
// device memory, four 16-lane shuffle trees and a __syncthreads for dv's
// cross-row sum; dv's row-tile partials went through device memory to a
// reduce launch. It took 1.41 ms at (2, 1024, 32, 64) on an H100 (~470 ns
// a step): 3.4% of the bound.
//
// Design: parallel over time chunks of kChunk = 32 steps. Every element (i,
// j) of S and of G is its own scalar recurrence (diag(w_t) scales rows, the
// outer products add elementwise); only the outputs sum. So once S is known
// at each chunk's start and G at each chunk's end, the chunks are
// independent:
//   1. wkv6_bwd_bound_kernel walks the two chains alone, a block of 128
//      threads (4 keys x 8 columns each) per (b, h, chain): S forward from
//      s0 (S = fmaf(w, S, k * v), the forward kernel's arithmetic), saving
//      the state at each chunk's start, and G backward from G_T (G =
//      fmaf(w, G, r * dy)), saving it at each chunk's end. One multiply and
//      one FMA an element and step; the rows come through a cp.async ring of
//      16-step stages and each step's are read from shared memory one step
//      ahead of their use. It reads w twice and writes 2 states a chunk:
//      ~164 MB at (2, 1024, 32, 64), which bounds it.
//   2. wkv6_bwd_chunk_kernel: one persistent block of 256 threads per SM
//      takes the (b, h, chunk) units in turn; a thread holds 4 keys x 4
//      value columns of the 64 x 64 state. A unit's rows of w, k, r, v, dy
//      and its start state come by cp.async into one half of a double
//      buffer while the previous unit computes (the steps past T, up to a
//      whole sub-chunk of kSub = 4, padded as no-ops: w = 1, the rest 0),
//      and c_t and beta_t of its steps are formed once. The block walks S
//      from the chunk's start, keeping the state at each sub-chunk's start
//      in shared memory; then, sub-chunk by sub-chunk from the last, each
//      thread recomputes the sub-chunk's 4 states into registers (the same
//      fmaf, so the same bits as pass 1's and the forward's) and walks G
//      down through them, forming its partial sums of dr, dk, dw (along a
//      row: 16 lanes) and dv (down a column: 2 lanes, 8 warps). The row
//      sums are a reduce-scatter of xor shuffles over the sub-chunk's 4
//      steps (one shuffle an output value and lane); the dv partials meet
//      in shared memory and one thread a (step, column) adds the 8 warps'
//      in order. Two barriers a sub-chunk, none a step, no partial in
//      device memory; outputs leave as whole 256-byte rows.
//   3. wkv6_bwd_du_kernel adds the (b, chunk) partials of du in order.
// Every sum runs in a fixed order and nothing is atomic, so a shape's result
// repeats bitwise. The numerical difference from the first kernel is only
// the order of the sums. fp32 on the CUDA cores throughout (no TF32): an
// element and step costs about 13 issued instructions (pass 1's S and G 2 +
// 2, the chunk's S walk and recompute 2 + 2, G 2, the four sums 4, the
// shuffle reduction ~1) against the 6 FMAs (12 FLOP) the bound counts: at
// one a cycle on every scheduler of an H100 that is ~100 us at (2, 1024,
// 32, 64). The chunk kernel issues them well below that rate: its 8 warps
// an SM (one block; the 4-step history alone takes 64 registers a thread)
// hide little latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                   // head size
constexpr int kChunk = 32;               // steps a chunk
constexpr int kSub = 4;                  // steps a sub-chunk (registers)
constexpr int kSubs = kChunk / kSub;
constexpr int kSlots = kSubs - 2;        // sub-chunk starts kept (1 .. 6)
constexpr int kThreads = 256;            // chunk kernel: 4 keys x 4 columns
constexpr int kWarps = kThreads / 32;
constexpr int kRowsIn = 5;               // staged rows a step: w, k, r, v, dy
constexpr int kRowPad = 72;              // row-sum buffer's padded row
constexpr int kPThreads = 128;           // bound kernel: 4 keys x 8 columns
constexpr int kPStage = 16;              // bound kernel: steps a stage
constexpr int kPRing = 4;                // bound kernel: stages in the ring
constexpr unsigned kFull = 0xffffffffu;

// The bound kernel's ring and the chunk kernel's shared memory (floats):
// two units' staged rows and start states, the sub-chunk starts (four
// float4 a thread), the row sums, dv's warp partials and c_t / beta_t of a
// sub-chunk.
constexpr size_t kPSmem = (size_t)kPRing * kPStage * 3 * kD * sizeof(float);
constexpr int kStgFloats = kChunk * kRowsIn * kD;
constexpr int kSubFloats = kSlots * 4 * kThreads * 4;
constexpr int kRowFloats = 3 * kSub * kRowPad;
constexpr int kDvFloats = kWarps * kSub * kD;
constexpr size_t kSmem = (size_t)(2 * kStgFloats + 2 * kD * kD + kSubFloats +
                                  kRowFloats + kDvFloats + 2 * kChunk +
                                  kSub * kD) * sizeof(float);
static_assert(kSmem <= 232448, "more shared memory than a block may have");
static_assert(kPSmem <= 49152, "the bound kernel's ring needs no opt-in");
static_assert(kChunk % kPStage == 0, "stages end on chunk edges");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float comp(float4 a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// x <- a x + b c, elementwise over c's four columns: S = fmaf(w, S, k * v)
// and G = fmaf(w, G, r * dy).
__device__ __forceinline__ float4 step4(float a, float4 x, float b,
                                        float4 c) {
  return make_float4(fmaf(a, x.x, b * c.x), fmaf(a, x.y, b * c.y),
                     fmaf(a, x.z, b * c.z), fmaf(a, x.w, b * c.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// One stage of a reduce-scatter between lane pairs `off` apart: the upper
// lane keeps `hi` plus its partner's `hi`, the lower one `lo` plus its
// partner's `lo`.
__device__ __forceinline__ float keep_sum(float lo, float hi, bool upper,
                                          int off) {
  const float send = upper ? lo : hi;
  return (upper ? hi : lo) + __shfl_xor_sync(kFull, send, off);
}

__device__ __forceinline__ float warp_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 16);
  x += __shfl_xor_sync(kFull, x, 8);
  x += __shfl_xor_sync(kFull, x, 4);
  x += __shfl_xor_sync(kFull, x, 2);
  x += __shfl_xor_sync(kFull, x, 1);
  return x;
}

// Pass 1: a block per (b, h, chain), a thread per 4 keys x 8 columns.
// Chain 0 walks S forward from s0 over the steps before the last chunk and
// saves the state before each chunk n >= 1 at sck[n - 1]; chain 1 walks G
// backward from G_T down to step kChunk and saves G after each chunk n <=
// n_ck - 2 at gck[n]. Positions p run in walk order, in stages of kPStage
// aligned to t (chain 1 pads T up to a whole stage and skips the pad), so
// every save falls at the end of a stage.
__global__ void __launch_bounds__(kPThreads, 1)
wkv6_bwd_bound_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ s0,
                      const float* __restrict__ dy,
                      const float* __restrict__ dsT, float* __restrict__ sck,
                      float* __restrict__ gck, int T, int H) {
  extern __shared__ __align__(16) float ring[];   // [kPRing][kPStage][3][kD]
  const int chain = blockIdx.x & 1, bh = blockIdx.x >> 1;
  const int h = bh % H, b = bh / H;
  const int n_ck = (T + kChunk - 1) / kChunk;
  const int t_pad = (T + kPStage - 1) / kPStage * kPStage;
  const int p_lo = chain ? t_pad - T : 0;          // first real position
  const int n_pos = chain ? t_pad - kChunk : (n_ck - 1) * kChunk;
  const int n_st = n_pos / kPStage;
  const float* pb = chain ? r : k;
  const float* pc = chain ? dy : v;
  const float* init = chain ? dsT : s0;
  const int64_t dd = (int64_t)kD * kD;
  float* save = (chain ? gck : sck) + (int64_t)bh * (n_ck - 1) * dd;
  const int64_t hd = (int64_t)H * kD;
  const int64_t row0 = (int64_t)b * T * hd + (int64_t)h * kD;
  const int i0 = 4 * (threadIdx.x >> 3), c8 = 8 * (threadIdx.x & 7);
  const int e0 = i0 * kD + c8;
  float4 X[4][2];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      X[e][h2] = init ? ld4(init + bh * dd + e0 + e * kD + 4 * h2)
                      : make_float4(0.f, 0.f, 0.f, 0.f);

  auto issue = [&](int g) {
    if (g < n_st) {
      float* st = ring + (g % kPRing) * kPStage * 3 * kD;
      for (int q = threadIdx.x; q < kPStage * 3 * 16; q += kPThreads) {
        const int j = q / 48, rem = q - 48 * j;
        const int row = rem >> 4, c = (rem & 15) * 4;
        const int p = g * kPStage + j;
        if (p >= p_lo) {
          const int t = chain ? t_pad - 1 - p : p;
          const float* src = row == 0 ? w : row == 1 ? pb : pc;
          cp_async16(st + (j * 3 + row) * kD + c,
                     src + row0 + (int64_t)t * hd + c);
        }
      }
    }
    cp_async_commit();
  };

  for (int g = 0; g < kPRing - 1; ++g) issue(g);
  for (int g = 0; g < n_st; ++g) {
    cp_async_wait<kPRing - 2>();
    __syncthreads();
    issue(g + kPRing - 1);
    const float* st = ring + (g % kPRing) * kPStage * 3 * kD;
    const int j0 = max(0, p_lo - g * kPStage);
    // each step's rows are read one step ahead of their use
    float4 a = ld4(st + j0 * 3 * kD + i0), bq = ld4(st + (j0 * 3 + 1) * kD + i0);
    float4 c0 = ld4(st + (j0 * 3 + 2) * kD + c8);
    float4 c1 = ld4(st + (j0 * 3 + 2) * kD + c8 + 4);
#pragma unroll 2
    for (int j = j0; j < kPStage; ++j) {
      const float* nx = st + min(j + 1, kPStage - 1) * 3 * kD;
      const float4 an = ld4(nx + i0), bn = ld4(nx + kD + i0);
      const float4 cn0 = ld4(nx + 2 * kD + c8), cn1 = ld4(nx + 2 * kD + c8 + 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        X[e][0] = step4(comp(a, e), X[e][0], comp(bq, e), c0);
        X[e][1] = step4(comp(a, e), X[e][1], comp(bq, e), c1);
      }
      a = an;
      bq = bn;
      c0 = cn0;
      c1 = cn1;
    }
    // S after the stage is the state before chunk (p + 1) / kChunk; G after
    // walking step t down is G at the end of chunk t / kChunk - 1
    const int edge = chain ? t_pad - (g + 1) * kPStage : (g + 1) * kPStage;
    if (edge % kChunk == 0) {
      float* o = save + (int64_t)(edge / kChunk - 1) * dd + e0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st4(o + e * kD, X[e][0]);
        st4(o + e * kD + 4, X[e][1]);
      }
    }
  }
  cp_async_wait<0>();
}

// One sub-chunk of the chunk kernel for this thread's keys i0 .. i0 + 3 and
// columns c4 .. c4 + 3: the len (<= kSub) states from S (its start) into
// registers, then G walked down through them. Leaves in racc the full row
// sums (dr, dk, dw less their bonus terms) of step 2 b2 + b3 and key i0 +
// 2 b1 + b0 (b3 .. b0 the bits of lane % 16), and in cacc[4 p .. 4 p + 3]
// the dv partials of step 2 p + lane / 16 summed over the warp's 8 keys.
__device__ __forceinline__ void sub_chunk(const float* __restrict__ st,
                                          float4 (&S)[4],
                                          float4 (&G)[4], int i0, int c4,
                                          int lane, float (&racc)[3],
                                          float (&cacc)[8]) {
  float4 W[kSub], K[kSub], V[kSub], H[kSub][4];
#pragma unroll
  for (int s = 0; s < kSub; ++s) {
    {
      const float* x = st + s * kRowsIn * kD;
      W[s] = ld4(x + i0);
      K[s] = ld4(x + kD + i0);
      V[s] = ld4(x + 3 * kD + c4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        H[s][e] = S[e];
        S[e] = step4(comp(W[s], e), S[e], comp(K[s], e), V[s]);
      }
    }
  }
  const bool b3 = lane & 8, hb = lane & 16;
  float rk[24];
#pragma unroll
  for (int p = kSub / 2 - 1; p >= 0; --p) {
    float rp[2][12], cp[2][4];
#pragma unroll
    for (int hs = 1; hs >= 0; --hs) {
      const int s = 2 * p + hs;
      {
        const float* x = st + s * kRowsIn * kD;
        const float4 R4 = ld4(x + 2 * kD + i0), Y4 = ld4(x + 4 * kD + c4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          rp[hs][3 * e] = dot4(Y4, H[s][e]);
          rp[hs][3 * e + 1] = dot4(G[e], V[s]);
          rp[hs][3 * e + 2] = dot4(G[e], H[s][e]);
        }
        const float4 k4 = K[s];
        cp[hs][0] = fmaf(G[3].x, k4.w, fmaf(G[2].x, k4.z,
                         fmaf(G[1].x, k4.y, G[0].x * k4.x)));
        cp[hs][1] = fmaf(G[3].y, k4.w, fmaf(G[2].y, k4.z,
                         fmaf(G[1].y, k4.y, G[0].y * k4.x)));
        cp[hs][2] = fmaf(G[3].z, k4.w, fmaf(G[2].z, k4.z,
                         fmaf(G[1].z, k4.y, G[0].z * k4.x)));
        cp[hs][3] = fmaf(G[3].w, k4.w, fmaf(G[2].w, k4.z,
                         fmaf(G[1].w, k4.y, G[0].w * k4.x)));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          G[e] = step4(comp(W[s], e), G[e], comp(R4, e), Y4);
      }
    }
    // lane bit 3 keeps step 2 p + b3 of the row sums; the upper half-warp
    // keeps step 2 p + 1 of the column sums
#pragma unroll
    for (int q = 0; q < 12; ++q)
      rk[12 * p + q] = keep_sum(rp[0][q], rp[1][q], b3, 8);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cacc[4 * p + q] = keep_sum(cp[0][q], cp[1][q], hb, 16);
  }
  // rk[12 p + 3 e + q]: p by lane bit 2, e's high bit by bit 1, its low bit
  // by bit 0
#pragma unroll
  for (int x = 0; x < 12; ++x) rk[x] = keep_sum(rk[x], rk[x + 12], lane & 4, 4);
#pragma unroll
  for (int x = 0; x < 6; ++x) rk[x] = keep_sum(rk[x], rk[x + 6], lane & 2, 2);
#pragma unroll
  for (int x = 0; x < 3; ++x)
    racc[x] = keep_sum(rk[x], rk[x + 3], lane & 1, 1);
}

// Pass 2: a persistent block per SM walks the (b, h, chunk) units
// blockIdx.x, blockIdx.x + gridDim.x, ...; while it computes one unit, the
// next one's rows and start state arrive in the other half of the staging.
__global__ void __launch_bounds__(kThreads, 1)
wkv6_bwd_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u,
                      const float* __restrict__ s0,
                      const float* __restrict__ dy,
                      const float* __restrict__ dsT,
                      const float* __restrict__ sck,
                      const float* __restrict__ gck, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_part,
                      float* __restrict__ ds0, int T, int H, int n_units) {
  extern __shared__ __align__(16) float smem[];
  float* stgs = smem;                            // [2][kChunk][5][kD]
  float* starts = stgs + 2 * kStgFloats;         // [2][kD][kD]
  float4* sub = reinterpret_cast<float4*>(starts + 2 * kD * kD);
                                                 // [kSlots][4][kThreads]
  float* rowbuf = reinterpret_cast<float*>(sub) + kSubFloats;
                                                 // [3][kSub][kRowPad]
  float* dvbuf = rowbuf + kRowFloats;            // [kWarps][kSub][kD]
  float* cbuf = dvbuf + kDvFloats;               // [2][kChunk]: c, beta
  float* dubuf = cbuf + 2 * kChunk;              // [kSub][kD]
  const int n_ck = (T + kChunk - 1) / kChunk;
  const int64_t hd = (int64_t)H * kD, dd = (int64_t)kD * kD;
  const int tid = threadIdx.x;

  // A unit's rows and the state at its chunk's start into half `buf`, one
  // copy group; the steps past T up to a whole sub-chunk padded as no-ops
  // (w = 1, the rest 0).
  auto stage = [&](int unit, int buf) {
    const int n = unit % n_ck, bh = unit / n_ck;
    const int t0 = n * kChunk, len = min(kChunk, T - t0);
    const int64_t row0 = (int64_t)(bh / H) * T * hd + (int64_t)(bh % H) * kD;
    float* stg = stgs + buf * kStgFloats;
    const float* sp = n ? sck + ((int64_t)bh * (n_ck - 1) + n - 1) * dd
                        : s0 + bh * dd;
    for (int q = tid; q < len * kRowsIn * 16; q += kThreads) {
      const int s = q / (kRowsIn * 16), rem = q - s * kRowsIn * 16;
      const int row = rem >> 4, c = (rem & 15) * 4;
      const float* src = row == 0 ? w : row == 1 ? k : row == 2 ? r
                       : row == 3 ? v : dy;
      cp_async16(stg + (s * kRowsIn + row) * kD + c,
                 src + row0 + (int64_t)(t0 + s) * hd + c);
    }
    for (int q = tid; q < kD * kD / 4; q += kThreads)
      cp_async16(starts + buf * kD * kD + 4 * q, sp + 4 * q);
    cp_async_commit();
    const int padded = (len + kSub - 1) / kSub * kSub;
    for (int q = len * kRowsIn * kD + tid; q < padded * kRowsIn * kD;
         q += kThreads)
      stg[q] = q % (kRowsIn * kD) < kD ? 1.f : 0.f;
  };

  const int wp = tid >> 5, lane = tid & 31;
  const int i0 = 8 * wp + 4 * (lane >> 4), c4 = 4 * (lane & 15);
  const int e0 = i0 * kD + c4;
  const int sr = 2 * ((lane >> 2) & 1) + ((lane >> 3) & 1);   // racc's step
  const int ir = i0 + (lane & 3);                             // racc's key

  if (blockIdx.x < n_units) stage(blockIdx.x, 0);
  for (int unit = blockIdx.x, it = 0; unit < n_units;
       unit += gridDim.x, ++it) {
    const int n = unit % n_ck, bh = unit / n_ck;
    const int h = bh % H, b = bh / H;
    const int t0 = n * kChunk, len = min(kChunk, T - t0);
    const int n_sub = (len + kSub - 1) / kSub;
    const int64_t row0 = (int64_t)b * T * hd + (int64_t)h * kD;
    const float* stg = stgs + (it & 1) * kStgFloats;
    const float* sp = starts + (it & 1) * kD * kD;
    const float* gp = n < n_ck - 1 ? gck + ((int64_t)bh * (n_ck - 1) + n) * dd
                    : dsT ? dsT + bh * dd : nullptr;
    float4 S[4], G[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      G[e] = gp ? ld4(gp + e0 + e * kD) : make_float4(0.f, 0.f, 0.f, 0.f);
    float du_acc = 0.f;

    // The unit's copies (and every thread's work on the previous unit) are
    // done. Walk S over sub-chunks 0 .. n_sub - 2, keeping the starts of 1
    // .. n_sub - 2 (the last one's start stays in S).
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e) S[e] = ld4(sp + e0 + e * kD);
    for (int m = 0; m + 1 < n_sub; ++m) {
      if (m) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sub[(4 * (m - 1) + e) * kThreads + tid] = S[e];
      }
      const float* st = stg + m * kSub * kRowsIn * kD;
#pragma unroll
      for (int s = 0; s < kSub; ++s) {
        const float* x = st + s * kRowsIn * kD;
        const float4 w4 = ld4(x + i0), k4 = ld4(x + kD + i0);
        const float4 v4 = ld4(x + 3 * kD + c4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          S[e] = step4(comp(w4, e), S[e], comp(k4, e), v4);
      }
    }
    // c_t = dy_t . v_t and beta_t = sum_i r_t[i] u[i] k_t[i] of every step
    for (int d = wp; d < 2 * kChunk; d += kWarps) {
      const int s = d % kChunk;
      float x = 0.f;
      if (s < len) {
        const float* y = stg + s * kRowsIn * kD;
        if (d < kChunk) {
          x = fmaf(y[4 * kD + lane + 32], y[3 * kD + lane + 32],
                   y[4 * kD + lane] * y[3 * kD + lane]);
        } else {
          const float* uh = u + h * kD;
          x = fmaf(y[2 * kD + lane + 32], uh[lane + 32] * y[kD + lane + 32],
                   y[2 * kD + lane] * (uh[lane] * y[kD + lane]));
        }
      }
      x = warp_sum(x);
      if (lane == 0) cbuf[d] = x;
    }
    // the other half was the previous unit's, done by every thread
    if (unit + (int)gridDim.x < n_units) stage(unit + gridDim.x, (it & 1) ^ 1);

    for (int m = n_sub - 1; m >= 0; --m) {
      if (m < n_sub - 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          S[e] = m ? sub[(4 * (m - 1) + e) * kThreads + tid]
                   : ld4(sp + e0 + e * kD);
      }
      const int lenm = min(kSub, len - m * kSub);
      const float* st = stg + m * kSub * kRowsIn * kD;
      float racc[3], cacc[8];
      sub_chunk(st, S, G, i0, c4, lane, racc, cacc);
      __syncthreads();            // the previous sub-chunk's sums are read
#pragma unroll
      for (int q = 0; q < 3; ++q)
        rowbuf[(q * kSub + sr) * kRowPad + ir] = racc[q];
#pragma unroll
      for (int p = 0; p < kSub / 2; ++p)
        st4(dvbuf + (wp * kSub + 2 * p + (lane >> 4)) * kD + c4,
            make_float4(cacc[4 * p], cacc[4 * p + 1], cacc[4 * p + 2],
                        cacc[4 * p + 3]));
      __syncthreads();
      {  // thread (step s, key / column i) writes the outputs
        const int s = tid / kD, i = tid & (kD - 1);
        const float ui = u[h * kD + i];
        if (s < lenm) {
          const float* y = st + s * kRowsIn * kD;
          const float c = cbuf[m * kSub + s];
          const float beta = cbuf[kChunk + m * kSub + s];
          const int64_t x = row0 + (int64_t)(t0 + m * kSub + s) * hd + i;
          dr[x] = fmaf(ui * y[kD + i], c, rowbuf[s * kRowPad + i]);
          dk[x] = fmaf(y[2 * kD + i] * ui, c,
                       rowbuf[(kSub + s) * kRowPad + i]);
          dw[x] = rowbuf[(2 * kSub + s) * kRowPad + i];
          float acc = dvbuf[s * kD + i];
#pragma unroll
          for (int q = 1; q < kWarps; ++q)
            acc += dvbuf[(q * kSub + s) * kD + i];
          dv[x] = fmaf(beta, y[4 * kD + i], acc);
          du_acc = fmaf(y[2 * kD + i] * y[kD + i], c, du_acc);
        }
      }
    }
    dubuf[tid] = du_acc;
    __syncthreads();
    if (n == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st4(ds0 + bh * dd + e0 + e * kD, G[e]);
    }
    if (tid < kD) {
      float acc = dubuf[tid];
#pragma unroll
      for (int s = 1; s < kSub; ++s) acc += dubuf[s * kD + tid];
      du_part[((int64_t)(b * n_ck + n) * H + h) * kD + tid] = acc;
    }
  }
}

// du[h] = the (b, chunk) partials of head h added in (b, chunk) order.
__global__ void __launch_bounds__(kD)
wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                   int B, int n_ck, int H) {
  const int h = blockIdx.x, j = threadIdx.x;
  float acc = 0.f;
  for (int bn = 0; bn < B * n_ck; ++bn)
    acc += du_part[((int64_t)bn * H + h) * kD + j];
  du[h * kD + j] = acc;
}

}  // namespace

// The WKV6 backward over contiguous fp32 r, k, v, w, dy (B, T, H, D), u
// (H, D), s0 and dsT (B, H, D, D; dsT may be null: a zero gradient of the
// final state): writes dr, dk, dv, dw (B, T, H, D), du (H, D) and ds0 (B,
// H, D, D). Scratch (fp32), with n = ceil(T / 32) chunks: sck and gck of
// B * H * (n - 1) * D * D floats each (the states at the chunks' edges) and
// du_part of B * n * H * D. D must be 64, T >= 1, every pointer 16-byte
// aligned. Three launches on `stream` (two when T <= 32). Returns 0 or a
// cudaError_t.
extern "C" int repro_wkv6_bwd(const float* r, const float* k, const float* v,
                              const float* w, const float* u, const float* s0,
                              const float* dy, const float* dsT, float* sck,
                              float* gck, float* du_part, float* dr,
                              float* dk, float* dv, float* dw, float* du,
                              float* ds0, int64_t B, int64_t T, int64_t H,
                              int64_t D, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D != kD || T > 0x7fffffff - kChunk)
    return (int)cudaErrorInvalidValue;
  const int64_t n_ck = (T + kChunk - 1) / kChunk;
  if (B * H * n_ck > 0x7fffffff || B * n_ck * H > 0x7fffffff / kD ||
      H > 0x7fffffff / kD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  cudaError_t err;
  if (n_ck > 1) {
    wkv6_bwd_bound_kernel<<<(unsigned)(B * H * 2), kPThreads, kPSmem, st>>>(
        r, k, v, w, s0, dy, dsT, sck, gck, (int)T, (int)H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_units = B * H * n_ck;
  wkv6_bwd_chunk_kernel<<<(unsigned)(n_units < sms ? n_units : sms),
                          kThreads, kSmem, st>>>(
      r, k, v, w, u, s0, dy, dsT, sck, gck, dr, dk, dv, dw, du_part, ds0,
      (int)T, (int)H, (int)n_units);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_du_kernel<<<(unsigned)H, kD, 0, st>>>(du_part, du, (int)B,
                                                 (int)n_ck, (int)H);
  return (int)cudaGetLastError();
}
