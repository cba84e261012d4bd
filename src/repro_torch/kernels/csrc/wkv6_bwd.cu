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
// dv, dw (2 each), 12 D^2 + O(D) FLOP a step: 3.2 GFLOP, 48 us at
// 67 TFLOP/s fp32. So operations bound it, just.
//
// Design (a simple CUDA-core kernel; making it fast is later work).
// Every row i of S and G depends on row i alone (diag(w_t) scales rows, the
// outer products add r_t[i] dy_t and k_t[i] v_t), so a block takes one (b,
// h) and 16 keys i, and its 256 threads hold 4 columns of one row each
// (thread (row 16 x, columns 4 c .. 4 c + 3)): dr, dk, dw and c_t are sums
// along a row, over the 16 lanes that share it (xor shuffles 8, 4, 2, 1).
// Only dv sums over rows: each step the block's 16 rows meet in shared
// memory, 64 threads add them in row order and write the block's partial;
// wkv6_bwd_reduce_kernel then adds the four row tiles' partials in tile
// order and the bonus term, and the batch rows' du. No atomics: a shape's
// result repeats bitwise.
// The backward needs S_{t-1} in reverse order, and running the recurrence
// backwards would divide by w_t. So a first pass runs the forward
// recurrence from s0 and saves the state before every kChunk-th step
// (scratch, (B, H, ceil(T / kChunk), D, D)); then, chunk by chunk from the
// last, each thread recomputes its part of the chunk's states into its own
// slots of shared memory and walks the chunk's steps backwards.
// Numerics: fmaf throughout; the state recurrence is the forward kernel's
// arithmetic (S = fmaf(w, S, k * v)), so the saved states are its states.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                   // head size
constexpr int kRows = 16;                // keys a block
constexpr int kTiles = kD / kRows;       // blocks a (b, h)
constexpr int kLanes = 16;               // threads a row (4 columns each)
constexpr int kThreads = kRows * kLanes;
constexpr int kChunk = 16;               // steps between saved states
constexpr unsigned kFull = 0xffffffffu;
// A thread's kChunk states (float4 each) and the dv rows of two steps.
constexpr int kSmem = kChunk * kThreads * 16 + 2 * kRows * kD * 4;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 step_state(float w, float k, float4 v,
                                             float4 s) {
  return make_float4(fmaf(w, s.x, k * v.x), fmaf(w, s.y, k * v.y),
                     fmaf(w, s.z, k * v.z), fmaf(w, s.w, k * v.w));
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

// The sum over the 16 lanes of a row (lanes 0-15 or 16-31 of a warp).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 8);
  x += __shfl_xor_sync(kFull, x, 4);
  x += __shfl_xor_sync(kFull, x, 2);
  x += __shfl_xor_sync(kFull, x, 1);
  return x;
}

__global__ void __launch_bounds__(kThreads)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                const float* __restrict__ dy, const float* __restrict__ dsT,
                float* __restrict__ ckpt, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dw,
                float* __restrict__ dv_part, float* __restrict__ du_part,
                float* __restrict__ ds0, int T, int H) {
  extern __shared__ __align__(16) float4 smem4[];
  float4* st_s = smem4;                                  // [kChunk][kThreads]
  float* dv_s = reinterpret_cast<float*>(smem4 + kChunk * kThreads);
                                                         // [2][kRows][kD]
  const int tile = blockIdx.x % kTiles, bh = blockIdx.x / kTiles;
  const int h = bh % H, b = bh / H;
  const int rl = threadIdx.x / kLanes, c4 = 4 * (threadIdx.x % kLanes);
  const int i = tile * kRows + rl;
  const int64_t st_off = ((int64_t)bh * kD + i) * kD + c4;
  const int64_t hd = (int64_t)H * kD;
  const int64_t row0 = (int64_t)b * T * hd + (int64_t)h * kD;  // t = 0
  const int64_t plane = (int64_t)(gridDim.x / kTiles) * T * kD;  // B T H D
  const int n_ck = (T + kChunk - 1) / kChunk;
  float* ck = ckpt + (int64_t)bh * n_ck * kD * kD + (int64_t)i * kD + c4;

  // Pass 1: the states before steps kChunk, 2 kChunk, ... (slot n holds
  // the one before step n kChunk; slot 0, s0, is read from s0).
  float4 S = ld4(s0 + st_off);
  for (int t = 0; t < (n_ck - 1) * kChunk; ++t) {
    const int64_t x = row0 + (int64_t)t * hd;
    S = step_state(w[x + i], k[x + i], ld4(v + x + c4), S);
    if ((t + 1) % kChunk == 0)
      *reinterpret_cast<float4*>(ck + (int64_t)(t + 1) / kChunk * kD * kD) =
          S;
  }

  // Pass 2: the chunks from the last, each step of a chunk from its last.
  float4 G = dsT ? ld4(dsT + st_off) : make_float4(0.f, 0.f, 0.f, 0.f);
  const float ui = u[h * kD + i];
  float du_acc = 0.0f;
  for (int n = n_ck - 1; n >= 0; --n) {
    const int t0 = n * kChunk, t1 = min(T, t0 + kChunk);
    S = n ? ld4(ck + (int64_t)n * kD * kD) : ld4(s0 + st_off);
    for (int t = t0; t < t1; ++t) {
      st_s[(t - t0) * kThreads + threadIdx.x] = S;      // S_{t-1}
      const int64_t x = row0 + (int64_t)t * hd;
      S = step_state(w[x + i], k[x + i], ld4(v + x + c4), S);
    }
    for (int t = t1 - 1; t >= t0; --t) {
      const int64_t x = row0 + (int64_t)t * hd;
      const float rt = r[x + i], kt = k[x + i], wt = w[x + i];
      const float4 vt = ld4(v + x + c4), gt = ld4(dy + x + c4);
      const float4 Sp = st_s[(t - t0) * kThreads + threadIdx.x];
      const float c = row_sum(dot4(gt, vt));
      const float pr = row_sum(dot4(gt, Sp));
      const float pk = row_sum(dot4(G, vt));
      const float pw = row_sum(dot4(G, Sp));
      if (c4 == 0) {
        dr[x + i] = fmaf(ui * kt, c, pr);
        dk[x + i] = fmaf(rt * ui, c, pk);
        dw[x + i] = pw;
      }
      du_acc = fmaf(rt * kt, c, du_acc);
      // This tile's part of dv_t: its 16 rows of G_t k_t, added in row order.
      float* buf = dv_s + (t & 1) * kRows * kD;
      *reinterpret_cast<float4*>(buf + rl * kD + c4) =
          make_float4(G.x * kt, G.y * kt, G.z * kt, G.w * kt);
      __syncthreads();
      if (threadIdx.x < kD) {
        float acc = buf[threadIdx.x];
#pragma unroll
        for (int q = 1; q < kRows; ++q) acc += buf[q * kD + threadIdx.x];
        dv_part[tile * plane + x + threadIdx.x] = acc;
      }
      G = make_float4(fmaf(wt, G.x, rt * gt.x), fmaf(wt, G.y, rt * gt.y),
                      fmaf(wt, G.z, rt * gt.z), fmaf(wt, G.w, rt * gt.w));
    }
  }
  *reinterpret_cast<float4*>(ds0 + st_off) = G;
  if (c4 == 0) du_part[(int64_t)bh * kD + i] = du_acc;
}

// dv_t = the four tiles' partials in tile order + (sum_i r u k) dy_t: one
// block of 64 threads per (b, t, h); then one block per head h for du, the
// batch rows' partials in order.
__global__ void __launch_bounds__(kD)
wkv6_bwd_reduce_kernel(const float* __restrict__ r,
                       const float* __restrict__ k,
                       const float* __restrict__ u,
                       const float* __restrict__ dy,
                       const float* __restrict__ dv_part,
                       const float* __restrict__ du_part,
                       float* __restrict__ dv, float* __restrict__ du, int B,
                       int T, int H) {
  __shared__ float warp_sum[kD / 32];
  const int j = threadIdx.x;
  const int64_t rows = (int64_t)B * T * H;
  if (blockIdx.x >= rows) {                 // du of head h
    const int h = (int)(blockIdx.x - rows);
    float acc = du_part[(int64_t)h * kD + j];
    for (int b = 1; b < B; ++b) acc += du_part[((int64_t)b * H + h) * kD + j];
    du[(int64_t)h * kD + j] = acc;
    return;
  }
  const int64_t x = (int64_t)blockIdx.x * kD;   // row (b, t, h)
  const int h = (int)(blockIdx.x % H);
  float bonus = r[x + j] * (u[h * kD + j] * k[x + j]);
  bonus += __shfl_xor_sync(kFull, bonus, 16);
  bonus += __shfl_xor_sync(kFull, bonus, 8);
  bonus += __shfl_xor_sync(kFull, bonus, 4);
  bonus += __shfl_xor_sync(kFull, bonus, 2);
  bonus += __shfl_xor_sync(kFull, bonus, 1);
  if (j % 32 == 0) warp_sum[j / 32] = bonus;
  __syncthreads();
  bonus = warp_sum[0] + warp_sum[1];
  const int64_t plane = rows * kD;
  float acc = dv_part[x + j];
#pragma unroll
  for (int q = 1; q < kTiles; ++q) acc += dv_part[q * plane + x + j];
  dv[x + j] = fmaf(bonus, dy[x + j], acc);
}

}  // namespace

// The WKV6 backward over contiguous fp32 r, k, v, w, dy (B, T, H, D), u
// (H, D), s0 and dsT (B, H, D, D; dsT may be null: a zero gradient of the
// final state): writes dr, dk, dv, dw (B, T, H, D), du (H, D) and ds0 (B,
// H, D, D). Scratch (fp32): ckpt of B * H * ceil(T / 16) * D * D floats,
// dv_part of 4 * B * T * H * D and du_part of B * H * D. D must be 64, T >=
// 1, every pointer 16-byte aligned. Two launches on `stream`. Returns 0 or
// a cudaError_t.
extern "C" int repro_wkv6_bwd(const float* r, const float* k, const float* v,
                              const float* w, const float* u, const float* s0,
                              const float* dy, const float* dsT, float* ckpt,
                              float* dv_part, float* du_part, float* dr,
                              float* dk, float* dv, float* dw, float* du,
                              float* ds0, int64_t B, int64_t T, int64_t H,
                              int64_t D, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D != kD ||
      B * H * kTiles > 0x7fffffff || B * T * H + H > 0x7fffffff ||
      T > 0x7fffffff - kChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  wkv6_bwd_kernel<<<(unsigned)(B * H * kTiles), kThreads, kSmem, st>>>(
      r, k, v, w, u, s0, dy, dsT, ckpt, dr, dk, dw, dv_part, du_part, ds0,
      (int)T, (int)H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_reduce_kernel<<<(unsigned)(B * T * H + H), kD, 0, st>>>(
      r, k, u, dy, dv_part, du_part, dv, du, (int)B, (int)T, (int)H);
  return (int)cudaGetLastError();
}
