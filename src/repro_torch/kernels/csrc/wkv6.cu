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
// Design (simple first). One block per (b, h), one thread per value column
// j (64 threads). Thread j keeps column j of S in 64 registers for the
// whole T loop, so the state crosses device memory twice per call (read at
// the start, written at the end), never per step. Steps are staged in
// shared memory kTB at a time: the 64 threads copy r_t, k_t, w_t and v_t of
// kTB steps (each row is 64 contiguous floats of the (B, T, H, D) layout, so
// a warp reads 128 contiguous bytes; no transposes), one barrier, then kTB
// steps of compute read r, k, w, u as broadcast float4s from shared memory.
// The sum over i runs in four interleaved partial sums (i mod 4), added as
// (p0 + p1) + (p2 + p3): another order than the plain version's einsum, so
// kernel and plain agree to fp32 rounding, not bitwise.
//
// Numerics. Built with nvcc's default --fmad=true (no --use_fast_math): the
// three mul-adds of each (i, j) term contract to FMAs, 1 FMUL + 3 FFMA = 7
// FLOP per term. The function needs 5: the bonus factors out as
// v_t[j] * sum_i r_t[i] u[i] k_t[i] (O(D) per step), which leaves one FMA
// for r . S and a multiply plus an FMA for the decay update.
//
// Bound. Per call 4*B*T*H*D*4 bytes in (r, k, v, w), B*T*H*D*4 out (y), the
// state in and out (2*B*H*D*D*4), and the function's 5*B*T*H*D*(D+1) FLOP
// (not the kernel's 7 per term). At the prefill shape (8, 512, 32, 64) that
// is 176 MB (52.6 us at 3.35 TB/s) against 2.73 GFLOP (40.7 us at
// 67 TFLOP/s fp32): bytes bound it; at (1, 4096, 32, 64), 169 MB (50.4 us).
// At decode (T = 1) the state I/O (16 KB per (b, h) each way) and the launch
// latency bound it: 8.4 MB at B = 8 is 2.5 us. Occupancy is the weak point
// of this design: B*H blocks of two warps (256 blocks at B = 8, 32 at B = 1
// on 132 SMs), each a chain of dependent steps, and no overlap of the next
// batch's loads with this batch's compute.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;       // head size: one thread per value column
constexpr int kTB = 32;      // steps staged in shared memory per barrier

__global__ void __launch_bounds__(kD)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* s0,
            float* __restrict__ y, float* sT, int64_t T, int64_t H) {
  __shared__ __align__(16) float r_s[kTB][kD];
  __shared__ __align__(16) float k_s[kTB][kD];
  __shared__ __align__(16) float w_s[kTB][kD];
  __shared__ float v_s[kTB][kD];
  __shared__ __align__(16) float u_s[kD];

  const int j = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / H, h = bh % H;

  // Column j of S: for each i the 64 threads read one contiguous row.
  float s[kD];
  const float* s_in = s0 + bh * kD * kD;
#pragma unroll
  for (int i = 0; i < kD; ++i) s[i] = s_in[i * kD + j];
  u_s[j] = u[h * kD + j];

  const int64_t step = H * kD;                  // floats between steps
  const int64_t base = (b * T * H + h) * kD;    // (b, t = 0, h, 0)
  for (int64_t t0 = 0; t0 < T; t0 += kTB) {
    const int nt = (int)(T - t0 < kTB ? T - t0 : kTB);
    __syncthreads();            // the previous batch has been read
#pragma unroll 8
    for (int tt = 0; tt < nt; ++tt) {
      const int64_t off = base + (t0 + tt) * step + j;
      r_s[tt][j] = r[off];
      k_s[tt][j] = k[off];
      w_s[tt][j] = w[off];
      v_s[tt][j] = v[off];
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = v_s[tt][j];
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < kD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&r_s[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&k_s[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&w_s[tt][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&u_s[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float kv = kk[q] * vj;
          p[q] += rr[q] * (s[i + q] + uu[q] * kv);
          s[i + q] = ww[q] * s[i + q] + kv;
        }
      }
      y[base + (t0 + tt) * step + j] = (p[0] + p[1]) + (p[2] + p[3]);
    }
  }

  float* s_out = sT + bh * kD * kD;
#pragma unroll
  for (int i = 0; i < kD; ++i) s_out[i * kD + j] = s[i];
}

}  // namespace

// WKV6 over contiguous fp32 r, k, v, w (B, T, H, D), u (H, D) and s0
// (B, H, D, D); writes y (B, T, H, D) and the final state sT (B, H, D, D),
// which may be s0 itself. D must be 64, T >= 1. Returns 0 or a cudaError_t.
extern "C" int repro_wkv6(const float* r, const float* k, const float* v,
                          const float* w, const float* u, const float* s0,
                          float* y, float* sT, int64_t B, int64_t T,
                          int64_t H, int64_t D, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D != kD || B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  wkv6_kernel<<<(unsigned)(B * H), kD, 0, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, w, u, s0, y, sT, T, H);
  return (int)cudaGetLastError();
}
