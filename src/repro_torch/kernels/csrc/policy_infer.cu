// Fused serving inference for Hopper (sm_90a): obs-normalize -> 3-layer tanh
// policy MLP -> mean or mean + exp(log_std) * noise, one launch per batch.
//
// Replaces the Pallas TPU kernel policy_infer_pallas
// (src/repro/kernels/policy_infer.py:61, body _policy_infer_kernel at :33).
// It computes the same function: x = (obs - norm_mean) / norm_std with a real
// division, h1 = tanh(x @ w1 + b1), h2 = tanh(h1 @ w2 + b2),
// mean = tanh(h2 @ w3 + b3), act = sample ? mean + exp(log_std) * noise : mean,
// each value an fp32 (the dot products accumulate in fp64: Numerics below),
// cast to obs's dtype on the store. Weights are (in, out),
// row-major, as in the JAX package.
//
// Work per batch row: 2 * (obs_dim*H + H*H + H*act) FLOP, which is 9,088 FLOP
// at the serving width 6-64-1, against 32 B of obs + noise + action traffic
// in fp32 (24 B obs, 4 B noise, 4 B action), plus 18.7 KB of weights read once
// per block. At B = 1024 that is about 180 FLOP per byte: above the card's
// fp32 ridge, so by the roofline the kernel is bound by fp32 CUDA-core
// arithmetic (the shapes are far too narrow for tensor cores to pay). In
// practice, at serving batch sizes (8..1024 rows) the whole launch is a few
// microseconds and launch latency dominates.
//
// Design. The TPU kernel walks a sequential grid of block_b-row tiles with the
// weights resident in VMEM. Here every block of 8 warps stages all weights in
// shared memory (about 55 KB at 6-64-1 with w2's fp64 copy and the per-warp
// scratch), then each of its first rows_per_block warps takes one batch row
// at a time in a grid-stride loop:
//   * lanes normalize the row's obs_dim values into the warp's scratch;
//   * lanes split the hidden units of layer 1 and write h1 to the scratch;
//   * lanes split the hidden units of layer 2 and keep h2 in registers, each
//     output summed as four partial chains (k mod 4) added pairwise, so the
//     dependent chain is hidden/4 FMAs long;
//   * each action column is a warp-shuffle reduction of the lanes' partial
//     h2 . w3[:, a] sums, and lane a holds the result.
// Lane a then reads noise[row, a] and writes act[row, a] to the same element,
// so out may alias noise (the twin of the donated noise buffer in the JAX
// engine): each element is read and then written by one thread only.
//
// What bounds it: at the serving buckets (8..1024 rows) the launch is
// latency, not FLOP or bytes. Its design answers:
//   * the weights: every thread issues all of its copies before it waits on
//     any, 16-byte cp.async for the 16-byte-aligned body of each tensor and
//     4-byte cp.async for a misaligned head or tail (the wrapper takes any
//     fp32 view), each tensor placed in shared memory at its source's phase
//     so the body's 16-byte copies land aligned; two commit groups, w1, b1
//     and the norm stats first, then w2, b2, w3, b3 and log_std, so each
//     warp computes its first row's layer 1 while w2 is in flight (a copy
//     loop that stores each 4-byte load to shared memory waits on it, a
//     round trip per element a thread);
//   * the rows: a row's obs values and noise are loaded into registers
//     before the block issues any weight copy (the next row's while a row
//     computes), so no load of a row waits behind the weights;
//   * layer 2 reads the 32 KB of fp64 w2 from shared memory for every row,
//     so an SM's shared-memory bandwidth bounds how many rows it should
//     take: a block takes ceil(B / SMs) rows (at most 8, one a warp), so a
//     bucket spreads over as many SMs as it has rows (B = 8: 8 blocks of one
//     row; 64: 64; 256: 128 blocks of 2; 1024: 128 blocks of 8), while all 8
//     warps still issue the block's copies and convert w2 (blocks of fewer
//     warps, which did both with fewer threads, were slower on the card);
//   * the SM count is asked of the runtime once per device, and the dynamic
//     shared-memory opt-in is set once per size, so a launch makes no other
//     runtime call.
// What is left (clock64 stamps of block 0 on the H100, PERF.md): issuing the
// copies, layer 1 behind the first copies, the fp64 conversion of w2, and
// layer 2's shared-memory reads.
//
// Numerics: every layer takes and gives fp32 values (x, h1, h2 and the
// action are rounded to fp32; tanhf / expf and IEEE division in fp32), and
// each layer's dot products and bias add accumulate in fp64 and are rounded
// to fp32 once, before the tanh. An fp32 sum of 64 unit-scale terms is off
// by a few ulp of its size in any order, which after three saturating layers
// puts the kernel's error and the fp32 plain version's at the same size, so
// no fp32 order keeps within twice the plain version's own error on every
// input (the rule of chip_smoke.py's phase 3); the fp64 sums leave only the
// fp32 roundings both share. Built WITHOUT --use_fast_math (which would turn
// '/' and tanhf into approximations). Results are not bitwise equal to a CPU
// matmul, and the comparisons use a stated tolerance.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

#include "flat_common.cuh"

namespace {

using repro_flat::load_f32;
using repro_flat::store_f32;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Limits the Python wrapper checks too (repro_torch.kernels.policy_infer).
// hidden <= 128 keeps w1, w2 and the rest in shared memory; h2 lives in
// kMaxHidden / 32 registers per lane.
constexpr int kMaxHidden = 128;
constexpr int kMaxObsDim = 128;
constexpr int kMaxActDim = 32;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxDevices = 64;

// Floats a staged tensor of n elements takes in shared memory: up to 3 of
// phase in front of it, rounded up to 16 bytes, so the next one starts
// 16-byte aligned.
__host__ __device__ constexpr int region(int n) { return (n + 6) & ~3; }

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

// Issue (and do not wait for) the copies of the n floats at src into the
// 16-byte-aligned region at base, placed at src's phase within 16 bytes:
// 4-byte copies up to src's first 16-byte boundary, 16-byte copies for the
// body, 4-byte copies for the tail. Returns where element 0 lands.
__device__ __forceinline__ const float* stage_async(float* base,
                                                    const float* src, int n) {
  const int ph = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  float* dst = base + ph;
  const int head = min((4 - ph) & 3, n);
  const int body = (n - head) >> 2;
  if (threadIdx.x < head) cp_async4(dst + threadIdx.x, src + threadIdx.x);
#pragma unroll 1
  for (int c = threadIdx.x; c < body; c += kThreads)
    cp_async16(dst + head + 4 * c, src + head + 4 * c);
  const int tail = head + 4 * body + threadIdx.x;
  if (tail < n) cp_async4(dst + tail, src + tail);
  return dst;
}

// TO: obs and output dtype; TN: noise dtype; kNQ = ceil(hidden / 32), the
// hidden units a lane owns. noise and out may alias, so neither is
// __restrict__. Warps from rows_per_block (<= kWarps) on stage and convert
// the weights but take no row.
template <typename TO, typename TN, int kNQ>
__global__ void __launch_bounds__(kThreads)
policy_infer_kernel(const TO* __restrict__ obs, const TN* noise, TO* out,
                    const float* __restrict__ norm_mean,
                    const float* __restrict__ norm_std,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    const float* __restrict__ log_std, int64_t batch,
                    int obs_dim, int hidden, int act_dim, int sample,
                    int rows_per_block) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * rows_per_block;
  int64_t row = warp < rows_per_block
                    ? (int64_t)blockIdx.x * rows_per_block + warp : batch;
  // a row's obs values (lane + 32 p) and noise (lane < act_dim), loaded into
  // registers ahead of their use: the first row's before any weight copy is
  // issued, so they do not queue behind the weights
  float ov[kMaxObsDim / 32], nv = 0.0f;
  auto fetch = [&](int64_t rw) {
    const TO* obs_row = obs + rw * obs_dim;
#pragma unroll
    for (int p = 0; p < kMaxObsDim / 32; ++p)
      ov[p] = lane + 32 * p < obs_dim ? load_f32(obs_row + lane + 32 * p) : 0.0f;
    if (sample && lane < act_dim) nv = load_f32(noise + rw * act_dim + lane);
  };
  if (row < batch) fetch(row);

  float* r = smem;
  // group 0: what a row's layer 1 reads
  const float* s_w1 = stage_async(r, w1, obs_dim * hidden);
  r += region(obs_dim * hidden);
  const float* s_b1 = stage_async(r, b1, hidden);
  r += region(hidden);
  const float* s_nm = stage_async(r, norm_mean, obs_dim);
  r += region(obs_dim);
  const float* s_ns = stage_async(r, norm_std, obs_dim);
  r += region(obs_dim);
  cp_async_commit();
  // group 1: the rest, in flight while the first row's layer 1 runs
  const float* s_w2 = stage_async(r, w2, hidden * hidden);
  r += region(hidden * hidden);
  const float* s_b2 = stage_async(r, b2, hidden);
  r += region(hidden);
  const float* s_w3 = stage_async(r, w3, hidden * act_dim);
  r += region(hidden * act_dim);
  const float* s_b3 = stage_async(r, b3, act_dim);
  r += region(act_dim);
  const float* s_ls = stage_async(r, log_std, act_dim);
  r += region(act_dim);
  cp_async_commit();
  // hidden <= 64 (kNQ <= 2; the serving width): w2 is converted to fp64
  // once a block, so layer 2 reads its operands as they are multiplied;
  // wider layers convert each w2 element as it is read
  constexpr bool kW2F64 = kNQ <= 2;
  double* s_w2d = reinterpret_cast<double*>(r);
  if (kW2F64) r += 2 * hidden * hidden;
  // per-warp scratch: the row's h1 (fp64) and x
  double* h1 = reinterpret_cast<double*>(r) + warp * hidden;
  float* x = r + 2 * kWarps * hidden + warp * obs_dim;
  // the hidden units of layers 2 and 3 this lane owns; a unit past hidden
  // reads unit hidden - 1 and is dropped
  int jj[kNQ];
#pragma unroll
  for (int q = 0; q < kNQ; ++q) jj[q] = min(lane + 32 * q, hidden - 1);

  // normalize the fetched row into x, then h1 = tanh(x @ w1 + b1)
  auto layer1 = [&]() {
#pragma unroll
    for (int p = 0; p < kMaxObsDim / 32; ++p) {
      const int i = lane + 32 * p;
      if (i < obs_dim) x[i] = (ov[p] - s_nm[i]) / s_ns[i];
    }
    __syncwarp();
    for (int j = lane; j < hidden; j += 32) {
      double acc = 0.0;
      for (int i = 0; i < obs_dim; ++i)
        acc = fma((double)x[i], (double)s_w1[i * hidden + j], acc);
      h1[j] = (double)tanhf((float)(acc + (double)s_b1[j]));
    }
    __syncwarp();
  };

  cp_async_wait<1>();
  __syncthreads();
  if (row < batch) layer1();
  cp_async_wait<0>();
  __syncthreads();
  if (kW2F64) {
    for (int i = threadIdx.x; i < hidden * hidden; i += kThreads)
      s_w2d[i] = (double)s_w2[i];
    __syncthreads();
  }
  const float act_std = lane < act_dim ? expf(s_ls[lane]) : 0.0f;

  for (; row < batch; row += stride) {
    // the next row's obs and noise load while this row computes; this
    // row's noise is read before its action is written (out may alias it)
    const int64_t next = row + stride;
    const float noise_v = nv;
    if (next < batch) fetch(next);
    // layer 2: four partial fp64 chains a unit (k mod 4), summed pairwise
    float h2[kNQ];
    {
      double a[4][kNQ];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < kNQ; ++q) a[c][q] = 0.0;
      auto w2_at = [&](int k, int q) {
        const int e = k * hidden + jj[q];
        return kW2F64 ? s_w2d[e] : (double)s_w2[e];
      };
      int k = 0;
#pragma unroll 2
      for (; k + 3 < hidden; k += 4) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const double hk = h1[k + c];
#pragma unroll
          for (int q = 0; q < kNQ; ++q) a[c][q] = fma(hk, w2_at(k + c, q), a[c][q]);
        }
      }
      for (; k < hidden; ++k) {
#pragma unroll
        for (int q = 0; q < kNQ; ++q) a[0][q] = fma(h1[k], w2_at(k, q), a[0][q]);
      }
#pragma unroll
      for (int q = 0; q < kNQ; ++q)
        h2[q] = tanhf((float)(((a[0][q] + a[1][q]) + (a[2][q] + a[3][q])) +
                              (double)s_b2[jj[q]]));
    }
    // Every lane is done reading this row's x and h1 before any lane writes
    // the next row's.
    __syncwarp();

    double mine = 0.0;
    for (int a = 0; a < act_dim; ++a) {
      double part = 0.0;
#pragma unroll
      for (int q = 0; q < kNQ; ++q)
        if (lane + 32 * q < hidden)
          part = fma((double)h2[q], (double)s_w3[jj[q] * act_dim + a], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == a) mine = part;
    }
    if (lane < act_dim) {
      float act = tanhf((float)(mine + (double)s_b3[lane]));
      const int64_t e = row * act_dim + lane;
      if (sample) act += act_std * noise_v;
      store_f32(out + e, act);
    }
    if (next < batch) layer1();
  }
}

template <typename TO, typename TN, int kNQ>
int launch(const void* obs, const void* noise, void* out, const float* nm,
           const float* ns, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3,
           const float* log_std, int64_t batch, int obs_dim, int hidden,
           int act_dim, int sample, int device, cudaStream_t stream) {
  const int smem_floats = region(obs_dim * hidden) + region(hidden) +
                          2 * region(obs_dim) + region(hidden * hidden) +
                          region(hidden) + region(hidden * act_dim) +
                          2 * region(act_dim) +
                          (kNQ <= 2 ? 2 * hidden * hidden : 0) +
                          kWarps * (2 * hidden + obs_dim);
  const int smem = smem_floats * (int)sizeof(float);
  auto kernel = policy_infer_kernel<TO, TN, kNQ>;
  if (smem > 48 * 1024) {
    // the opt-in, once per device and size (the largest set so far)
    static std::atomic<int> opted[kMaxDevices];
    const bool known = device >= 0 && device < kMaxDevices;
    if (!known || opted[device].load(std::memory_order_relaxed) < smem) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      if (known) opted[device].store(smem, std::memory_order_relaxed);
    }
  }
  const int sms = repro_flat::sm_count(device);
  const int64_t sm_n = sms > 0 ? sms : 132;
  int64_t rpb = (batch + sm_n - 1) / sm_n;         // rows a block
  if (rpb > kWarps) rpb = kWarps;
  const int64_t cap = sm_n * kBlocksPerSm;
  int64_t blocks = (batch + rpb - 1) / rpb;
  if (blocks > cap) blocks = cap;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const TO*>(obs), static_cast<const TN*>(noise),
      static_cast<TO*>(out), nm, ns, w1, b1, w2, b2, w3, b3, log_std, batch,
      obs_dim, hidden, act_dim, sample, (int)rpb);
  return (int)cudaGetLastError();
}

template <typename TO, typename TN>
int launch_nq(const void* obs, const void* noise, void* out, const float* nm,
              const float* ns, const float* w1, const float* b1,
              const float* w2, const float* b2, const float* w3,
              const float* b3, const float* log_std, int64_t batch,
              int obs_dim, int hidden, int act_dim, int sample, int device,
              cudaStream_t stream) {
#define REPRO_NQ(NQ)                                                          \
  return launch<TO, TN, NQ>(obs, noise, out, nm, ns, w1, b1, w2, b2, w3, b3, \
                            log_std, batch, obs_dim, hidden, act_dim, sample, \
                            device, stream)
  switch ((hidden + 31) / 32) {
    case 1: REPRO_NQ(1);
    case 2: REPRO_NQ(2);
    case 3: REPRO_NQ(3);
    default: REPRO_NQ(4);
  }
#undef REPRO_NQ
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. device: the CUDA device index of
// the tensors (keys the cached SM count). Returns 0 or a cudaError_t.
extern "C" int repro_policy_infer(const void* obs, const void* noise, void* out,
                                  const float* norm_mean, const float* norm_std,
                                  const float* w1, const float* b1,
                                  const float* w2, const float* b2,
                                  const float* w3, const float* b3,
                                  const float* log_std, int64_t batch,
                                  int obs_dim, int hidden, int act_dim,
                                  int sample, int obs_dtype, int noise_dtype,
                                  int device, void* stream) {
  if (batch <= 0 || obs_dim < 1 || obs_dim > kMaxObsDim || hidden < 1 ||
      hidden > kMaxHidden || act_dim < 1 || act_dim > kMaxActDim ||
      obs_dtype < 0 || obs_dtype > 1 || noise_dtype < 0 || noise_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TO, TN)                                                  \
  return launch_nq<TO, TN>(obs, noise, out, norm_mean, norm_std, w1, b1, w2,  \
                           b2, w3, b3, log_std, batch, obs_dim, hidden,       \
                           act_dim, sample, device, s)
  if (obs_dtype == 0 && noise_dtype == 0) REPRO_LAUNCH(float, float);
  if (obs_dtype == 0 && noise_dtype == 1) REPRO_LAUNCH(float, __nv_bfloat16);
  if (obs_dtype == 1 && noise_dtype == 0) REPRO_LAUNCH(__nv_bfloat16, float);
  REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_LAUNCH
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
