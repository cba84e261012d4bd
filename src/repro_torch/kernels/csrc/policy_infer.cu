// Fused serving inference for Hopper (sm_90a): obs-normalize -> 3-layer tanh
// policy MLP -> mean or mean + exp(log_std) * noise, one launch per batch.
//
// Replaces the Pallas TPU kernel policy_infer_pallas
// (src/repro/kernels/policy_infer.py:61, body _policy_infer_kernel at :33).
// It computes the same function: x = (obs - norm_mean) / norm_std with a real
// division, h1 = tanh(x @ w1 + b1), h2 = tanh(h1 @ w2 + b2),
// mean = tanh(h2 @ w3 + b3), act = sample ? mean + exp(log_std) * noise : mean,
// all in fp32, cast to obs's dtype on the store. Weights are (in, out),
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
// weights resident in VMEM. Here every block stages all weights in shared
// memory once (coalesced copies, about 21 KB at 6-64-1 with the per-warp
// scratch), then each warp takes one batch row at a time in a grid-stride
// loop:
//   * lanes normalize the row's obs_dim values into the warp's shared scratch;
//   * lanes split the hidden units of layer 1 and write h1 to the scratch;
//   * lanes split the hidden units of layer 2 and keep h2 in registers;
//   * each action column is a warp-shuffle reduction of the lanes' partial
//     h2 . w3[:, a] sums, and lane a holds the result.
// Lane a then reads noise[row, a] and writes act[row, a] to the same element,
// so out may alias noise (the twin of the donated noise buffer in the JAX
// engine): each element is read and then written by one thread only.
//
// Numerics: fp32 accumulation throughout, tanhf / expf and IEEE division.
// Built WITHOUT --use_fast_math (which would turn '/' and tanhf into
// approximations) and with nvcc's default --fmad=true, so a*b+c contracts to
// one FMA: results are not bitwise equal to a CPU matmul, and the comparisons
// use a stated tolerance.
//
// A wgmma/TMA redesign (batch rows as the M dimension of a warpgroup product)
// is later work; at these widths it would not change the launch-bound time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Limits the Python wrapper checks too (repro_torch.kernels.policy_infer).
// hidden <= 128 keeps w2 (hidden^2 floats, 64 KB) and the rest in shared
// memory; h2 lives in kMaxHidden / 32 registers per lane.
constexpr int kMaxHidden = 128;
constexpr int kMaxObsDim = 128;
constexpr int kMaxActDim = 32;
constexpr int kBlocksPerSm = 8;

template <typename T> __device__ __forceinline__ float load_f32(const T* p);
template <> __device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}
template <> __device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T> __device__ __forceinline__ void store_f32(T* p, float v);
template <> __device__ __forceinline__ void store_f32<float>(float* p, float v) {
  *p = v;
}
template <> __device__ __forceinline__ void store_f32<__nv_bfloat16>(
    __nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// TO: obs and output dtype; TN: noise dtype. noise and out may alias, so
// neither is __restrict__.
template <typename TO, typename TN>
__global__ void __launch_bounds__(kThreads)
policy_infer_kernel(const TO* __restrict__ obs, const TN* noise, TO* out,
                    const float* __restrict__ norm_mean,
                    const float* __restrict__ norm_std,
                    const float* __restrict__ w1, const float* __restrict__ b1,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    const float* __restrict__ w3, const float* __restrict__ b3,
                    const float* __restrict__ log_std, int64_t batch,
                    int obs_dim, int hidden, int act_dim, int sample) {
  extern __shared__ float smem[];
  float* s_w1 = smem;                          // obs_dim * hidden
  float* s_w2 = s_w1 + obs_dim * hidden;       // hidden * hidden
  float* s_w3 = s_w2 + hidden * hidden;        // hidden * act_dim
  float* s_b1 = s_w3 + hidden * act_dim;       // hidden
  float* s_b2 = s_b1 + hidden;                 // hidden
  float* s_b3 = s_b2 + hidden;                 // act_dim
  float* s_std = s_b3 + act_dim;               // act_dim: exp(log_std)
  float* s_nm = s_std + act_dim;               // obs_dim
  float* s_ns = s_nm + obs_dim;                // obs_dim
  float* s_warp = s_ns + obs_dim;              // kWarps * (obs_dim + hidden)

  stage(s_w1, w1, obs_dim * hidden);
  stage(s_w2, w2, hidden * hidden);
  stage(s_w3, w3, hidden * act_dim);
  stage(s_b1, b1, hidden);
  stage(s_b2, b2, hidden);
  stage(s_b3, b3, act_dim);
  stage(s_nm, norm_mean, obs_dim);
  stage(s_ns, norm_std, obs_dim);
  for (int a = threadIdx.x; a < act_dim; a += kThreads) s_std[a] = expf(log_std[a]);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* x = s_warp + warp * (obs_dim + hidden);
  float* h1 = x + obs_dim;

  for (int64_t row = (int64_t)blockIdx.x * kWarps + warp; row < batch;
       row += (int64_t)gridDim.x * kWarps) {
    const TO* obs_row = obs + row * obs_dim;
    for (int i = lane; i < obs_dim; i += 32)
      x[i] = (load_f32(obs_row + i) - s_nm[i]) / s_ns[i];
    __syncwarp();

    for (int j = lane; j < hidden; j += 32) {
      float acc = 0.0f;
      for (int i = 0; i < obs_dim; ++i) acc = fmaf(x[i], s_w1[i * hidden + j], acc);
      h1[j] = tanhf(acc + s_b1[j]);
    }
    __syncwarp();

    float h2[kMaxHidden / 32];
#pragma unroll
    for (int q = 0; q < kMaxHidden / 32; ++q) {
      const int j = lane + 32 * q;
      h2[q] = 0.0f;
      if (j < hidden) {
        float acc = 0.0f;
        for (int k = 0; k < hidden; ++k) acc = fmaf(h1[k], s_w2[k * hidden + j], acc);
        h2[q] = tanhf(acc + s_b2[j]);
      }
    }
    // Every lane is done reading this row's x and h1 before any lane writes
    // the next row's.
    __syncwarp();

    float mine = 0.0f;
    for (int a = 0; a < act_dim; ++a) {
      float part = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxHidden / 32; ++q) {
        const int j = lane + 32 * q;
        if (j < hidden) part = fmaf(h2[q], s_w3[j * act_dim + a], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == a) mine = part;
    }
    if (lane < act_dim) {
      float act = tanhf(mine + s_b3[lane]);
      const int64_t e = row * act_dim + lane;
      if (sample) act += s_std[lane] * load_f32(noise + e);
      store_f32(out + e, act);
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

template <typename TO, typename TN>
int launch(const void* obs, const void* noise, void* out, const float* nm,
           const float* ns, const float* w1, const float* b1, const float* w2,
           const float* b2, const float* w3, const float* b3,
           const float* log_std, int64_t batch, int obs_dim, int hidden,
           int act_dim, int sample, cudaStream_t stream) {
  const size_t smem_floats = (size_t)obs_dim * hidden + (size_t)hidden * hidden +
                             (size_t)hidden * act_dim + 2 * hidden + 2 * act_dim +
                             2 * obs_dim + (size_t)kWarps * (obs_dim + hidden);
  const size_t smem = smem_floats * sizeof(float);
  auto kernel = policy_infer_kernel<TO, TN>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorNoDevice;
  int64_t blocks = (batch + kWarps - 1) / kWarps;
  if (blocks > (int64_t)sms * kBlocksPerSm) blocks = (int64_t)sms * kBlocksPerSm;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const TO*>(obs), static_cast<const TN*>(noise),
      static_cast<TO*>(out), nm, ns, w1, b1, w2, b2, w3, b3, log_std, batch,
      obs_dim, hidden, act_dim, sample);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Returns 0 or a cudaError_t.
extern "C" int repro_policy_infer(const void* obs, const void* noise, void* out,
                                  const float* norm_mean, const float* norm_std,
                                  const float* w1, const float* b1,
                                  const float* w2, const float* b2,
                                  const float* w3, const float* b3,
                                  const float* log_std, int64_t batch,
                                  int obs_dim, int hidden, int act_dim,
                                  int sample, int obs_dtype, int noise_dtype,
                                  void* stream) {
  if (batch <= 0 || obs_dim < 1 || obs_dim > kMaxObsDim || hidden < 1 ||
      hidden > kMaxHidden || act_dim < 1 || act_dim > kMaxActDim ||
      obs_dtype < 0 || obs_dtype > 1 || noise_dtype < 0 || noise_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TO, TN)                                                  \
  return launch<TO, TN>(obs, noise, out, norm_mean, norm_std, w1, b1, w2, b2, \
                        w3, b3, log_std, batch, obs_dim, hidden, act_dim,     \
                        sample, s)
  if (obs_dtype == 0 && noise_dtype == 0) REPRO_LAUNCH(float, float);
  if (obs_dtype == 0 && noise_dtype == 1) REPRO_LAUNCH(float, __nv_bfloat16);
  if (obs_dtype == 1 && noise_dtype == 0) REPRO_LAUNCH(__nv_bfloat16, float);
  REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_LAUNCH
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
