// Shared pieces of the flat-buffer kernels (decay_accum.cu, flat_update.cu):
// fp32 loads and stores for the three buffer dtypes, the per-row coefficient,
// the cached SM count and the launch grid over an (m, n) row-major matrix.
//
// Every kernel here spells its arithmetic with the IEEE round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn). nvcc
// never contracts those into an FMA, so each kernel performs exactly the
// roundings of its plain PyTorch version (one rounding per torch operation)
// whatever --fmad says.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro_flat {

// dtype codes shared with the Python wrappers: 0 float32, 1 bfloat16,
// 2 float16.
constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float load_f32(const T* p);
template <> __device__ __forceinline__ float load_f32<float>(const float* p) {
  return *p;
}
template <> __device__ __forceinline__ float load_f32<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <> __device__ __forceinline__ float load_f32<__half>(const __half* p) {
  return __half2float(*p);
}

// Round to nearest even, as torch's .to(bfloat16) / .to(float16).
template <typename T> __device__ __forceinline__ void store_f32(T* p, float v);
template <> __device__ __forceinline__ void store_f32<float>(float* p, float v) {
  *p = v;
}
template <> __device__ __forceinline__ void store_f32<__nv_bfloat16>(
    __nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ void store_f32<__half>(__half* p,
                                                             float v) {
  *p = __float2half_rn(v);
}

// A per-row coefficient: coef[row * stride] when coef is given (stride 1 for
// an (m,) vector, 0 for a one-element device scalar), else the by-value
// scalar.
__device__ __forceinline__ float row_coef(const float* coef, int64_t stride,
                                          float value, int64_t row) {
  return coef != nullptr ? coef[row * stride] : value;
}

// The SM count of a device, asked of the runtime once per device and
// process and cached: the flat kernels size their grids by it on every
// launch, and their launch path makes no other runtime call. -1 (a device
// the runtime refuses; its error is then the launch's) gives a fixed grid:
// every kernel here strides over its whole buffer, so the grid's size
// changes speed only.
inline int sm_count(int device) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> cache[kMaxDevices];   // 0: not asked yet
  if (device < 0 || device >= kMaxDevices) return -1;
  int sms = cache[device].load(std::memory_order_relaxed);
  if (sms > 0) return sms;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return -1;
  cache[device].store(sms, std::memory_order_relaxed);
  return sms;
}

// Grid for an elementwise pass over an (m, n) matrix: blockIdx.y walks rows
// (grid-stride past 65,535), blockIdx.x and the threads walk the columns of a
// row (grid-stride past the cap), so a thread reads its row's coefficient
// once and neighbouring threads touch neighbouring addresses.
inline dim3 rows_grid(int64_t m, int64_t n, int device) {
  const int sms = sm_count(device);
  int64_t bx = (n + kThreads - 1) / kThreads;
  const int64_t cap_x = sms > 0 ? (int64_t)sms * 16 : 2048;
  if (bx > cap_x) bx = cap_x;
  int64_t by = m < 65535 ? m : 65535;
  return dim3((unsigned)bx, (unsigned)by, 1);
}

}  // namespace repro_flat
