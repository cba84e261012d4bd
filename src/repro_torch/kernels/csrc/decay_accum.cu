// Fused decay-weighted accumulation for Hopper (sm_90a): out = acc + d * g
// over a flat (m, n) buffer with one coefficient per row, in one launch.
//
// Replaces the Pallas TPU kernel decay_accum_pallas
// (src/repro/kernels/decay_accum.py:27, body _decay_accum_kernel at :18),
// which the JAX dispatch vmaps over the agent axis (dispatch.py:289-295). It
// is the decay/mask-weighted SGD step of the federated loop (d = -eta * w,
// strategies.py:243) and scale_rows (g + (w - 1) * g, dispatch.py:336).
//
// Numerics, as the JAX dispatch contract (dispatch.py:32-35): acc and g are
// read as fp32, the sum is taken in fp32 and only the store rounds to acc's
// dtype (fp32, bf16 or fp16). The two operations are spelled __fmul_rn and
// __fadd_rn so they round exactly as the plain version's two torch ops do.
//
// Bound: 12 B per element in fp32 (read acc, read g, write out), 2 FLOP per
// element, so far below the card's ridge: device-memory bandwidth bounds it.
// Design: a plain grid-stride pass; blockIdx.y is the row, so a block reads
// its coefficient once and a warp reads 32 neighbouring elements. The TPU's
// 1-D block_n tiling is not carried over. out may be acc (the in-place
// update of the training loop): each element is read and written by one
// thread only.

#include "flat_common.cuh"

namespace {

using namespace repro_flat;

template <typename T>
__global__ void __launch_bounds__(kThreads)
decay_accum_kernel(const T* acc, const T* __restrict__ g, T* out,
                   const float* __restrict__ d, int64_t d_stride, float d_value,
                   int64_t m, int64_t n) {
  for (int64_t row = blockIdx.y; row < m; row += gridDim.y) {
    const float coef = row_coef(d, d_stride, d_value, row);
    const int64_t base = row * n;
    for (int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; col < n;
         col += (int64_t)gridDim.x * blockDim.x) {
      const float a = load_f32(acc + base + col);
      const float x = load_f32(g + base + col);
      store_f32(out + base + col, __fadd_rn(a, __fmul_rn(coef, x)));
    }
  }
}

template <typename T>
int launch(const void* acc, const void* g, void* out, const float* d,
           int64_t d_stride, float d_value, int64_t m, int64_t n,
           cudaStream_t stream) {
  decay_accum_kernel<T><<<rows_grid(m, n), kThreads, 0, stream>>>(
      static_cast<const T*>(acc), static_cast<const T*>(g),
      static_cast<T*>(out), d, d_stride, d_value, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

// out[i, j] = acc[i, j] + d_i * g[i, j] for an (m, n) row-major buffer; an
// (n,) buffer is m = 1. d_i = d[i * d_stride] when d is given, else d_value.
// dtype: 0 float32, 1 bfloat16, 2 float16. Returns 0 or a cudaError_t.
extern "C" int repro_decay_accum(const void* acc, const void* g, void* out,
                                 const float* d, int64_t d_stride,
                                 float d_value, int64_t m, int64_t n,
                                 int dtype, void* stream) {
  if (m <= 0 || n <= 0 || dtype < 0 || dtype > 2 || d_stride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(acc, g, out, d, d_stride, d_value, m, n, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(acc, g, out, d, d_stride, d_value, m, n, s);
  return launch<__half>(acc, g, out, d, d_stride, d_value, m, n, s);
}
