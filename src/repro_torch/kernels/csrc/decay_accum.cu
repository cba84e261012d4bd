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
// element, so far below the card's ridge: device-memory bandwidth bounds it,
// and what matters is enough bytes in flight on every SM.
//
// Design: the contiguous (m, n) buffer is one flat array of m*n elements.
// Each thread moves 16-byte vectors (4 fp32 or 8 bf16 / fp16 elements),
// one per loop trip with its loads and its rows' coefficients issued before
// any arithmetic, over a grid-stride loop on a grid of at most 4 blocks per
// SM (the SM count cached per device, flat_common.cuh; the launch bounds
// keep all 4 resident): enough bytes in flight for HBM's rate. A small
// buffer gets one vector a thread, on as many blocks as that takes; two
// vectors a trip were no faster at (1024, 9347) and slower at (7, 9347).
// The body is aligned to out: a head of up to 3 (7) elements before out's
// first 16-byte boundary and the tail after the last whole vector are
// scalar steps of the first threads. acc and g are read as vectors where
// they share out's alignment (the whole buffers of the training loop do),
// else element by element; either way the arithmetic is the same. A vector
// can straddle a row: its first element's row r0 is one division, and when
// n is at least the vector's length it reaches at most into row r0 + 1 (one
// compare per element); for shorter rows each element's row is divided
// out. out may be acc (the in-place update of the training loop): each
// element is read and written by one thread only.

#include "flat_common.cuh"

namespace {

using namespace repro_flat;

constexpr int kBlocksPerSm = 4;

// The elements of a 16-byte vector of T as fp32 values, and back (round to
// nearest even); Vec<T> holds the 16-bit dtypes' conversions.
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  __device__ static float lo(unsigned w) { return __uint_as_float(w << 16); }
  __device__ static float hi(unsigned w) {
    return __uint_as_float(w & 0xffff0000u);
  }
  __device__ static unsigned short to_bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __device__ static unsigned short at(const __nv_bfloat16* p) {
    return __bfloat16_as_ushort(*p);
  }
};
template <> struct Vec<__half> {
  __device__ static float lo(unsigned w) {
    return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
  }
  __device__ static float hi(unsigned w) {
    return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
  }
  __device__ static unsigned short to_bits(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
  __device__ static unsigned short at(const __half* p) {
    return __half_as_ushort(*p);
  }
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& r, float* v) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 4) {
      v[k] = __uint_as_float(w[k]);
    } else {
      v[2 * k] = Vec<T>::lo(w[k]);
      v[2 * k + 1] = Vec<T>::hi(w[k]);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* v) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 4) {
      w[k] = __float_as_uint(v[k]);
    } else {
      w[k] = (unsigned)Vec<T>::to_bits(v[2 * k]) |
             ((unsigned)Vec<T>::to_bits(v[2 * k + 1]) << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The 4-byte word at p (element aligned only).
template <typename T> __device__ __forceinline__ unsigned word_at(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(*p);
  } else {
    return (unsigned)Vec<T>::at(p) | ((unsigned)Vec<T>::at(p + 1) << 16);
  }
}

// The 16 bytes at p: one vector load where p is 16-byte aligned, else one
// load per 4-byte word's elements.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, bool aligned) {
  if (aligned) return *reinterpret_cast<const uint4*>(p);
  constexpr int kW = 4 / sizeof(T);                   // elements per word
  return make_uint4(word_at(p), word_at(p + kW), word_at(p + 2 * kW),
                    word_at(p + 3 * kW));
}

// The row of flat element e; 32-bit division where the buffer allows it.
__device__ __forceinline__ int64_t row_of(int64_t e, int64_t n, bool narrow) {
  return narrow ? (int64_t)((uint32_t)e / (uint32_t)n) : e / n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
decay_accum_kernel(const T* acc, const T* __restrict__ g, T* out,
                   const float* __restrict__ d, int64_t d_stride, float d_value,
                   int64_t n, int64_t total, int64_t head, int64_t vecs,
                   bool acc_aligned, bool g_aligned) {
  constexpr int kV = 16 / sizeof(T);   // elements per vector
  const bool narrow = total <= 0xffffffffLL;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;

  // the scalar head [0, head) and tail [body_end, total)
  const int64_t body_end = head + vecs * kV;
  if (tid < head + (total - body_end)) {
    const int64_t e = tid < head ? tid : body_end + (tid - head);
    const float coef = row_coef(d, d_stride, d_value, row_of(e, n, narrow));
    store_f32(out + e,
              __fadd_rn(load_f32(acc + e), __fmul_rn(coef, load_f32(g + e))));
  }

  for (int64_t v = tid; v < vecs; v += stride) {
    // the vector's loads and its rows' coefficients first, then arithmetic
    const int64_t e0 = head + v * kV;
    const uint4 ra = load16(acc + e0, acc_aligned);
    const uint4 rg = load16(g + e0, g_aligned);
    float a[kV], x[kV], c[kV];
    if (n >= kV) {            // at most one row boundary in the vector
      const int64_t r0 = row_of(e0, n, narrow);
      const int64_t edge = (r0 + 1) * n - e0;
      const float c0 = row_coef(d, d_stride, d_value, r0);
      const float c1 =
          edge < kV ? row_coef(d, d_stride, d_value, r0 + 1) : c0;
#pragma unroll
      for (int k = 0; k < kV; ++k) c[k] = k < edge ? c0 : c1;
    } else {
#pragma unroll
      for (int k = 0; k < kV; ++k)
        c[k] = row_coef(d, d_stride, d_value, row_of(e0 + k, n, narrow));
    }
    unpack<T>(ra, a);
    unpack<T>(rg, x);
#pragma unroll
    for (int k = 0; k < kV; ++k) a[k] = __fadd_rn(a[k], __fmul_rn(c[k], x[k]));
    *reinterpret_cast<uint4*>(out + e0) = pack<T>(a);
  }
}

template <typename T>
int launch(const void* acc, const void* g, void* out, const float* d,
           int64_t d_stride, float d_value, int64_t m, int64_t n, int device,
           cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int64_t total = m * n;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  int64_t head = (int64_t)((16 - o % 16) % 16) / (int64_t)sizeof(T);
  if (head > total) head = total;
  const int64_t vecs = (total - head) / kV;
  const bool acc_aligned = (reinterpret_cast<uintptr_t>(acc) - o) % 16 == 0;
  const bool g_aligned = (reinterpret_cast<uintptr_t>(g) - o) % 16 == 0;
  const int sms = sm_count(device);
  const int64_t cap = sms > 0 ? (int64_t)sms * kBlocksPerSm : 512;
  int64_t blocks = (vecs + kThreads - 1) / kThreads;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;             // the scalar head and tail
  decay_accum_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(acc), static_cast<const T*>(g),
      static_cast<T*>(out), d, d_stride, d_value, n, total, head, vecs,
      acc_aligned, g_aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// out[i, j] = acc[i, j] + d_i * g[i, j] for an (m, n) row-major buffer; an
// (n,) buffer is m = 1. d_i = d[i * d_stride] when d is given, else d_value.
// dtype: 0 float32, 1 bfloat16, 2 float16; device: the buffers' CUDA device
// ordinal. Buffers need only their dtype's alignment. Returns 0 or a
// cudaError_t.
extern "C" int repro_decay_accum(const void* acc, const void* g, void* out,
                                 const float* d, int64_t d_stride,
                                 float d_value, int64_t m, int64_t n,
                                 int dtype, int device, void* stream) {
  if (m <= 0 || n <= 0 || dtype < 0 || dtype > 2 || d_stride < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(acc, g, out, d, d_stride, d_value, m, n, device, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(acc, g, out, d, d_stride, d_value, m, n,
                                 device, s);
  return launch<__half>(acc, g, out, d, d_stride, d_value, m, n, device, s);
}
