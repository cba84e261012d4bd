// Sliding-window causal attention (flash schedule, online softmax) for
// Hopper (sm_90a).
//
// For each (b, h) and query i, with key positions j and query positions
// both counted from 0:
//     s[i, j] = (q_i . k_j) * D^-1/2                  (fp32)
//     s[i, j] = -1e30  where (causal and j > i) or (window and j <= i - W)
//     o_i     = sum_j softmax_j(s[i, :]) v_j          (fp32, cast to q's type)
// q is (B, Sq, H, D); k and v are (B, Sk, KV, D), not repeated: head h
// reads KV head h / (H / KV), the mapping of the JAX package's _repeat_kv
// (each KV head repeated H / KV times in a row). Inputs are fp32 or bf16,
// converted to fp32 on load; D is 120 or 128.
//
// Replaces the Pallas TPU kernel swa_attention_pallas
// (src/repro/kernels/swa_attention.py:80, body _swa_kernel at :25). That
// kernel walks a grid (B, H, q blocks, kv blocks) with the kv axis
// sequential and carries the running max, denominator and accumulator in
// VMEM scratch; kv blocks outside [q_lo - W + 1, q_hi] are skipped. Hopper
// blocks run in no order, so here the kv axis is a loop inside the block,
// which visits only the kv tiles that overlap that range (the same skip: the
// work is O(Sq * W), not O(Sq * Sk)). The softmax weights p stay in fp32 for
// p @ v, as in the TPU kernel (the JAX model's own flash_attention rounds
// them to q's type first). Unlike the TPU kernel, any Sq and Sk are taken:
// rows past Sq are computed on zeros and not stored, keys past Sk get
// weight 0. The caller refuses shapes with a query row that has no key in
// its window (Sq >= Sk + W): its softmax is over no key at all.
//
// Design (simple first). One block of 256 threads per (b, h, 64-row q
// tile). The q tile and each 64-row k and v tile are staged in shared
// memory as fp32 (row stride D + 4 floats: float4 reads of 8 neighbouring
// rows fall in distinct banks), 112-119 KB of dynamic shared memory, so one
// block per SM. Thread (ty, tx) of a 16 x 16 grid owns query rows
// 4ty..4ty+3: it computes their scores against keys tx + 16c (c < 4) with
// fp32 FMAs on the CUDA cores, the row max and sum go across the 16
// threads of the row by warp shuffles, p goes through shared memory, and
// the thread accumulates columns 4tx..4tx+3 and 64+4tx..64+4tx+3 of its
// rows' outputs in 32 registers. No tensor cores, no TMA, no overlap of the
// next tile's loads with this tile's compute: those are for a later kernel.
//
// Bound. The function needs 4*D FLOP per unmasked (i, j) pair (2*D for
// q.k, 2*D for p*v) and reads q, k, v and writes o once. At the prefill
// shape (1, 8192, 32 heads / 8 KV, D 120) with W = 4096 that is 805M pairs,
// 387 GFLOP: 5.8 ms at 67 TFLOP/s fp32 (this kernel computes in fp32 on the
// CUDA cores), against 157 MB of bf16 I/O (47 us at 3.35 TB/s): operations
// bound it. Its weakness: every product is a shared-memory operand, so the
// loads from shared memory, not the FMAs, limit the inner loops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPS = kBK + 4;     // row stride of the p tile (floats)
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// 64 rows of D elements (row r at src + r * stride) into dst (row stride
// D + 4) as fp32; rows at or past `valid` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int valid) {
  constexpr int kC = D / 4;
  for (int idx = threadIdx.x; idx < 64 * kC; idx += kThreads) {
    const int r = idx / kC, c = (idx - r * kC) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid) x = load4(src + r * stride + c);
    store4(dst + r * (D + 4) + c, x);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Sk, int H, int KV, int window, int causal,
                     float scale) {
  constexpr int DP = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // kBQ x DP
  float* k_s = q_s + kBQ * DP;     // kBK x DP
  float* v_s = k_s + kBK * DP;     // kBK x DP
  float* p_s = v_s + kBK * DP;     // kBQ x kPS

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int q_hi = min(q0 + kBQ, Sq) - 1;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KV * D;
  const T* q_blk = q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;
  const T* k_bh = k + (int64_t)b * Sk * kv_stride + (int64_t)g * D;
  const T* v_bh = v + (int64_t)b * Sk * kv_stride + (int64_t)g * D;

  load_tile<T, D>(q_s, q_blk, q_stride, Sq - q0);

  // The kv tiles that overlap [q0 - W + 1, q_hi] (the Pallas block skip).
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_hi) : Sk - 1;

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
  }
  const bool hi_cols = 64 + 4 * tx < D;   // this thread's second 4 columns

  for (int k0 = (lo / kBK) * kBK; k0 <= hi; k0 += kBK) {
    __syncthreads();   // the previous tile's k, v and p have been read
    load_tile<T, D>(k_s, k_bh + k0 * kv_stride, kv_stride, Sk - k0);
    load_tile<T, D>(v_s, v_bh + k0 * kv_stride, kv_stride, Sk - k0);
    __syncthreads();

    // s = q k^T for rows 4ty + i, keys tx + 16c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(q_s + (4 * ty + i) * DP + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) ka[c] = load4(k_s + (tx + 16 * c) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[i][c];
          x = fmaf(qa[i].x, ka[c].x, x);
          x = fmaf(qa[i].y, ka[c].y, x);
          x = fmaf(qa[i].z, ka[c].z, x);
          x = fmaf(qa[i].w, ka[c].w, x);
          s[i][c] = x;
        }
    }

    // mask, online softmax, p to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        float x = s[i][c] * scale;
        if (kp >= Sk) {
          x = -INFINITY;                      // no such key: weight 0
        } else if ((causal && kp > qp) || (window > 0 && kp <= qp - window)) {
          x = kMasked;
        }
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        p_s[(4 * ty + i) * kPS + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += p v for rows 4ty + i, columns 4tx.. and 64 + 4tx..
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = load4(p_s + (4 * ty + i) * kPS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = v_s + (c + cc) * DP;
        const float4 va = load4(vr + 4 * tx);
        const float4 vb = hi_cols ? load4(vr + 64 + 4 * tx)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y
                        : cc == 2 ? pa[i].z : pa[i].w;
          acc[i][0] = fmaf(p, va.x, acc[i][0]);
          acc[i][1] = fmaf(p, va.y, acc[i][1]);
          acc[i][2] = fmaf(p, va.z, acc[i][2]);
          acc[i][3] = fmaf(p, va.w, acc[i][3]);
          acc[i][4] = fmaf(p, vb.x, acc[i][4]);
          acc[i][5] = fmaf(p, vb.y, acc[i][5]);
          acc[i][6] = fmaf(p, vb.z, acc[i][6]);
          acc[i][7] = fmaf(p, vb.w, acc[i][7]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* out = o + ((int64_t)b * Sq + r) * q_stride + (int64_t)h * D;
    store4(out + 4 * tx, make_float4(acc[i][0] / den, acc[i][1] / den,
                                     acc[i][2] / den, acc[i][3] / den));
    if (hi_cols)
      store4(out + 64 + 4 * tx, make_float4(acc[i][4] / den, acc[i][5] / den,
                                            acc[i][6] / den, acc[i][7] / den));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int window, int causal, float scale,
           cudaStream_t stream) {
  constexpr int kSmem = (3 * 64 * (D + 4) + kBQ * kPS) * (int)sizeof(float);
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        swa_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)H, (unsigned)B);
  swa_attention_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, window,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Attention over contiguous q (B, Sq, H, D) and k, v (B, Sk, KV, D), all of
// one dtype (0 = fp32, 1 = bf16), into o (B, Sq, H, D) of that dtype.
// window <= 0 means no window; causal is 0 or 1; D is 120 or 128; H a
// multiple of KV. Returns 0 or a cudaError_t.
extern "C" int repro_swa_attention(const void* q, const void* k, const void* v,
                                   void* o, int64_t B, int64_t Sq, int64_t Sk,
                                   int64_t H, int64_t KV, int64_t D,
                                   int64_t window, int causal, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV ||
      B > 65535 || H > 65535 || Sq > 0x7fffffff - kBQ || Sk > 0x7fffffff ||
      window > 0x7fffffff || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int w = window > 0 ? (int)window : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = (int)B, sq = (int)Sq, sk = (int)Sk, h = (int)H, kv = (int)KV;
  if (D == 120)
    return dtype == 0
        ? launch<float, 120>(q, k, v, o, b, sq, sk, h, kv, w, causal, scale, s)
        : launch<__nv_bfloat16, 120>(q, k, v, o, b, sq, sk, h, kv, w, causal,
                                     scale, s);
  if (D == 128)
    return dtype == 0
        ? launch<float, 128>(q, k, v, o, b, sq, sk, h, kv, w, causal, scale, s)
        : launch<__nv_bfloat16, 128>(q, k, v, o, b, sq, sk, h, kv, w, causal,
                                     scale, s);
  return (int)cudaErrorInvalidValue;
}
