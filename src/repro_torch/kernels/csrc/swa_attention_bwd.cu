// The backward of sliding-window causal attention (flash schedule) for
// Hopper (sm_90a), on the CUDA cores.
//
// For each (b, h) with the forward's log-sum-exp lse (B, H, Sq), query and
// key positions both counted from 0 and the forward's mask (key j is seen
// by query i unless (causal and j > i) or (window and j <= i - W)):
//     delta_i = sum_d do_id o_id                      (fp32)
//     p_ij    = exp(s_ij * D^-1/2 - lse_i)            (0 where masked)
//     dv_j   += p_ij do_i          dp_ij = do_i . v_j
//     ds_ij   = p_ij (dp_ij - delta_i) D^-1/2
//     dq_i   += ds_ij k_j          dk_j += ds_ij q_i
// q, o, do, dq are (B, Sq, H, D); k, v, dk, dv (B, Sk, KV, D), not
// repeated: head h reads KV head h / (H / KV), so dk and dv of a KV head
// sum over the H / KV query heads of its group (the gradient of the JAX
// package's _repeat_kv). Inputs are fp32 or bf16, D is 120 or 128; every
// product accumulates in fp32 and the results are cast to the input type.
//
// Replaces no Pallas kernel: the JAX package's training attention is the
// jnp flash_attention custom VJP, whose backward _flash_bwd
// (src/repro/models/attention.py:224-260) scans the kv chunks with the
// same formulas. The port's forward is the hand-written swa_attention
// kernel, so its gradient is written by hand as well.
//
// Two launches, so that no sum needs atomics and a shape's result repeats
// bitwise:
// - swa_bwd_dq_kernel: one block of 256 threads per (b, h, 64-row q tile),
//   the tiles with the most kv tiles first. It stages q, do and (first) o in
//   shared memory, writes delta for its rows (read by the second kernel),
//   then walks only the 64-row kv tiles that overlap [q0 - W + 1, q_hi], as
//   the forward does: s and dp for 4 query rows x 4 keys a thread, ds
//   through shared memory, dq += ds k into 32 registers a thread.
// - swa_bwd_dkdv_kernel: one block per (b, KV head, 64-row key tile). It
//   stages k and v, then for each query head of the group in order and each
//   64-row q tile that sees the tile ([k0, k_hi + W - 1] when causal) stages
//   q, do, lse and delta, forms s^T and dp^T for 4 keys x 4 query rows a
//   thread, p and ds through shared memory, and accumulates dv += p^T do and
//   dk += ds^T q in 64 registers a thread.
// Tiles are fp32 in shared memory with a row stride of D + 4 floats (float4
// reads of 8 neighbouring rows fall in distinct banks): 150 KB (dq) and
// 167 KB (dk / dv) of dynamic shared memory, one block per SM.
//
// Bound: five products of 2*D FLOP per unmasked (i, j) pair (s, dp, dv, dq,
// dk; the kernels recompute s and dp once more, 14*D in all) on the fp32
// CUDA cores against q, k, v, o, do, lse read and dq, dk, dv written once.
// Every operand of the inner loops comes from shared memory, so the
// shared-memory loads, not the FMAs, limit them; a tensor-core design
// (wgmma with TMA, as the forward's) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;           // rows of a q tile and of a k tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPS = kT + 4;      // row stride of the p / ds tiles (floats)

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float x) {
  x = fmaf(a.x, b.x, x);
  x = fmaf(a.y, b.y, x);
  x = fmaf(a.z, b.z, x);
  return fmaf(a.w, b.w, x);
}

__device__ __forceinline__ float lane4(float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// 64 rows of D elements (row r at src + r * stride) into dst as fp32 (row
// stride D + 4); rows at or past `valid` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int valid) {
  for (int idx = threadIdx.x; idx < kT * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[r * (D + 4) + c] = r < valid ? to_f32<T>(src[r * stride + c]) : 0.0f;
  }
}

__device__ __forceinline__ bool seen(int qp, int kp, int Sq, int Sk,
                                     int window, int causal) {
  return qp < Sq && kp < Sk && !(causal && kp > qp) &&
         !(window > 0 && kp <= qp - window);
}

// Row r's 4 x 8 accumulator into dst (columns 4tx.. and 64 + 4tx..).
template <typename T, int D>
__device__ __forceinline__ void store_row(T* dst, const float (&acc)[8],
                                          int tx) {
#pragma unroll
  for (int c = 0; c < 4; ++c) dst[4 * tx + c] = from_f32<T>(acc[c]);
  if (64 + 4 * tx < D) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[64 + 4 * tx + c] = from_f32<T>(acc[4 + c]);
  }
}

// acc[i][0..7] += a_i * (row's columns 4tx.. and 64 + 4tx..), for the 4
// rows of a thread, over the 64 rows of `rows` weighted by w_s (row stride
// kPS): acc[i] += sum_r w_s[(4ty + i) * kPS + r] * rows[r].
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][8],
                                           const float* w_s, const float* rows,
                                           int tx, int ty) {
  constexpr int DP = D + 4;
  const bool hi_cols = 64 + 4 * tx < D;
#pragma unroll 2
  for (int r = 0; r < kT; r += 4) {
    float4 wa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wa[i] = load4(w_s + (4 * ty + i) * kPS + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float* row = rows + (r + rr) * DP;
      const float4 a = load4(row + 4 * tx);
      const float4 b = hi_cols ? load4(row + 64 + 4 * tx)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = lane4(wa[i], rr);
        acc[i][0] = fmaf(w, a.x, acc[i][0]);
        acc[i][1] = fmaf(w, a.y, acc[i][1]);
        acc[i][2] = fmaf(w, a.z, acc[i][2]);
        acc[i][3] = fmaf(w, a.w, acc[i][3]);
        acc[i][4] = fmaf(w, b.x, acc[i][4]);
        acc[i][5] = fmaf(w, b.y, acc[i][5]);
        acc[i][6] = fmaf(w, b.z, acc[i][6]);
        acc[i][7] = fmaf(w, b.w, acc[i][7]);
      }
    }
  }
}

// x[i][c] = a row (4ty + i) . b row (tx + 16c), y likewise for (a2, b2):
// two 64 x 64 score tiles in one pass over D.
template <int D>
__device__ __forceinline__ void two_scores(float (&x)[4][4], float (&y)[4][4],
                                           const float* a, const float* b,
                                           const float* a2, const float* b2,
                                           int tx, int ty) {
  constexpr int DP = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[i][c] = y[i][c] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 aa[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) aa[i] = load4(a + (4 * ty + i) * DP + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) bb[c] = load4(b + (tx + 16 * c) * DP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[i][c] = dot4(aa[i], bb[c], x[i][c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) aa[i] = load4(a2 + (4 * ty + i) * DP + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) bb[c] = load4(b2 + (tx + 16 * c) * DP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) y[i][c] = dot4(aa[i], bb[c], y[i][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
swa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ delta, T* __restrict__ dq, int Sq,
                  int Sk, int H, int KV, int window, int causal, float scale) {
  constexpr int DP = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // kT x DP
  float* do_s = q_s + kT * DP;       // kT x DP
  float* k_s = do_s + kT * DP;       // kT x DP (o first, for delta)
  float* v_s = k_s + kT * DP;        // kT x DP
  float* ds_s = v_s + kT * DP;       // kT x kPS
  float* lse_s = ds_s + kT * kPS;    // kT
  float* dl_s = lse_s + kT;          // kT

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / KV);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;   // long tiles first
  const int q_hi = min(q0 + kT, Sq) - 1;
  const int nq = q_hi - q0 + 1;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KV * D;
  const int64_t q_off = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;
  const int64_t row0 = ((int64_t)b * H + h) * Sq + q0;   // lse / delta
  const T* k_bh = k + (int64_t)b * Sk * kv_stride + (int64_t)g * D;
  const T* v_bh = v + (int64_t)b * Sk * kv_stride + (int64_t)g * D;

  load_tile<T, D>(q_s, q + q_off, q_stride, nq);
  load_tile<T, D>(do_s, dout + q_off, q_stride, nq);
  load_tile<T, D>(k_s, o + q_off, q_stride, nq);
  __syncthreads();
  {  // delta = sum_d do * o: four threads a row
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    float x = 0.0f;
    for (int c = part; c < D; c += 4)
      x = fmaf(do_s[r * DP + c], k_s[r * DP + c], x);
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (part == 0) {
      dl_s[r] = x;
      lse_s[r] = r < nq ? lse[row0 + r] : 0.0f;
      if (r < nq) delta[row0 + r] = x;
    }
  }

  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_hi) : Sk - 1;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  for (int k0 = (lo / kT) * kT; k0 <= hi; k0 += kT) {
    __syncthreads();   // o (first tile), the previous k, v and ds are read
    load_tile<T, D>(k_s, k_bh + k0 * kv_stride, kv_stride, Sk - k0);
    load_tile<T, D>(v_s, v_bh + k0 * kv_stride, kv_stride, Sk - k0);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_scores<D>(s, dp, q_s, k_s, do_s, v_s, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kc = tx + 16 * c;
        const float p = seen(q0 + r, k0 + kc, Sq, Sk, window, causal)
                            ? expf(s[i][c] * scale - lse_s[r])
                            : 0.0f;
        ds_s[r * kPS + kc] = p * (dp[i][c] - dl_s[r]) * scale;
      }
    }
    __syncthreads();
    accumulate<D>(acc, ds_s, k_s, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r < nq) store_row<T, D>(dq + q_off + r * q_stride, acc[i], tx);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
swa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                    int window, int causal, float scale) {
  constexpr int DP = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // kT x DP
  float* v_s = k_s + kT * DP;        // kT x DP
  float* q_s = v_s + kT * DP;        // kT x DP
  float* do_s = q_s + kT * DP;       // kT x DP
  float* p_s = do_s + kT * DP;       // kT x kPS: p^T (keys x query rows)
  float* ds_s = p_s + kT * kPS;      // kT x kPS: ds^T
  float* lse_s = ds_s + kT * kPS;    // kT
  float* dl_s = lse_s + kT;          // kT

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int g = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kT;
  const int k_hi = min(k0 + kT, Sk) - 1;
  const int rep = H / KV;
  const int64_t q_stride = (int64_t)H * D, kv_stride = (int64_t)KV * D;
  const int64_t kv_off = ((int64_t)b * Sk + k0) * kv_stride + (int64_t)g * D;

  load_tile<T, D>(k_s, k + kv_off, kv_stride, k_hi - k0 + 1);
  load_tile<T, D>(v_s, v + kv_off, kv_stride, k_hi - k0 + 1);

  // The query rows that see a key of this tile.
  const int lo = causal ? k0 : 0;
  const int hi = window > 0 ? min(Sq - 1, k_hi + window - 1) : Sq - 1;
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = g * rep + hh;
    const int64_t row_h = ((int64_t)b * H + h) * Sq;
    for (int q0 = (lo / kT) * kT; q0 <= hi; q0 += kT) {
      const int nq = min(kT, Sq - q0);
      const int64_t q_off = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * D;
      __syncthreads();   // the previous q, do, p and ds are read
      load_tile<T, D>(q_s, q + q_off, q_stride, nq);
      load_tile<T, D>(do_s, dout + q_off, q_stride, nq);
      if (threadIdx.x < kT) {
        const int r = threadIdx.x;
        lse_s[r] = r < nq ? lse[row_h + q0 + r] : 0.0f;
        dl_s[r] = r < nq ? delta[row_h + q0 + r] : 0.0f;
      }
      __syncthreads();

      // s^T and dp^T: keys 4ty + i against query rows tx + 16c
      float s[4][4], dp[4][4];
      two_scores<D>(s, dp, k_s, q_s, v_s, do_s, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = 4 * ty + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = tx + 16 * c;
          const float p = seen(q0 + r, k0 + kr, Sq, Sk, window, causal)
                              ? expf(s[i][c] * scale - lse_s[r])
                              : 0.0f;
          p_s[kr * kPS + r] = p;
          ds_s[kr * kPS + r] = p * (dp[i][c] - dl_s[r]) * scale;
        }
      }
      __syncthreads();
      accumulate<D>(dv_acc, p_s, do_s, tx, ty);
      accumulate<D>(dk_acc, ds_s, q_s, tx, ty);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = 4 * ty + i;
    if (k0 + kr > k_hi) continue;
    store_row<T, D>(dk + kv_off + kr * kv_stride, dk_acc[i], tx);
    store_row<T, D>(dv + kv_off + kr * kv_stride, dv_acc[i], tx);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
           int window, int causal, float scale, cudaStream_t stream) {
  constexpr int DP = D + 4;
  constexpr int kSmemDq = (4 * kT * DP + kT * kPS + 2 * kT) * (int)sizeof(float);
  constexpr int kSmemDkdv =
      (4 * kT * DP + 2 * kT * kPS + 2 * kT) * (int)sizeof(float);
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        swa_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemDq);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(swa_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemDkdv);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const dim3 grid_q((unsigned)((Sq + kT - 1) / kT), (unsigned)H, (unsigned)B);
  swa_bwd_dq_kernel<T, D><<<grid_q, kThreads, kSmemDq, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), tdo, lse, delta,
      static_cast<T*>(dq), Sq, Sk, H, KV, window, causal, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((unsigned)((Sk + kT - 1) / kT), (unsigned)KV, (unsigned)B);
  swa_bwd_dkdv_kernel<T, D><<<grid_k, kThreads, kSmemDkdv, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Sk, H, KV, window, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Gradients of attention over contiguous q, o, do (B, Sq, H, D) and k, v
// (B, Sk, KV, D), all of one dtype (0 = fp32, 1 = bf16), with the
// forward's fp32 lse (B, H, Sq): dq (B, Sq, H, D), dk, dv (B, Sk, KV, D) in
// that dtype; delta (B, H, Sq) fp32 is scratch. window <= 0 means no
// window; causal is 0 or 1; D is 120 or 128; H a multiple of KV. Two
// launches on `stream`. Returns 0 or a cudaError_t.
extern "C" int repro_swa_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t KV,
    int64_t D, int64_t window, int causal, float scale, int dtype,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV ||
      B > 65535 || H > 65535 || Sq > 0x7fffffff - kT ||
      Sk > 0x7fffffff - kT || window > 0x7fffffff ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int w = window > 0 ? (int)window : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int b = (int)B, sq = (int)Sq, sk = (int)Sk, h = (int)H, kv = (int)KV;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define REPRO_BWD(T, DD)                                                      \
  launch<T, DD>(q, k, v, o, dout, l, dl, dq, dk, dv, b, sq, sk, h, kv, w,     \
                causal, scale, s)
  if (D == 120)
    return dtype == 0 ? REPRO_BWD(float, 120) : REPRO_BWD(__nv_bfloat16, 120);
  if (D == 128)
    return dtype == 0 ? REPRO_BWD(float, 128) : REPRO_BWD(__nv_bfloat16, 128);
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}
