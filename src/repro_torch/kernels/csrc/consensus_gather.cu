// Sparse neighbour-list consensus gossip for Hopper (sm_90a): one round
//     out[i, j] = sum_k w[i, k] * g[idx[i, k], j]
// over agent i's padded closed neighbourhood (the NeighborList layout of
// repro_torch.core.topology: valid entries ascending with the agent itself
// included, padding = the agent's own row with weight exactly 0.0).
//
// Replaces the Pallas TPU kernel consensus_gather_pallas
// (src/repro/kernels/consensus_gather.py:51, body _gather_kernel at :29). The
// TPU version scalar-prefetches idx so a BlockSpec index map can DMA any row
// of g, and carries a VMEM scratch row across the innermost k grid dimension.
// On Hopper blocks carry nothing from one to the next, so the k loop lives
// inside the block.
//
// Numerics. g is read as fp32 (fp32, bf16 or fp16 buffers), the sum is one
// fp32 chain per output in ascending k,
//     acc = -0.0;  acc = acc + w[i, k] * g[idx[i, k], j]   for k = 0..k_max-1,
// spelled __fmul_rn / __fadd_rn (no FMA contraction; -0.0 is the exact
// additive identity, so the first step gives w[i, 0] * g[idx[i, 0], j]), and
// only the store rounds to g's dtype. That is operation for operation the
// plain version (w[:, 0] * g32[idx[:, 0]], then `out + w[:, k] * g32[idx[:,
// k]]` for k = 1..), so both kernels below are bitwise equal to it: they
// differ only in where an operand is read from. Padding slots are gathered
// unconditionally, as on the TPU: their weight 0.0 adds an exact zero.
//
// Preconditions (not checked per launch: the host checks idx once when the
// strategy builds its NeighborList): 0 <= idx < m; out does not overlap g.
//
// Bound. Each source row read once and each output row written once: at
// least 2*m*n*s bytes (s = 4 for fp32), 76.6 MB at (1024, 9347) = 22.9 us
// at 3.35 TB/s, and 748 MB at (10000, 9347) = 223 us; k_max*m*n*2 FLOP is
// far below the card's rate. A block that reads each of its rows' k_max
// sources for itself moves k_max*m*n*s bytes through L2 (345 MB at (1024,
// 9347), k = 9): the L2's read rate, not device memory, was the limit of
// the row kernel below (55 us flushed and warm alike).
//
// Two kernels, chosen by shape alone (the wrapper's gather_plan,
// repro_torch/kernels/consensus_gather.py, picks and sizes them):
//
// consensus_gather_kernel_staged, for m >= 256 and k_max <= kMaxSlots (186;
// the consensus path's lists at m = 1024 and 10,000, k_max = 9). A block of
// 16 warps takes R consecutive output rows, one a warp (R = min(16, 186 /
// k_max, m)), and walks column tiles of 512 bytes (128 fp32 or 256 bf16 /
// fp16 columns, 4 or 8 a lane). It loads the R*k_max slots of its
// rows once, de-duplicates their source rows on the device (each slot enters
// its source row into a shared-memory hash table and keeps the smallest slot
// holding it there, so every slot learns its row's first occurrence in O(1);
// a ballot prefix sum numbers the first occurrences, so the U unique rows
// are kept in the order they first appear, which for ascending lists of
// consecutive rows is ascending but for the ring's wrap), and remaps every
// slot to its source row's place in shared memory. For each tile it then streams the U source
// rows' columns into a ring of shared-memory stages, once each, with 16-byte
// cp.async (4-byte copies, or plain loads for 16-bit buffers, for the
// elements of a chunk that leaves the row), each row placed at its own
// 16-byte phase so the copies land aligned; and every output chain reads its
// k_max operands from shared memory. A k-NN ring has U = R + k_max - 1, so
// L2 reads fall from k_max*m*n*s to (1 + (k_max - 1)/R)*m*n*s (1.5x at k =
// 9); a list whose rows share no neighbour has U = R*k_max and reads no more
// than the row kernel. The ring holds up to kStages stages of U rows in its
// ring_bytes (at least one stage of U = min(R*k_max, m) rows, sized by the
// host); the grid is one wave of 2 blocks an SM (what the ring lets an SM
// hold), each taking an equal run of the (row group, column tile) sequence,
// a whole number of blocks a group where there are fewer groups than
// blocks. The block's fixed cost (the slot load, the de-duplication and the
// first tile's round trip, one after the other) outweighs the L2 reads it
// saves below 256 rows: measured on the H100, it lost to the row kernel at
// m = 64 and 128 and won from 256 on.
//
// consensus_gather_kernel, for m < 256 (the consensus path at m = 64) or
// k_max > 186 (the full-list gather over m up to 1,025 that holds
// consensus_step bitwise): one block a row and a tile of 1024 columns (4
// per thread, 256 apart), idx[i, :] and w[i, :] staged 256 slots at a time,
// the k loop in registers; the blocks in flight cover consecutive rows at
// one column tile, so neighbouring rows' shared sources come from L2.

#include "flat_common.cuh"

namespace {

using namespace repro_flat;

constexpr int kMaxDevices = 64;

// --- consensus_gather_kernel: one row a block ------------------------------

constexpr int kPer = 4;                      // columns per thread
constexpr int kTileCols = kThreads * kPer;   // 1024 columns per block

template <typename T>
__global__ void __launch_bounds__(kThreads)
consensus_gather_kernel(const T* __restrict__ g, const int* __restrict__ idx,
                        const float* __restrict__ w, T* __restrict__ out,
                        int64_t n, int k_max) {
  __shared__ int idx_s[kThreads];
  __shared__ float w_s[kThreads];
  const int64_t i = blockIdx.x;
  const int64_t col0 = (int64_t)blockIdx.y * kTileCols + threadIdx.x;
  float acc[kPer];
#pragma unroll
  for (int c = 0; c < kPer; ++c) acc[c] = -0.0f;

  for (int k0 = 0; k0 < k_max; k0 += kThreads) {
    const int kn = k_max - k0 < kThreads ? k_max - k0 : kThreads;
    if (threadIdx.x < kn) {
      idx_s[threadIdx.x] = idx[i * k_max + k0 + threadIdx.x];
      w_s[threadIdx.x] = w[i * k_max + k0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      const T* src = g + (int64_t)idx_s[k] * n;
      const float wk = w_s[k];
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int64_t col = col0 + (int64_t)c * kThreads;
        if (col < n)
          acc[c] = __fadd_rn(acc[c], __fmul_rn(wk, load_f32(src + col)));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < kPer; ++c) {
    const int64_t col = col0 + (int64_t)c * kThreads;
    if (col < n) store_f32(out + i * n + col, acc[c]);
  }
}

// --- consensus_gather_kernel_staged: R rows a block, sources staged once ---

// Mirrored by the wrapper's gather_plan.
constexpr int kStagedThreads = 512;  // 16 warps, one output row each
constexpr int kStagedWarps = kStagedThreads / 32;
constexpr int kMaxSlots = 186;       // R * k_max: at most one slot a thread
constexpr int kMaxRows = kStagedWarps; // R: one row a warp
constexpr int kStages = 8;           // ring depth cap
constexpr int kRowBytes = 528;       // a staged source row: 512 B + 16 B phase
constexpr int kRingCap = 98304;      // largest ring: 186 rows of 528 B fit
constexpr int kTableBits = 9;        // the de-duplication's hash table
constexpr int kTable = 1 << kTableBits;

template <typename T>
struct Staged {
  static constexpr int kVec = 16 / (int)sizeof(T);    // elements a chunk
  static constexpr int kCols = 512 / (int)sizeof(T);  // columns a tile
  static constexpr int kStride = kRowBytes / (int)sizeof(T);
  static constexpr int kChunks = kCols / kVec + 1;    // chunks a row a tile
  static constexpr int kPerLane = kCols / 32;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
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

// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_at_most(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<kStages - 1>(); break;
  }
}

// One element of a chunk that leaves its row: a 4-byte copy for fp32, a
// plain load and store for the 16-bit dtypes (their element may not be
// 4-byte aligned).
template <typename T>
__device__ __forceinline__ void copy_one(T* dst, const T* src) {
  *dst = *src;
}
template <>
__device__ __forceinline__ void copy_one<float>(float* dst, const float* src) {
  cp_async4(dst, src);
}

// A row's phase: the elements its start lies past a 16-byte boundary.
template <typename T>
__device__ __forceinline__ int phase(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) &
               (Staged<T>::kVec - 1));
}

template <typename T>
__global__ void __launch_bounds__(kStagedThreads, 2)
consensus_gather_kernel_staged(const T* __restrict__ g,
                               const int* __restrict__ idx,
                               const float* __restrict__ w,
                               T* __restrict__ out, int64_t m, int64_t n,
                               int k_max, int rows_per_group, int ring_elems) {
  using S = Staged<T>;
  extern __shared__ __align__(16) unsigned char ring_raw[];
  T* ring = reinterpret_cast<T*>(ring_raw);
  __shared__ int s_key[kTable];         // hash table: source row ...
  __shared__ int s_val[kTable];         // ... and the first slot holding it
  __shared__ int s_pos[kMaxSlots];      // a first occurrence's unique number
  __shared__ int s_src[kMaxSlots];      // unique source rows, first-seen order
  __shared__ int64_t s_base[kMaxSlots]; // a unique row's start less its phase
  __shared__ int2 s_slot[kMaxSlots];    // (offset in a stage, weight bits)
  __shared__ int s_count[kStagedWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = threadIdx.x;            // this thread's slot

  // The (group, column tile) sequence has fewer than 2^31 entries (the
  // wrapper checks), so its arithmetic is 32-bit.
  const int tiles_per_row = (int)((n + S::kCols - 1) / S::kCols);
  const int groups = (int)((m + rows_per_group - 1) / rows_per_group);
  const int total = groups * tiles_per_row;
  int t = (int)((int64_t)total * blockIdx.x / gridDim.x);
  const int t_end = (int)((int64_t)total * (blockIdx.x + 1) / gridDim.x);

  while (t < t_end) {
    const int grp = t / tiles_per_row;
    const int grp_end = (grp + 1) * tiles_per_row;
    const int n_t = (t_end < grp_end ? t_end : grp_end) - t;
    const int64_t c_first = (int64_t)(t - grp * tiles_per_row) * S::kCols;
    const int64_t i0 = (int64_t)grp * rows_per_group;
    const int rows = m - i0 < rows_per_group ? (int)(m - i0) : rows_per_group;
    const int n_slots = rows * k_max;

    // The group's slots (idx[i0 .. i0 + rows, :] is contiguous), and the
    // first slot holding each source row: every slot enters its row into a
    // hash table (open addressing) and keeps the smallest slot there.
    for (int i = threadIdx.x; i < kTable; i += kStagedThreads) {
      s_key[i] = -1;
      s_val[i] = kMaxSlots;
    }
    int v = 0, h = 0;
    float wv = 0.0f;
    if (s < n_slots) {
      v = idx[i0 * k_max + s];
      wv = w[i0 * k_max + s];
      h = (int)(((unsigned)v * 2654435761u) >> (32 - kTableBits));
    }
    __syncthreads();
    if (s < n_slots) {
      for (;;) {
        const int prev = atomicCAS(&s_key[h], -1, v);
        if (prev == -1 || prev == v) break;
        h = (h + 1) & (kTable - 1);
      }
      atomicMin(&s_val[h], s);
    }
    __syncthreads();
    const int first = s < n_slots ? s_val[h] : s;
    const bool is_first = s < n_slots && first == s;
    const unsigned ball = __ballot_sync(0xffffffffu, is_first);
    if (lane == 0) s_count[warp] = __popc(ball);
    __syncthreads();
    int before = 0, n_unique = 0;
#pragma unroll
    for (int x = 0; x < kStagedWarps; ++x) {
      before += x < warp ? s_count[x] : 0;
      n_unique += s_count[x];
    }
    if (is_first) {
      const int u = before + __popc(ball & ((1u << lane) - 1u));
      const int64_t start = (int64_t)v * n;
      s_pos[s] = u;
      s_src[u] = v;
      s_base[u] = start - phase(g + start);
    }
    __syncthreads();
    if (s < n_slots) {
      const int u = s_pos[first];
      s_slot[s] = make_int2(u * S::kStride + phase(g + (int64_t)v * n),
                            __float_as_int(wv));
    }
    __syncthreads();

    const int stage = n_unique * S::kStride;
    const int depth = min(kStages, ring_elems / stage);   // >= 1 (the host)
    const int n_chunks = n_unique * S::kChunks;

    // Issue the copies of the column tile at c0 into the stage at st: chunk
    // q of unique row u is the 16 aligned bytes at s_base[u] + c0 + q*kVec,
    // stored at st + u*kStride + q*kVec. A chunk inside its row is copied
    // whole; of a chunk that leaves the row (at a row's first or last
    // tile), only the elements in the row.
    auto issue = [&](int64_t c0, T* st) {
      for (int e = threadIdx.x; e < n_chunks; e += kStagedThreads) {
        const int u = e / S::kChunks, q = e - u * S::kChunks;
        const int64_t col = s_base[u] + c0 + q * S::kVec;
        const int64_t in_row = col - (int64_t)s_src[u] * n;
        T* dst = st + u * S::kStride + q * S::kVec;
        if (in_row >= 0 && in_row + S::kVec <= n) {
          cp_async16(dst, g + col);
        } else {
#pragma unroll
          for (int x = 0; x < S::kVec; ++x)
            if (in_row + x >= 0 && in_row + x < n) copy_one(dst + x, g + col + x);
        }
      }
    };

    // The ring: tile j of the segment is read from stage j mod depth. With
    // two stages or more, the copies of tile j + depth - 1 are issued right
    // after the barrier that makes tile j visible, into the stage every
    // warp finished with in the previous iteration: one barrier a tile.
    // With one stage, a second barrier frees it before the next copy.
    int fill = 0, use = 0;
    const int ahead = depth > 1 ? depth - 1 : 1;   // tiles in flight
    for (int p = 0; p < ahead; ++p) {
      if (p < n_t) issue(c_first + (int64_t)p * S::kCols, ring + fill * stage);
      cp_async_commit();
      fill = fill + 1 == depth ? 0 : fill + 1;
    }
    const int2* sl = s_slot + warp * k_max;   // this warp's row's slots
    for (int j = 0; j < n_t; ++j) {
      cp_async_wait_at_most(ahead - 1);
      __syncthreads();
      if (depth > 1) {
        if (j + ahead < n_t)
          issue(c_first + (int64_t)(j + ahead) * S::kCols, ring + fill * stage);
        cp_async_commit();
        fill = fill + 1 == depth ? 0 : fill + 1;
      }
      const T* st = ring + use * stage + lane;
      use = use + 1 == depth ? 0 : use + 1;
      if (warp < rows) {
        float acc[S::kPerLane];
#pragma unroll
        for (int q = 0; q < S::kPerLane; ++q) acc[q] = -0.0f;
#pragma unroll 4
        for (int k = 0; k < k_max; ++k) {
          const int2 x = sl[k];
          const float wk = __int_as_float(x.y);
#pragma unroll
          for (int q = 0; q < S::kPerLane; ++q)
            acc[q] = __fadd_rn(acc[q], __fmul_rn(wk, load_f32(st + x.x + 32 * q)));
        }
        const int64_t c0 = c_first + (int64_t)j * S::kCols + lane;
        T* o = out + (i0 + warp) * n + c0;
#pragma unroll
        for (int q = 0; q < S::kPerLane; ++q)
          if (c0 + 32 * q < n) store_f32(o + 32 * q, acc[q]);
      }
      if (depth == 1) {
        __syncthreads();   // every warp is done with the one stage
        if (j + 1 < n_t) issue(c_first + (int64_t)(j + 1) * S::kCols, ring);
        cp_async_commit();
      }
    }
    // every warp is done with the slot tables before the next group's
    __syncthreads();
    t += n_t;
  }
}

template <typename T>
int launch_rows(const void* g, const int* idx, const float* w, void* out,
                int64_t m, int64_t n, int k_max, cudaStream_t stream) {
  const int64_t tiles = (n + kTileCols - 1) / kTileCols;
  if (m > 0x7fffffff || tiles > 65535) return (int)cudaErrorInvalidValue;
  consensus_gather_kernel<T><<<dim3((unsigned)m, (unsigned)tiles), kThreads,
                               0, stream>>>(
      static_cast<const T*>(g), idx, w, static_cast<T*>(out), n, k_max);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_staged(const void* g, const int* idx, const float* w, void* out,
                  int64_t m, int64_t n, int k_max, int rows, int blocks,
                  int ring_bytes, int device, cudaStream_t stream) {
  const int64_t slots = (int64_t)rows * k_max;
  const int64_t u_max = slots < m ? slots : m;
  const int64_t tiles = (m + rows - 1) / rows * ((n + Staged<T>::kCols - 1) /
                                                 Staged<T>::kCols);
  if (rows < 1 || rows > kMaxRows || slots > kMaxSlots || tiles > 0x7fffffff ||
      blocks < 1 || ring_bytes % 16 != 0 || ring_bytes > kRingCap ||
      ring_bytes < u_max * kRowBytes)
    return (int)cudaErrorInvalidValue;
  auto kernel = consensus_gather_kernel_staged<T>;
  {
    // once per device: the opt-in to kRingCap of dynamic shared memory, and
    // the largest shared-memory carveout, so two blocks fit an SM
    static std::atomic<bool> opted[kMaxDevices];
    const bool known = device >= 0 && device < kMaxDevices;
    if (!known || !opted[device].load(std::memory_order_relaxed)) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingCap);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return (int)e;
      if (known) opted[device].store(true, std::memory_order_relaxed);
    }
  }
  kernel<<<(unsigned)blocks, kStagedThreads, ring_bytes, stream>>>(
      static_cast<const T*>(g), idx, w, static_cast<T*>(out), m, n, k_max,
      rows, ring_bytes / (int)sizeof(T));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* g, const int* idx, const float* w, void* out,
           int64_t m, int64_t n, int k_max, int rows, int blocks,
           int ring_bytes, int device, cudaStream_t stream) {
  if (rows == 0) return launch_rows<T>(g, idx, w, out, m, n, k_max, stream);
  return launch_staged<T>(g, idx, w, out, m, n, k_max, rows, blocks,
                          ring_bytes, device, stream);
}

}  // namespace

// One gossip round over an (m, k_max) int32 neighbour list idx with fp32
// weights w, on row-major (m, n) g and out (dtype: 0 float32, 1 bfloat16,
// 2 float16). rows = 0 launches consensus_gather_kernel; rows >= 1 launches
// consensus_gather_kernel_staged with groups of `rows` output rows, `blocks`
// blocks and a ring of `ring_bytes` of shared memory (the wrapper's
// gather_plan). device keys the once-per-device shared-memory opt-in.
// Returns 0 or a cudaError_t.
extern "C" int repro_consensus_gather(const void* g, const int* idx,
                                      const float* w, void* out, int64_t m,
                                      int64_t n, int k_max, int dtype,
                                      int rows, int blocks, int ring_bytes,
                                      int device, void* stream) {
  if (m <= 0 || n <= 0 || k_max <= 0 || dtype < 0 || dtype > 2 || rows < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(T)                                                        \
  return launch<T>(g, idx, w, out, m, n, k_max, rows, blocks, ring_bytes,     \
                   device, s)
  if (dtype == 0) REPRO_LAUNCH(float);
  if (dtype == 1) REPRO_LAUNCH(__nv_bfloat16);
  REPRO_LAUNCH(__half);
#undef REPRO_LAUNCH
}
