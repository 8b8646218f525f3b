// Fused SDC scan + top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sdc/sdc.py::sdc_topk
// (_sdc_topk_kernel, _sdc_topk_kernel_packed, _merge_running_topk): for
// every query, the k documents of highest SDC score
//
//   score = ((a*a) * dot + (a*beta) * (sum c_q + sum c_d)) + D*beta^2) * inv
//
// with dot the exact int32 code product, inv the reciprocal document
// norm, documents with !(inv > 0) excluded, and ties broken toward the
// lower document id. Empty slots come back as (-1e30, -1).
//
// What bounds it: the corpus. At Q = 64 queries and D = 128 the scan reads
// N * (D + 4) bytes once and does 2*Q*D int8 operations per document, far
// below the card's ridge point, so the floor is HBM bandwidth. The design
// reads every corpus byte once per call: each block owns one slice of the
// documents and holds ALL of the batch's query codes in shared memory
// (64 x 128 int8 = 8 KB), so the corpus is not re-read per query tile.
// Rows are loaded as 16-byte vectors straight into registers (one document
// per thread), scored against every query with __dp4a (exact int32), and
// nibble-packed rows are unpacked in registers (lo = even dims, hi = odd
// dims) against query halves split beforehand; Hopper has no int4 MMA.
// Query rows are read from shared memory as 16-byte vectors. The grid is
// one full wave: as many slices as blocks fit on the SMs at once. This
// first version scores on the CUDA cores, so at Q = 64 the dp4a work, not
// HBM, is what it waits on; a tensor-core (mma/wgmma) inner product is the
// next step.
//
// Top-k without a sequential grid: blocks run in parallel and in no order,
// so each block keeps, per query, a candidate buffer in shared memory of
// 64-bit keys that order (score desc, id asc) as unsigned integers. A
// document enters only if its key beats the query's current k-th best
// key; a buffer that fills is sorted (bitonic) and cut back to k. Each
// block writes its per-query top-k partials [Q, n_slices, k]; a second
// kernel merges them with the same buffer into [Q, k]. Keys are unique
// (ids are), so the result does not depend on the order blocks finish in.
//
// The epilogue uses __fmul_rn / __fadd_rn so that no FMA contraction
// changes the reference's rounding (the file is also built -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

namespace {

constexpr int kThreads = 256;  // threads per block = documents per round
constexpr float kNegInf = -1e30f;

// Total order (score desc, id asc) as an unsigned 64-bit key: larger is
// better. 0 is below every real key and marks an empty slot.
__device__ __forceinline__ u64 make_key(float v, int id) {
  unsigned b = __float_as_uint(v);
  unsigned ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)ord << 32) | (u64)(0xFFFFFFFFu - (unsigned)id);
}

__device__ __forceinline__ float key_val(u64 key) {
  unsigned ord = (unsigned)(key >> 32);
  unsigned b = (ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord;
  return __uint_as_float(b);
}

__device__ __forceinline__ int key_id(u64 key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
}

// Per-query candidate buffers in shared memory. Every function below is
// called by all threads of the block with the same arguments.
struct Selector {
  u64* buf;     // [nq][cap]
  u64* thresh;  // [nq] k-th best key once a query holds k entries, else 0
  int* count;   // [nq] entries in use (may run past cap on overflow)
  int* base;    // [nq] count at the start of the current round
  int cap;      // power of two, >= 2k
  int k;

  __device__ void insert(int q, u64 key) {
    if (key > thresh[q]) {
      int slot = atomicAdd(&count[q], 1);
      if (slot < cap) buf[q * cap + slot] = key;
    }
  }

  // Bitonic sort of one buffer, best key first.
  __device__ void sort_desc(u64* a) {
    for (int size = 2; size <= cap; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = threadIdx.x; i < cap; i += blockDim.x) {
          int j = i ^ stride;
          if (j > i) {
            u64 x = a[i], y = a[j];
            bool desc = (i & size) == 0;
            if (desc ? (x < y) : (x > y)) {
              a[i] = y;
              a[j] = x;
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // Sort query q's buffer and keep its best min(count, k) entries.
  // Requires count[q] <= cap and a barrier since count[q] was last written.
  __device__ void compact(int q) {
    u64* b = buf + q * cap;
    int c = count[q];
    for (int i = c + threadIdx.x; i < cap; i += blockDim.x) b[i] = 0ull;
    __syncthreads();
    sort_desc(b);
    if (threadIdx.x == 0) {
      int m = c < k ? c : k;
      count[q] = m;
      thresh[q] = (m == k) ? b[k - 1] : 0ull;
    }
    __syncthreads();
  }

  // End of a round in which each thread offered at most one key per query.
  // A buffer that overflowed drops the round's entries, is cut back to k,
  // and the round is offered again in sub-rounds of cap - k threads, which
  // cannot overflow. rescore(q) gives this thread's key for query q again.
  template <class Rescore>
  __device__ void end_round(int nq, Rescore rescore) {
    __syncthreads();
    for (int q = 0; q < nq; ++q) {
      int c = count[q];
      if (c > cap) {
        __syncthreads();
        if (threadIdx.x == 0) count[q] = base[q];
        __syncthreads();
        compact(q);
        const int S = cap - k;
        for (int r0 = 0; r0 < (int)blockDim.x; r0 += S) {
          if ((int)threadIdx.x >= r0 && (int)threadIdx.x < r0 + S) insert(q, rescore(q));
          __syncthreads();
          bool full = count[q] > k;
          __syncthreads();
          if (full) compact(q);
        }
      } else if (c > cap / 2) {
        compact(q);
      }
    }
    for (int q = threadIdx.x; q < nq; q += blockDim.x) base[q] = count[q];
    __syncthreads();
  }

  __device__ void init(int nq) {
    for (int q = threadIdx.x; q < nq; q += blockDim.x) {
      count[q] = 0;
      base[q] = 0;
      thresh[q] = 0ull;
    }
  }
};

// Shared memory: buf [qc][cap] u64, query words [qc][QSTRIDE] int (each
// row 16-byte aligned, read as int4), thresh [qc] u64, qsum/count/base
// [qc] int.
template <int D, bool PACKED>
__global__ void __launch_bounds__(kThreads)
sdc_scan_kernel(const int* __restrict__ qa,      // int8 [Q, D]; packed: even dims [Q, D/2]
                const int* __restrict__ qb,      // packed: odd dims [Q, D/2]; else unused
                const uint8_t* __restrict__ docs,  // [N, D] int8 or [N, D/2] packed
                const float* __restrict__ inv,     // [N]
                u64* __restrict__ partial,         // [Q, n_slices, k]
                int Q, int N, int k, int cap, int qc, int slice_docs,
                float c1, float c2, float c3) {
  constexpr int ROW_BYTES = PACKED ? D / 2 : D;
  constexpr int RW = ROW_BYTES / 4;  // 32-bit words per document row
  constexpr int QSTRIDE = PACKED ? 2 * RW : RW;

  extern __shared__ u64 smem[];
  Selector sel;
  sel.buf = smem;
  int* qs = reinterpret_cast<int*>(sel.buf + qc * cap);
  sel.thresh = reinterpret_cast<u64*>(qs + qc * QSTRIDE);
  int* qsum = reinterpret_cast<int*>(sel.thresh + qc);
  sel.count = qsum + qc;
  sel.base = sel.count + qc;
  sel.cap = cap;
  sel.k = k;

  const int q0 = blockIdx.y * qc;
  const int nq = min(qc, Q - q0);
  for (int i = threadIdx.x; i < nq * RW; i += blockDim.x) {
    int qq = i / RW, w = i % RW;
    qs[qq * QSTRIDE + w] = qa[(size_t)(q0 + qq) * RW + w];
    if constexpr (PACKED) qs[qq * QSTRIDE + RW + w] = qb[(size_t)(q0 + qq) * RW + w];
  }
  sel.init(nq);
  __syncthreads();
  for (int qq = threadIdx.x; qq < nq; qq += blockDim.x) {
    int s = 0;
    for (int w = 0; w < QSTRIDE; ++w) s = __dp4a(qs[qq * QSTRIDE + w], 0x01010101, s);
    qsum[qq] = s;
  }
  __syncthreads();

  const long long begin = (long long)blockIdx.x * slice_docs;
  const long long end = min((long long)N, begin + slice_docs);
  for (long long r = begin; r < end; r += kThreads) {
    const long long n = r + threadIdx.x;
    bool valid = n < end;
    unsigned a[RW];  // int8 row words, or the low nibbles (even dims)
    unsigned b[PACKED ? RW : 1];  // high nibbles (odd dims)
    float w_inv = 0.f;
    int sd = 0;
    if (valid) {
      const uint4* row = reinterpret_cast<const uint4*>(docs + n * ROW_BYTES);
#pragma unroll
      for (int v = 0; v < RW / 4; ++v) {
        uint4 x = row[v];
        a[4 * v] = x.x;
        a[4 * v + 1] = x.y;
        a[4 * v + 2] = x.z;
        a[4 * v + 3] = x.w;
      }
      w_inv = inv[n];
      valid = w_inv > 0.f;
    }
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      if constexpr (PACKED) {
        b[w] = (a[w] >> 4) & 0x0F0F0F0Fu;
        a[w] = a[w] & 0x0F0F0F0Fu;
        sd = __dp4a((int)b[w], 0x01010101, sd);
      }
      sd = __dp4a((int)a[w], 0x01010101, sd);
    }
    const int id = (int)n;
    auto score_key = [&](int qq) -> u64 {
      const int4* qw = reinterpret_cast<const int4*>(qs + qq * QSTRIDE);
      int dot = 0;
#pragma unroll
      for (int v = 0; v < RW / 4; ++v) {
        const int4 x = qw[v];
        dot = __dp4a((int)a[4 * v], x.x, dot);
        dot = __dp4a((int)a[4 * v + 1], x.y, dot);
        dot = __dp4a((int)a[4 * v + 2], x.z, dot);
        dot = __dp4a((int)a[4 * v + 3], x.w, dot);
        if constexpr (PACKED) {
          const int4 y = qw[RW / 4 + v];
          dot = __dp4a((int)b[4 * v], y.x, dot);
          dot = __dp4a((int)b[4 * v + 1], y.y, dot);
          dot = __dp4a((int)b[4 * v + 2], y.z, dot);
          dot = __dp4a((int)b[4 * v + 3], y.w, dot);
        }
      }
      const int sums = qsum[qq] + sd;
      float s = __fadd_rn(__fmul_rn(c1, __int2float_rn(dot)), __fmul_rn(c2, __int2float_rn(sums)));
      s = __fmul_rn(__fadd_rn(s, c3), w_inv);
      return make_key(s, id);
    };
    if (valid) {
      for (int qq = 0; qq < nq; ++qq) sel.insert(qq, score_key(qq));
    }
    sel.end_round(nq, [&](int qq) -> u64 { return valid ? score_key(qq) : 0ull; });
  }

  for (int qq = 0; qq < nq; ++qq) {
    bool over = sel.count[qq] > k;
    __syncthreads();
    if (over) sel.compact(qq);
  }
  const size_t n_slices = gridDim.x;
  for (int qq = 0; qq < nq; ++qq) {
    u64* dst = partial + ((size_t)(q0 + qq) * n_slices + blockIdx.x) * k;
    const int c = sel.count[qq];
    for (int j = threadIdx.x; j < k; j += blockDim.x) dst[j] = j < c ? sel.buf[qq * cap + j] : 0ull;
  }
}

// One block per query: the best k of its n_slices * k partial keys.
__global__ void __launch_bounds__(kThreads)
sdc_merge_kernel(const u64* __restrict__ partial, float* __restrict__ vals,
                 int* __restrict__ ids, int m, int k, int cap) {
  extern __shared__ u64 smem[];
  Selector sel;
  sel.buf = smem;
  sel.thresh = sel.buf + cap;
  sel.count = reinterpret_cast<int*>(sel.thresh + 1);
  sel.base = sel.count + 1;
  sel.cap = cap;
  sel.k = k;
  sel.init(1);
  __syncthreads();

  const u64* src = partial + (size_t)blockIdx.x * m;
  for (int r = 0; r < m; r += kThreads) {
    const int i = r + threadIdx.x;
    const u64 key = i < m ? src[i] : 0ull;
    sel.insert(0, key);
    sel.end_round(1, [&](int) -> u64 { return key; });
  }
  sel.compact(0);
  const int c = sel.count[0];
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float v = kNegInf;
    int id = -1;
    if (j < c) {
      u64 key = sel.buf[j];
      v = key_val(key);
      id = v > kNegInf / 2 ? key_id(key) : -1;
    }
    vals[(size_t)blockIdx.x * k + j] = v;
    ids[(size_t)blockIdx.x * k + j] = id;
  }
}

typedef void (*ScanFn)(const int*, const int*, const uint8_t*, const float*, u64*, int, int,
                       int, int, int, int, float, float, float);

template <bool PACKED>
ScanFn pick_scan(int D) {
  switch (D) {
    case 32: return sdc_scan_kernel<32, PACKED>;
    case 64: return sdc_scan_kernel<64, PACKED>;
    case 128: return sdc_scan_kernel<128, PACKED>;
    case 256: return sdc_scan_kernel<256, PACKED>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one scan block holding qc queries.
size_t sdc_topk_scan_smem(int D, int packed, int cap, int qc) {
  (void)packed;
  const int qstride = D / 4;  // int words per query (both nibble halves when packed)
  return (size_t)qc * cap * sizeof(u64) + (size_t)qc * sizeof(u64) +
         (size_t)qc * qstride * sizeof(int) + 3 * (size_t)qc * sizeof(int);
}

size_t sdc_topk_merge_smem(int cap) { return (size_t)cap * sizeof(u64) + sizeof(u64) + 2 * sizeof(int); }

// Scan blocks that fit on one SM at once (occupancy), or a negative CUDA
// error code; the wrapper sizes the grid to one full wave from it.
int sdc_topk_blocks_per_sm(int D, int packed, int cap, int qc) {
  ScanFn scan = packed ? pick_scan<true>(D) : pick_scan<false>(D);
  if (scan == nullptr) return -(int)cudaErrorInvalidValue;
  const size_t smem = sdc_topk_scan_smem(D, packed, cap, qc);
  cudaError_t err = cudaFuncSetAttribute((const void*)scan,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, scan, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}

// Launches the scan over n_slices x ceil(Q / qc) blocks, then the merge
// over Q blocks, on `stream`. Returns cudaGetLastError() (0 on success).
int sdc_topk_launch(const void* qa, const void* qb, const void* docs, const void* inv,
                    void* partial, void* vals, void* ids, int Q, int N, int D, int packed,
                    int k, int cap, int qc, int n_slices, int slice_docs, float c1, float c2,
                    float c3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ScanFn scan = packed ? pick_scan<true>(D) : pick_scan<false>(D);
  if (scan == nullptr) return (int)cudaErrorInvalidValue;
  const size_t scan_smem = sdc_topk_scan_smem(D, packed, cap, qc);
  cudaError_t err = cudaFuncSetAttribute((const void*)scan,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)scan_smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_slices, (Q + qc - 1) / qc);
  scan<<<grid, kThreads, scan_smem, s>>>((const int*)qa, (const int*)qb, (const uint8_t*)docs,
                                         (const float*)inv, (u64*)partial, Q, N, k, cap, qc,
                                         slice_docs, c1, c2, c3);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t merge_smem = sdc_topk_merge_smem(cap);
  err = cudaFuncSetAttribute((const void*)sdc_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)merge_smem);
  if (err != cudaSuccess) return (int)err;
  sdc_merge_kernel<<<Q, kThreads, merge_smem, s>>>((const u64*)partial, (float*)vals, (int*)ids,
                                                   n_slices * k, k, cap);
  return (int)cudaGetLastError();
}

const char* sdc_topk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
