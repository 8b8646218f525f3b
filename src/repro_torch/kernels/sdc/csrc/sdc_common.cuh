// Device code shared by the SDC kernels (sdc_topk.cu, gather_topk.cu,
// sdc_scores.cu): the row sizes, the query rows' load, the uncontracted
// affine epilogue, the 64-bit ordered keys and the shared-memory top-k
// selector. The tensor-core tile product and its staging are in
// tile_mma.cuh.
//
// Every source includes this header and is built into its own library, so
// nothing here needs external linkage. Build with -fmad=false; the epilogue
// also uses __fmul_rn / __fadd_rn so that no FMA contraction changes the
// reference's rounding.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sdc {

typedef unsigned long long u64;

constexpr int kThreads = 256;  // threads per block = rows per round
constexpr float kNegInf = -1e30f;

// Total order (score desc, tie asc) as an unsigned 64-bit key: larger is
// better. `tie` is the document id (flat scan) or the probe slot p*L + pos
// (gather). 0 is below every real key and marks an empty slot.
__device__ __forceinline__ u64 make_key(float v, unsigned tie) {
  unsigned b = __float_as_uint(v);
  unsigned ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((u64)ord << 32) | (u64)(0xFFFFFFFFu - tie);
}

__device__ __forceinline__ float key_val(u64 key) {
  unsigned ord = (unsigned)(key >> 32);
  unsigned b = (ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord;
  return __uint_as_float(b);
}

__device__ __forceinline__ unsigned key_tie(u64 key) {
  return 0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull);
}

// score = ((a*a) * dot + (a*beta) * sums) + D*beta^2) * inv, in the
// reference's op order (c1 = a*a, c2 = a*beta, c3 = D*beta^2).
__device__ __forceinline__ float epilogue(int dot, int sums, float inv, float c1, float c2,
                                          float c3) {
  float s = __fadd_rn(__fmul_rn(c1, __int2float_rn(dot)), __fmul_rn(c2, __int2float_rn(sums)));
  return __fmul_rn(__fadd_rn(s, c3), inv);
}

// The sizes of a stored document row of D codes (int8, or nibble-packed:
// the low nibble of each byte the even dim, the high one the odd dim) and
// of a query row in shared memory (packed: even-dim half, then odd-dim half).
template <int D, bool PACKED>
struct Row {
  static constexpr int ROW_BYTES = PACKED ? D / 2 : D;
  static constexpr int RW = ROW_BYTES / 4;              // 32-bit words per stored row
  static constexpr int QSTRIDE = PACKED ? 2 * RW : RW;  // int words per query row
};

// Copy nq query rows into shared memory (row j from query src(j) of qa/qb,
// at qs + j * QS words) and their code sums into qsum. Called by all
// threads; ends on a barrier.
template <int D, bool PACKED, int QS, class Src>
__device__ void load_queries(int* qs, int* qsum, const int* qa, const int* qb, int nq, Src src) {
  using R = Row<D, PACKED>;
  for (int i = threadIdx.x; i < nq * R::RW; i += blockDim.x) {
    const int j = i / R::RW, w = i % R::RW;
    const size_t g = (size_t)src(j) * R::RW + w;
    qs[j * QS + w] = qa[g];
    if constexpr (PACKED) qs[j * QS + R::RW + w] = qb[g];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nq; j += blockDim.x) {
    int s = 0;
    for (int w = 0; w < R::QSTRIDE; ++w) s = __dp4a(qs[j * QS + w], 0x01010101, s);
    qsum[j] = s;
  }
  __syncthreads();
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

  // After the last round: cut every buffer back to its best k, sorted.
  __device__ void finish(int nq) {
    for (int q = 0; q < nq; ++q) {
      bool over = count[q] > k;
      __syncthreads();
      if (over) compact(q);
    }
  }

  // Write query q's best k keys to dst[0..k), zero-filled past its count.
  __device__ void store(int q, u64* dst) const {
    const int c = count[q];
    for (int j = threadIdx.x; j < k; j += blockDim.x) dst[j] = j < c ? buf[q * cap + j] : 0ull;
  }

  __device__ void init(int nq) {
    for (int q = threadIdx.x; q < nq; q += blockDim.x) {
      count[q] = 0;
      base[q] = 0;
      thresh[q] = 0ull;
    }
  }

  // Lay nq buffers out at the start of dynamic shared memory: buf
  // [nq][cap] u64, thresh [nq] u64, count [nq] int, base [nq] int. Returns
  // the first free byte, 16-byte aligned. Every pointer is an offset from
  // `smem`, never an integer cast, so the compiler still knows they point
  // into shared memory and reads through them with shared-memory loads.
  __device__ char* place(u64* smem, int nq, int cap_, int k_);
};

// Bytes of Selector::place for nq buffers, with the 16-byte round-up.
__host__ __device__ inline size_t selector_smem(int nq, int cap) {
  size_t b = (size_t)nq * cap * sizeof(u64) + (size_t)nq * sizeof(u64) + 2 * (size_t)nq * sizeof(int);
  return (b + 15) & ~(size_t)15;
}

__device__ inline char* Selector::place(u64* smem, int nq, int cap_, int k_) {
  buf = smem;
  thresh = buf + (size_t)nq * cap_;
  count = reinterpret_cast<int*>(thresh + nq);
  base = count + nq;
  cap = cap_;
  k = k_;
  return reinterpret_cast<char*>(smem) + selector_smem(nq, cap_);
}

// One block, one row: the best k of src[0..m) into buffer 0 of `sel`
// (placed for one buffer), sorted best first; sel.count[0] holds how many.
__device__ inline void select_row(Selector& sel, const u64* src, int m) {
  sel.init(1);
  __syncthreads();
  for (int r = 0; r < m; r += kThreads) {
    const int i = r + threadIdx.x;
    const u64 key = i < m ? src[i] : 0ull;
    sel.insert(0, key);
    sel.end_round(1, [&](int) -> u64 { return key; });
  }
  sel.compact(0);
}

// Number of blocks of `fn` with `smem` dynamic bytes that fit on one SM at
// once, or a negative CUDA error code.
inline int blocks_per_sm(const void* fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}

}  // namespace sdc
