// Exact int8 tensor-core code products for the SDC scans (sm_90a), the
// b1 product of binary_dot.cu (mma_b1) and the cp.async helpers both use.
//
// A scan block scores one round of kThreads document rows, staged in
// shared memory, against up to 64 query rows held there too: tile_dots
// writes the [query][row] int32 dot tile that gather_topk.cu's per-row
// epilogue and selector read; warp_products leaves the products in each
// warp's accumulators, where sdc_topk.cu's per-pair epilogue takes them.
// The product is mma.sync.m16n8k32 s8 x s8 -> s32: A is 16 rows x 32
// codes of the documents, row-major, and B is 32 codes x 8 queries,
// column-major, i.e. each query's codes contiguous: both are the rows as
// they are stored. The int32 accumulator is exact, since codes are
// 0..2^n - 1 < 2^7 and |dot| <= D * 127^2 < 2^31 for every D the kernels
// take (28,800 at D = 128 and n = 4).
//
// Per lane (g = lane / 4, t = lane % 4) the fragments hold, as bytes of
// four codes each:
//   a[0]: row g, k 4t..4t+3    a[1]: row g + 8, k 4t..4t+3
//   a[2]: row g, k 16+4t..     a[3]: row g + 8, k 16+4t..
//   b[0]: col g, k 4t..4t+3    b[1]: col g, k 16+4t..
//   c[0]: (g, 2t)  c[1]: (g, 2t + 1)  c[2]: (g + 8, 2t)  c[3]: (g + 8, 2t + 1)
// A sum over K does not depend on K's order, so a lane takes whole 32-bit
// words of a row: int8 rows give a[0] and a[2] words t and 4 + t of each
// 32-code step. Nibble-packed rows are split as they are loaded: the low
// nibbles (even dims) of packed word t of a 16-byte step go to a[0] and
// the high nibbles (odd dims) to a[2], and B takes the same word of the
// query's even-dim half and of its odd-dim half: the [even | odd] order of
// the query rows (Row::QSTRIDE), so A and B agree on K. Hopper has no int4
// tensor-core product; a split costs two ALU operations per word.
//
// Shared-memory rows are padded to a stride of 4 (mod 8) words, so the
// eight rows a fragment load touches fall in distinct banks, and the dot
// tile's rows to kThreads + 4 words, so its stores are conflict-free and
// thread r reads its row's dots for every query with one bank each.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sdc_common.cuh"

namespace sdc {

// Words of a shared-memory row of w words (w a multiple of 4), padded.
__host__ __device__ constexpr int pad_words(int w) { return w + 4 + (w & 4); }

constexpr int kDotStride = kThreads + 4;  // words per query row of the dot tile

template <int D, bool PACKED>
struct Tile {
  using R = Row<D, PACKED>;
  static constexpr int S = pad_words(R::RW);        // words per staged row
  static constexpr int QS = pad_words(R::QSTRIDE);  // words per query row
  static constexpr int KSTEPS = D / 32;             // mma k-steps of 32 codes
  static constexpr int CH = R::ROW_BYTES / 16;      // 16-byte chunks per stored row
};

// c += a * b for one 16 x 8 x 32 tile, s8 x s8 -> s32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += popc(A row AND B column) for one 16 x 8 tile of 128 bits (KW = 1:
// mma.sync m16n8k128) or 256 bits (KW = 2: m16n8k256), b1 x b1 -> s32,
// with the int8 product's lane layout, 32 bits a word: a[0] row g word t,
// a[1] row g + 8 word t, b[0] column g word t; at KW = 2 a[2], a[3], b[1]
// the same rows' and column's word 4 + t. Hopper has .and.popc only.
template <int KW>
__device__ __forceinline__ void mma_b1(int (&c)[4], const unsigned (&a)[2 * KW],
                                       const unsigned (&b)[KW]) {
  if constexpr (KW == 1) {
    asm volatile(
        "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// 16 bytes from global to shared memory, asynchronously (L2 only).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// 4 bytes from global to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Ask for `bytes` (a multiple of 16) at src to be brought into L2, without
// waiting for them.
__device__ __forceinline__ void prefetch_l2(const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying the kThreads stored rows at src (row i at src + i *
// ROW_BYTES) into tile (row i at tile + i * S words). Warp w copies the
// rows of its own 32 threads, 16 bytes a lane, neighbouring lanes on
// neighbouring bytes. A row whose bit in `live` (the warp's ballot) is
// clear is neither read nor written: its slot keeps stale codes, whose
// dots no one reads. Called by all threads.
template <int D, bool PACKED>
__device__ __forceinline__ void stage_rows(unsigned* tile, const uint8_t* src, unsigned live) {
  using T = Tile<D, PACKED>;
  constexpr int RPI = 32 / T::CH;  // rows per warp-wide copy
  const int lane = threadIdx.x & 31, w0 = threadIdx.x & ~31;
  const int sub = lane / T::CH, ch = lane % T::CH;
#pragma unroll
  for (int i = 0; i < T::CH; ++i) {
    const int row = i * RPI + sub;
    if ((live >> row) & 1u) {
      cp_async16(tile + (w0 + row) * T::S + ch * 4,
                 src + (size_t)(w0 + row) * T::R::ROW_BYTES + ch * 16);
    }
  }
}

// Sum of the codes of one staged row.
template <int D, bool PACKED>
__device__ __forceinline__ int staged_row_sum(const unsigned* row) {
  const uint4* v = reinterpret_cast<const uint4*>(row);
  int s = 0;
#pragma unroll
  for (int i = 0; i < Row<D, PACKED>::RW / 4; ++i) {
    const uint4 x = v[i];
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (PACKED) {
        s = __dp4a((int)(w[e] & 0x0F0F0F0Fu), 0x01010101, s);
        s = __dp4a((int)((w[e] >> 4) & 0x0F0F0F0Fu), 0x01010101, s);
      } else {
        s = __dp4a((int)w[e], 0x01010101, s);
      }
    }
  }
  return s;
}

// dots[j * kDotStride + m] = code product of staged row m with query row j
// (qs + j * QS words), for every row m < kThreads and every query j below
// nq rounded up to a multiple of 8 (rows past nq are read and their dots
// written, never meant to be used). Warp w computes rows 32w..32w+31, one
// 16-row half at a time: the half's A fragments are loaded once, then each
// group of 8 queries is KSTEPS products. Called by all threads; the caller
// puts a barrier between it and the first read of the tile.
template <int D, bool PACKED>
__device__ __forceinline__ void tile_dots(const unsigned* tile, const int* qs, int* dots, int nq) {
  using T = Tile<D, PACKED>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m0 = (threadIdx.x & ~31) + 16 * half;
    const unsigned* lo = tile + (m0 + g) * T::S;  // row g of the half
    const unsigned* hi = lo + 8 * T::S;           // row g + 8
    unsigned a[T::KSTEPS][4];
#pragma unroll
    for (int s = 0; s < T::KSTEPS; ++s) {
      if constexpr (PACKED) {
        const unsigned x = lo[4 * s + t], y = hi[4 * s + t];
        a[s][0] = x & 0x0F0F0F0Fu;
        a[s][1] = y & 0x0F0F0F0Fu;
        a[s][2] = (x >> 4) & 0x0F0F0F0Fu;
        a[s][3] = (y >> 4) & 0x0F0F0F0Fu;
      } else {
        a[s][0] = lo[8 * s + t];
        a[s][1] = hi[8 * s + t];
        a[s][2] = lo[8 * s + 4 + t];
        a[s][3] = hi[8 * s + 4 + t];
      }
    }
    for (int n = 0; n < nq; n += 8) {
      const int* q = qs + (n + g) * T::QS;
      int c[4] = {0, 0, 0, 0};
#pragma unroll
      for (int s = 0; s < T::KSTEPS; ++s) {
        unsigned b[2];
        if constexpr (PACKED) {
          b[0] = (unsigned)q[4 * s + t];
          b[1] = (unsigned)q[T::R::RW + 4 * s + t];
        } else {
          b[0] = (unsigned)q[8 * s + t];
          b[1] = (unsigned)q[8 * s + 4 + t];
        }
        mma_s8(c, a[s], b);
      }
      int* d = dots + (n + 2 * t) * kDotStride + m0 + g;
      d[0] = c[0];
      d[kDotStride] = c[1];
      d[8] = c[2];
      d[kDotStride + 8] = c[3];
    }
  }
}

// Word i of the staged rows that lane (g, t) of warp w feeds k-step s of
// the product for the warp's 16-row half h (rows 32w + 16h..): packed rows
// word 4s + t of row g (i = 0) and of row g + 8 (i = 1); int8 rows words
// 8s + t and 8s + 4 + t (i >> 1) of rows g and g + 8 (i & 1).
template <int D, bool PACKED>
__device__ __forceinline__ unsigned fragment_word(const unsigned* tile, int s, int h, int i) {
  using T = Tile<D, PACKED>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned* row = tile + ((threadIdx.x & ~31) + 16 * h + 8 * (i & 1) + g) * T::S;
  return PACKED ? row[4 * s + t] : row[8 * s + 4 * (i >> 1) + t];
}

// The code products of warp w's staged rows 32w..32w+31 with query rows
// 0..8NG-1 (NG <= NC groups of 8), left in the accumulators: c[h][G] is
// the 16 x 8 tile of rows 32w + 16h.. and queries 8G.., so lane (g, t)
// holds in c[h][G][i] the product of row 32w + 16h + 8(i >> 1) + g with
// query 8G + 2t + (i & 1). Groups from NG on are left as they were. The
// rows' words come from word(s, h, i) (fragment_word's, from the tile or
// from registers loaded earlier). Each k-step takes the A fragments of
// both halves, then each group's B fragment once for both. Called by all
// threads of the warp.
template <int D, bool PACKED, int NG, int NC, class Words>
__device__ __forceinline__ void warp_products(Words word, const int* qs, int (&c)[2][NC][4]) {
  static_assert(NG <= NC, "more groups than accumulators");
  using T = Tile<D, PACKED>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int G = 0; G < NG; ++G) c[h][G][0] = c[h][G][1] = c[h][G][2] = c[h][G][3] = 0;
#pragma unroll
  for (int s = 0; s < T::KSTEPS; ++s) {
    unsigned a[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if constexpr (PACKED) {
        const unsigned x = word(s, h, 0), y = word(s, h, 1);
        a[h][0] = x & 0x0F0F0F0Fu;
        a[h][1] = y & 0x0F0F0F0Fu;
        a[h][2] = (x >> 4) & 0x0F0F0F0Fu;
        a[h][3] = (y >> 4) & 0x0F0F0F0Fu;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[h][i] = word(s, h, i);
      }
    }
#pragma unroll
    for (int G = 0; G < NG; ++G) {
      const int* q = qs + (8 * G + g) * T::QS;
      unsigned b[2];
      if constexpr (PACKED) {
        b[0] = (unsigned)q[4 * s + t];
        b[1] = (unsigned)q[T::R::RW + 4 * s + t];
      } else {
        b[0] = (unsigned)q[8 * s + t];
        b[1] = (unsigned)q[8 * s + 4 + t];
      }
      mma_s8(c[0][G], a[0], b);
      mma_s8(c[1][G], a[1], b);
    }
  }
}

}  // namespace sdc
