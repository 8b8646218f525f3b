// Unfused SDC score matrix for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sdc/sdc.py::sdc_scores
// (_sdc_kernel, _sdc_kernel_packed): scores [Q, N] f32, score[q, n] the SDC
// epilogue of sdc_common.cuh, or -1e30 where !(inv[n] > 0). The unfused
// routes use it: ops.sdc_search(fused=False), and sdc_topk and the gather
// on the card for k > K_MAX or a code dim above 256.
//
// What bounds it: the output. At Q = 64 and D = 128 it writes 4 * Q = 256
// bytes per document against D + 4 bytes read, so the floor is HBM bytes,
// two thirds of them writes. The design keeps the store stream whole and
// takes the product off the CUDA cores:
//
//  - A block holds a chunk of up to kMaxQueries queries in shared memory
//    and walks one slice of the documents in tiles of kRows rows. Each
//    tile's rows are staged in shared memory with cp.async, kStages - 1
//    steps ahead, in chunks of kChunkCodes codes: any code dim that is a
//    multiple of 32 (the wrapper pads to one) runs as a loop over chunks,
//    so a wide row never needs a whole tile of shared memory.
//  - The code products are the exact int8 tensor-core tile product of
//    tile_mma.cuh (mma.sync m16n8k32, s8 x s8 -> s32). The chunk's queries
//    are split in two halves of up to 32, each behind an all-ones query
//    row, so that the product also gives each row's code sum; warp w takes
//    32 rows of the tile (two m16 tiles) against one half (five n8 tiles),
//    accumulating over the chunks in registers, and holds that half's B
//    fragments in registers for the whole scan where the code is one chunk
//    (D <= 128): the warp loads only its rows from shared memory. Nibble-
//    packed rows are split into their even and odd dims as they are loaded,
//    against query rows whose even- and odd-dim words are interleaved in
//    shared memory.
//  - The epilogue runs on the accumulators in the reference's order
//    (__fmul_rn / __fadd_rn; the file is also built -fmad=false), with each
//    lane's query code sums in registers, and writes the tile's scores
//    [query][row] to shared memory; then a warp writes each query's kRows
//    scores with 16-byte stores, whole 128-byte lines, since the wrapper
//    pads the rows of the output to a multiple of 32 scores (ldo) and
//    tiles start at multiples of kRows.
//
// Shared-memory rows are padded so that the fragment loads of a warp fall
// in distinct banks: 64-bit loads of word pairs (int8 rows, query rows) at
// a stride of 8 (mod 16) words, 32-bit loads (packed rows) at 4 (mod 8).
// Integer sums are exact: codes are int8, so |dot| <= D * 2^14 and the
// code sums are below 2^24 for every D the wrapper passes.

#include "sdc_common.cuh"
#include "tile_mma.cuh"

using namespace sdc;

namespace {

constexpr int kRows = 128;             // document rows per tile
constexpr int kMaxQueries = 64;        // queries a block holds: two halves of up to 32
constexpr int kNT = 5;                 // n8 tiles of a half: its ones column and 32 queries
constexpr int kHalfRows = 8 * kNT;     // query rows of a half in shared memory
constexpr int kChunkCodes = 128;       // codes of a row staged at once
constexpr int kKSteps = kChunkCodes / 32;  // mma k-steps of a chunk
constexpr int kStages = 3;             // staged chunks: one in use, the rest in flight
constexpr int kOutStride = kRows + 4;  // floats per query row of the output tile
constexpr int kMinBlocks = 2;          // blocks an SM (the wrapper's _SCORES_BLOCKS_PER_SM)

static_assert(kRows == 32 * (kThreads / 64), "a warp takes 32 rows against one query half");

// Words of a shared-memory row of w words (w a multiple of 8) read as word
// pairs: a stride of 8 (mod 16) words.
__host__ __device__ constexpr int pad_pairs(int w) { return w + 8 + (w & 8); }

// Byte offsets of a block's shared arrays for code dim D (a multiple of 32)
// and qc queries: the query rows of both halves [2 * kHalfRows][QS] words
// (row 0 of a half all ones), their code sums [2 * kHalfRows] float,
// kStages staged chunks of [kRows][S] words, each with the tile's inverse
// norms [kRows] float, and the output tile [qc][kOutStride] float. Every
// array starts 16-byte aligned.
struct Layout {
  int QS, S;
  size_t qsum, stages, stage_bytes, invs, out, end;
};

__host__ __device__ inline Layout layout(int D, bool packed, int qc) {
  Layout l;
  l.QS = pad_pairs(D / 4);
  l.S = packed ? pad_words(kChunkCodes / 8) : pad_pairs(kChunkCodes / 4);
  l.qsum = (size_t)2 * kHalfRows * l.QS * sizeof(int);
  l.stages = l.qsum + 2 * kHalfRows * sizeof(float);
  l.invs = (size_t)kRows * l.S * sizeof(unsigned);
  l.stage_bytes = l.invs + kRows * sizeof(float);
  l.out = l.stages + kStages * l.stage_bytes;
  l.end = l.out + (size_t)qc * kOutStride * sizeof(float);
  return l;
}

// The accumulators start at kBias and give float(x) of their sum x, exactly.
// NARROW (|x| <= 2^22: every dot of D <= 256 int8 codes): kBias is the bits
// of 1.5 * 2^23, so the int32 sum is the bits of 1.5 * 2^23 + x and one
// exact subtraction gives x, where a conversion instruction would issue at
// a fraction of the float rate. Otherwise a conversion.
template <bool NARROW>
constexpr int kBias = NARROW ? 0x4B400000 : 0;

template <bool NARROW>
__device__ __forceinline__ float to_float(int biased) {
  if constexpr (NARROW) {
    return __fsub_rn(__int_as_float(biased), 12582912.0f);
  } else {
    return __int2float_rn(biased);
  }
}

template <bool PACKED, bool NARROW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sdc_scores_kernel(const int* __restrict__ qa,        // int8 [Q, D]; packed: even dims [Q, D/2]
                  const int* __restrict__ qb,        // packed: odd dims [Q, D/2]; else unused
                  const uint8_t* __restrict__ docs,  // [N, D] int8 or [N, D/2] packed
                  const float* __restrict__ inv,     // [N]
                  float* __restrict__ out,           // [Q, ldo], ldo a multiple of 32
                  int Q, int N, int ldo, int D, int qc, int slice_docs, float c1, float c2,
                  float c3) {
  extern __shared__ __align__(16) u64 smem[];
  char* const base = reinterpret_cast<char*>(smem);
  const Layout lay = layout(D, PACKED, qc);
  int* qs = reinterpret_cast<int*>(base);
  float* qsum = reinterpret_cast<float*>(base + lay.qsum);
  float* otile = reinterpret_cast<float*>(base + lay.out);
  const int QS = lay.QS, S = lay.S, QW = D / 4;
  const int RB = PACKED ? D / 2 : D;                          // bytes of a stored row
  constexpr int CB = PACKED ? kChunkCodes / 2 : kChunkCodes;  // bytes of a row chunk
  const int nk = (RB + CB - 1) / CB;                          // chunks per row
  const int q0 = blockIdx.x * qc;
  const int nq = min(qc, Q - q0);
  const int h0 = (nq + 1) / 2;  // queries of half 0; half 1 takes the rest

  // Query rows: row 0 of each half all ones, row c > 0 of half h query
  // h * h0 + c - 1 of the chunk, zero past the half's queries. Packed rows
  // interleave the halves of the code: word 2w is even-dim word w, 2w + 1
  // odd-dim word w, so that one 64-bit load gives a k-step's two B words.
  for (int i = threadIdx.x; i < 2 * kHalfRows * QW; i += kThreads) {
    const int r = i / QW, w = i - r * QW;
    const int h = r / kHalfRows, c = r - h * kHalfRows;
    const int j = h * h0 + c - 1;  // the chunk's query, for c > 0
    int v = 0x01010101;
    if (c > 0) {
      v = 0;
      if (c <= (h ? nq - h0 : h0)) {
        const size_t row = (size_t)(q0 + j) * QW;
        if constexpr (PACKED) v = (w & 1 ? qb : qa)[row / 2 + w / 2];
        else v = qa[row + w];
      }
    }
    qs[r * QS + w] = v;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < 2 * kHalfRows; r += kThreads) {
    int s = 0;
    for (int w = 0; w < QW; ++w) s = __dp4a(qs[r * QS + w], 0x01010101, s);
    qsum[r] = __int2float_rn(s);  // exact: below 2^24
  }
  __syncthreads();

  const long long begin = (long long)blockIdx.y * slice_docs;
  const long long end = min((long long)N, begin + slice_docs);
  const int nsteps = (int)((end - begin + kRows - 1) / kRows) * nk;
  auto rows_of = [&](int step) {
    return reinterpret_cast<unsigned*>(base + lay.stages + (step % kStages) * lay.stage_bytes);
  };
  // Start copying chunk c of the rows of tile `step / nk` (rows past the
  // slice are not read; their scores land in no column below N), and with
  // the last chunk the rows' inverse norms.
  auto stage = [&](int step) {
    const int tile = step / nk, c = step - tile * nk;
    const long long n0 = begin + (long long)tile * kRows;
    const int nrows = (int)min((long long)kRows, end - n0);
    const int ch = min(CB, RB - c * CB) / 16;
    unsigned* rows = rows_of(step);
    const uint8_t* src = docs + n0 * RB + c * CB;
    for (int i = threadIdx.x; i < nrows * ch; i += kThreads) {
      const int r = i / ch, x = i - r * ch;
      cp_async16(rows + r * S + 4 * x, src + (size_t)r * RB + 16 * x);
    }
    if (c == nk - 1 && (int)threadIdx.x < nrows) {
      float* invs = reinterpret_cast<float*>(reinterpret_cast<char*>(rows) + lay.invs);
      cp_async4(invs + threadIdx.x, inv + n0 + threadIdx.x);
    }
  };

  // Warp w takes rows m0..m0+31 of each tile (two m16 tiles) against query
  // half h: columns 8n + 2t, 8n + 2t + 1 of its n8 tiles, column 0 the
  // rows' code sums, column c > 0 query h * h0 + c - 1.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = warp / (kThreads / 64), m0 = 32 * (warp % (kThreads / 64));
  const int hq = h ? nq - h0 : h0;  // queries of this warp's half
  const int nt = (hq + 8) / 8;      // its n8 tiles in use
  const int* hrows = qs + h * kHalfRows * QS;
  float qv[kNT][2];  // the code sums of this lane's columns
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    qv[n][0] = qsum[h * kHalfRows + 8 * n + 2 * t];
    qv[n][1] = qsum[h * kHalfRows + 8 * n + 2 * t + 1];
  }
  // The B fragments of the half's query rows for one chunk of the code, in
  // registers: loaded once where the code is one chunk, else every step.
  unsigned bq[kNT][kKSteps][2];
  auto load_b = [&](int c) {
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        // A sum over K does not depend on K's order: lane t takes the same
        // two words (int8) or the two nibble halves of the same word
        // (packed) of its A row and its B column.
        const int qw = PACKED ? 2 * (c * (kChunkCodes / 8) + 4 * ks + t)
                              : c * (kChunkCodes / 4) + 8 * ks + 2 * t;
        const uint2 b2 = *reinterpret_cast<const uint2*>(hrows + (8 * n + g) * QS + qw);
        bq[n][ks][0] = b2.x;
        bq[n][ks][1] = b2.y;
      }
    }
  };
  if (nk == 1) load_b(0);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) stage(s);
    cp_async_commit();
  }
  int acc[2][kNT][4];
  for (int step = 0; step < nsteps; ++step) {
    // This step's chunk has landed for every thread's copies, and every
    // thread is done with the chunk staged kStages - 1 steps ago and with
    // the output tile.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (step + kStages - 1 < nsteps) stage(step + kStages - 1);
    cp_async_commit();

    const int tile = step / nk, c = step - tile * nk;
    if (nk > 1) load_b(c);
    if (c == 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < kNT; ++n)
          acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = kBias<NARROW>;
    }
    const unsigned* rows = rows_of(step);
    const int ksteps = min(CB, RB - c * CB) / (PACKED ? 16 : 32);
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      if (ks < ksteps) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const unsigned* lo = rows + (m0 + 16 * m + g) * S;  // row g of the m16 tile
          const unsigned* hi = lo + 8 * S;                    // row g + 8
          unsigned a[4];
          if constexpr (PACKED) {
            const unsigned x = lo[4 * ks + t], y = hi[4 * ks + t];
            a[0] = x & 0x0F0F0F0Fu;
            a[1] = y & 0x0F0F0F0Fu;
            a[2] = (x >> 4) & 0x0F0F0F0Fu;
            a[3] = (y >> 4) & 0x0F0F0F0Fu;
          } else {
            const uint2 x = *reinterpret_cast<const uint2*>(lo + 8 * ks + 2 * t);
            const uint2 y = *reinterpret_cast<const uint2*>(hi + 8 * ks + 2 * t);
            a[0] = x.x;
            a[1] = y.x;
            a[2] = x.y;
            a[3] = y.y;
          }
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            if (n < nt) mma_s8(acc[m][n], a, bq[n][ks]);
          }
        }
      }
    }
    if (c < nk - 1) continue;

    // Epilogue: c[0] (row g, column 2t), c[1] (g, 2t + 1), c[2] (g + 8, 2t),
    // c[3] (g + 8, 2t + 1) of each m16 x n8 tile.
    const float* invs = reinterpret_cast<const float*>(
        reinterpret_cast<const char*>(rows) + lay.invs);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int r = m0 + 16 * m + g;  // this lane's rows r and r + 8 of the tile
      const float sd[2] = {to_float<NARROW>(__shfl_sync(0xFFFFFFFFu, acc[m][0][0], lane & ~3)),
                           to_float<NARROW>(__shfl_sync(0xFFFFFFFFu, acc[m][0][2], lane & ~3))};
      const float w[2] = {invs[r], invs[r + 8]};
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if (n < nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * n + 2 * t + (e & 1), hh = e >> 1;
            if (col >= 1 && col <= hq) {
              // the sum of two integer code sums below 2^24 is exact in
              // float; no branch: an excluded row's score is computed, then
              // replaced
              const float sums = __fadd_rn(qv[n][e & 1], sd[hh]);
              float s = __fadd_rn(__fmul_rn(c1, to_float<NARROW>(acc[m][n][e])),
                                  __fmul_rn(c2, sums));
              s = __fmul_rn(__fadd_rn(s, c3), w[hh]);
              otile[(h * h0 + col - 1) * kOutStride + r + 8 * hh] = w[hh] > 0.f ? s : kNegInf;
            }
          }
        }
      }
    }
    __syncthreads();  // the output tile is written
    const long long n = begin + (long long)tile * kRows + 4 * lane;
    if (n < ldo) {
      for (int j = warp; j < nq; j += kThreads / 32) {
        const float4 v = *reinterpret_cast<const float4*>(otile + j * kOutStride + 4 * lane);
        *reinterpret_cast<float4*>(out + (size_t)(q0 + j) * ldo + n) = v;
      }
    }
  }
}

typedef void (*ScoresFn)(const int*, const int*, const uint8_t*, const float*, float*, int, int,
                         int, int, int, int, float, float, float);

// The kernel for code dim D (a positive multiple of 32), or nullptr.
ScoresFn pick(int D, int packed) {
  if (D <= 0 || D % 32) return nullptr;
  if (D <= 256) return packed ? &sdc_scores_kernel<true, true> : &sdc_scores_kernel<false, true>;
  return packed ? &sdc_scores_kernel<true, false> : &sdc_scores_kernel<false, false>;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block holding qc queries at code dim D.
size_t sdc_scores_smem(int D, int packed, int qc) { return layout(D, packed != 0, qc).end; }

// Blocks that fit on one SM at once, or a negative CUDA error code.
int sdc_scores_blocks_per_sm(int D, int packed, int qc) {
  ScoresFn fn = pick(D, packed);
  if (fn == nullptr || qc < 1 || qc > kMaxQueries) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm((const void*)fn, sdc_scores_smem(D, packed, qc));
}

// Launches ceil(Q / qc) x n_slices blocks on `stream`: D is the padded code
// dim, ldo the output's row stride (a multiple of 32 floats, >= N). Returns
// cudaGetLastError() (0 on success).
int sdc_scores_launch(const void* qa, const void* qb, const void* docs, const void* inv,
                      void* out, int Q, int N, int ldo, int D, int packed, int qc, int n_slices,
                      int slice_docs, float c1, float c2, float c3, void* stream) {
  ScoresFn fn = pick(D, packed);
  if (fn == nullptr || qc < 1 || qc > kMaxQueries || ldo % 32 || ldo < N || slice_docs % kRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sdc_scores_smem(D, packed, qc);
  cudaError_t err = cudaFuncSetAttribute((const void*)fn,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + qc - 1) / qc, n_slices);
  fn<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)qa, (const int*)qb, (const uint8_t*)docs, (const float*)inv, (float*)out, Q, N,
      ldo, D, qc, slice_docs, c1, c2, c3);
  return (int)cudaGetLastError();
}

const char* sdc_scores_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
