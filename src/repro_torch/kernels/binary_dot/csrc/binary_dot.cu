// Bitwise recurrent-binary dot (xor + popcount) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/binary_dot/kernel.py::binary_dot
// (_binary_dot_kernel): for query bit planes x_s and document bit planes
// y_t, packed 32 dims to a word (bit j of word w = dim 32w + j, 1 = +1),
//
//   score[q, n] = sum_{s,t < NL} 2^-(s+t) * (M - 2 * popc(x_s ^ y_t)),  M = 32 W.
//
// This is the paper's baseline (the GPU scheme of Shan et al.), kept as the
// scheme it is: every one of the NL^2 plane pairs is a Hamming term of its
// own, so its product grows as NL^2, which is what the paper's Table 5
// measures against SDC. It is not rewritten as the equal code product.
//
// What bounds it: the output. At Q = 64 and m = 128 it writes 256 bytes of
// scores per document and reads 4 * NL * W = 16 NL, so the floor is HBM
// bytes, 0.8-0.96 ms at N = 10,000,037. The popcounts are not: on the
// tensor cores' binary path (mma.sync m16n8k128 .and.popc, 0.88 products
// per SM per clock on an H100, tools/mma_rate.py) NL = 4's 16 plane pairs
// take about 0.35 ms, where __popc on the CUDA cores took 9.8 ms. So the
// design takes the product off the CUDA cores and keeps the store stream
// whole, as sdc_scores.cu does:
//
//  - With a_st = popc(x_s AND y_t), the plane popcounts Pq = sum_s w_s
//    popc(x_s) and Pd = sum_t w_t popc(y_t), w_s = 2^(NL-1-s) and
//    WT = 2^NL - 1, each score is the exact integer
//      4 sum_{s,t} w_s w_t a_st - 2 WT (Pq + Pd) + M WT^2,
//    scaled once by 2^-2(NL-1). Hopper's binary product has .and.popc
//    only, hence AND and the popcount terms.
//  - A block holds a chunk of up to kMaxQueries queries, in two halves of
//    up to 32, as B fragments in registers for the whole scan, with their
//    Pq terms; it walks one slice of the documents in tiles of kRows rows,
//    staged in shared memory with cp.async kStages - 1 tiles ahead (rows
//    padded so that fragment loads fall in distinct banks). Warp w takes
//    32 rows of a tile (two m16 tiles) against one half (four n8 tiles).
//    Document planes are the A rows, query planes the B columns; a plane
//    of W < 4 words leaves lanes t >= W zero (AND with zero adds nothing),
//    W = 8 runs m16n8k256.
//  - The weighted sum over plane pairs is Horner's rule over e = s + t:
//    the pairs of one e accumulate into the same int32 fragments, which
//    double before the next e (2 NL - 2 doublings, no per-pair scaling).
//    Pd comes from the same A fragments (__popc of a lane's words, two
//    shuffles). Integers are exact in any order.
//  - The epilogue adds the popcount terms to a bias of 1.5 * 2^23, so
//    that the int32 is the float bits of 1.5 * 2^23 + score and one exact
//    subtraction converts it (|score| <= M WT^2 < 2^22), scales with
//    __fmul_rn, and writes the tile's scores [query][row] to shared
//    memory; then a warp writes each query's kRows scores with 16-byte
//    stores, whole 128-byte lines, since the wrapper pads the rows of the
//    output to a multiple of 32 scores (ldo) and tiles start at multiples
//    of kRows. The result equals binary_dot_ref bit for bit.

#include "tile_mma.cuh"

namespace {

using sdc::cp_async16;
using sdc::cp_async4;
using sdc::cp_async_commit;
using sdc::cp_async_wait;
using sdc::mma_b1;

constexpr int kThreads = sdc::kThreads;  // 8 warps
constexpr int kRows = 128;               // document rows per tile
constexpr int kMaxQueries = 64;          // queries a block holds: two halves of up to 32
constexpr int kNT = 4;                   // n8 tiles of a half
constexpr int kStages = 3;               // staged tiles: one in use, the rest in flight
constexpr int kOutStride = kRows + 4;    // floats per query row of the output tile
constexpr int kMinBlocks = 2;            // blocks an SM
constexpr int kBias = 0x4B400000;        // the float bits of 1.5 * 2^23

static_assert(kRows == 32 * (kThreads / 64), "a warp takes 32 rows against one query half");

// Words per staged row of lw words: padded to a stride of 4 (mod 8) where
// rows are copied as 16-byte chunks, else odd.
__host__ __device__ constexpr int staged_words(int lw) {
  return lw % 4 == 0 ? sdc::pad_words(lw) : (lw | 1);
}

__host__ __device__ constexpr size_t smem_bytes(int lw, int qc) {
  return ((size_t)kStages * kRows * staged_words(lw) + (size_t)qc * kOutStride) * 4;
}

template <int NL, int W>
__device__ __forceinline__ int weighted_popc(const unsigned* row) {
  int p = 0;
#pragma unroll
  for (int s = 0; s < NL; ++s)
#pragma unroll
    for (int w = 0; w < W; ++w) p += __popc(__ldg(row + s * W + w)) << (NL - 1 - s);
  return p;
}

template <int NL, int W>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
binary_dot_kernel(const unsigned* __restrict__ q,  // [Q, NL, W] words
                  const unsigned* __restrict__ d,  // [N, NL, W] words
                  float* __restrict__ out,         // [Q, ldo], ldo a multiple of 32
                  int Q, int N, int ldo, int qc, int slice_docs, float scale) {
  constexpr int LW = NL * W, S = staged_words(LW);
  constexpr int KW = W > 4 ? 2 : 1;  // 32-bit words of a plane a lane takes
  constexpr int WT = (1 << NL) - 1, M = 32 * W;
  extern __shared__ __align__(16) unsigned smem[];
  float* otile = reinterpret_cast<float*>(smem + kStages * kRows * S);
  const int q0 = blockIdx.x * qc;
  const int nq = min(qc, Q - q0);
  const int h0 = (nq + 1) / 2;  // queries of half 0; half 1 takes the rest

  // Warp w takes rows m0..m0+31 of each tile against query half h: B column
  // 8n + g of n8 tile n is the half's query 8n + g; C columns 8n + 2t and
  // 8n + 2t + 1 are this lane's.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int h = warp / (kThreads / 64), m0 = 32 * (warp % (kThreads / 64));
  const int hq = h ? nq - h0 : h0;  // queries of this warp's half
  const int nt = (hq + 7) / 8;      // its n8 tiles in use
  const unsigned* qh = q + (size_t)(q0 + h * h0) * LW;
  unsigned bq[kNT][NL][KW];
  int ct[kNT][2];  // bias + M WT^2 - 2 WT Pq of this lane's two columns
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int j = 8 * n + g;
#pragma unroll
    for (int s = 0; s < NL; ++s)
#pragma unroll
      for (int kw = 0; kw < KW; ++kw) {
        const int w = t + 4 * kw;
        bq[n][s][kw] = j < hq && w < W ? __ldg(qh + j * LW + s * W + w) : 0u;
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * n + 2 * t + e;
      ct[n][e] = col < hq ? kBias + M * WT * WT - 2 * WT * weighted_popc<NL, W>(qh + col * LW) : 0;
    }
  }

  const long long begin = (long long)blockIdx.y * slice_docs;
  const long long end = min((long long)N, begin + slice_docs);
  const int ntiles = (int)((end - begin + kRows - 1) / kRows);
  auto rows_of = [&](int tile) { return smem + (tile % kStages) * kRows * S; };
  // Start copying the rows of `tile` (rows past the slice are not read;
  // their scores land in no column below N).
  auto stage = [&](int tile) {
    const long long n0 = begin + (long long)tile * kRows;
    const int nrows = (int)min((long long)kRows, end - n0);
    unsigned* rows = rows_of(tile);
    const unsigned* src = d + n0 * LW;
    if constexpr (LW % 4 == 0) {
      constexpr int CH = LW / 4;  // 16-byte chunks a row
      for (int i = threadIdx.x; i < nrows * CH; i += kThreads) {
        const int r = i / CH, x = i - r * CH;
        cp_async16(rows + r * S + 4 * x, src + (size_t)r * LW + 4 * x);
      }
    } else {
      for (int i = threadIdx.x; i < nrows * LW; i += kThreads) {
        const int r = i / LW, x = i - r * LW;
        cp_async4(rows + r * S + x, src + i);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_async_commit();
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    // This tile has landed for every thread's copies, and every thread is
    // done with the tile staged kStages - 1 steps ago and with the output
    // tile.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (tile + kStages - 1 < ntiles) stage(tile + kStages - 1);
    cp_async_commit();

    const unsigned* rows = rows_of(tile);
    if (nt > 0) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        // A fragments of rows g and g + 8 of the m16 tile, every plane, and
        // the rows' weighted plane popcounts packed as lo + (hi << 16)
        // (each below 2^12), summed over the four lanes of a row.
        const unsigned* lo = rows + (m0 + 16 * m + g) * S;
        const unsigned* hi = lo + 8 * S;
        unsigned a[NL][2 * KW];
        int pd = 0;
#pragma unroll
        for (int s = 0; s < NL; ++s) {
#pragma unroll
          for (int kw = 0; kw < KW; ++kw) {
            const int w = t + 4 * kw;
            const unsigned x = w < W ? lo[s * W + w] : 0u;
            const unsigned y = w < W ? hi[s * W + w] : 0u;
            a[s][2 * kw] = x;
            a[s][2 * kw + 1] = y;
            pd += (__popc(x) + (__popc(y) << 16)) << (NL - 1 - s);
          }
        }
        pd += __shfl_xor_sync(0xFFFFFFFFu, pd, 1);
        pd += __shfl_xor_sync(0xFFFFFFFFu, pd, 2);
        const int rt[2] = {-2 * WT * (pd & 0xFFFF), -2 * WT * (pd >> 16)};

        // sum_{s,t} w_s w_t a_st by Horner's rule over e = s + t.
        int acc[kNT][4];
#pragma unroll
        for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0;
#pragma unroll
        for (int e = 0; e <= 2 * (NL - 1); ++e) {
          if (e > 0) {
#pragma unroll
            for (int n = 0; n < kNT; ++n)
#pragma unroll
              for (int r = 0; r < 4; ++r) acc[n][r] += acc[n][r];
          }
#pragma unroll
          for (int s = 0; s < NL; ++s) {
            if (e - s >= 0 && e - s < NL) {
#pragma unroll
              for (int n = 0; n < kNT; ++n) {
                if (n < nt) mma_b1<KW>(acc[n], a[e - s], bq[n][s]);
              }
            }
          }
        }

        // c[0] (row g, column 2t), c[1] (g, 2t + 1), c[2] (g + 8, 2t),
        // c[3] (g + 8, 2t + 1) of each m16 x n8 tile.
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          if (n < nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * n + 2 * t + (e & 1), hh = e >> 1;
              if (col < hq) {
                const int v = 4 * acc[n][e] + ct[n][e & 1] + rt[hh];
                otile[(h * h0 + col) * kOutStride + m0 + 16 * m + g + 8 * hh] =
                    __fmul_rn(__fsub_rn(__int_as_float(v), 12582912.0f), scale);
              }
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

typedef void (*BinaryDotFn)(const unsigned*, const unsigned*, float*, int, int, int, int, int,
                            float);

template <int NL>
BinaryDotFn pick_words(int W) {
  switch (W) {
    case 1: return binary_dot_kernel<NL, 1>;
    case 2: return binary_dot_kernel<NL, 2>;
    case 3: return binary_dot_kernel<NL, 3>;
    case 4: return binary_dot_kernel<NL, 4>;
    case 8: return binary_dot_kernel<NL, 8>;
    default: return nullptr;
  }
}

BinaryDotFn pick(int n_levels, int W) {
  switch (n_levels) {
    case 1: return pick_words<1>(W);
    case 2: return pick_words<2>(W);
    case 3: return pick_words<3>(W);
    case 4: return pick_words<4>(W);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Blocks of the (n_levels, W) kernel holding qc queries that fit on one SM
// at once, or a negative CUDA error code.
int binary_dot_blocks_per_sm(int n_levels, int W, int qc) {
  BinaryDotFn fn = pick(n_levels, W);
  if (fn == nullptr || qc < 1 || qc > kMaxQueries) return -(int)cudaErrorInvalidValue;
  return sdc::blocks_per_sm((const void*)fn, smem_bytes(n_levels * W, qc));
}

// Launches ceil(Q / qc) x n_slices blocks on `stream`: ldo is the output's
// row stride (a multiple of 32 floats, >= N), slice_docs a multiple of
// kRows. Returns cudaGetLastError() (0 on success).
int binary_dot_launch(const void* q, const void* d, void* out, int Q, int N, int ldo,
                      int n_levels, int W, int qc, int n_slices, int slice_docs, float scale,
                      void* stream) {
  BinaryDotFn fn = pick(n_levels, W);
  if (fn == nullptr || qc < 1 || qc > kMaxQueries || ldo % 32 || ldo < N || slice_docs % kRows)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_levels * W, qc);
  cudaError_t err = cudaFuncSetAttribute((const void*)fn,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + qc - 1) / qc, n_slices);
  fn<<<grid, kThreads, smem, (cudaStream_t)stream>>>((const unsigned*)q, (const unsigned*)d,
                                                     (float*)out, Q, N, ldo, qc, slice_docs,
                                                     scale);
  return (int)cudaGetLastError();
}

const char* binary_dot_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
