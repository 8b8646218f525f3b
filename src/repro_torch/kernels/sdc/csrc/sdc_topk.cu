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
// N * (D + 4) bytes and does 2*Q*D int8 operations per document, far below
// the card's ridge point, so the floor is HBM bandwidth. What keeps a
// design off that floor is the work per (query, document) pair (code
// product, epilogue and key, the selector's offer) and per round of rows
// (staging, barriers, the selector's end of round).
//
// The grid is one wave of blocks. A block owns one slice of the documents
// and one chunk of at most 16 queries, held in shared memory.
// The query chunk is blockIdx.x, so the chunks of one slice run side by
// side and all but the first read the slice from the 50 MB L2. A round is
// kThreads document rows, staged in shared memory with cp.async
// (tile_mma.cuh) with their inverse norms, the next round's copy running
// while this round's keys are selected and the round after it asked into
// L2. The code products of the round's rows with the chunk's queries are
// one exact int8 tensor-core tile product
// (mma.sync m16n8k32) into a [query][row] dot tile; nibble-packed rows are
// split into their even and odd dims as the product loads them, against
// query halves split beforehand (Hopper has no int4 product). One more
// query row of all ones gives each row's code sum in the same product.
// Each thread then takes its row's dots through the epilogue to keys;
// integers go to float by an exact add, not a conversion instruction.
//
// Top-k without a sequential grid: blocks run in parallel and in no order,
// so each block keeps, per query, a candidate buffer in shared memory of
// 64-bit keys that order (score desc, id asc) as unsigned integers (the
// Selector of sdc_common.cuh). A key is offered only if it beats the
// query's current k-th best key; a buffer that fills is sorted (bitonic)
// and cut back to k. A thread whose offer takes a buffer past cap / 2
// says so at the round's closing barrier, and only then does the
// selector's serial pass over the block's queries run; that barrier also
// publishes the next round's rows, so a round costs two barriers. They are
// hidden by other blocks' work, so a chunk is small and three blocks share
// an SM.
// A block's first round finds every threshold at 0, so kThreads offers
// would overflow a buffer of cap < kThreads keys: it is offered in parts
// of min(cap, kThreads) threads instead, and the first part's compaction
// sets the threshold for the rest; each part but the last closes on one
// more barrier, so that the next part's offers stay out of the counts
// that an overflow falls back to. Each block writes its per-query top-k
// partials [Q, n_slices, k]; a second kernel merges them with the same
// buffer into [Q, k]. Keys are unique (ids are), so the result depends
// neither on the order blocks finish in nor on how offers are cut into
// rounds.
//
// The epilogue uses __fmul_rn / __fadd_rn so that no FMA contraction
// changes the reference's rounding (the file is also built -fmad=false).

#include "sdc_common.cuh"
#include "tile_mma.cuh"

using namespace sdc;

namespace {

// Blocks an SM the shape is sized for; the wrapper gives a block at most
// 16 queries (_TOPK_QUERIES_PER_BLOCK) and counts on this (_TOPK_BLOCKS_PER_SM).
constexpr int kMinBlocks = 3;

// Byte offsets of a scan block's shared arrays: the selector's buffers for
// qc queries, then the query rows [qp][QS] int (qp = qc + 1 rounded up to
// a multiple of 8, the tile product's width; row nq is all ones, so the
// product also gives each row's code sum), the row tile [kThreads][S]
// words and its rows' inverse norms [kThreads] float, the dot tile
// [qp][kDotStride] int and the query code sums [qc] float. Every array
// starts 16-byte aligned.
struct ScanLayout {
  size_t qs, rows, invs, dots, qsum, end;
};

__host__ __device__ inline ScanLayout scan_layout(int D, bool packed, int cap, int qc) {
  const size_t S = pad_words(packed ? D / 8 : D / 4), QS = pad_words(D / 4);
  const size_t qp = (size_t)(qc + 8) & ~(size_t)7;
  ScanLayout l;
  l.qs = selector_smem(qc, cap);
  l.rows = l.qs + qp * QS * sizeof(int);
  l.invs = l.rows + kThreads * S * sizeof(unsigned);
  l.dots = l.invs + kThreads * sizeof(float);
  l.qsum = l.dots + qp * kDotStride * sizeof(int);
  l.end = l.qsum + (((size_t)qc * sizeof(float) + 15) & ~(size_t)15);
  return l;
}

// float(x), exactly, for |x| < 2^22, without a conversion instruction (which
// Hopper issues at an eighth of the float rate): every code product and
// code sum of D <= 256 codes in [0, 127] is in range.
__device__ __forceinline__ float exact_float(int x) {
  return __fsub_rn(__int_as_float(0x4B400000 + x), 12582912.0f);  // 1.5 * 2^23
}

// End a round of offers: Selector::end_round where some buffer needs it
// (holds more than cap / 2 keys; `cut` is whether this thread saw one of
// its offers pass that), otherwise what end_round then does: each query's
// next round starts at its count. So the serial pass over the block's
// queries runs only in the rounds in which a buffer is to be cut, and a
// round costs one barrier. Where another part of the same round of rows
// follows (`part_follows`, the same in every thread), one more barrier
// keeps its offers out of the base: end_round cuts an overflowing buffer
// back to its base and offers the part again, so a key counted in the
// base would be offered twice.
template <class Rescore>
__device__ __forceinline__ void close_round(Selector& sel, int nq, bool cut, bool part_follows,
                                            Rescore rescore) {
  if (__syncthreads_or(cut)) {
    sel.end_round(nq, rescore);
  } else {
    for (int j = threadIdx.x; j < nq; j += blockDim.x) sel.base[j] = sel.count[j];
    if (part_follows) __syncthreads();
  }
}

template <int D, bool PACKED>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sdc_scan_kernel(const int* __restrict__ qa,      // int8 [Q, D]; packed: even dims [Q, D/2]
                const int* __restrict__ qb,      // packed: odd dims [Q, D/2]; else unused
                const uint8_t* __restrict__ docs,  // [N, D] int8 or [N, D/2] packed
                const float* __restrict__ inv,     // [N]
                u64* __restrict__ partial,         // [Q, n_slices, k]
                int Q, int N, int k, int cap, int qc, int slice_docs,
                float c1, float c2, float c3) {
  using R = Row<D, PACKED>;
  using T = Tile<D, PACKED>;
  extern __shared__ __align__(16) u64 smem[];
  const ScanLayout lay = scan_layout(D, PACKED, cap, qc);
  char* const base = reinterpret_cast<char*>(smem);
  const int q0 = blockIdx.x * qc;
  const int nq = min(qc, Q - q0);
  Selector sel;
  sel.place(smem, qc, cap, k);
  int* qs = reinterpret_cast<int*>(base + lay.qs);
  unsigned* tile = reinterpret_cast<unsigned*>(base + lay.rows);
  float* invs = reinterpret_cast<float*>(base + lay.invs);
  int* dots = reinterpret_cast<int*>(base + lay.dots);
  float* qsum = reinterpret_cast<float*>(base + lay.qsum);
  sel.init(nq);
  load_queries<D, PACKED, T::QS>(qs, reinterpret_cast<int*>(qsum), qa, qb, nq,
                                 [&](int j) { return q0 + j; });
  // The code sums as floats (in place), and query row nq all ones.
  for (int j = threadIdx.x; j < nq; j += blockDim.x)
    qsum[j] = exact_float(reinterpret_cast<int*>(qsum)[j]);
  for (int w = threadIdx.x; w < R::QSTRIDE; w += blockDim.x) qs[nq * T::QS + w] = 0x01010101;
  __syncthreads();

  const long long begin = (long long)blockIdx.y * slice_docs;
  const long long end = min((long long)N, begin + slice_docs);
  // Start copying the round of rows at r, and their inverse norms, into the
  // row tile: thread t copies row t's norm, so it may read that norm after
  // its own wait. The round after it is asked into L2.
  auto stage = [&](long long r) {
    const bool in = r + threadIdx.x < end;
    stage_rows<D, PACKED>(tile, docs + r * R::ROW_BYTES, __ballot_sync(0xFFFFFFFFu, in));
    if (in) cp_async4(invs + threadIdx.x, inv + r + threadIdx.x);
    cp_async_commit();
    const long long ahead = r + kThreads;
    if (threadIdx.x == 0 && ahead < end)
      prefetch_l2(docs + ahead * R::ROW_BYTES,
                  (unsigned)(min((long long)kThreads, end - ahead) * R::ROW_BYTES));
  };
  // The rows of round r + 1 are copied while round r's keys are selected,
  // and have landed (for this thread's copies) before the round closes,
  // so that its barrier also makes them visible to all.
  stage(begin);
  cp_async_wait<0>();
  __syncthreads();
  bool warm = true;
  for (long long r = begin; r < end; r += kThreads) {
    const long long n = r + threadIdx.x;
    const float w_inv = n < end ? invs[threadIdx.x] : 0.f;  // this thread's own copy
    const bool valid = w_inv > 0.f;
    tile_dots<D, PACKED>(tile, qs, dots, nq + 1);
    __syncthreads();  // the dot tile is written, the row tile free
    const float sd = exact_float(dots[nq * kDotStride + threadIdx.x]);
    const bool more = r + kThreads < end;
    if (more) stage(r + kThreads);
    // The epilogue of sdc_common.cuh, in its order; the sum of two integer
    // code sums below 2^24 is exact in float.
    auto key_of = [&](int j) -> u64 {
      const float dot = exact_float(dots[j * kDotStride + threadIdx.x]);
      const float s = __fadd_rn(__fmul_rn(c1, dot), __fmul_rn(c2, __fadd_rn(qsum[j], sd)));
      return make_key(__fmul_rn(__fadd_rn(s, c3), w_inv), (unsigned)n);
    };
    const int part = warm ? min(cap, kThreads) : kThreads;
    for (int h = 0; h < kThreads; h += part) {
      const bool mine = valid && (int)threadIdx.x >= h && (int)threadIdx.x < h + part;
      auto rescore = [&](int j) -> u64 { return mine ? key_of(j) : 0ull; };
      bool cut = false;
      if (mine) {
        for (int j = 0; j < nq; ++j) {
          const u64 key = key_of(j);
          if (key > sel.thresh[j]) {
            sel.insert(j, key);
            cut |= sel.count[j] > cap / 2;
          }
        }
      }
      const bool last = h + part >= kThreads;
      if (more && last) cp_async_wait<0>();
      close_round(sel, nq, cut, !last, rescore);
    }
    warm = false;
  }

  sel.finish(nq);
  const size_t n_slices = gridDim.y;
  for (int j = 0; j < nq; ++j)
    sel.store(j, partial + ((size_t)(q0 + j) * n_slices + blockIdx.y) * k);
}

// One block per query: the best k of its n_slices * k partial keys.
__global__ void __launch_bounds__(kThreads)
sdc_merge_kernel(const u64* __restrict__ partial, float* __restrict__ vals,
                 int* __restrict__ ids, int m, int k, int cap) {
  extern __shared__ __align__(16) u64 smem[];
  Selector sel;
  sel.place(smem, 1, cap, k);
  select_row(sel, partial + (size_t)blockIdx.x * m, m);
  const int c = sel.count[0];
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float v = kNegInf;
    int id = -1;
    if (j < c) {
      u64 key = sel.buf[j];
      v = key_val(key);
      id = v > kNegInf / 2 ? (int)key_tie(key) : -1;
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
  return scan_layout(D, packed != 0, cap, qc).end;
}

size_t sdc_topk_merge_smem(int cap) { return selector_smem(1, cap); }

// Scan blocks that fit on one SM at once (occupancy), or a negative CUDA
// error code; the wrapper sizes the grid to one full wave from it.
int sdc_topk_blocks_per_sm(int D, int packed, int cap, int qc) {
  ScanFn scan = packed ? pick_scan<true>(D) : pick_scan<false>(D);
  if (scan == nullptr) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm((const void*)scan, sdc_topk_scan_smem(D, packed, cap, qc));
}

// Launches the scan over ceil(Q / qc) x n_slices blocks, then the merge
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
  dim3 grid((Q + qc - 1) / qc, n_slices);
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
