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
// What bounds it: at one query, the corpus (N * (D + 4) bytes from HBM).
// At 16 queries a block, the copy of each slice into shared memory, once a
// query chunk, with one round in flight a block; then the work per (query,
// document) pair (the epilogue and the test against the query's k-th
// best, which fewer than 0.1% pass), then the selector. tools/topk_split.py
// measures the split.
//
// The grid is one wave of blocks. A block owns one slice of the documents
// and one chunk of at most kMaxQueries queries, held in shared memory (the
// wrapper sizes the chunks, trading copies of a slice against selection).
// The query chunk is blockIdx.x, so the chunks of one slice run side by
// side and all but the first read the slice from the 50 MB L2. A round is
// kThreads document rows, staged in shared memory with cp.async
// (tile_mma.cuh) with their inverse norms; warp w stages and scores only
// its own 32 rows, so a round's copy needs no barrier of the block: the
// warp reads its rows and their norms, then starts the next round's copy
// while it selects this round's keys (the round after it asked into L2).
//
// The per-pair path stays in registers. The code products of a warp's 32
// rows with the chunk's queries are exact int8 tensor-core products
// (mma.sync m16n8k32, warp_products) left in their accumulators: lane
// (g, t) holds rows 8p + g of the warp's 32 (its four row slots p) against
// query columns 8G + 2t and 8G + 2t + 1; nibble-packed rows are split into
// their even and odd dims as the product loads them, against query halves
// split beforehand (Hopper has no int4 product). One more query row of all
// ones gives each row's code sum in the same product, and the lane that
// holds it hands it to the rest of its quad by a shuffle. Where a lane's
// words of the round fit in 16 registers it loads them before it starts
// the next round's copy, so that the copy runs under the product too.
//
// Each lane runs the epilogue on its own accumulators, with its rows'
// norms and its queries' code sums in registers, in sdc_common.cuh's order,
// so the score is bit for bit the reference's; integers go to float by an
// exact add, not a conversion instruction. A pair then meets a float gate:
// each lane holds, for each of its query columns, the value of the query's
// k-th best key (-inf while the query holds fewer than k), and only a
// score not below it becomes a 64-bit key and meets the exact test.
// make_key orders floats as >= does, so the gate lets through every pair
// that the exact test would take; ties fall through to it, and so would -0
// against +0, which < holds equal (no score is -0: the sum before the norm
// adds c3 = D*beta^2 >= 0, so it is -0 only as a negative product that
// underflows, and the codes and norms make none). A lane tests a
// half-round's pairs (two rows) at once and leaves the straight path only
// where one passes. The gate's thresholds are read again after every
// round that cut a buffer, the only time they rise.
//
// Top-k without a sequential grid: blocks run in parallel and in no order,
// so each block keeps, per query, a candidate buffer in shared memory of
// 64-bit keys that order (score desc, id asc) as unsigned integers (the
// Selector of sdc_common.cuh). A key that beats the query's current k-th
// best is appended; a buffer that fills is sorted (bitonic) and cut back
// to k. A thread whose offer takes a buffer past cap / 2 says so at the
// round's closing barrier, the round's one barrier of the block, and only
// then does the serial pass over the block's queries run. A lane offers up
// to four keys a query in a round (64 lanes hold a query's column), so a
// round's offers can pass cap: a key past it is dropped, and the lane that
// offered it keeps a bit for it; once the buffer is cut, each such lane
// scores its dropped pairs again from the rows in global memory (integer
// dot products, the same epilogue: the same keys) and offers them in
// sub-rounds that cannot overflow (close_round). A block's first round
// finds every threshold at -inf; where cap < kThreads (k <= 64) it is
// offered in two parts, each with its own product: first the row slots
// that fill at most cap keys a query (64 keys a slot), whose compaction
// sets the threshold, then the rest past the gate. (Offered at once, such
// a round overflows, and remaking most of its keys from global memory
// costs more than a second product: PERF.md section 6.) Each block writes
// its per-query top-k partials [Q, n_slices, k]; a second kernel merges
// them with the same buffer into [Q, k]. Keys are unique (ids are), so the
// result depends neither on the order blocks finish in nor on how offers
// are cut into rounds.
//
// Each block adds the pairs it scored and the pairs that passed the gate
// to a two-word counter of the caller's, one atomic add each.
//
// The epilogue uses __fmul_rn / __fadd_rn so that no FMA contraction
// changes the reference's rounding (the file is also built -fmad=false).

#include "sdc_common.cuh"
#include "tile_mma.cuh"

using namespace sdc;

namespace {

// Blocks an SM the shape is sized for; the wrapper counts on this
// (_TOPK_BLOCKS_PER_SM).
constexpr int kMinBlocks = 3;
// Most queries a scan block holds (the wrapper's _TOPK_QUERIES_PER_BLOCK),
// and the groups of 8 product columns they and the all-ones row take.
constexpr int kMaxQueries = 16;
constexpr int kGroups = (kMaxQueries + 8) / 8;   // product groups, the all-ones row's included
constexpr int kQueryGroups = kMaxQueries / 8;    // groups that can hold queries
constexpr int kSlots = 4;               // rows a lane scores a round: 8p + g of its warp's 32
constexpr int kOwners = kThreads / 4;   // lanes that score a query: t = (j % 8) / 2 of each warp

// Byte offsets of a scan block's shared arrays: the selector's buffers for
// qc queries, then the query rows [qp][QS] int (qp = qc + 1 rounded up to
// a multiple of 8, the tile product's width; row nq is all ones, so the
// product also gives each row's code sum), the row tile [kThreads][S]
// words and its rows' inverse norms [kThreads] float, the query code sums
// [qc] float and the block's count of pairs past the gate. Every array
// starts 16-byte aligned.
struct ScanLayout {
  size_t qs, rows, invs, qsum, passed, end;
};

__host__ __device__ inline ScanLayout scan_layout(int D, bool packed, int cap, int qc) {
  const size_t S = pad_words(packed ? D / 8 : D / 4), QS = pad_words(D / 4);
  const size_t qp = (size_t)(qc + 8) & ~(size_t)7;
  ScanLayout l;
  l.qs = selector_smem(qc, cap);
  l.rows = l.qs + qp * QS * sizeof(int);
  l.invs = l.rows + kThreads * S * sizeof(unsigned);
  l.qsum = l.invs + kThreads * sizeof(float);
  l.passed = l.qsum + (((size_t)qc * sizeof(float) + 15) & ~(size_t)15);
  l.end = l.passed + 16;
  return l;
}

// float(x), exactly, for |x| < 2^22, without a conversion instruction (which
// Hopper issues at an eighth of the float rate): every code product and
// code sum of D <= 256 codes in [0, 127] is in range.
__device__ __forceinline__ float exact_float(int x) {
  return __fsub_rn(__int_as_float(0x4B400000 + x), 12582912.0f);  // 1.5 * 2^23
}

// End a round of offers, on one barrier where no buffer needs more
// (`cut`: whether one of this thread's offers took a buffer past cap / 2).
// Otherwise each buffer past cap / 2 is sorted and cut back to its best k
// (Selector::compact). A buffer that overflowed kept cap keys and dropped
// the rest: it is cut from the cap keys it kept, then offered the dropped
// ones again in sub-rounds that cannot overflow. Each thread offers its
// own, named by `lost` (bit 2 kQueryGroups p + 2G + e: its key of row slot
// p and query column 8G + 2t + e), which rescore(q, p) makes again. No
// kept key is offered twice, so the buffer ends as the best k of all that
// was offered. Returns whether buffers were cut (the same in every
// thread): the only time the thresholds rise.
template <class Rescore>
__device__ __forceinline__ bool close_round(Selector& sel, int nq, bool cut, unsigned lost,
                                            Rescore rescore) {
  if (!__syncthreads_or(cut)) return false;
  const int t = threadIdx.x & 3;
  const int owner = (threadIdx.x >> 5) * 8 + ((threadIdx.x & 31) >> 2);
  for (int q = 0; q < nq; ++q) {
    const int c = sel.count[q];
    if (c > sel.cap) {
      __syncthreads();
      if (threadIdx.x == 0) sel.count[q] = sel.cap;
      __syncthreads();
      sel.compact(q);
      unsigned mine = 0;  // this thread's dropped keys of query q, a bit a slot
      if (((q & 7) >> 1) == t) {
        for (int p = 0; p < kSlots; ++p)
          mine |= ((lost >> (2 * kQueryGroups * p + 2 * (q >> 3) + (q & 1))) & 1u) << p;
      }
      // Each sub-round offers as many keys as the buffer has room for; the
      // buffer is cut back only once less than half of cap - k is left,
      // and after the last sub-round where it holds more than cap / 2.
      for (int e0 = 0, room = sel.cap - sel.k; e0 < kSlots * kOwners;) {
        for (int p = 0; p < kSlots; ++p) {
          const int e = p * kOwners + owner - e0;
          if (((mine >> p) & 1u) && e >= 0 && e < room) sel.insert(q, rescore(q, p));
        }
        __syncthreads();
        const int n = sel.count[q];
        __syncthreads();
        e0 += room;
        if (n > (e0 < kSlots * kOwners ? (sel.cap + sel.k) / 2 : sel.cap / 2)) {
          sel.compact(q);
          room = sel.cap - sel.k;
        } else {
          room = sel.cap - n;
        }
      }
    } else if (c > sel.cap / 2) {
      sel.compact(q);
    }
  }
  __syncthreads();  // every count is read before the next offers
  return true;
}

// warp_products over the ng groups that hold the block's queries and its
// all-ones row, the count a compile-time constant in each branch.
template <int D, bool PACKED, class Words>
__device__ __forceinline__ void round_products(Words words, const int* qs, int ng,
                                               int (&c)[2][kGroups][4]) {
  static_assert(kGroups == 3, "one branch a group count");
  if (ng == 1) {
    warp_products<D, PACKED, 1>(words, qs, c);
  } else if (ng == 2) {
    warp_products<D, PACKED, 2>(words, qs, c);
  } else {
    warp_products<D, PACKED, 3>(words, qs, c);
  }
}

template <int D, bool PACKED>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sdc_scan_kernel(const int* __restrict__ qa,      // int8 [Q, D]; packed: even dims [Q, D/2]
                const int* __restrict__ qb,      // packed: odd dims [Q, D/2]; else unused
                const uint8_t* __restrict__ docs,  // [N, D] int8 or [N, D/2] packed
                const float* __restrict__ inv,     // [N]
                u64* __restrict__ partial,         // [Q, n_slices, k]
                u64* __restrict__ counts,          // [2]: += pairs scored, pairs past the gate
                int Q, int N, int k, int cap, int qc, int slice_docs,
                float c1, float c2, float c3) {
  using R = Row<D, PACKED>;
  using T = Tile<D, PACKED>;
  constexpr int kWords = PACKED ? 2 : 4;  // a lane's words of a half a k-step
  constexpr bool kEarly = T::KSTEPS * 2 * kWords <= 16;
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
  float* qsum = reinterpret_cast<float*>(base + lay.qsum);
  u64* block_passed = reinterpret_cast<u64*>(base + lay.passed);
  sel.init(nq);
  if (threadIdx.x == 0) *block_passed = 0ull;
  load_queries<D, PACKED, T::QS>(qs, reinterpret_cast<int*>(qsum), qa, qb, nq,
                                 [&](int j) { return q0 + j; });
  // The code sums as floats (in place), and query row nq all ones.
  for (int j = threadIdx.x; j < nq; j += blockDim.x)
    qsum[j] = exact_float(reinterpret_cast<int*>(qsum)[j]);
  for (int w = threadIdx.x; w < R::QSTRIDE; w += blockDim.x) qs[nq * T::QS + w] = 0x01010101;
  __syncthreads();

  // This lane's rows are row0 + 8p (its slots p), its query columns
  // 8G + 2t + e; the all-ones column nq is in group G1, at lane t1 of each
  // quad and parity e1. The lane keeps its queries' code sums and gate
  // thresholds in registers.
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (threadIdx.x & ~31) + g;
  const int ng = (nq + 8) >> 3;
  const int G1 = nq >> 3, t1 = (nq & 7) >> 1, e1 = nq & 1;
  const float no_threshold = __int_as_float(0xFF800000u);  // -inf: every score passes
  float qf[kQueryGroups][2], thr[kQueryGroups][2];
#pragma unroll
  for (int G = 0; G < kQueryGroups; ++G)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * G + 2 * t + e;
      qf[G][e] = j < nq ? qsum[j] : 0.f;
      thr[G][e] = no_threshold;
    }
  // The value of each query's k-th best key once it holds k (key_val(0) is
  // a NaN, which would shut the gate).
  auto read_thresholds = [&]() {
#pragma unroll
    for (int G = 0; G < kQueryGroups; ++G)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * G + 2 * t + e;
        if (j < nq) {
          const u64 th = sel.thresh[j];
          thr[G][e] = th ? key_val(th) : no_threshold;
        }
      }
  };

  const long long begin = (long long)blockIdx.y * slice_docs;
  const long long end = min((long long)N, begin + slice_docs);
  // Start copying the round of rows at r, and their inverse norms, into the
  // row tile: thread t copies row t and its norm, and warp w only its own
  // rows. The round after it is asked into L2.
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
  // so that its barrier also makes them visible to the warp.
  stage(begin);
  cp_async_wait<0>();
  __syncthreads();
  unsigned passed = 0;
  bool warm = true;
  for (long long r = begin; r < end; r += kThreads) {
    const bool more = r + kThreads < end;
    // A block's first round is offered in two parts, the first of at most
    // cap keys a query (row slots [0, first)), each part scored from the
    // row tile; every later round at once.
    const int first = warm ? min(kSlots, cap / kOwners) : kSlots;
    // This thread's key of row slot p for query j, made again from the row
    // in global memory (the product and code sum as integer dot products,
    // exact as the tensor core's), for a key its buffer dropped.
    auto rescore = [&](int j, int p) -> u64 {
      const long long n = r + row0 + 8 * p;
      const unsigned* row = reinterpret_cast<const unsigned*>(docs + n * R::ROW_BYTES);
      const int* q = qs + j * T::QS;
      int dot = 0, sum = 0;
      for (int w = 0; w < R::RW; ++w) {
        const unsigned x = row[w];
        if constexpr (PACKED) {
          const int lo = (int)(x & 0x0F0F0F0Fu), hi = (int)((x >> 4) & 0x0F0F0F0Fu);
          dot = __dp4a(hi, q[R::RW + w], __dp4a(lo, q[w], dot));
          sum = __dp4a(hi, 0x01010101, __dp4a(lo, 0x01010101, sum));
        } else {
          dot = __dp4a((int)x, q[w], dot);
          sum = __dp4a((int)x, 0x01010101, sum);
        }
      }
      const float v = __fadd_rn(__fmul_rn(c1, exact_float(dot)),
                                __fmul_rn(c2, __fadd_rn(qsum[j], exact_float(sum))));
      return make_key(__fmul_rn(__fadd_rn(v, c3), inv[n]), (unsigned)n);
    };
    for (int p0 = 0, p1 = first; p0 < kSlots; p0 = p1, p1 = kSlots) {
      const bool last = p1 == kSlots;
      // The product reads the warp's rows from registers loaded before the
      // next round's copy is started where they fit, else from the tile
      // before it is.
      unsigned early[kEarly ? T::KSTEPS : 1][2][kWords];
      if constexpr (kEarly) {
#pragma unroll
        for (int s = 0; s < T::KSTEPS; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < kWords; ++i)
              early[s][h][i] = fragment_word<D, PACKED>(tile, s, h, i);
      }
      auto words = [&](int s, int h, int i) -> unsigned {
        if constexpr (kEarly) {
          return early[s][h][i];
        } else {
          return fragment_word<D, PACKED>(tile, s, h, i);
        }
      };
      float w_inv[kSlots];
#pragma unroll
      for (int p = 0; p < kSlots; ++p)
        w_inv[p] = r + row0 + 8 * p < end ? invs[row0 + 8 * p] : 0.f;
      // The warp's rows and norms are read: its next copy may land on them.
      auto release = [&]() {
        __syncwarp();
        if (more) stage(r + kThreads);
      };
      if (kEarly && last) release();
      int c[2][kGroups][4];
      round_products<D, PACKED>(words, qs, ng, c);
      if (!kEarly && last) release();
      // Each accumulator (slot p = 2h + (i >> 1)) through the epilogue of
      // sdc_common.cuh, in its order (the sum of two integer code sums below
      // 2^24 is exact in float), and the gate, a half's pairs at a time; the
      // pairs past the gate, if any, then meet the exact test.
      bool cut = false;
      unsigned lost = 0;  // a bit a dropped key: 2 kQueryGroups p + 2G + e
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (2 * h + 1 < p0 || 2 * h >= p1) continue;  // no slot of the part
        int sums[2] = {0, 0};  // the code sums of rows g and g + 8, in lane t1
#pragma unroll
        for (int G = 0; G < kGroups; ++G) {
          if (G == G1) {
            sums[0] = e1 ? c[h][G][1] : c[h][G][0];
            sums[1] = e1 ? c[h][G][3] : c[h][G][2];
          }
        }
        float sc[2][kQueryGroups][2];
        bool live[2], any = false;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float sd = exact_float(__shfl_sync(0xFFFFFFFFu, sums[hi], (lane & ~3) | t1));
          const int p = 2 * h + hi;
          const float wi = w_inv[p];
          live[hi] = p >= p0 && p < p1 && wi > 0.f;
          if (p < p0 || p >= p1) continue;
#pragma unroll
          for (int G = 0; G < kQueryGroups; ++G) {
            if (8 * G >= nq) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dot = exact_float(c[h][G][2 * hi + e]);
              const float v = __fadd_rn(__fmul_rn(c1, dot), __fmul_rn(c2, __fadd_rn(qf[G][e], sd)));
              const float s = __fmul_rn(__fadd_rn(v, c3), wi);
              sc[hi][G][e] = s;
              any |= live[hi] && 8 * G + 2 * t + e < nq && !(s < thr[G][e]);
            }
          }
        }
        if (!any) continue;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          if (!live[hi]) continue;
          const unsigned n = (unsigned)(r + row0 + 16 * h + 8 * hi);
#pragma unroll
          for (int G = 0; G < kQueryGroups; ++G) {
            if (8 * G >= nq) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int j = 8 * G + 2 * t + e;
              const float s = sc[hi][G][e];
              if (j >= nq || s < thr[G][e]) continue;
              ++passed;
              const u64 key = make_key(s, n);
              if (key > sel.thresh[j]) {
                const int slot = atomicAdd(&sel.count[j], 1);
                if (slot < cap) {
                  sel.buf[j * cap + slot] = key;
                } else {
                  lost |= 1u << (2 * kQueryGroups * (2 * h + hi) + 2 * G + e);
                }
                cut |= slot >= cap / 2;
              }
            }
          }
        }
      }
      if (more && last) cp_async_wait<0>();
      if (close_round(sel, nq, cut, lost, rescore)) read_thresholds();
    }
    warm = false;
  }

  sel.finish(nq);
  const size_t n_slices = gridDim.y;
  for (int j = 0; j < nq; ++j)
    sel.store(j, partial + ((size_t)(q0 + j) * n_slices + blockIdx.y) * k);
  if (passed) atomicAdd(block_passed, (u64)passed);
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(counts, (u64)nq * (u64)max(0ll, end - begin));
    atomicAdd(counts + 1, *block_passed);
  }
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

typedef void (*ScanFn)(const int*, const int*, const uint8_t*, const float*, u64*, u64*, int,
                       int, int, int, int, int, float, float, float);

template <bool PACKED>
ScanFn pick_scan(int D, int qc) {
  if (qc < 1 || qc > kMaxQueries) return nullptr;
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
  ScanFn scan = packed ? pick_scan<true>(D, qc) : pick_scan<false>(D, qc);
  if (scan == nullptr) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm((const void*)scan, sdc_topk_scan_smem(D, packed, cap, qc));
}

// Launches the scan over ceil(Q / qc) x n_slices blocks, then the merge
// over Q blocks, on `stream`; the scan adds the pairs it scored and the
// pairs that passed its gate to counts[0] and counts[1] (uint64).
// Returns cudaGetLastError() (0 on success).
int sdc_topk_launch(const void* qa, const void* qb, const void* docs, const void* inv,
                    void* partial, void* counts, void* vals, void* ids, int Q, int N, int D,
                    int packed, int k, int cap, int qc, int n_slices, int slice_docs, float c1,
                    float c2, float c3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ScanFn scan = packed ? pick_scan<true>(D, qc) : pick_scan<false>(D, qc);
  if (scan == nullptr) return (int)cudaErrorInvalidValue;
  const size_t scan_smem = sdc_topk_scan_smem(D, packed, cap, qc);
  cudaError_t err = cudaFuncSetAttribute((const void*)scan,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)scan_smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Q + qc - 1) / qc, n_slices);
  scan<<<grid, kThreads, scan_smem, s>>>((const int*)qa, (const int*)qb, (const uint8_t*)docs,
                                         (const float*)inv, (u64*)partial, (u64*)counts, Q,
                                         N, k, cap, qc, slice_docs, c1, c2, c3);
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
