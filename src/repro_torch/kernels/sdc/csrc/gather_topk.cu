// SDC scan of probed inverted lists + top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sdc/gather.py::sdc_gather_topk
// (the IVF fine layer; later also HNSW hops and the bi-granular rerank):
// for query q, every slot (p, pos) of its probed lists, list
// c = clamp(probes[q, p], 0, nlist - 1), position pos < L, is scored with
// the SDC epilogue of sdc_common.cuh; a slot with !(inv > 0), ids < 0 or,
// in the masked variant, !(cand_mask[q, p, pos] > 0) is excluded. The k
// best slots are returned as (score, lists_ids[c, pos]), ties broken toward
// the lower slot p*L + pos (the earlier probe column, then the lower
// position), which is the reference's order: its running top-k merges the
// probe columns in order, running entries first. Empty slots come back as
// (-1e30, -1).
//
// What bounds it: the probed lists. Q queries x nprobe probes touch at most
// nlist distinct lists, so the least traffic is those lists read once,
// lists * L * (Dc + 8) bytes; the operations are 2 * Q * nprobe * L * D.
// A design that scans one (query, probe) pair per block reads every list
// once per pair that probes it, Q * nprobe / nlist times as often (32x at
// the serving shapes). So this kernel works list by list: the wrapper
// sorts the (q, p) pairs by their list (order, pair_off), and cuts each
// list's pairs into units of at most qc pairs (unit_off). A block owns one
// unit and one slice of the list's rows, holds the unit's query codes in
// shared memory and scores every row it loads against all of them, like
// sdc_topk.cu scores a corpus slice against a whole batch. A list is then
// read once per unit (once, unless more than qc pairs probe it), and the
// units of one list run side by side (blockIdx.x is the unit), so the
// rereads hit L2. The grid's x extent is a bound on the number of units
// that needs no device-to-host copy; blocks past the last unit return at
// once. Lists differ in length (3x to 6x at the serving shapes) and in how
// many pairs probe them, so blocks differ in work: the grid is some four
// waves of slices, which the card balances, rather than one wave that waits
// on its largest block.
//
// A round is kThreads rows, one per thread. The code products of the
// round's rows with the unit's queries are one int8 tensor-core tile
// product (tile_mma.cuh: mma.sync m16n8k32, exact int32 sums) into a
// [pair][row] dot tile; each thread then takes its row's dot for every
// pair through the SDC epilogue to a key, and the selector ends the round.
// The rows are staged in shared memory with cp.async, and the next round's
// copy runs while this round's keys are selected; rows that are not live
// are not fetched, and a round with no live row (the padding past a list's
// occupancy) is skipped whole. What is left is the selector: its rounds
// end on barriers and a serial pass over the pairs, which one block cannot
// hide, so a unit is at most 16 pairs and three blocks share an SM (one
// row tile each, not two, for that). Each slice's first live round would
// overflow every pair's buffer; it is offered in parts instead (below).
//
// Top-k: each block keeps, per pair, a candidate buffer of 64-bit keys
// (score desc, slot asc) in the Selector of sdc_common.cuh and writes the
// pair's top-k of its slice to partial[q * nprobe + p][slice]; a second
// kernel merges a query's nprobe * n_slices * k keys and only then looks
// up the doc id of each winning slot. Slots are unique per query, so the
// result does not depend on the order blocks finish in, nor on how the
// offers are cut into rounds. All addressing of the lists is 64-bit:
// nlist * L * Dc passes 2^31 at deployment sizes.

#include "sdc_common.cuh"
#include "tile_mma.cuh"

using namespace sdc;

namespace {

// Byte offsets of a scan block's shared arrays: the selector's buffers for
// qc pairs, then the unit's query rows [qp][QS] int (qp = qc rounded up to
// a multiple of 8, the tile product's width), the row tile [kThreads][S]
// words, the dot tile [qp][kDotStride] int, each pair's offset into the
// mask [qc] long long, and qsum, each pair's query and its probe column
// [qc] int. Every array starts 16-byte aligned.
struct ScanLayout {
  size_t qs, rows, dots, moff, qsum, end;
};

__host__ __device__ inline ScanLayout scan_layout(int D, bool packed, int cap, int qc) {
  const size_t S = pad_words(packed ? D / 8 : D / 4), QS = pad_words(D / 4);
  const size_t qp = (size_t)(qc + 7) & ~(size_t)7;
  ScanLayout l;
  l.qs = selector_smem(qc, cap);
  l.rows = l.qs + qp * QS * sizeof(int);
  l.dots = l.rows + kThreads * S * sizeof(unsigned);
  l.moff = l.dots + qp * kDotStride * sizeof(int);
  l.qsum = l.moff + (((size_t)qc * sizeof(long long) + 15) & ~(size_t)15);
  l.end = l.qsum + 3 * (size_t)qc * sizeof(int);
  return l;
}

template <int D, bool PACKED, bool MASKED>
__global__ void __launch_bounds__(kThreads, 3)  // three blocks an SM (gather.py)
gather_scan_kernel(const int* __restrict__ qa,          // int8 [Q, D]; packed: even dims
                   const int* __restrict__ qb,          // packed: odd dims; else unused
                   const uint8_t* __restrict__ lists,   // [nlist, L, D] int8 or [.., D/2]
                   const float* __restrict__ inv,       // [nlist, L]
                   const int* __restrict__ ids,         // [nlist, L]
                   const int* __restrict__ order,       // [Q * nprobe] pairs, by list
                   const int* __restrict__ pair_off,    // [nlist + 1] into order
                   const int* __restrict__ unit_off,    // [nlist + 1] units per list, summed
                   const float* __restrict__ mask,      // [Q, nprobe, L], any strides
                   long long msq, long long msp, long long msl,
                   u64* __restrict__ partial,           // [Q * nprobe, n_slices, k]
                   int nlist, int L, int nprobe, int k, int cap, int qc, int slice_rows,
                   float c1, float c2, float c3) {
  using R = Row<D, PACKED>;
  using T = Tile<D, PACKED>;
  const int u = blockIdx.x;
  if (u >= unit_off[nlist]) return;
  // the list of unit u: unit_off[c] <= u < unit_off[c + 1]
  int c = 0, hi = nlist;
  while (hi - c > 1) {
    const int mid = (c + hi) >> 1;
    if (unit_off[mid] <= u) c = mid; else hi = mid;
  }
  const int first = pair_off[c] + (u - unit_off[c]) * qc;
  const int np = min(qc, pair_off[c + 1] - first);

  extern __shared__ __align__(16) u64 smem[];
  const ScanLayout lay = scan_layout(D, PACKED, cap, qc);
  char* const base = reinterpret_cast<char*>(smem);
  Selector sel;
  sel.place(smem, qc, cap, k);
  int* qs = reinterpret_cast<int*>(base + lay.qs);
  unsigned* tile = reinterpret_cast<unsigned*>(base + lay.rows);
  int* dots = reinterpret_cast<int*>(base + lay.dots);
  long long* moff = reinterpret_cast<long long*>(base + lay.moff);
  int* qsum = reinterpret_cast<int*>(base + lay.qsum);
  int* pq = qsum + qc;  // query of each pair
  int* pp = pq + qc;    // probe column of each pair
  for (int j = threadIdx.x; j < np; j += blockDim.x) {
    const int pair = order[first + j];
    pq[j] = pair / nprobe;
    pp[j] = pair % nprobe;
    moff[j] = pq[j] * msq + pp[j] * msp;
  }
  sel.init(np);
  __syncthreads();
  load_queries<D, PACKED, T::QS>(qs, qsum, qa, qb, np, [&](int j) { return pq[j]; });

  const long long list0 = (long long)c * L;
  const uint8_t* rows0 = lists + list0 * R::ROW_BYTES;
  const int begin = blockIdx.y * slice_rows;
  const int end = min(L, begin + slice_rows);
  // This thread's row of the round starting at r: its inverse norm, and
  // whether it is live (in the slice, inv > 0, a real id).
  auto meta = [&](int r, float& w, bool& ok) {
    const int pos = r + threadIdx.x;
    w = 0.f;
    ok = false;
    if (pos < end) {
      w = inv[list0 + pos];
      ok = w > 0.f && ids[list0 + pos] >= 0;
    }
  };
  auto stage = [&](int r, bool ok) {
    stage_rows<D, PACKED>(tile, rows0 + (size_t)r * R::ROW_BYTES, __ballot_sync(0xFFFFFFFFu, ok));
    cp_async_commit();
  };
  // The rows of round r + 1 are copied while round r's keys are selected,
  // the longest part of a round; the live flags that choose which rows to
  // fetch are loaded a round before that.
  float w0, w1;
  bool ok0, ok1;
  meta(begin, w0, ok0);
  meta(begin + kThreads, w1, ok1);
  stage(begin, ok0);
  // The block's first live round finds every pair's threshold at 0, so a
  // round of kThreads offers overflows a buffer of cap < kThreads keys.
  // It is offered in parts of min(cap, kThreads) threads instead: the
  // first part fits, and its compaction sets the threshold for the rest.
  bool warm = true;
  for (int r = begin; r < end; r += kThreads) {
    float w2;
    bool ok2;
    meta(r + 2 * kThreads, w2, ok2);
    cp_async_wait<0>();  // this round's rows have landed
    const int pos = r + threadIdx.x;
    const bool valid = ok0;
    const float w_inv = w0;
    w0 = w1;
    ok0 = ok1;
    w1 = w2;
    ok1 = ok2;
    const bool live = __syncthreads_or(valid);
    int sd = 0;
    if (live) {
      tile_dots<D, PACKED>(tile, qs, dots, np);
      if (valid) sd = staged_row_sum<D, PACKED>(tile + threadIdx.x * T::S);
      __syncthreads();  // the dot tile is written, the row tile free
    }
    if (r + kThreads < end) stage(r + kThreads, ok0);
    if (!live) continue;  // no live row: no product, no selector round
    const int part = warm ? min(cap, kThreads) : kThreads;
    for (int h = 0; h < kThreads; h += part) {
      const bool mine = valid && (int)threadIdx.x >= h && (int)threadIdx.x < h + part;
      auto key_of = [&](int j) -> u64 {
        if (!mine) return 0ull;
        const float s = epilogue(dots[j * kDotStride + threadIdx.x], qsum[j] + sd, w_inv, c1,
                                 c2, c3);
        const u64 key = make_key(s, (unsigned)pp[j] * (unsigned)L + (unsigned)pos);
        if constexpr (MASKED) return mask[moff[j] + pos * msl] > 0.f ? key : 0ull;
        return key;
      };
      if (mine) {
        for (int j = 0; j < np; ++j) sel.insert(j, key_of(j));
      }
      sel.end_round(np, key_of);
    }
    warm = false;
  }

  sel.finish(np);
  const size_t n_slices = gridDim.y;
  for (int j = 0; j < np; ++j) {
    const size_t pair = (size_t)pq[j] * nprobe + pp[j];
    sel.store(j, partial + (pair * n_slices + blockIdx.y) * k);
  }
}

// One block per query: the best k of its nprobe * n_slices * k partial
// keys, then each winner's slot -> (list, position) -> doc id.
__global__ void __launch_bounds__(kThreads)
gather_merge_kernel(const u64* __restrict__ partial, const int* __restrict__ probes,
                    const int* __restrict__ ids, float* __restrict__ vals,
                    int* __restrict__ out_ids, int m, int k, int cap, int nlist, int L,
                    int nprobe) {
  extern __shared__ __align__(16) u64 smem[];
  Selector sel;
  sel.place(smem, 1, cap, k);
  select_row(sel, partial + (size_t)blockIdx.x * m, m);
  const int n = sel.count[0];
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float v = kNegInf;
    int id = -1;
    if (j < n) {
      const u64 key = sel.buf[j];
      v = key_val(key);
      const unsigned slot = key_tie(key);
      const int p = (int)(slot / (unsigned)L), pos = (int)(slot % (unsigned)L);
      const int c = min(max(probes[(size_t)blockIdx.x * nprobe + p], 0), nlist - 1);
      id = ids[(long long)c * L + pos];
    }
    vals[(size_t)blockIdx.x * k + j] = v;
    out_ids[(size_t)blockIdx.x * k + j] = id;
  }
}

typedef void (*ScanFn)(const int*, const int*, const uint8_t*, const float*, const int*,
                       const int*, const int*, const int*, const float*, long long, long long,
                       long long, u64*, int, int, int, int, int, int, int, float, float, float);

template <bool PACKED, bool MASKED>
ScanFn pick_dim(int D) {
  switch (D) {
    case 32: return gather_scan_kernel<32, PACKED, MASKED>;
    case 64: return gather_scan_kernel<64, PACKED, MASKED>;
    case 128: return gather_scan_kernel<128, PACKED, MASKED>;
    case 256: return gather_scan_kernel<256, PACKED, MASKED>;
    default: return nullptr;
  }
}

ScanFn pick_scan(int D, int packed, int masked) {
  if (packed) return masked ? pick_dim<true, true>(D) : pick_dim<true, false>(D);
  return masked ? pick_dim<false, true>(D) : pick_dim<false, false>(D);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one scan block holding qc pairs.
size_t gather_topk_scan_smem(int D, int packed, int cap, int qc) {
  return scan_layout(D, packed != 0, cap, qc).end;
}

// Scan blocks that fit on one SM at once, or a negative CUDA error code.
int gather_topk_blocks_per_sm(int D, int packed, int masked, int cap, int qc) {
  ScanFn scan = pick_scan(D, packed, masked);
  if (scan == nullptr) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm((const void*)scan, gather_topk_scan_smem(D, packed, cap, qc));
}

// Launches the scan over max_units x n_slices blocks, then the merge over
// Q blocks, on `stream`. Returns cudaGetLastError() (0 on success).
int gather_topk_launch(const void* qa, const void* qb, const void* lists, const void* inv,
                       const void* ids, const void* probes, const void* order,
                       const void* pair_off, const void* unit_off, const void* mask,
                       long long msq, long long msp, long long msl, void* partial, void* vals,
                       void* out_ids, int Q, int nlist, int L, int D, int nprobe, int packed,
                       int k, int cap, int qc, int max_units, int n_slices, int slice_rows,
                       float c1, float c2, float c3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ScanFn scan = pick_scan(D, packed, mask != nullptr);
  if (scan == nullptr) return (int)cudaErrorInvalidValue;
  const size_t scan_smem = gather_topk_scan_smem(D, packed, cap, qc);
  cudaError_t err = cudaFuncSetAttribute((const void*)scan,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)scan_smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(max_units, n_slices);
  scan<<<grid, kThreads, scan_smem, s>>>(
      (const int*)qa, (const int*)qb, (const uint8_t*)lists, (const float*)inv, (const int*)ids,
      (const int*)order, (const int*)pair_off, (const int*)unit_off, (const float*)mask, msq,
      msp, msl, (u64*)partial, nlist, L, nprobe, k, cap, qc, slice_rows, c1, c2, c3);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t merge_smem = selector_smem(1, cap);
  err = cudaFuncSetAttribute((const void*)gather_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)merge_smem);
  if (err != cudaSuccess) return (int)err;
  gather_merge_kernel<<<Q, kThreads, merge_smem, s>>>(
      (const u64*)partial, (const int*)probes, (const int*)ids, (float*)vals, (int*)out_ids,
      nprobe * n_slices * k, k, cap, nlist, L, nprobe);
  return (int)cudaGetLastError();
}

const char* gather_topk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
