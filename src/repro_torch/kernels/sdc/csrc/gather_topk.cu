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
// many pairs probe them, so blocks differ in work: the grid is some eight
// waves of slices, which the card balances, rather than one wave that waits
// on its largest block. Scoring is __dp4a on the CUDA cores, as in
// sdc_topk.cu.
//
// Top-k: each block keeps, per pair, a candidate buffer of 64-bit keys
// (score desc, slot asc) and writes the pair's top-k of its slice to
// partial[q * nprobe + p][slice]; a second kernel merges a query's
// nprobe * n_slices * k keys and only then looks up the doc id of each
// winning slot. Slots are unique per query, so the result does not depend
// on the order blocks finish in. All addressing of the lists is 64-bit:
// nlist * L * Dc passes 2^31 at deployment sizes.

#include "sdc_common.cuh"

using namespace sdc;

namespace {

// Shared memory: the selector's buffers for qc pairs, then query words
// [qc][QSTRIDE] int, qsum [qc], and each pair's query and probe column.
template <int D, bool PACKED, bool MASKED>
__global__ void __launch_bounds__(kThreads)
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
  Selector sel;
  int* qs = reinterpret_cast<int*>(sel.place(smem, qc, cap, k));
  int* qsum = qs + qc * R::QSTRIDE;
  int* pq = qsum + qc;  // query of each pair
  int* pp = pq + qc;    // probe column of each pair
  for (int j = threadIdx.x; j < np; j += blockDim.x) {
    const int pair = order[first + j];
    pq[j] = pair / nprobe;
    pp[j] = pair % nprobe;
  }
  sel.init(np);
  __syncthreads();
  load_queries<D, PACKED>(qs, qsum, qa, qb, np, [&](int j) { return pq[j]; });

  const long long list0 = (long long)c * L;
  const int begin = blockIdx.y * slice_rows;
  const int end = min(L, begin + slice_rows);
  for (int r = begin; r < end; r += kThreads) {
    const int pos = r + threadIdx.x;
    bool valid = pos < end;
    unsigned a[R::RW];
    unsigned b[R::BW];
    int sd = 0;
    float w_inv = 0.f;
    if (valid) {
      const long long e = list0 + pos;
      w_inv = inv[e];
      valid = w_inv > 0.f && ids[e] >= 0;
      if (valid) {
        load_row(lists + e * R::ROW_BYTES, a);
        sd = unpack_row<PACKED>(a, b);
      }
    }
    auto key_of = [&](int j) -> u64 {
      if (!valid) return 0ull;
      if constexpr (MASKED) {
        if (!(mask[pq[j] * msq + pp[j] * msp + pos * msl] > 0.f)) return 0ull;
      }
      const float s = epilogue(row_dot<PACKED>(a, b, qs + j * R::QSTRIDE), qsum[j] + sd, w_inv,
                               c1, c2, c3);
      return make_key(s, (unsigned)pp[j] * (unsigned)L + (unsigned)pos);
    };
    if (valid) {
      for (int j = 0; j < np; ++j) sel.insert(j, key_of(j));
    }
    sel.end_round(np, key_of);
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
size_t gather_topk_scan_smem(int D, int cap, int qc) {
  const int qstride = D / 4;  // int words per query (both nibble halves when packed)
  return selector_smem(qc, cap) + (size_t)qc * qstride * sizeof(int) + 3 * (size_t)qc * sizeof(int);
}

// Scan blocks that fit on one SM at once, or a negative CUDA error code.
int gather_topk_blocks_per_sm(int D, int packed, int masked, int cap, int qc) {
  ScanFn scan = pick_scan(D, packed, masked);
  if (scan == nullptr) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm((const void*)scan, gather_topk_scan_smem(D, cap, qc));
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
  const size_t scan_smem = gather_topk_scan_smem(D, cap, qc);
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
