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

#include "sdc_common.cuh"

using namespace sdc;

namespace {

// Shared memory: the selector's buffers for qc queries (Selector::place),
// then query words [qc][QSTRIDE] int (each row 16-byte aligned, read as
// int4) and qsum [qc] int.
template <int D, bool PACKED>
__global__ void __launch_bounds__(kThreads)
sdc_scan_kernel(const int* __restrict__ qa,      // int8 [Q, D]; packed: even dims [Q, D/2]
                const int* __restrict__ qb,      // packed: odd dims [Q, D/2]; else unused
                const uint8_t* __restrict__ docs,  // [N, D] int8 or [N, D/2] packed
                const float* __restrict__ inv,     // [N]
                u64* __restrict__ partial,         // [Q, n_slices, k]
                int Q, int N, int k, int cap, int qc, int slice_docs,
                float c1, float c2, float c3) {
  using R = Row<D, PACKED>;
  extern __shared__ __align__(16) u64 smem[];
  const int q0 = blockIdx.y * qc;
  const int nq = min(qc, Q - q0);
  Selector sel;
  int* qs = reinterpret_cast<int*>(sel.place(smem, qc, cap, k));
  int* qsum = qs + qc * R::QSTRIDE;
  sel.init(nq);
  load_queries<D, PACKED>(qs, qsum, qa, qb, nq, [&](int j) { return q0 + j; });

  const long long begin = (long long)blockIdx.x * slice_docs;
  const long long end = min((long long)N, begin + slice_docs);
  for (long long r = begin; r < end; r += kThreads) {
    const long long n = r + threadIdx.x;
    bool valid = n < end;
    unsigned a[R::RW];  // int8 row words, or the low nibbles (even dims)
    unsigned b[R::BW];  // high nibbles (odd dims)
    float w_inv = 0.f;
    if (valid) {
      load_row(docs + n * R::ROW_BYTES, a);
      w_inv = inv[n];
      valid = w_inv > 0.f;
    }
    const int sd = unpack_row<PACKED>(a, b);  // unused where !valid
    auto score_key = [&](int qq) -> u64 {
      const float s = epilogue(row_dot<PACKED>(a, b, qs + qq * R::QSTRIDE), qsum[qq] + sd, w_inv,
                               c1, c2, c3);
      return make_key(s, (unsigned)n);
    };
    if (valid) {
      for (int qq = 0; qq < nq; ++qq) sel.insert(qq, score_key(qq));
    }
    sel.end_round(nq, [&](int qq) -> u64 { return valid ? score_key(qq) : 0ull; });
  }

  sel.finish(nq);
  const size_t n_slices = gridDim.x;
  for (int qq = 0; qq < nq; ++qq)
    sel.store(qq, partial + ((size_t)(q0 + qq) * n_slices + blockIdx.x) * k);
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
  (void)packed;
  const int qstride = D / 4;  // int words per query (both nibble halves when packed)
  return selector_smem(qc, cap) + (size_t)qc * qstride * sizeof(int) + (size_t)qc * sizeof(int);
}

size_t sdc_topk_merge_smem(int cap) { return selector_smem(1, cap); }

// Scan blocks that fit on one SM at once (occupancy), or a negative CUDA
// error code; the wrapper sizes the grid to one full wave from it.
int sdc_topk_blocks_per_sm(int D, int packed, int cap, int qc) {
  ScanFn scan = packed ? pick_scan<true>(D) : pick_scan<false>(D);
  if (scan == nullptr) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm((const void*)scan, sdc_topk_scan_smem(D, packed, cap, qc));
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
