// Unfused SDC score matrix for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/sdc/sdc.py::sdc_scores
// (_sdc_kernel, _sdc_kernel_packed): scores [Q, N] f32, score[q, n] the SDC
// epilogue of sdc_common.cuh, or -1e30 where !(inv[n] > 0). Only the
// unfused search (ops.sdc_search(fused=False)) and the tests use it.
//
// What bounds it: the output. At Q = 64 it writes 4 * Q = 256 bytes per
// document against D + 4 bytes read, so the floor is HBM bytes, and
// mostly the writes. The design is sdc_topk.cu's scan without the top-k:
// each block holds a chunk of up to 64 queries in shared memory and walks
// one slice of the documents, one row per thread, loaded as 16-byte
// vectors into registers; every query's score of that row is written at
// once, so a warp's 32 stores to a query row are one contiguous 128-byte
// line. Scoring is __dp4a on the CUDA cores (exact int32).

#include "sdc_common.cuh"

using namespace sdc;

namespace {

// Shared memory: query words [qc][QSTRIDE] int, qsum [qc] int.
template <int D, bool PACKED>
__global__ void __launch_bounds__(kThreads)
sdc_scores_kernel(const int* __restrict__ qa, const int* __restrict__ qb,
                  const uint8_t* __restrict__ docs, const float* __restrict__ inv,
                  float* __restrict__ out, int Q, int N, int qc, int slice_docs, float c1,
                  float c2, float c3) {
  using R = Row<D, PACKED>;
  extern __shared__ __align__(16) u64 smem[];
  int* qs = reinterpret_cast<int*>(smem);
  int* qsum = qs + qc * R::QSTRIDE;
  const int q0 = blockIdx.y * qc;
  const int nq = min(qc, Q - q0);
  load_queries<D, PACKED>(qs, qsum, qa, qb, nq, [&](int j) { return q0 + j; });

  const long long begin = (long long)blockIdx.x * slice_docs;
  const long long end = min((long long)N, begin + slice_docs);
  for (long long n = begin + threadIdx.x; n < end; n += kThreads) {
    const float w_inv = inv[n];
    const bool valid = w_inv > 0.f;
    unsigned a[R::RW];
    unsigned b[R::BW];
    int sd = 0;
    if (valid) {
      load_row(docs + n * R::ROW_BYTES, a);
      sd = unpack_row<PACKED>(a, b);
    }
    for (int qq = 0; qq < nq; ++qq) {
      const float s = valid ? epilogue(row_dot<PACKED>(a, b, qs + qq * R::QSTRIDE), qsum[qq] + sd,
                                       w_inv, c1, c2, c3)
                            : kNegInf;
      out[(size_t)(q0 + qq) * N + n] = s;
    }
  }
}

typedef void (*ScoresFn)(const int*, const int*, const uint8_t*, const float*, float*, int, int,
                         int, int, float, float, float);

template <bool PACKED>
ScoresFn pick(int D) {
  switch (D) {
    case 32: return sdc_scores_kernel<32, PACKED>;
    case 64: return sdc_scores_kernel<64, PACKED>;
    case 128: return sdc_scores_kernel<128, PACKED>;
    case 256: return sdc_scores_kernel<256, PACKED>;
    default: return nullptr;
  }
}

size_t scores_smem(int D, int qc) { return (size_t)qc * (D / 4) * sizeof(int) + (size_t)qc * sizeof(int); }

}  // namespace

extern "C" {

// Blocks that fit on one SM at once, or a negative CUDA error code.
int sdc_scores_blocks_per_sm(int D, int packed, int qc) {
  ScoresFn fn = packed ? pick<true>(D) : pick<false>(D);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  return blocks_per_sm((const void*)fn, scores_smem(D, qc));
}

// Launches n_slices x ceil(Q / qc) blocks on `stream`. Returns
// cudaGetLastError() (0 on success).
int sdc_scores_launch(const void* qa, const void* qb, const void* docs, const void* inv,
                      void* out, int Q, int N, int D, int packed, int qc, int n_slices,
                      int slice_docs, float c1, float c2, float c3, void* stream) {
  ScoresFn fn = packed ? pick<true>(D) : pick<false>(D);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = scores_smem(D, qc);
  cudaError_t err = cudaFuncSetAttribute((const void*)fn,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_slices, (Q + qc - 1) / qc);
  fn<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)qa, (const int*)qb, (const uint8_t*)docs, (const float*)inv, (float*)out, Q, N,
      qc, slice_docs, c1, c2, c3);
  return (int)cudaGetLastError();
}

const char* sdc_scores_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
