// DLRM dot interaction for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dot_interact/kernel.py::dot_interact
// (_dot_interact_kernel): for each example b of emb [B, F, D] f32, the
// strictly lower triangle of its Gram matrix E E^T,
//
//   out[b, p] = sum_d emb[b, i, d] * emb[b, j, d],   (i, j) = pair p,
//
// with the pairs in np.tril_indices(F, -1) order (row i ascending, then
// column j < i ascending, p = i (i - 1) / 2 + j). As on the TPU, the
// [B, F, F] Gram tensor never reaches device memory: the kernel computes
// the triangle in its own body and writes only the P = F (F - 1) / 2
// outputs of each example.
//
// Exactness: each output is summed over d in index order, one product and
// one add at a time, rounded to nearest (__fmul_rn, __fadd_rn; the file is
// built -fmad=false), so it has the same bits as the plain version
// dot_interact_torch, which does the same on whole [B, P] tensors.
//
// What bounds it: bytes. At dlrm-rm2's F = 27, D = 64 an example is 6,912
// bytes in and 1,404 bytes out against 351 * 64 multiply-adds, far below
// the card's float32 ridge. The design reads each example once: a block
// takes kExamples consecutive examples, loads their rows into shared
// memory (warp per row, coalesced), and gives each thread one pair p, which
// it computes for all of the block's examples at once (kExamples
// independent sums). Rows are stored with an odd stride, so the threads of
// a warp, which read rows i and j of the same d, hit distinct banks or the
// same word. A thread writes out[b, p] for each example, so a warp's
// stores are consecutive. The ragged edge of B is masked here: rows past
// B are zero in shared memory and their outputs are not written.
//
// This first version pays two 32-bit shared-memory loads per pair and d
// (about 1,400 warp-wide loads per example), and the SM serves one a
// clock; by that count shared memory, not HBM, is its limit. It takes
// 1.88 ms at B = 262,144 against the 0.65 ms bytes bound, on an H100 SXM
// at 700 W. Register tiles of the Gram matrix, which reuse each loaded
// row across several pairs, are the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kExamples = 4;  // examples per block

__global__ void dot_interact_kernel(const float* __restrict__ emb,  // [B, F, D]
                                    float* __restrict__ out,        // [B, P]
                                    int B, int F, int D, int S) {
  extern __shared__ float xs[];  // [kExamples][F][S]
  const int P = F * (F - 1) / 2;
  const long long b0 = (long long)blockIdx.x * kExamples;
  const int nb = (int)min((long long)kExamples, (long long)B - b0);
  const float* src = emb + b0 * F * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int r = warp; r < kExamples * F; r += n_warps) {
    const bool live = r < nb * F;
    for (int d = lane; d < D; d += 32) xs[r * S + d] = live ? src[(long long)r * D + d] : 0.f;
  }
  __syncthreads();

  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    int i = 1;
    while ((i + 1) * i / 2 <= p) ++i;
    const int j = p - i * (i - 1) / 2;
    float acc[kExamples];
#pragma unroll
    for (int e = 0; e < kExamples; ++e) acc[e] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int e = 0; e < kExamples; ++e) {
        const float* x = xs + e * F * S;
        acc[e] = __fadd_rn(acc[e], __fmul_rn(x[i * S + d], x[j * S + d]));
      }
    }
#pragma unroll
    for (int e = 0; e < kExamples; ++e)
      if (e < nb) out[(b0 + e) * P + p] = acc[e];
  }
}

// Row stride in shared memory: odd, so rows i and j of one d fall in
// different banks.
int row_stride(int D) { return D | 1; }

size_t smem_bytes(int F, int D) { return (size_t)kExamples * F * row_stride(D) * sizeof(float); }

}  // namespace

extern "C" {

size_t dot_interact_smem(int F, int D) { return smem_bytes(F, D); }

// Launches ceil(B / kExamples) blocks of `threads` threads (a multiple of
// 32, at most 1024) on `stream`. Returns cudaGetLastError() (0 on success).
int dot_interact_launch(const void* emb, void* out, int B, int F, int D, int threads,
                        void* stream) {
  const size_t smem = smem_bytes(F, D);
  cudaError_t err = cudaFuncSetAttribute((const void*)dot_interact_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)B + kExamples - 1) / kExamples;
  dot_interact_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float*)emb, (float*)out, B, F, D, row_stride(D));
  return (int)cudaGetLastError();
}

const char* dot_interact_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
