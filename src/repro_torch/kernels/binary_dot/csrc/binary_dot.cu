// Bitwise recurrent-binary dot (xor + popcount) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/binary_dot/kernel.py::binary_dot
// (_binary_dot_kernel): for query bit planes x_s and document bit planes
// y_t, packed 32 dims to a word (bit j of word w = dim 32w + j),
//
//   score[q, n] = sum_{s,t < NL} 2^-(s+t) * (M - 2 * popc(x_s ^ y_t)),  M = 32 W.
//
// This is the paper's baseline (the GPU scheme of Shan et al.), kept as the
// scheme it is: every one of the NL^2 plane pairs is a separate Hamming
// distance, so its cost grows as NL^2, which is what the paper's Table 5
// measures against SDC. It is not rewritten as the equal code product.
//
// Exactness: each (s, t) Hamming sum is an int32; the kernel adds
// (M - 2h) * 2^(2(NL-1) - s - t) into one int32, whose magnitude is at most
// M (2^NL - 1)^2 < 2^24 for the instantiated shapes, and scales it once by
// 2^-(2(NL-1)). Both steps are exact in float32, so the result equals the
// reference's in any summation order.
//
// What bounds it: popcounts. At Q = 64, NL = 4, W = 4 it does 64 __popc per
// (query, document), 4.1e10 at ten million documents, against 64 bytes of
// planes read and 256 bytes of scores written per document; the CUDA
// cores' popc rate (16 per SM per clock on compute capability 9.0) sets the
// floor well above the HBM time. The design keeps that work on the CUDA
// cores and everything else out of its way: all of a chunk of up to 64
// queries' planes sit in shared memory (64 x 4 x 4 words = 4 KB at the
// serving shapes), each thread holds one document's NL * W words in
// registers (16-byte loads where the row allows) and writes that
// document's column of scores, so a warp's stores to one query row are one
// contiguous 128-byte line. The grid is one full wave of blocks striding
// over the documents; the ragged edge of N is masked here, nothing is
// padded.
//
// At NL = 4 this runs within a few % of the popcount bound (10.1 ms against
// 9.8 ms at Q = 64, N = 10,000,037, m = 128, on an H100 SXM at 700 W). At
// NL = 1 and 2 something else is the floor: about 2.5 ms, where writing the
// 2.56 GB of scores alone takes 0.8 ms. A warp's stores of one round go to
// 64 rows N * 4 bytes apart; giving each block a contiguous slice of the
// documents instead of the grid stride did not help.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int NL, int W>
__global__ void __launch_bounds__(kThreads)
binary_dot_kernel(const unsigned* __restrict__ q,  // [Q, NL, W] words
                  const unsigned* __restrict__ d,  // [N, NL, W] words
                  float* __restrict__ out,         // [Q, N]
                  int Q, int N, int qc, float scale) {
  constexpr int WORDS = NL * W;
  constexpr int M = 32 * W;
  extern __shared__ __align__(16) unsigned qs[];  // [qc][WORDS]
  const int q0 = blockIdx.y * qc;
  const int nq = min(qc, Q - q0);
  for (int i = threadIdx.x; i < nq * WORDS; i += kThreads) qs[i] = q[(size_t)q0 * WORDS + i];
  __syncthreads();

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long n = (long long)blockIdx.x * kThreads + threadIdx.x; n < N; n += stride) {
    unsigned x[WORDS];
    const unsigned* row = d + n * WORDS;
    if constexpr (WORDS % 4 == 0) {
      const uint4* r4 = reinterpret_cast<const uint4*>(row);
#pragma unroll
      for (int v = 0; v < WORDS / 4; ++v) {
        const uint4 t = __ldg(r4 + v);
        x[4 * v] = t.x;
        x[4 * v + 1] = t.y;
        x[4 * v + 2] = t.z;
        x[4 * v + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; ++i) x[i] = __ldg(row + i);
    }
    for (int qq = 0; qq < nq; ++qq) {
      const unsigned* y = qs + qq * WORDS;
      int acc = 0;
#pragma unroll
      for (int s = 0; s < NL; ++s) {
        unsigned ys[W];
#pragma unroll
        for (int w = 0; w < W; ++w) ys[w] = y[s * W + w];
#pragma unroll
        for (int t = 0; t < NL; ++t) {
          int h = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) h += __popc(ys[w] ^ x[t * W + w]);
          acc += (M - 2 * h) * (1 << (2 * (NL - 1) - s - t));
        }
      }
      out[(size_t)(q0 + qq) * N + n] = __fmul_rn(__int2float_rn(acc), scale);
    }
  }
}

typedef void (*BinaryDotFn)(const unsigned*, const unsigned*, float*, int, int, int, float);

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

size_t smem_bytes(int n_levels, int W, int qc) { return (size_t)qc * n_levels * W * sizeof(unsigned); }

}  // namespace

extern "C" {

// Blocks of the (n_levels, W) kernel that fit on one SM at once, or a
// negative CUDA error code.
int binary_dot_blocks_per_sm(int n_levels, int W, int qc) {
  BinaryDotFn fn = pick(n_levels, W);
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)fn, kThreads,
                                                                  smem_bytes(n_levels, W, qc));
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}

// Launches n_blocks x ceil(Q / qc) blocks on `stream`. Returns
// cudaGetLastError() (0 on success).
int binary_dot_launch(const void* q, const void* d, void* out, int Q, int N, int n_levels, int W,
                      int qc, int n_blocks, float scale, void* stream) {
  BinaryDotFn fn = pick(n_levels, W);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid(n_blocks, (Q + qc - 1) / qc);
  fn<<<grid, kThreads, smem_bytes(n_levels, W, qc), (cudaStream_t)stream>>>(
      (const unsigned*)q, (const unsigned*)d, (float*)out, Q, N, qc, scale);
  return (int)cudaGetLastError();
}

const char* binary_dot_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
