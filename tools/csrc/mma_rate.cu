// Tensor-core issue rates of the warp-level products binary_dot can use
// on Hopper (sm_90a), and a check of the b1 fragment layout: the products
// of sdc/csrc/tile_mma.cuh (mma_b1, mma_s8), as the kernels issue them.
//
// Every warp of the rate kernels runs `iters` rounds of kChains independent
// mma.sync products on registers (no memory traffic), so the time of a
// launch over many blocks is the SM's issue rate for that instruction:
//
//   b1_k128  mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc
//   b1_k256  mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//   s8_k32   mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
//
// The layout kernel computes one m16n8 tile of the b1 product from a
// [16][K/32] word A and an [8][K/32] word B in global memory, each lane
// taking word t (and 4 + t at k256) of row g, g + 8 and column g, and
// writes the [16][8] int32 tile, which tools/mma_rate.py holds against
// popcounts computed on the host.

#include "tile_mma.cuh"

namespace {

using sdc::mma_b1;
using sdc::mma_s8;

constexpr int kChains = 8;

// kind 0: b1_k128, 1: b1_k256, 2: s8_k32
template <int KIND>
__global__ void rate_kernel(int iters, unsigned seed, int* out) {
  const unsigned x = seed * 2654435761u + threadIdx.x;
  unsigned a[4] = {x, x * 3u, x * 5u, x * 7u};
  unsigned b[kChains][2];
  int c[kChains][4];
#pragma unroll
  for (int j = 0; j < kChains; ++j) {
    b[j][0] = x ^ (0x9E3779B9u * (j + 1));
    b[j][1] = x + j;
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if constexpr (KIND == 0) {
        const unsigned a2[2] = {a[0], a[1]};
        const unsigned b1[1] = {b[j][0]};
        mma_b1<1>(c[j], a2, b1);
      } else if constexpr (KIND == 1) {
        mma_b1<2>(c[j], a, b[j]);
      } else {
        mma_s8(c[j], a, b[j]);
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// One m16n8 tile of popc(A row AND B column) at K = 32 * words (128 or 256).
__global__ void layout_kernel(const unsigned* A, const unsigned* B, int words, int* C) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int c[4] = {0, 0, 0, 0};
  if (words == 4) {
    const unsigned a[2] = {A[g * 4 + t], A[(g + 8) * 4 + t]};
    const unsigned b[1] = {B[g * 4 + t]};
    mma_b1<1>(c, a, b);
  } else {
    const unsigned a[4] = {A[g * 8 + t], A[(g + 8) * 8 + t], A[g * 8 + 4 + t],
                           A[(g + 8) * 8 + 4 + t]};
    const unsigned b[2] = {B[g * 8 + t], B[g * 8 + 4 + t]};
    mma_b1<2>(c, a, b);
  }
  C[g * 8 + 2 * t] = c[0];
  C[g * 8 + 2 * t + 1] = c[1];
  C[(g + 8) * 8 + 2 * t] = c[2];
  C[(g + 8) * 8 + 2 * t + 1] = c[3];
}

}  // namespace

extern "C" {

// Launches `blocks` x `threads` of rate kernel `kind`; each warp issues
// iters * kChains products. Returns cudaGetLastError().
int mma_rate_launch(int kind, int blocks, int threads, int iters, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0: rate_kernel<0><<<blocks, threads, 0, s>>>(iters, 1u, (int*)out); break;
    case 1: rate_kernel<1><<<blocks, threads, 0, s>>>(iters, 1u, (int*)out); break;
    case 2: rate_kernel<2><<<blocks, threads, 0, s>>>(iters, 1u, (int*)out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int mma_rate_chains() { return kChains; }

int mma_layout_launch(const void* A, const void* B, int words, void* C, void* stream) {
  if (words != 4 && words != 8) return (int)cudaErrorInvalidValue;
  layout_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const unsigned*)A, (const unsigned*)B, words,
                                                    (int*)C);
  return (int)cudaGetLastError();
}

}  // extern "C"
