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
// dot_interact_torch, which does the same on whole [B, P] tensors. That
// rules out the tensor cores (TF32) and any split of d; the CUDA cores
// suffice, the bytes being the bound.
//
// What bounds it: bytes. At dlrm-rm2's F = 27, D = 64 an example is 6,912
// bytes in and 1,404 bytes out against 351 * 64 multiply-adds. A thread
// per pair would pay two 32-bit shared-memory loads per pair and d, and
// the SM's one load a clock, not HBM, would bound it. So:
//
//  - Persistent blocks, three to an SM at F = 27, D = 64, walk the batch
//    in stages of E examples (8 where shared memory allows). A stage's rows
//    are copied with cp.async (16 bytes at a time where D is a multiple of
//    4) into rows padded with zeros to Dp = D rounded up to 4 and examples
//    padded with zero rows to 4R = F rounded up to 4 (R row blocks); while
//    one block waits for its copies, the others on its SM compute. (Two
//    stage buffers in one block, the next stage copied while this one is
//    computed, leave room for one block an SM, whose 8 warps cannot hide
//    the latency of the products: it measured slower.)
//  - The triangle is cut into 4 x 4 tiles of pairs: R (R - 1) / 2 below the
//    diagonal (rows 4I..4I+3 against columns 4J..4J+3, J < I) and R on it
//    (its 6 pairs i > j). A lane holds one tile of one example in
//    registers and reads d four at a time: 8 16-byte loads feed 64
//    multiply-adds (4 and 24 on the diagonal), a sixteenth of the loads of
//    a thread per pair. Zero padding adds +0 products, which leave a sum
//    unchanged.
//  - Lane l takes example l % E of the stage and tile l / E of its warp's
//    group, so the 8 lanes of a 16-byte load phase read one row of 8
//    examples; an example's stride is an odd number of 16-byte units, so
//    they fall in distinct banks. Tiles below the diagonal come first in
//    the tile order and the diagonal ones last, so few warps mix the two.
//  - Results go to a shared [E][P] tile, the stage's span of the output,
//    which the block then writes with coalesced 16-byte stores (a span
//    starts at example 8s, so at a multiple of 16 bytes). The ragged edge
//    of B is masked: examples past B are neither loaded nor written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Floats of one example in shared memory: 4R rows of Dp floats, rounded to
// an odd number of 16-byte units.
__host__ __device__ inline int example_stride(int F, int D) {
  return 4 * (((round4(F) * round4(D)) / 4) | 1);
}

// Dynamic shared memory: a stage of E examples, then the [E][P] output tile.
__host__ __device__ inline size_t smem_bytes(int F, int D, int E) {
  const int P = F * (F - 1) / 2;
  return ((size_t)E * example_stride(F, D) + (size_t)round4(E * P)) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float mac(float acc, float x, float y) {
  return __fadd_rn(acc, __fmul_rn(x, y));
}

// acc[r][c] += rows a[r] . rows b[c] over Dp floats, d ascending. a and b
// point at the first of 4 rows, Dp floats apart.
__device__ __forceinline__ void tile_below(const float* a, const float* b, int Dp,
                                           float (&acc)[4][4]) {
  for (int d = 0; d < Dp; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x[r] = *reinterpret_cast<const float4*>(a + r * Dp + d);
      y[r] = *reinterpret_cast<const float4*>(b + r * Dp + d);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = mac(acc[r][c], x[r].x, y[c].x);
        acc[r][c] = mac(acc[r][c], x[r].y, y[c].y);
        acc[r][c] = mac(acc[r][c], x[r].z, y[c].z);
        acc[r][c] = mac(acc[r][c], x[r].w, y[c].w);
      }
    }
  }
}

// The 6 pairs r > c of 4 rows: acc[r][c] for c < r.
__device__ __forceinline__ void tile_diagonal(const float* a, int Dp, float (&acc)[4][4]) {
  for (int d = 0; d < Dp; d += 4) {
    float4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = *reinterpret_cast<const float4*>(a + r * Dp + d);
#pragma unroll
    for (int r = 1; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < r; ++c) {
        acc[r][c] = mac(acc[r][c], x[r].x, x[c].x);
        acc[r][c] = mac(acc[r][c], x[r].y, x[c].y);
        acc[r][c] = mac(acc[r][c], x[r].z, x[c].z);
        acc[r][c] = mac(acc[r][c], x[r].w, x[c].w);
      }
    }
  }
}

// At most 64 registers (4 blocks an SM by registers; shared memory allows
// 3 at F = 27, D = 64): measured faster than the compiler's own choice.
__global__ void __launch_bounds__(kThreads, 4)
dot_interact_kernel(const float* __restrict__ emb,  // [B, F, D]
                    float* __restrict__ out,        // [B, P]
                    int B, int F, int D, int E, int vec) {
  extern __shared__ __align__(16) float xs[];  // [E][ES], then [E * P]
  const int P = F * (F - 1) / 2;
  const int Dp = round4(D), R = round4(F) / 4, ES = example_stride(F, D);
  const int n_below = R * (R - 1) / 2, n_tiles = n_below + R;
  const int per_warp = 32 / E;  // tiles a warp takes at once; E divides 32
  // Tile groups of per_warp tiles: the tiles below the diagonal, then the
  // diagonal ones, never both in one group (they take different code).
  const int below_groups = (n_below + per_warp - 1) / per_warp;
  const int n_groups = below_groups + (R + per_warp - 1) / per_warp;
  float* otile = xs + (size_t)E * ES;
  const long long n_stages = ((long long)B + E - 1) / E;

  // Zero everything once: the padding (columns past D, rows past F) is
  // never written again, and +0 products leave a sum unchanged.
  for (int i = threadIdx.x; i < E * ES; i += kThreads) xs[i] = 0.f;
  __syncthreads();

  // Start copying the rows of stage s. With D a multiple of 4, Dp = D and
  // an example's rows are contiguous in shared memory too.
  auto load = [&](long long s) {
    const long long b0 = s * E;
    const int nb = (int)min((long long)E, (long long)B - b0);
    for (int e = 0; e < nb; ++e) {
      float* dst = xs + e * ES;
      const float* src = emb + (b0 + e) * F * D;
      if (vec) {
        for (int c = threadIdx.x; c < F * D / 4; c += kThreads) cp_async16(dst + 4 * c, src + 4 * c);
      } else {
        for (int i = threadIdx.x; i < F * D; i += kThreads) {
          const int f = i / D;
          cp_async4(dst + f * Dp + (i - f * D), src + i);
        }
      }
    }
  };

  // This lane's example and the tiles of its warp.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int e = lane % E, tw = lane / E;

  for (long long s = blockIdx.x; s < n_stages; s += gridDim.x) {
    // The previous stage's rows were last read before its second barrier.
    load(s);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the stage's rows are in shared memory, the output tile free

    const long long b0 = s * E;
    const int nb = (int)min((long long)E, (long long)B - b0);
    const float* ex = xs + e * ES;
    for (int g = warp; g < n_groups; g += kWarps) {
      const int tile = g < below_groups ? g * per_warp + tw
                                        : n_below + (g - below_groups) * per_warp + tw;
      if (tile >= (g < below_groups ? n_below : n_tiles)) continue;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      int I, J;
      if (tile < n_below) {  // tile = I (I - 1) / 2 + J, J < I
        I = 1;
        while ((I + 1) * I / 2 <= tile) ++I;
        J = tile - I * (I - 1) / 2;
        tile_below(ex + 4 * I * Dp, ex + 4 * J * Dp, Dp, acc);
      } else {
        I = J = tile - n_below;
        tile_diagonal(ex + 4 * I * Dp, Dp, acc);
      }
      if (e < nb) {
        float* o = otile + e * P;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * I + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = 4 * J + c;
            if (i < F && j < i) o[i * (i - 1) / 2 + j] = acc[r][c];
          }
        }
      }
    }
    __syncthreads();  // the output tile is written, the stage's rows free

    // The stage's span out[b0 * P, (b0 + nb) * P): 16 bytes at a time where
    // it starts on 16 bytes (always for E = 4 or 8).
    float* dst = out + b0 * P;
    const int n = nb * P, n4 = (b0 * P) % 4 ? 0 : n / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(otile)[i];
    for (int i = 4 * n4 + threadIdx.x; i < n; i += kThreads) dst[i] = otile[i];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of a block with E examples a stage.
size_t dot_interact_smem(int F, int D, int E) { return smem_bytes(F, D, E); }

// Blocks of the kernel that fit on one SM at once, or a negative CUDA error
// code.
int dot_interact_blocks_per_sm(int F, int D, int E) {
  const size_t smem = smem_bytes(F, D, E);
  cudaError_t err = cudaFuncSetAttribute((const void*)dot_interact_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dot_interact_kernel, kThreads,
                                                      smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Launches `grid` persistent blocks on `stream`: E (1, 2, 4 or 8) examples a
// stage, vec whether rows are copied 16 bytes at a time (D % 4 == 0 and emb
// 16-byte aligned). out must be 16-byte aligned. Returns cudaGetLastError()
// (0 on success).
int dot_interact_launch(const void* emb, void* out, int B, int F, int D, int E, int vec,
                        int grid, void* stream) {
  if (E < 1 || E > 8 || 32 % E || grid < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(F, D, E);
  cudaError_t err = cudaFuncSetAttribute((const void*)dot_interact_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dot_interact_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)emb, (float*)out, B, F, D, E, vec);
  return (int)cudaGetLastError();
}

const char* dot_interact_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
