// Shared pieces of the SIMT f32 flash kernel flash_bwd_dq_f32.cu: the f32
// instance of the dQ kernel, for models whose attention runs in f32 (the
// reference's Pallas bodies upcast to f32 and write the input's dtype, so
// an f32 model's attention is f32 throughout). The f32 forward and dK/dV
// run on the tensor cores by a 3xTF32 split instead (flash_tf32.cuh).
//
// Design: plain SIMT f32 arithmetic with fmaf on the CUDA cores, never one
// TF32 pass or bf16 staging (TF32 alone would round the inputs to a 10-bit
// mantissa, which the reference's f32 body does not). A block owns ROWS
// "own" rows of one (batch, head) plane: WARPS warps of R rows each. It
// walks the other side's rows in tiles of TILE = 32 rows staged in shared
// memory, one lane per tile row: each lane computes its row's dot products
// against the warp's R own rows (the own rows in shared memory, read as
// broadcasts; the tile rows padded to D + 1 floats so the 32 lanes read 32
// banks). The product that sums over the tile (dS.K) broadcasts each
// lane's value with a shuffle while every lane accumulates D / 32 output
// columns in registers. The order of every sum is fixed, so a launch is
// bitwise repeatable.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace flash_f32 {

constexpr int WARPS = 4;
constexpr int R = 8;                // own rows per warp
constexpr int ROWS = WARPS * R;     // own rows per block
constexpr int TILE = 32;            // rows of the other side per tile: one a lane
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// rows [row0, row0 + n) of a [rows_total, D] f32 plane into shared memory
// with row stride `stride`; rows past rows_total read as zeros
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, int stride, const float* __restrict__ src, int row0, int n,
                                           int rows_total) {
  for (int idx = threadIdx.x; idx < n * D; idx += THREADS) {
    const int r = idx / D, d = idx % D, row = row0 + r;
    dst[r * stride + d] = row < rows_total ? src[(size_t)row * D + d] : 0.f;
  }
}

// dynamic shared memory of the kernel: two [ROWS, D] own-row arrays and two
// [TILE, D + 1] tile arrays
template <int D>
constexpr size_t smem_bytes(int own_arrays) {
  return sizeof(float) * ((size_t)own_arrays * ROWS * D + 2 * TILE * (D + 1));
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace flash_f32
