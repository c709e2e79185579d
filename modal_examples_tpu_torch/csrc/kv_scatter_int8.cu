// KV page scatter into an int8 cache for Hopper (sm_90a): quantize every
// layer's new K/V rows per (token, kv head) and write the int8 rows and their
// f32 scales into the paged cache, in place.
//
// Replaces the int8 branch of modal_examples_tpu/ops/paged_attention.py::
// _kv_scatter_kernel (entry scatter_kv_pages with QuantizedKV pages), which
// DMA'd four arrays (int8 K/V columns and their f32 scale columns, :1052-1056)
// after XLA had quantized the rows outside the pallas_call (:1011-1012).
// Here the quantization is fused into the scatter; the function is the same:
// for each (layer, token, kv head) row of D values, amax over D in f32,
// scale = amax / 127 (1 for an all-zero row), data = rint(x / scale) clipped
// to +-127. Both divisions are IEEE (no fast math) and rintf rounds half to
// even, so the result is bitwise that of the plain version.
//
// Bound: bytes. The function reads each bf16 row once and writes it once as
// int8 plus one f32 scale per head; the arithmetic (one division per
// element) is far below the card's rate. The design gives each (token,
// array, layer) its own block, as kv_scatter.cu does, so a decode step's few
// tokens still spread over many SMs; one warp takes one head at a time, each
// lane 4 consecutive values (8-byte loads, 4-byte stores), and the amax is a
// warp reduction. Dead or padded tokens all target page 0, slot 0: those
// writes race, which is harmless because page 0 is never attended.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAXD = 256;  // largest head dim a warp holds in registers (4 values a lane, 2 passes)

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__global__ void __launch_bounds__(THREADS) kv_scatter_int8_kernel(
    int8_t* __restrict__ k_pages,               // [L, P, ps, Hkv, D]
    int8_t* __restrict__ v_pages,
    float* __restrict__ k_scales,               // [L, P, ps, Hkv]
    float* __restrict__ v_scales,
    const __nv_bfloat16* __restrict__ k_new,    // [L, N, Hkv, D]
    const __nv_bfloat16* __restrict__ v_new,
    const int* __restrict__ page_idx,           // [N]
    const int* __restrict__ slot,               // [N]
    int N, int P, int ps, int Hkv, int D) {
  const int n = blockIdx.x;
  const int layer = blockIdx.z;
  const bool is_v = blockIdx.y == 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t src_row = ((size_t)layer * N + n) * Hkv;
  const size_t dst_row = (((size_t)layer * P + page_idx[n]) * ps + slot[n]) * Hkv;
  const __nv_bfloat16* src = is_v ? v_new : k_new;
  int8_t* data = is_v ? v_pages : k_pages;
  float* scales = is_v ? v_scales : k_scales;

  for (int h = warp; h < Hkv; h += WARPS) {
    const __nv_bfloat16* x = src + (src_row + h) * D;
    float v[MAXD / 32];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < MAXD / 128; ++j) {
      const int d = 4 * lane + 128 * j;
      if (d < D) {
        const uint2 raw = *reinterpret_cast<const uint2*>(x + d);  // 4 bf16, lowest first
        v[4 * j] = __uint_as_float(raw.x << 16);  // bf16 -> f32 is exact: the bits, shifted
        v[4 * j + 1] = __uint_as_float(raw.x & 0xffff0000u);
        v[4 * j + 2] = __uint_as_float(raw.y << 16);
        v[4 * j + 3] = __uint_as_float(raw.y & 0xffff0000u);
#pragma unroll
        for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(v[4 * j + e]));
      }
    }
    amax = warp_max(amax);
    const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    int8_t* q = data + (dst_row + h) * D;
#pragma unroll
    for (int j = 0; j < MAXD / 128; ++j) {
      const int d = 4 * lane + 128 * j;
      if (d < D) {
        char4 c;
        c.x = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v[4 * j], scale)), -127.f), 127.f);
        c.y = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v[4 * j + 1], scale)), -127.f), 127.f);
        c.z = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v[4 * j + 2], scale)), -127.f), 127.f);
        c.w = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v[4 * j + 3], scale)), -127.f), 127.f);
        *reinterpret_cast<char4*>(q + d) = c;
      }
    }
    if (lane == 0) scales[dst_row + h] = scale;
  }
}

}  // namespace

extern "C" int kv_scatter_int8(void* k_pages, void* v_pages, void* k_scales, void* v_scales,
                               const void* k_new, const void* v_new, const void* page_idx,
                               const void* slot, int L, int N, int P, int ps, int Hkv, int D,
                               void* stream) {
  if (D > MAXD || D % 4 != 0 || L > 65535 || Hkv <= 0) return (int)cudaErrorInvalidValue;
  if (N == 0 || L == 0) return (int)cudaSuccess;
  dim3 grid(N, 2, L);
  kv_scatter_int8_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (int8_t*)k_pages, (int8_t*)v_pages, (float*)k_scales, (float*)v_scales,
      (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, (const int*)page_idx,
      (const int*)slot, N, P, ps, Hkv, D);
  return (int)cudaGetLastError();
}

extern "C" const char* kv_scatter_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
