// Int8-weight matmul for Hopper (sm_90a):
//   out[m, n] = scale[n] * sum_k bf16(x[m, k]) * bf16(q[k, n])   (f32 sum, f32 out)
//
// Replaces modal_examples_tpu/ops/quantized_matmul.py::_qmm_kernel (entry
// quantized_matmul): int8 W [K, N] times a bf16 activation x [M, K], f32
// accumulation over K tiles, the per-output-channel scale applied once after
// the whole sum. The TPU kernel carried the sum in VMEM scratch across a
// sequential K grid axis and fell back to XLA for shapes that do not tile;
// here each block loops over its K range itself and masks the ragged edge of
// every dimension, so every shape runs on the kernel.
//
// Bound: at decode (M = 8 slots) the int8 weight stream (e.g. 45 MB for
// 4096 x 11008, 0.0136 ms at 3.35 TB/s); at prefill (M = 2048) operations
// (185 GFLOP for the same weight, 0.187 ms at 989 TFLOP/s bf16). The design:
// - int8 -> bf16 on the way into shared memory (exact: |q| <= 127 fits
//   bf16's 8-bit significand), then bf16 tensor-core products
//   (mma.sync m16n8k16, f32 accumulators in registers; ldmatrix feeds the
//   fragments, .trans for the [k][n] weight tile). Products are exact, so
//   only the f32 summation order differs from the plain version.
// - Weights load 16 bytes a thread, neighbouring threads on neighbouring n;
//   the next K tile's loads start before the current tile's products
//   (register prefetch into a second shared-memory buffer, one barrier per
//   tile).
// - Two tile shapes: 16 x 128 rows x columns for small M (decode), 128 x 128
//   for large M (prefill). At decode one block per output tile would give
//   32-250 blocks, about one wave on 132 SMs, too few loads in flight to
//   stream the weights at HBM rate; so K is split across blocks (the
//   launcher picks the split for several blocks per SM), each split writes f32
//   partials, and a second pass sums them in a fixed order and applies the
//   scale: the result does not change from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int WARPS_M_, int WARPS_N_, int WM_TILES_, int WN_TILES_, int BK_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int WM_TILES = WM_TILES_, WN_TILES = WN_TILES_;  // 16-row / 8-column mma tiles a warp
  static constexpr int BM = WARPS_M * WM_TILES * 16;
  static constexpr int BN = WARPS_N * WN_TILES * 8;
  static constexpr int BK = BK_;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int A_STRIDE = BK + 8;  // bf16 per shared row of x: +16 bytes, so ldmatrix rows hit distinct banks
  static constexpr int B_STRIDE = BN + 8;  // bf16 per shared row of w
  static constexpr int A_LOADS = BM * BK / 8 / THREADS;   // 16-byte chunks of x a thread loads per tile
  static constexpr int B_LOADS = BK * BN / 16 / THREADS;  // 16-byte chunks of int8 w a thread loads per tile
  static_assert(BM * BK / 8 % THREADS == 0 && BK * BN / 16 % THREADS == 0, "loads must divide evenly");
  static_assert(WN_TILES % 2 == 0 && BK % 16 == 0, "ldmatrix.x4 covers two n tiles and one k16 step");
};

using Small = Cfg<1, 4, 1, 4, 64, 4>;  // 16 x 128 tile, 128 threads: decode (M <= 64)
using Large = Cfg<2, 4, 4, 4, 32, 2>;  // 128 x 128 tile, 256 threads: prefill

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 int8 weights (the bytes of v, lowest first) -> 16 bf16 at dst (32 bytes,
// 16-byte aligned); shifts, not a byte view, so v stays in registers
__device__ __forceinline__ void int8x16_to_bf16(const uint4& v, __nv_bfloat16* dst) {
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
  uint32_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t word = in[e / 2], shift = 16 * (e % 2);
    const float lo = (float)(int8_t)(word >> shift), hi = (float)(int8_t)(word >> (shift + 8));
    h[e] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(h[0], h[1], h[2], h[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

// Block (blockIdx.x, blockIdx.y) owns output tile [m0, m0+BM) x [n0, n0+BN);
// blockIdx.z owns K range [z*chunk, min(K, (z+1)*chunk)). With one split it
// writes scale * sum into out; with several, its partial sum into part[z].
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS) qmm_kernel(
    const uint16_t* __restrict__ x,   // [M, K] bf16 bits
    const int8_t* __restrict__ w,     // [K, N]
    const float* __restrict__ scale,  // [N]
    float* __restrict__ out,          // [M, N]
    float* __restrict__ part,         // [splits, M, N] when gridDim.z > 1
    int M, int N, int K, int chunk, int x_vec, int w_vec) {
  __shared__ __align__(16) __nv_bfloat16 As[2][C::BM * C::A_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][C::BK * C::B_STRIDE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int k_begin = blockIdx.z * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + C::BK - 1) / C::BK : 0;

  uint4 a_reg[C::A_LOADS];
  uint4 b_reg[C::B_LOADS];

  // global -> registers for the tile at k0; out-of-range elements load as 0
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < C::A_LOADS; ++j) {
      const int idx = tid + j * C::THREADS;
      const int m = m0 + idx / (C::BK / 8), k = k0 + 8 * (idx % (C::BK / 8));
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m < M) {
        const uint16_t* src = x + (size_t)m * K + k;
        if (x_vec && k + 8 <= k_end) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {  // ragged K edge or unaligned rows: element by element
          uint32_t e[4] = {0, 0, 0, 0};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (k + i < k_end) e[i / 2] |= (uint32_t)src[i] << (16 * (i % 2));
          v = make_uint4(e[0], e[1], e[2], e[3]);
        }
      }
      a_reg[j] = v;
    }
#pragma unroll
    for (int j = 0; j < C::B_LOADS; ++j) {
      const int idx = tid + j * C::THREADS;
      const int k = k0 + idx / (C::BN / 16), n = n0 + 16 * (idx % (C::BN / 16));
      uint4 v = make_uint4(0, 0, 0, 0);
      if (k < k_end) {
        const int8_t* src = w + (size_t)k * N + n;
        if (w_vec && n + 16 <= N) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {  // ragged N edge or N % 16 != 0: byte by byte
          uint32_t e[4] = {0, 0, 0, 0};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (n + i < N) e[i / 4] |= (uint32_t)(uint8_t)src[i] << (8 * (i % 4));
          v = make_uint4(e[0], e[1], e[2], e[3]);
        }
      }
      b_reg[j] = v;
    }
  };

  // registers -> shared buffer, weights converted to bf16
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int j = 0; j < C::A_LOADS; ++j) {
      const int idx = tid + j * C::THREADS;
      *reinterpret_cast<uint4*>(&As[buf][(idx / (C::BK / 8)) * C::A_STRIDE + 8 * (idx % (C::BK / 8))]) = a_reg[j];
    }
#pragma unroll
    for (int j = 0; j < C::B_LOADS; ++j) {
      const int idx = tid + j * C::THREADS;
      int8x16_to_bf16(b_reg[j], &Bs[buf][(idx / (C::BN / 16)) * C::B_STRIDE + 16 * (idx % (C::BN / 16))]);
    }
  };

  float acc[C::WM_TILES][C::WN_TILES][4];
#pragma unroll
  for (int i = 0; i < C::WM_TILES; ++i)
#pragma unroll
    for (int j = 0; j < C::WN_TILES; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (n_tiles > 0) {
    load_tile(k_begin);
    store_tile(0);
  }
  __syncthreads();
  const int a_row = wm * C::WM_TILES * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = lane & 15, b_col = wn * C::WN_TILES * 8 + (lane >> 4) * 8;
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) load_tile(k_begin + (t + 1) * C::BK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      uint32_t a[C::WM_TILES][4];
#pragma unroll
      for (int i = 0; i < C::WM_TILES; ++i) ldsm_x4(a[i], &As[cur][(a_row + 16 * i) * C::A_STRIDE + kk + a_col]);
#pragma unroll
      for (int p = 0; p < C::WN_TILES / 2; ++p) {
        uint32_t b[4];  // b[0..1]: n tile 2p, b[2..3]: n tile 2p+1
        ldsm_x4_trans(b, &Bs[cur][(kk + b_row) * C::B_STRIDE + b_col + 16 * p]);
#pragma unroll
        for (int i = 0; i < C::WM_TILES; ++i) {
          mma_bf16(acc[i][2 * p], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (t + 1 < n_tiles) store_tile(cur ^ 1);
    __syncthreads();
  }

  // accumulator e of mma tile (i, j): row g (+8 for e >= 2), columns 2*tig, 2*tig+1
  const bool split = gridDim.z > 1;
  float* dst = split ? part + (size_t)blockIdx.z * M * N : out;
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < C::WM_TILES; ++i)
#pragma unroll
    for (int j = 0; j < C::WN_TILES; ++j) {
      const int n = n0 + wn * C::WN_TILES * 8 + 8 * j + 2 * tig;
      if (n >= N) continue;
      const float s0 = split ? 1.f : scale[n];
      const float s1 = split || n + 1 >= N ? 1.f : scale[n + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * C::WM_TILES * 16 + 16 * i + g + 8 * h;
        if (m >= M) continue;
        float* o = dst + (size_t)m * N + n;
        const float v0 = acc[i][j][2 * h] * s0, v1 = acc[i][j][2 * h + 1] * s1;
        if (n + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          o[0] = v0;
          if (n + 1 < N) o[1] = v1;
        }
      }
    }
}

// out = scale * (part[0] + part[1] + ... + part[splits-1]), summed in that order
__global__ void qmm_reduce_kernel(const float* __restrict__ part, const float* __restrict__ scale,
                                  float* __restrict__ out, int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn; i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * mn + i];
    out[i] = s * scale[i % N];
  }
}

constexpr int SMALL_M = 64;  // M up to this takes the Small tile (decode)

// K splits for tile C: split K until the grid has about C::MIN_BLOCKS blocks
// per SM, every split non-empty (ceil(k_tiles / chunk) == splits)
template <class C>
int splits_for(int M, int N, int K, int sms) {
  const long long tiles = (long long)((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
  const int k_tiles = (K + C::BK - 1) / C::BK;
  long long s = (long long)C::MIN_BLOCKS * sms / (tiles > 0 ? tiles : 1);
  if (s > k_tiles) s = k_tiles;
  int splits = s < 1 ? 1 : (int)s;
  if (k_tiles > 0) {
    const int chunk = (k_tiles + splits - 1) / splits;
    splits = (k_tiles + chunk - 1) / chunk;
  }
  return splits;
}

int plan_splits(int M, int N, int K, int sms) {
  return M <= SMALL_M ? splits_for<Small>(M, N, K, sms) : splits_for<Large>(M, N, K, sms);
}

template <class C>
int launch(const void* x, const void* w, const void* scale, void* out, void* part, int M, int N, int K,
           int sms, cudaStream_t stream) {
  const int splits = splits_for<C>(M, N, K, sms);
  const int k_tiles = (K + C::BK - 1) / C::BK;
  const int chunk_tiles = k_tiles > 0 ? (k_tiles + splits - 1) / splits : 0;
  const int m_blocks = (M + C::BM - 1) / C::BM;
  if (m_blocks > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  const int x_vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && K % 8 == 0;
  const int w_vec = (reinterpret_cast<uintptr_t>(w) % 16 == 0) && N % 16 == 0;
  dim3 grid((N + C::BN - 1) / C::BN, m_blocks, splits);
  qmm_kernel<C><<<grid, C::THREADS, 0, stream>>>(
      (const uint16_t*)x, (const int8_t*)w, (const float*)scale, (float*)out, (float*)part, M, N, K,
      chunk_tiles * C::BK, x_vec, w_vec);
  if (splits > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const size_t mn = (size_t)M * N;
    const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
    qmm_reduce_kernel<<<blocks, 256, 0, stream>>>((const float*)part, (const float*)scale, (float*)out, M, N,
                                                  splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The K splits a launch on a card of ``sms`` SMs will use: ``part`` must hold
// [splits, M, N] f32 when this is above 1.
extern "C" int quantized_matmul_splits(int M, int N, int K, int sms) {
  return M > 0 && N > 0 && K >= 0 && sms > 0 ? plan_splits(M, N, K, sms) : 1;
}

// The tile (16 x 128 for M <= 64, else 128 x 128) and the K split are chosen
// here from M, N, K and the card's SM count; ``part`` is the f32 scratch that
// quantized_matmul_splits sizes (unused with one split).
extern "C" int quantized_matmul(const void* x, const void* w, const void* scale, void* out, void* part,
                                int M, int N, int K, int sms, void* stream) {
  if (M < 0 || N < 0 || K < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (M <= SMALL_M) return launch<Small>(x, w, scale, out, part, M, N, K, sms, (cudaStream_t)stream);
  return launch<Large>(x, w, scale, out, part, M, N, K, sms, (cudaStream_t)stream);
}

extern "C" const char* quantized_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
