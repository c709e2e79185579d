// Int4-weight matmul for Hopper (sm_90a), "K7-int4":
//   out[m, n] = scale[n] * sum_k bf16(x[m, k]) * q[k, n]   (f32 sum, f32 out)
// with q int4 [K, N] packed two contraction rows a byte: byte (kp, n) holds
// q[2kp, n] in its low nibble and q[2kp + 1, n] in its high nibble (a zero
// nibble pads an odd K), x bf16 [M, K], scale f32 [N].
//
// Replaces no Pallas kernel: the JAX package computes this product as XLA's
// dot over jnp.int4 (modal_examples_tpu/models/layers.py:100-108). It exists
// because the plain route (unpack to bf16, then a GEMM) reads four times the
// packed bytes, which defeats int4's purpose. At decode (M <= 64) the
// product is bound by the weight bytes (22.5 MB for 4096 x 11008, 0.0068 ms
// at 3.35 TB/s); at prefill (M = 2048) by operations (0.1867 ms at 989
// TFLOP/s bf16).
//
// Design (the simple first version): the output channels sit on mma.sync
// m16n8k16's 16-row side and the rows of x on its n8 side, so a decode step's
// 1-8 rows waste no MMA row. An MMA A fragment wants, per thread, the k-pair
// (2t, 2t+1) of one channel, which is exactly one packed byte: a thread reads
// 16 bytes of nibbles (16 neighbouring channels at one k-pair) straight from
// device memory with one 16-byte load and sign-extends each byte into a
// bf16x2 register with two logic operations and one bf16x2 FMA (the nibble,
// biased by 8, goes into the mantissa of 128; subtracting 136 gives its
// value exactly). A block owns 128 channels x 8*MT rows of x; its four warps
// take the four k16 steps of each 64-deep K tile and their sums are added in
// warp order at the end. Loads of the next K tile are issued before the
// current tile's products (a register double buffer). For small M the K
// range is split across blocks so that about six blocks fill each SM; each
// split writes f32 partials and the last block of an output tile to finish
// (an atomic ticket) sums them in split order and applies the scale, in the
// same launch, so the result does not change from run to run. Blocks that
// share a weight strip are launched next to each other (the rows of x are
// the fastest grid dimension), so a prefill reads each strip from HBM about
// once and again from L2. Shapes whose strides cannot take 16-byte loads
// (N % 16 != 0, K odd, an unaligned base) run the same kernel with
// element-wise masked loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;  // output channels a block
constexpr int BK = 64;   // contraction depth of one K tile (32 packed rows)
constexpr int THREADS = 128;
constexpr int RED_STRIDE = BN + 4;  // floats a row of the cross-warp sum

// the low byte of x (its nibbles already xor-ed with 8) as two bf16 values:
// low nibble in the low half
__device__ __forceinline__ uint32_t byte_to_bf16x2(uint32_t x) {
  const uint32_t biased = (x & 0xFu) | ((x & 0xF0u) << 12) | 0x43004300u;  // bf16(128 + u), two halves
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(out) : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));
  return out;  // 1.0 * (128 + u) - 136 = u - 8, the signed nibble, exactly
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One K tile's operands in registers: packed rows r and r + 4 of this
// thread's 16 channels, and x at k-pairs (2t, 2t + 1) and (+8, +9) of each
// n8 tile's row.
template <int MT>
struct Frag {
  uint4 w[2];
  uint32_t x[MT][2];
};

// Block (blockIdx.x, blockIdx.y, blockIdx.z): rows [MP x, MP x + MP) of x,
// channels [128 y, 128 y + 128), K tiles [z * chunk, (z + 1) * chunk).
template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS) qmm_int4_kernel(
    const uint16_t* __restrict__ x,   // [M, K] bf16 bits
    const uint8_t* __restrict__ w,    // [Kp, N], Kp = ceil(K / 2)
    const float* __restrict__ scale,  // [N]
    float* __restrict__ out,          // [M, N]
    float* __restrict__ part,         // [splits, M, N] when gridDim.z > 1
    int* __restrict__ tickets,        // [gridDim.y * gridDim.x], zero between launches
    int M, int N, int K, int chunk) {
  constexpr int MP = 8 * MT;
  __shared__ __align__(16) float red[MP * RED_STRIDE];
  __shared__ int is_last;

  const int m0 = blockIdx.x * MP, n0 = blockIdx.y * BN, z = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int Kp = (K + 1) / 2;
  const int kt_total = (K + BK - 1) / BK;
  const int kt0 = z * chunk, n_tiles = max(0, min(chunk, kt_total - kt0));
  const int nc = n0 + 16 * g;  // this thread's first channel

  auto load = [&](Frag<MT>& f, int tile) {
    const int kb = tile * BK + 16 * warp;  // this warp's k16 step
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = kb / 2 + t4 + 4 * h;  // packed row: k-pair kb + 2 t4 (+ 8)
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < Kp) {
        const uint8_t* src = w + (size_t)r * N + nc;
        if (VEC) {
          if (nc < N) v = *reinterpret_cast<const uint4*>(src);  // N % 16 == 0: all 16 in range
        } else {
          uint32_t e[4] = {0, 0, 0, 0};
#pragma unroll
          for (int i = 0; i < 16; ++i)
            if (nc + i < N) e[i / 4] |= (uint32_t)src[i] << (8 * (i % 4));
          v = make_uint4(e[0], e[1], e[2], e[3]);
        }
      }
      f.w[h] = v;
    }
#pragma unroll
    for (int nt = 0; nt < MT; ++nt) {
      const int m = m0 + 8 * nt + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = kb + 2 * t4 + 8 * h;
        uint32_t v = 0;
        if (m < M) {
          const uint16_t* src = x + (size_t)m * K + k;
          if (VEC) {
            if (k < K) v = *reinterpret_cast<const uint32_t*>(src);  // K even: k + 1 < K too
          } else {
            if (k < K) v = src[0];
            if (k + 1 < K) v |= (uint32_t)src[1] << 16;
          }
        }
        f.x[nt][h] = v;
      }
    }
  };

  // acc[j][nt][e]: channel 16 g + 2 j + (e >> 1), row 8 nt + 2 t4 + (e & 1)
  float acc[8][MT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < MT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

  auto compute = [&](const Frag<MT>& f) {
    const uint4 lo = make_uint4(f.w[0].x ^ 0x88888888u, f.w[0].y ^ 0x88888888u, f.w[0].z ^ 0x88888888u,
                                f.w[0].w ^ 0x88888888u);
    const uint4 hi = make_uint4(f.w[1].x ^ 0x88888888u, f.w[1].y ^ 0x88888888u, f.w[1].z ^ 0x88888888u,
                                f.w[1].w ^ 0x88888888u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // channels 16 g + 2 j and + 1 are bytes 2 (j % 2) and + 1 of word j / 2
      const int sh = 16 * (j % 2);
      const uint32_t a_lo = word_of(lo, j / 2) >> sh, a_hi = word_of(hi, j / 2) >> sh;
      uint32_t a[4];
      a[0] = byte_to_bf16x2(a_lo);      // row g (channel 2j), k 2t4, 2t4 + 1
      a[1] = byte_to_bf16x2(a_lo >> 8); // row g + 8 (channel 2j + 1)
      a[2] = byte_to_bf16x2(a_hi);      // row g, k + 8, + 9
      a[3] = byte_to_bf16x2(a_hi >> 8); // row g + 8, k + 8, + 9
#pragma unroll
      for (int nt = 0; nt < MT; ++nt) mma_bf16(acc[j][nt], a, f.x[nt][0], f.x[nt][1]);
    }
  };

  if (n_tiles > 0) {
    Frag<MT> cur, nxt;
    load(cur, kt0);
    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) load(nxt, kt0 + t + 1);  // in flight under this tile's products
      compute(cur);
      cur = nxt;
    }
  }

  // the four warps' sums, added in warp order
#pragma unroll 1
  for (int wi = 0; wi < 4; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int nt = 0; nt < MT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* r = red + (8 * nt + 2 * t4 + (e & 1)) * RED_STRIDE + 16 * g + 2 * j + (e >> 1);
            *r = wi == 0 ? acc[j][nt][e] : *r + acc[j][nt][e];
          }
    }
    __syncthreads();
  }

  // element i of the tile: row m0 + i / BN, channel n0 + i % BN (neighbouring
  // threads on neighbouring channels)
  constexpr int V = MP * BN / THREADS;
  const bool split = splits > 1;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = tid + THREADS * v, m = m0 + i / BN, n = n0 + i % BN;
    if (m >= M || n >= N) continue;
    const float s = red[(i / BN) * RED_STRIDE + i % BN];
    if (split) {
      part[((size_t)z * M + m) * N + n] = s;
    } else {
      out[(size_t)m * N + n] = s * scale[n];
    }
  }
  if (!split) return;

  // the last split of this output tile to finish sums every split's partial
  // in split order and applies the scale, then resets the ticket
  __threadfence();
  __syncthreads();
  int* ticket = tickets + blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = tid + THREADS * v, m = m0 + i / BN, n = n0 + i % BN;
    if (m >= M || n >= N) continue;
    float s = 0.f;
    for (int zz = 0; zz < splits; ++zz) s += __ldcg(part + ((size_t)zz * M + m) * N + n);
    out[(size_t)m * N + n] = s * scale[n];
  }
  if (tid == 0) *ticket = 0;
}

struct Plan {
  int mt;        // n8 tiles of x rows a block: 8 * mt rows
  int m_chunks;  // blocks along M
  int n_tiles;   // blocks along N
  int splits;    // blocks along K (1: no partials)
  int chunk;     // K tiles a split
  int tickets;   // ints of zeroed ticket scratch (0 with one split)
  int vec;       // 16-byte weight loads and 4-byte x loads
};

constexpr int BLOCKS_PER_SM = 6;  // the split target: about this many blocks resident on each SM

Plan make_plan(const void* x, const void* w, int M, int N, int K, int sms) {
  Plan p{};
  p.mt = M <= 8 ? 1 : M <= 16 ? 2 : 4;
  p.m_chunks = (M + 8 * p.mt - 1) / (8 * p.mt);
  p.n_tiles = (N + BN - 1) / BN;
  const int kt = (K + BK - 1) / BK;
  const long long tiles = (long long)p.m_chunks * p.n_tiles;
  long long s = (long long)BLOCKS_PER_SM * sms / (tiles > 0 ? tiles : 1);
  if (s > kt) s = kt;
  if (s > 65535) s = 65535;
  if (s < 1) s = 1;
  p.chunk = kt > 0 ? (int)((kt + s - 1) / s) : 0;
  p.splits = kt > 0 ? (kt + p.chunk - 1) / p.chunk : 1;  // every split non-empty
  p.tickets = p.splits > 1 ? (int)tiles : 0;
  p.vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 && N % 16 == 0 &&
          K % 2 == 0;
  return p;
}

template <int MT, bool VEC>
int launch(const Plan& p, const void* x, const void* w, const void* scale, void* out, void* part, void* tickets,
           int M, int N, int K, cudaStream_t stream) {
  dim3 grid(p.m_chunks, p.n_tiles, p.splits);
  qmm_int4_kernel<MT, VEC><<<grid, THREADS, 0, stream>>>((const uint16_t*)x, (const uint8_t*)w, (const float*)scale,
                                                         (float*)out, (float*)part, (int*)tickets, M, N, K, p.chunk);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_mt(const Plan& p, const void* x, const void* w, const void* scale, void* out, void* part, void* tickets,
              int M, int N, int K, cudaStream_t stream) {
  if (p.mt == 1) return launch<1, VEC>(p, x, w, scale, out, part, tickets, M, N, K, stream);
  if (p.mt == 2) return launch<2, VEC>(p, x, w, scale, out, part, tickets, M, N, K, stream);
  return launch<4, VEC>(p, x, w, scale, out, part, tickets, M, N, K, stream);
}

}  // namespace

// The launch's plan for x, w at M, N, K on a card of ``sms`` SMs: returns
// the rows of x a block takes (8, 16 or 32) and sets ``splits`` (``part``
// must hold [splits, M, N] f32 when above 1), ``chunk`` (64-deep K tiles a
// split) and ``tickets`` (ints of zeroed ticket scratch; every launch leaves
// them zero).
extern "C" int quantized_matmul_int4_plan(const void* x, const void* w, int M, int N, int K, int sms, int* splits,
                                          int* chunk, int* tickets) {
  if (M < 1 || N < 1 || K < 0 || sms < 1) return 0;
  const Plan p = make_plan(x, w, M, N, K, sms);
  *splits = p.splits;
  *chunk = p.chunk;
  *tickets = p.tickets;
  return 8 * p.mt;
}

extern "C" int quantized_matmul_int4(const void* x, const void* w, const void* scale, void* out, void* part,
                                     void* tickets, int M, int N, int K, int sms, void* stream) {
  if (M < 0 || N < 0 || K < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const Plan p = make_plan(x, w, M, N, K, sms);
  if (p.n_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return p.vec ? launch_mt<true>(p, x, w, scale, out, part, tickets, M, N, K, st)
               : launch_mt<false>(p, x, w, scale, out, part, tickets, M, N, K, st);
}

extern "C" const char* quantized_matmul_int4_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
