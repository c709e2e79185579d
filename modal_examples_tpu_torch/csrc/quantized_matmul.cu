// Int8-weight matmul for Hopper (sm_90a):
//   out[m, n] = scale[n] * sum_k bf16(x[m, k]) * bf16(q[k, n])   (f32 sum, f32 out)
//
// Replaces modal_examples_tpu/ops/quantized_matmul.py::_qmm_kernel (entry
// quantized_matmul): int8 W [K, N] times a bf16 activation x [M, K], f32
// accumulation over K tiles, the per-output-channel scale applied once after
// the whole sum. The TPU kernel carried the sum in VMEM scratch across a
// sequential K grid axis and fell back to XLA for shapes that do not tile;
// here every shape runs on a kernel of this file, which picks one of three
// paths by shape (quantized_matmul_plan):
//
// 1. Prefill, M > 64, with TMA-describable operands (16-byte aligned bases,
//    N % 16 == 0, K % 8 == 0): bound by operations (185 GFLOP for M = 2048
//    over 4096 x 11008, 0.187 ms at 989 TFLOP/s bf16). One block per
//    128 x 256 output tile, two warpgroups of 64 rows. x tiles [128 x 64]
//    and int8 W tiles [64 x 256] arrive by TMA (128-byte swizzle) into a ring
//    of P_STAGES stages. The warpgroups convert each int8 tile into bf16 in a
//    swizzled panel of hopper.cuh's MN-major layout (W is N-contiguous, the
//    B operand that flash_fwd.cu's P.V reads), one tile ahead, into one of
//    two panel buffers, while the tensor cores run wgmma m64n256k16 (A and B
//    from shared memory) on the tile before; one named barrier a tile hands
//    over the panel and frees the stage. The scale applies once in the
//    epilogue. On an H100 the conversion does not hide under the products:
//    timing-only variants without it ran about a third faster, yet neither a
//    converter warpgroup of its own (slower: four warps cannot keep up), nor
//    a wgmma group kept in flight over three panels, nor packing without cvt
//    did better than this design (PERF.md).
// 2. Decode, M <= 64, same operand rule: bound by the weight bytes (45 MB
//    for 4096 x 11008, 0.0136 ms at 3.35 TB/s), so the lever is bytes in
//    flight. W tiles [128 x 128] and x tiles arrive by TMA through a
//    D_STAGES-deep ring (72-96 KB in flight a block, 2-3 blocks an SM). The
//    products are mma.sync m16n8k16 with the output channels on the 16-row
//    side and the slots on the n8 side, so no MMA row is wasted at M = 8:
//    each warp's A fragments come straight from the int8 tile in registers
//    (one 16-byte load gives a thread its two channels of 8 m16 tiles at one
//    k), converted in registers. K is split across blocks for 2-3 blocks an
//    SM; each split writes f32 partials, and the last block of an output tile
//    to finish (an atomic ticket) sums them in split order and applies the
//    scale: one launch, and the result does not change from run to run.
//    M > 32 runs as chunks of 32 rows, each streaming the weights again.
// 3. Any other shape (a ragged N, an unaligned base): the first design,
//    mma.sync fed by ldmatrix from padded tiles with register prefetch,
//    masking every ragged edge; one block per output tile over all of K.
//
// int8 -> bf16 is exact (|q| <= 127 fits bf16's 8-bit significand): the byte,
// biased by 128, goes into the mantissa of 2^23 with a byte permute, one f32
// subtraction gives its value, and cvt.rn.bf16x2.f32 packs two. Products are
// exact, so only the f32 summation order differs from the plain version.
#include "hopper.cuh"

namespace {

using namespace hopper;

enum Path { PATH_MMA_SYNC = 0, PATH_RING = 1, PATH_WGMMA = 2 };

// -- conversion and mma.sync ---------------------------------------------------------

constexpr uint32_t BIAS = 0x80808080u;  // xor: int8 -> its value + 128 as uint8, per byte
constexpr float MAGIC = 8388736.f;      // 2^23 + 128

// byte b of xw (already biased) as the f32 value of the int8 it came from:
// the biased byte in the mantissa of 2^23, less 2^23 + 128
__device__ __forceinline__ float byte_to_f32(uint32_t xw, int b) {
  return __uint_as_float(__byte_perm(xw, 0x4B000000u, 0x7540u + b)) - MAGIC;
}

// 4 int8 (the bytes of w, lowest first) -> 4 bf16 as two bf16x2 words
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t xw = w ^ BIAS;
  lo = pack_bf16(byte_to_f32(xw, 0), byte_to_f32(xw, 1));
  hi = pack_bf16(byte_to_f32(xw, 2), byte_to_f32(xw, 3));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

// -- path 1: prefill, TMA + wgmma --------------------------------------------------------

constexpr int P_BM = 128, P_BN = 256, P_BK = 64, P_STAGES = 4, P_THREADS = 256;
constexpr uint32_t P_X_BYTES = P_BM * P_BK * 2;        // one 128-byte panel of 128 rows
constexpr uint32_t P_W8_BYTES = P_BK * P_BN;           // two int8 boxes of 64 rows x 128 bytes
constexpr uint32_t P_STAGE_BYTES = P_X_BYTES + P_W8_BYTES;
constexpr uint32_t P_PANEL_BYTES = P_BK * P_BN * 2;    // bf16 W: four panels of 64 rows x 128 bytes
constexpr uint32_t P_SMEM = 1024 + P_STAGES * P_STAGE_BYTES + 2 * P_PANEL_BYTES + 8 * P_STAGES;

__global__ void __launch_bounds__(P_THREADS, 1) qmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map,  // [M, K] bf16, box 64 x 128
    const __grid_constant__ CUtensorMap w_map,  // [K, N] int8, box 128 x 64
    const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage s: x, then the int8 W tile
  const uint32_t panels = ring + P_STAGES * P_STAGE_BYTES;     // two bf16 W tiles
  const uint32_t bars = panels + 2 * P_PANEL_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto x_s = [&](int s) { return ring + s * P_STAGE_BYTES; };
  auto w8_s = [&](int s) { return ring + s * P_STAGE_BYTES + P_X_BYTES; };

  const int m0 = blockIdx.x * P_BM, n0 = blockIdx.y * P_BN;  // consecutive blocks share a W tile
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int nk = (K + P_BK - 1) / P_BK;

  auto load = [&](int t) {
    const int s = t % P_STAGES;
    mbar_expect_tx(full(s), P_STAGE_BYTES);
    tma_load_3d(x_s(s), &x_map, full(s), t * P_BK, m0, 0);
    tma_load_3d(w8_s(s), &w_map, full(s), n0, t * P_BK, 0);
    tma_load_3d(w8_s(s) + P_W8_BYTES / 2, &w_map, full(s), n0 + 128, t * P_BK, 0);
  };

  // int8 tile t (stage t % P_STAGES) -> bf16 panel buffer pb. Each thread
  // converts four 16-byte chunks; eight neighbouring threads take one chunk
  // column over eight rows, so the swizzled loads and stores hit distinct banks.
  auto convert = [&](int t, int pb) {
    const uint32_t src = w8_s(t % P_STAGES), dst = panels + pb * P_PANEL_BYTES;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = tid + P_THREADS * r, h = j / 512, jj = j % 512;
      const int k = jj % 8 + 8 * (jj / 64), ch = (jj / 8) % 8;  // row, 16-byte chunk of the 128-byte row
      const uint4 v = lds128(src + h * (P_W8_BYTES / 2) + k * 128 + ((ch ^ (k & 7)) * 16));
      uint32_t o[8];
      int8x4_to_bf16(v.x, o[0], o[1]);
      int8x4_to_bf16(v.y, o[2], o[3]);
      int8x4_to_bf16(v.z, o[4], o[5]);
      int8x4_to_bf16(v.w, o[6], o[7]);
      // columns 128h + 16ch .. +15 of the tile: panel 2h + ch/4, chunks 2(ch%4) and +1
      const uint32_t row = dst + (2 * h + ch / 4) * (P_BK * 128) + k * 128;
      const int c0 = 2 * (ch % 4);
      sts128(row + ((c0 ^ (k & 7)) * 16), o[0], o[1], o[2], o[3]);
      sts128(row + (((c0 + 1) ^ (k & 7)) * 16), o[4], o[5], o[6], o[7]);
    }
    fence_proxy_async();  // the panel is read by wgmma, through the async proxy
  };

  if (tid == 0) {
    for (int s = 0; s < P_STAGES; ++s) mbar_init(full(s), 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(P_STAGES, nk); ++t) load(t);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  mbar_wait(full(0), 0);
  convert(0, 0);
  named_sync(1, P_THREADS);
  for (int t = 0; t < nk; ++t) {
    const int s = t % P_STAGES, pb = t & 1;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P_BK / 16; ++kk) {
      const uint64_t da = make_desc(x_s(s) + wg * 64 * 128 + kk * 32, 16, 1024, 128);
      const uint64_t db = make_desc(panels + pb * P_PANEL_BYTES + kk * 16 * 128, P_BK * 128, 1024, 128);
      Wgmma<256>::ss_mn(acc, da, db, 1);
    }
    wgmma_commit();
    if (t + 1 < nk) {  // the next tile's conversion runs under this tile's products
      mbar_wait(full((t + 1) % P_STAGES), ((t + 1) / P_STAGES) & 1);
      convert(t + 1, pb ^ 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // every thread is done with stage s (x read by its products, W converted
    // in the previous step) and with panel pb; panel pb ^ 1 is written
    named_sync(1, P_THREADS);
    if (tid == 0 && t + P_STAGES < nk) {
      fence_proxy_async();
      load(t + P_STAGES);
    }
  }

  // register d[4j + 2h + c]: row 16*warp + lane/4 + 8h, column 8j + 2*(lane%4) + c
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (m >= M) continue;
    float* o = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < P_BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n < N)  // N % 16 == 0 on this path, so n + 1 < N too
        *reinterpret_cast<float2*>(o + n) = make_float2(acc[4 * j + 2 * h] * scale[n], acc[4 * j + 2 * h + 1] * scale[n + 1]);
    }
  }
}

// -- path 2: decode, a TMA ring with the split-K sum folded in -------------------------

constexpr int D_BN = 128, D_BK = 128, D_STAGES = 4, D_THREADS = 128;
constexpr int D_RED_STRIDE = D_BN + 4;  // floats per slot row of the cross-warp sum

template <int MT>  // n8 tiles of slots: MP = 8 * MT rows per m chunk
struct Dec {
  static constexpr int MP = 8 * MT;
  static constexpr uint32_t W_BYTES = D_BK * D_BN;        // int8, 128-byte swizzle
  static constexpr uint32_t X_BYTES = D_BK / 64 * MP * 128;  // panels of 64 bf16 columns
  static constexpr uint32_t STAGE_BYTES = W_BYTES + X_BYTES;
  static constexpr uint32_t RING_BYTES = D_STAGES * STAGE_BYTES;
  static constexpr uint32_t RED_BYTES = 4 * MP * D_RED_STRIDE * 4;
  static constexpr uint32_t BODY = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
  static constexpr uint32_t SMEM = 1024 + BODY + 8 * D_STAGES + 16;
  static constexpr int MIN_BLOCKS = MT == 1 ? 3 : 2;
};

// Block (x, y, z): channels [128x, 128x + 128), K tiles [y*chunk, (y+1)*chunk),
// rows [MP z, MP z + MP) of x. Warp w multiplies k16 steps w, w + 4, ... of
// every stage; the four warps' sums are added in warp order at the end.
template <int MT>
__global__ void __launch_bounds__(D_THREADS, Dec<MT>::MIN_BLOCKS) qmm_ring_kernel(
    const __grid_constant__ CUtensorMap x_map,  // [M, K] bf16, box 64 x MP
    const __grid_constant__ CUtensorMap w_map,  // [K, N] int8, box 128 x 128
    const float* __restrict__ scale, float* __restrict__ out,
    float* __restrict__ part,                    // [splits, M, N] when gridDim.y > 1
    int* __restrict__ tickets,                   // [gridDim.z * gridDim.x], zero between launches
    int M, int N, int K, int chunk) {
  using C = Dec<MT>;
  constexpr int MP = C::MP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage s: W tile, then x panels
  float* red = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));  // reuses the ring
  const uint32_t bars = ring + C::BODY;
  auto full = [&](int s) { return bars + 8 * s; };
  __shared__ int is_last;

  const int n0 = blockIdx.x * D_BN, z = blockIdx.y, splits = gridDim.y, m0 = blockIdx.z * MP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int kt_total = (K + D_BK - 1) / D_BK;
  const int kt0 = z * chunk, n_tiles = min(chunk, kt_total - kt0);

  auto load = [&](int n) {
    const int s = n % D_STAGES, k0 = (kt0 + n) * D_BK;
    const uint32_t w_s = ring + s * C::STAGE_BYTES, x_s = w_s + C::W_BYTES;
    mbar_expect_tx(full(s), C::STAGE_BYTES);
    tma_load_3d(w_s, &w_map, full(s), n0, k0, 0);
#pragma unroll
    for (int p = 0; p < D_BK / 64; ++p) tma_load_3d(x_s + p * MP * 128, &x_map, full(s), k0 + 64 * p, m0, 0);
  };

  if (tid == 0) {
    for (int s = 0; s < D_STAGES; ++s) mbar_init(full(s), 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int n = 0; n < min(D_STAGES, n_tiles); ++n) load(n);

  // acc[j][nt]: m16 tile j (rows g, g + 8 = channels 16g + 2j and 16g + 2j + 1)
  // by n8 tile nt (slots 8nt + 2*t4 + {0, 1})
  float acc[8][MT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < MT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % D_STAGES;
    const uint32_t w_s = ring + s * C::STAGE_BYTES, x_s = w_s + C::W_BYTES;
    mbar_wait(full(s), (n / D_STAGES) & 1);
#pragma unroll
    for (int step = 0; step < D_BK / 64; ++step) {
      const int kb = (warp + 4 * step) * 16;  // this k16 step's first row of the tile
      // rows kb + 2*t4 + {0, 1, 8, 9}; chunk g of each (channels 16g .. 16g + 15)
      uint4 L[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = kb + 2 * t4 + (i & 1) + 8 * (i >> 1);
        L[i] = lds128(w_s + k * 128 + ((g ^ (k & 7)) * 16));
        L[i].x ^= BIAS, L[i].y ^= BIAS, L[i].z ^= BIAS, L[i].w ^= BIAS;
      }
      // B fragments: x[slot][kb + 2*t4 + {0, 1}] and [+8, +9], from the swizzled x panel
      uint32_t b[MT][2];
      const int c = kb % 64, panel = kb / 64;
#pragma unroll
      for (int nt = 0; nt < MT; ++nt) {
        const int slot = 8 * nt + g;
        const uint32_t row = x_s + panel * MP * 128 + slot * 128 + 4 * t4;
        b[nt][0] = lds32(row + (((c / 8) ^ (slot & 7)) * 16));
        b[nt][1] = lds32(row + (((c / 8 + 1) ^ (slot & 7)) * 16));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // word j/2 of each row holds channels 16g + 2j (byte 2(j%2)) and 16g + 2j + 1 (byte 2(j%2)+1)
        const int bl = 2 * (j % 2);
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = j / 2 == 0 ? L[i].x : j / 2 == 1 ? L[i].y : j / 2 == 2 ? L[i].z : L[i].w;
        uint32_t a[4];
        a[0] = pack_bf16(byte_to_f32(w[0], bl), byte_to_f32(w[1], bl));          // row g, k 2t4, 2t4+1
        a[1] = pack_bf16(byte_to_f32(w[0], bl + 1), byte_to_f32(w[1], bl + 1));  // row g+8
        a[2] = pack_bf16(byte_to_f32(w[2], bl), byte_to_f32(w[3], bl));          // row g, k +8, +9
        a[3] = pack_bf16(byte_to_f32(w[2], bl + 1), byte_to_f32(w[3], bl + 1));  // row g+8, k +8, +9
#pragma unroll
        for (int nt = 0; nt < MT; ++nt) mma_bf16(acc[j][nt], a, b[nt][0], b[nt][1]);
      }
    }
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && n + D_STAGES < n_tiles) {
      fence_proxy_async();
      load(n + D_STAGES);
    }
  }

  // the four warps' sums, added in warp order
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < MT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = 8 * nt + 2 * t4 + (e & 1), ch = 16 * g + 2 * j + (e >> 1);
        red[(warp * MP + slot) * D_RED_STRIDE + ch] = acc[j][nt][e];
      }
  __syncthreads();
  // outputs as float4s, V a thread: channels n .. n + 3 of one slot (N % 16
  // == 0 on this path, so all four are in range when n is)
  constexpr int V = MP * D_BN / 4 / D_THREADS;
  auto at = [&](int v, int& m, int& n) {
    const int e = 4 * (tid + D_THREADS * v);
    m = m0 + e / D_BN, n = n0 + e % D_BN;
    return m < M && n < N;
  };
  const bool split = splits > 1;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    int m, n;
    if (!at(v, m, n)) continue;
    const int slot = m - m0, ch = n - n0;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float4 p = *reinterpret_cast<const float4*>(red + (w * MP + slot) * D_RED_STRIDE + ch);
      r.x += p.x, r.y += p.y, r.z += p.z, r.w += p.w;
    }
    if (split) {
      *reinterpret_cast<float4*>(part + ((size_t)z * M + m) * N + n) = r;
    } else {
      *reinterpret_cast<float4*>(out + (size_t)m * N + n) =
          make_float4(r.x * scale[n], r.y * scale[n + 1], r.z * scale[n + 2], r.w * scale[n + 3]);
    }
  }
  if (!split) return;

  // the last split of this output tile to finish sums every split's partial
  // in split order (its loads in flight together) and applies the scale,
  // then resets the ticket
  __threadfence();
  __syncthreads();
  int* ticket = tickets + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(ticket, 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float4 sum[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sum[v] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int zz = 0; zz < splits; ++zz)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      int m, n;
      if (!at(v, m, n)) continue;
      const float4 p = __ldcg(reinterpret_cast<const float4*>(part + ((size_t)zz * M + m) * N + n));
      sum[v].x += p.x, sum[v].y += p.y, sum[v].z += p.z, sum[v].w += p.w;
    }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    int m, n;
    if (!at(v, m, n)) continue;
    *reinterpret_cast<float4*>(out + (size_t)m * N + n) =
        make_float4(sum[v].x * scale[n], sum[v].y * scale[n + 1], sum[v].z * scale[n + 2], sum[v].w * scale[n + 3]);
  }
  if (tid == 0) *ticket = 0;
}

// -- path 3: any shape, mma.sync from padded tiles ------------------------------------------

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

using Small = Cfg<1, 4, 1, 4, 64, 4>;  // 16 x 128 tile, 128 threads (M <= 64)
using Large = Cfg<2, 4, 4, 4, 32, 2>;  // 128 x 128 tile, 256 threads

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Block (blockIdx.x, blockIdx.y) owns output tile [m0, m0+BM) x [n0, n0+BN)
// over all of K.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS) qmm_kernel(
    const uint16_t* __restrict__ x,   // [M, K] bf16 bits
    const int8_t* __restrict__ w,     // [K, N]
    const float* __restrict__ scale,  // [N]
    float* __restrict__ out,          // [M, N]
    int M, int N, int K, int x_vec, int w_vec) {
  __shared__ __align__(16) __nv_bfloat16 As[2][C::BM * C::A_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][C::BK * C::B_STRIDE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int n_tiles = (K + C::BK - 1) / C::BK;

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
        if (x_vec && k + 8 <= K) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {  // ragged K edge or unaligned rows: element by element
          uint32_t e[4] = {0, 0, 0, 0};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (k + i < K) e[i / 2] |= (uint32_t)src[i] << (16 * (i % 2));
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
      if (k < K) {
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
      uint32_t h[8];
      int8x4_to_bf16(b_reg[j].x, h[0], h[1]);
      int8x4_to_bf16(b_reg[j].y, h[2], h[3]);
      int8x4_to_bf16(b_reg[j].z, h[4], h[5]);
      int8x4_to_bf16(b_reg[j].w, h[6], h[7]);
      uint4* dst = reinterpret_cast<uint4*>(&Bs[buf][(idx / (C::BN / 16)) * C::B_STRIDE + 16 * (idx % (C::BN / 16))]);
      dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
      dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
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
    load_tile(0);
    store_tile(0);
  }
  __syncthreads();
  const int a_row = wm * C::WM_TILES * 16 + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = lane & 15, b_col = wn * C::WN_TILES * 8 + (lane >> 4) * 8;
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) load_tile((t + 1) * C::BK);  // in flight during the products
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
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < C::WM_TILES; ++i)
#pragma unroll
    for (int j = 0; j < C::WN_TILES; ++j) {
      const int n = n0 + wn * C::WN_TILES * 8 + 8 * j + 2 * tig;
      if (n >= N) continue;
      const float s0 = scale[n], s1 = n + 1 < N ? scale[n + 1] : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * C::WM_TILES * 16 + 16 * i + g + 8 * h;
        if (m >= M) continue;
        float* o = out + (size_t)m * N + n;
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

// -- planning and launch ----------------------------------------------------------------------

struct Plan {
  int path;
  int mt;       // ring: n8 slot tiles per m chunk
  int m_chunks; // ring
  int splits;   // ring: K splits (1: no partials)
  int chunk;    // ring: K tiles per split
  int tickets;  // ring: ints of ticket scratch the launch needs (0 with one split)
};

template <int MT>
constexpr int dec_min_blocks = Dec<MT>::MIN_BLOCKS;

Plan make_plan(const void* x, const void* w, int M, int N, int K, int sms) {
  Plan p{PATH_MMA_SYNC, 0, 1, 1, 0, 0};
  const bool tma_ok = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                      N % 16 == 0 && K % 8 == 0 && K > 0;
  if (!tma_ok) return p;
  if (M > 64) {
    p.path = PATH_WGMMA;
    return p;
  }
  p.path = PATH_RING;
  p.mt = M <= 8 ? 1 : M <= 16 ? 2 : 4;
  p.m_chunks = (M + 8 * p.mt - 1) / (8 * p.mt);
  const int min_blocks = p.mt == 1 ? dec_min_blocks<1> : p.mt == 2 ? dec_min_blocks<2> : dec_min_blocks<4>;
  const long long tiles = (long long)((N + D_BN - 1) / D_BN) * p.m_chunks;
  const int kt = (K + D_BK - 1) / D_BK;
  long long s = (long long)min_blocks * sms / tiles;
  if (s > kt) s = kt;
  if (s > 65535) s = 65535;
  p.splits = s < 1 ? 1 : (int)s;
  p.chunk = (kt + p.splits - 1) / p.splits;
  p.splits = (kt + p.chunk - 1) / p.chunk;  // every split non-empty
  p.tickets = p.splits > 1 ? (int)tiles : 0;
  return p;
}

int launch_wgmma(const void* x, const void* w, const void* scale, void* out, int M, int N, int K,
                 cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  int e = encode_3d(&x_map, x, K, M, 1, 64, P_BM, 128);
  if (!e) e = encode_3d(&w_map, w, N, K, 1, 128, P_BK, 128, 1);
  if (e) return e;
  const int m_blocks = (M + P_BM - 1) / P_BM, n_blocks = (N + P_BN - 1) / P_BN;
  if (n_blocks > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P_SMEM);
  if (err != cudaSuccess) return (int)err;
  qmm_wgmma_kernel<<<dim3(m_blocks, n_blocks), P_THREADS, P_SMEM, stream>>>(
      x_map, w_map, (const float*)scale, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_ring(const Plan& p, const void* x, const void* w, const void* scale, void* out, void* part, void* tickets,
                int M, int N, int K, cudaStream_t stream) {
  using C = Dec<MT>;
  CUtensorMap x_map, w_map;
  int e = encode_3d(&x_map, x, K, M, 1, 64, C::MP, 128);
  if (!e) e = encode_3d(&w_map, w, N, K, 1, D_BN, D_BK, 128, 1);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(qmm_ring_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + D_BN - 1) / D_BN, p.splits, p.m_chunks);
  qmm_ring_kernel<MT><<<grid, D_THREADS, C::SMEM, stream>>>(x_map, w_map, (const float*)scale, (float*)out,
                                                             (float*)part, (int*)tickets, M, N, K, p.chunk);
  return (int)cudaGetLastError();
}

template <class C>
int launch_mma_sync(const void* x, const void* w, const void* scale, void* out, int M, int N, int K,
                    cudaStream_t stream) {
  const int m_blocks = (M + C::BM - 1) / C::BM;
  if (m_blocks > 65535) return (int)cudaErrorInvalidValue;
  const int x_vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && K % 8 == 0;
  const int w_vec = (reinterpret_cast<uintptr_t>(w) % 16 == 0) && N % 16 == 0;
  dim3 grid((N + C::BN - 1) / C::BN, m_blocks);
  qmm_kernel<C><<<grid, C::THREADS, 0, stream>>>((const uint16_t*)x, (const int8_t*)w, (const float*)scale,
                                                 (float*)out, M, N, K, x_vec, w_vec);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch's plan for x, w at M, N, K on a card of ``sms`` SMs: returns the
// path (0: mma.sync, any shape; 1: the decode ring; 2: TMA + wgmma) and sets
// ``splits`` (``part`` must hold [splits, M, N] f32 when above 1) and
// ``tickets`` (ints of zeroed ticket scratch; every launch leaves them zero).
extern "C" int quantized_matmul_plan(const void* x, const void* w, int M, int N, int K, int sms, int* splits,
                                     int* tickets) {
  const Plan p = M > 0 && N > 0 && K >= 0 && sms > 0 ? make_plan(x, w, M, N, K, sms) : Plan{PATH_MMA_SYNC, 0, 1, 1, 0, 0};
  *splits = p.splits;
  *tickets = p.tickets;
  return p.path;
}

extern "C" int quantized_matmul(const void* x, const void* w, const void* scale, void* out, void* part,
                                void* tickets, int M, int N, int K, int sms, void* stream) {
  if (M < 0 || N < 0 || K < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const Plan p = make_plan(x, w, M, N, K, sms);
  switch (p.path) {
    case PATH_WGMMA: return launch_wgmma(x, w, scale, out, M, N, K, st);
    case PATH_RING:
      if (p.mt == 1) return launch_ring<1>(p, x, w, scale, out, part, tickets, M, N, K, st);
      if (p.mt == 2) return launch_ring<2>(p, x, w, scale, out, part, tickets, M, N, K, st);
      return launch_ring<4>(p, x, w, scale, out, part, tickets, M, N, K, st);
    default:
      if (M <= 64) return launch_mma_sync<Small>(x, w, scale, out, M, N, K, st);
      return launch_mma_sync<Large>(x, w, scale, out, M, N, K, st);
  }
}

extern "C" const char* quantized_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
