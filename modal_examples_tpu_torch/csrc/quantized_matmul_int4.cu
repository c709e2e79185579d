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
// TFLOP/s bf16). Every path converts the nibbles in registers, never through
// a bf16 copy in shared memory: a nibble with its top bit flipped is q + 8
// as unsigned; in the mantissa of bf16(128) that is 128 + q + 8, and one
// bf16x2 FMA (x 1 - 136) gives q exactly, two values at a time. Products are
// exact, so only the f32 summation order differs from the plain version.
// The kernel picks one of three paths by shape (quantized_matmul_int4_path),
// one launch in every case, the same bits from run to run:
//
// 1. Prefill, M > 64, operands TMA can describe (16-byte aligned bases,
//    N % 16 == 0, K % 8 == 0): wgmma with A from registers. The output
//    channels sit on wgmma's 64-row A side and the rows of x on its N side
//    (128 a block). A producer warp keeps TMA loads in flight through a ring
//    of P_STAGES stages, each a packed tile [64 packed rows x 256 channels]
//    (two 128-byte boxes, 128-byte swizzle) and an x tile [128 rows x 128]
//    (two 128-byte panels, 128-byte swizzle: x is row-major, so it already
//    is wgmma's K-major B operand). Two consumer warpgroups of 128 channels
//    each (two m64 tiles) read a 4-byte word a thread a k16 step and packed
//    row (four channels at one k-pair: exactly the bytes of its A
//    fragments; the chunk order keeps a warp's loads free of bank conflicts
//    after the swizzle), convert it in registers and issue two m64n128k16
//    (B K-major); one step's products run
//    under the next step's loads and conversion, and a stage's last step is
//    waited for before the stage is freed (a product in flight across the
//    ring's turn makes ptxas serialize them all). A thread's four channels
//    are neighbours, so the epilogue stores float4s straight from the
//    accumulators (64 contiguous bytes of a row for four lanes) and applies
//    the scale once. The rows of x are the fastest grid dimension, so the
//    blocks that share a weight strip run together and read it from HBM
//    about once.
// 2. Decode, M <= 64, same operand rule: bound by the weight bytes, so the
//    lever is bytes in flight. Packed tiles [64 packed rows x 128 channels]
//    and x panels arrive by TMA through a ring of Ring<MT>::STAGES stages
//    (80-96 KB in flight a block, 2 blocks an SM), as K7's ring path does.
//    The products are mma.sync m16n8k16 with the channels on the 16-row side
//    and the rows of x on the n8 side, so no MMA row is wasted at M = 8: a
//    thread's 16 channels at one k-pair are one 16-byte shared load (the
//    A fragments of 8 m16 tiles), converted in registers. K is split across
//    blocks for about 2 blocks an SM, but into no more splits than keep the
//    f32 partials within an eighth of the weight bytes; the last block of an
//    output tile to finish (an atomic ticket) sums the partials in split
//    order and applies the scale, in the same launch.
//    The stage depths and counts of both paths are the fastest of a sweep on
//    an H100 (PERF.md, PR 21): prefill 64-deep stages x 6 to 256 x 2, decode
//    256-deep x 4 with 8 warps to 64-deep x 12 with 3 blocks an SM.
// 3. Any other shape (N % 16 != 0, K % 8 != 0, an unaligned base): the first
//    design, kept as the masked path. Operands loaded by threads (16-byte
//    loads where the strides allow, element-wise otherwise) into a register
//    double buffer, mma.sync with the channels on the 16-row side, four warps
//    on the four k16 steps of each 64-deep K tile, K split for small M as in
//    path 2.
#include "hopper.cuh"

namespace {

using namespace hopper;

enum Path { PATH_MASKED = 0, PATH_RING = 1, PATH_WGMMA = 2 };

// -- conversion, loads and mma.sync -----------------------------------------------------

// Bits 0-3 and 16-19 of v, two nibbles, as the bf16x2 of their int4 values
// (the low half from bits 0-3): ((v ^ 0x00080008) & 0x000F000F) | 0x43004300
// in one lop3 (operand b selects the nibble bits, c the top nibble bit and
// the exponent of 128), then (128 + q + 8) * 1 - 136.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(r) : "r"(v), "r"(0x000F000Fu), "r"(0x43084308u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// The four bytes of w (four channels at one k-pair) as bf16x2 registers:
// p[b] holds byte b's (even row, odd row) values, an MMA A-fragment register.
__device__ __forceinline__ void word_to_bf16x2(uint32_t w, uint32_t (&p)[4]) {
  const uint32_t t0 = nibbles_to_bf16x2(w);        // bytes 0 and 2, low nibbles
  const uint32_t t1 = nibbles_to_bf16x2(w >> 4);   // bytes 0 and 2, high nibbles
  const uint32_t t2 = nibbles_to_bf16x2(w >> 8);   // bytes 1 and 3, low nibbles
  const uint32_t t3 = nibbles_to_bf16x2(w >> 12);  // bytes 1 and 3, high nibbles
  p[0] = __byte_perm(t0, t1, 0x5410);
  p[1] = __byte_perm(t2, t3, 0x5410);
  p[2] = __byte_perm(t0, t1, 0x7632);
  p[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
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

// Pins four registers at this point of the program, so the compiler moves no
// instruction that defines them past a wgmma.fence placed after it (ptxas
// would serialize the products otherwise).
__device__ __forceinline__ void pin4(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// -- path 1: prefill, TMA + wgmma with A from registers ------------------------------------

constexpr int P_BM = 128;       // rows of x a block: wgmma's N
constexpr int P_BN = 256;       // output channels a block: two warpgroups of two m64 tiles
constexpr int P_BK = 128;       // contraction depth of a stage: 64 packed rows
constexpr int P_STAGES = 4;
constexpr int P_THREADS = 288;  // two consumer warpgroups and a producer warp
constexpr uint32_t P_X_PANEL = P_BM * 128;      // 64 columns of x: one 128-byte panel of 128 rows
constexpr uint32_t P_X_BYTES = P_BK / 64 * P_X_PANEL;
constexpr uint32_t P_W_BYTES = P_BK / 2 * P_BN;  // two boxes of P_BK / 2 packed rows x 128 bytes
constexpr uint32_t P_STAGE_BYTES = P_X_BYTES + P_W_BYTES;
constexpr uint32_t P_SMEM = 1024 + P_STAGES * P_STAGE_BYTES + 16 * P_STAGES;

// Block (x, y): rows [128 x, 128 x + 128) of x, channels [256 y, 256 y + 256).
__global__ void __launch_bounds__(P_THREADS, 1) qmm4_wgmma_kernel(
    const __grid_constant__ CUtensorMap x_map,  // [M, K] bf16, box 64 x 128
    const __grid_constant__ CUtensorMap w_map,  // [Kp, N] uint8, box 128 x P_BK / 2
    const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage s: the x tile, then the packed tile
  const uint32_t bars = ring + P_STAGES * P_STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (P_STAGES + s); };
  auto x_s = [&](int s) { return ring + s * P_STAGE_BYTES; };
  auto w_s = [&](int s) { return ring + s * P_STAGE_BYTES + P_X_BYTES; };

  const int m0 = blockIdx.x * P_BM, n0 = blockIdx.y * P_BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nk = (K + P_BK - 1) / P_BK;

  if (tid == 0) {
    for (int s = 0; s < P_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer: stage t % P_STAGES refilled once the consumers free it
    if (lane == 0) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % P_STAGES;
        if (t >= P_STAGES) mbar_wait(empty(s), (t / P_STAGES - 1) & 1);
        mbar_expect_tx(full(s), P_STAGE_BYTES);
        for (int p = 0; p < P_BK / 64; ++p)
          tma_load_3d(x_s(s) + p * P_X_PANEL, &x_map, full(s), t * P_BK + 64 * p, m0, 0);
        tma_load_3d(w_s(s), &w_map, full(s), n0, t * (P_BK / 2), 0);
        tma_load_3d(w_s(s) + P_W_BYTES / 2, &w_map, full(s), n0 + 128, t * (P_BK / 2), 0);
      }
    }
    return;
  }

  // consumer warpgroup wg, warp cw of it. The thread's four channels are
  // 128 wg + 64 (g / 4) + 16 cw + 4 (g % 4) + {0, 1, 2, 3}: word g % 4 of
  // 16-byte chunk c of each 128-byte packed row of its box. Channel +2i+h
  // is MMA row g + 8h of m64 tile i (rows 16 cw .. 16 cw + 15 are this warp's).
  const int wg = warp / 4, cw = warp % 4, g = lane / 4, t4 = lane % 4;
  const int c = 4 * (g / 4) + cw;
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;

  for (int t = 0; t < nk; ++t) {
    const int s = t % P_STAGES;
    mbar_wait(full(s), (t / P_STAGES) & 1);
    const uint32_t wt = w_s(s) + wg * (P_W_BYTES / 2) + 4 * (g % 4);
#pragma unroll
    for (int st = 0; st < P_BK / 16; ++st) {
      // packed rows 8 st + t4 and + 4: this thread's k-pairs of the k16 step
      const int r0 = 8 * st + t4, r1 = r0 + 4;
      uint32_t pl[4], ph[4];
      word_to_bf16x2(lds32(wt + r0 * 128 + ((c ^ (r0 & 7)) << 4)), pl);
      word_to_bf16x2(lds32(wt + r1 * 128 + ((c ^ (r1 & 7)) << 4)), ph);
      uint32_t a0[4] = {pl[0], pl[1], ph[0], ph[1]};  // tile 0: channels +0 (row g), +1 (row g + 8)
      uint32_t a1[4] = {pl[2], pl[3], ph[2], ph[3]};  // tile 1: channels +2, +3
      pin4(a0);
      pin4(a1);
      const uint64_t db = make_desc(x_s(s) + st / 4 * P_X_PANEL + st % 4 * 32, 16, 1024, 128);
      wgmma_fence();
      Wgmma<128>::rs_k(acc0, a0, db, 1);
      Wgmma<128>::rs_k(acc1, a1, db, 1);
      wgmma_commit();
      if (st < P_BK / 16 - 1) {
        wgmma_wait<1>();  // the step before is done: one step's products in flight
      } else {  // the stage's last step: drained here, so no product is in flight across a stage
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));
      }
    }
  }
  fence_regs(acc0);
  fence_regs(acc1);

  // acc_i[4j + 2h + e]: channel ch + 2i + h, row m0 + 8j + 2 t4 + e
  const int ch = n0 + wg * 128 + 64 * (g / 4) + 16 * cw + 4 * (g % 4);
  if (ch >= N) return;  // N % 16 == 0 on this path, so ch + 3 < N when ch < N
  const float s0 = scale[ch], s1 = scale[ch + 1], s2 = scale[ch + 2], s3 = scale[ch + 3];
#pragma unroll
  for (int j = 0; j < P_BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t4 + e;
      if (m < M)
        *reinterpret_cast<float4*>(out + (size_t)m * N + ch) =
            make_float4(acc0[4 * j + e] * s0, acc0[4 * j + 2 + e] * s1, acc1[4 * j + e] * s2, acc1[4 * j + 2 + e] * s3);
    }
}

// -- path 2: decode, a TMA ring with the split-K sum folded in ------------------------------

constexpr int D_BN = 128;                        // output channels a block
constexpr int D_BK = 128;                        // contraction depth of a stage: 64 packed rows
constexpr uint32_t D_W_BYTES = D_BK / 2 * D_BN;  // one box of 64 packed rows x 128 bytes
constexpr int D_RED_STRIDE = D_BN + 4;           // floats a row of the cross-warp sum

template <int MT>  // n8 tiles of x rows: MP = 8 * MT rows a block
struct Ring {
  static constexpr int MP = 8 * MT;
  static constexpr int WARPS = 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int STAGES = MT == 4 ? 6 : 8;  // 80, 96 and 96 KB in flight
  static constexpr uint32_t X_BYTES = D_BK / 64 * MP * 128;  // panels of 64 bf16 columns
  static constexpr uint32_t STAGE_BYTES = D_W_BYTES + X_BYTES;
  static constexpr uint32_t RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr uint32_t RED_BYTES = WARPS * MP * D_RED_STRIDE * 4;
  static constexpr uint32_t BODY = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
  static constexpr uint32_t SMEM = 1024 + BODY + 8 * STAGES;
  static constexpr int MIN_BLOCKS = 2;
};

// Block (x, y, z): channels [128 x, 128 x + 128), K stages [y chunk, (y + 1)
// chunk), rows [MP z, MP z + MP) of x. Warp w multiplies the k16 steps w, w +
// WARPS, ... of every stage; the warps' sums are added in warp order at the end.
template <int MT>
__global__ void __launch_bounds__(Ring<MT>::THREADS, Ring<MT>::MIN_BLOCKS) qmm4_ring_kernel(
    const __grid_constant__ CUtensorMap x_map,  // [M, K] bf16, box 64 x MP
    const __grid_constant__ CUtensorMap w_map,  // [Kp, N] uint8, box 128 x 128
    const float* __restrict__ scale, float* __restrict__ out,
    float* __restrict__ part,  // [splits, M, N] when gridDim.y > 1
    int* __restrict__ tickets, // [gridDim.z * gridDim.x], zero between launches
    int M, int N, int K, int chunk) {
  using C = Ring<MT>;
  constexpr int MP = C::MP, WARPS = C::WARPS, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // stage s: the packed tile, then x panels
  float* red = reinterpret_cast<float*>(smem_raw + (ring - smem_u32(smem_raw)));  // reuses the ring
  const uint32_t bars = ring + C::BODY;
  auto full = [&](int s) { return bars + 8 * s; };
  __shared__ int is_last;

  const int n0 = blockIdx.x * D_BN, z = blockIdx.y, splits = gridDim.y, m0 = blockIdx.z * MP;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  // this thread's 16 channels: 16-byte chunk c of each packed row, chosen so
  // that a quarter warp's eight loads (rows t4, chunks of g = 2p, 2p + 1)
  // land in eight distinct chunks after the swizzle
  const int c = 4 * (g % 2) + g / 2;
  const int kt_total = (K + D_BK - 1) / D_BK;
  const int kt0 = z * chunk, n_tiles = min(chunk, kt_total - kt0);

  auto load = [&](int n) {
    const int s = n % STAGES, k0 = (kt0 + n) * D_BK;
    const uint32_t w_s = ring + s * C::STAGE_BYTES, x_s = w_s + D_W_BYTES;
    mbar_expect_tx(full(s), C::STAGE_BYTES);
    tma_load_3d(w_s, &w_map, full(s), n0, k0 / 2, 0);
#pragma unroll
    for (int p = 0; p < D_BK / 64; ++p) tma_load_3d(x_s + p * MP * 128, &x_map, full(s), k0 + 64 * p, m0, 0);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int n = 0; n < min(STAGES, n_tiles); ++n) load(n);

  // acc[j][nt]: m16 tile j (rows g, g + 8 = channels 16c + 2j and 16c + 2j + 1)
  // by n8 tile nt (rows of x 8nt + 2 t4 + {0, 1})
  float acc[8][MT][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < MT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % STAGES;
    const uint32_t w_s = ring + s * C::STAGE_BYTES, x_s = w_s + D_W_BYTES;
    mbar_wait(full(s), (n / STAGES) & 1);
#pragma unroll
    for (int step = 0; step < D_BK / 16 / WARPS; ++step) {
      const int st = warp + WARPS * step;  // k16 step of the stage: packed rows 8 st .. 8 st + 7
      const int r0 = 8 * st + t4;          // k-pairs t4 and t4 + 4 of the step
      const uint4 lo = lds128(w_s + r0 * 128 + ((c ^ t4) << 4));
      const uint4 hi = lds128(w_s + (r0 + 4) * 128 + ((c ^ (t4 + 4)) << 4));
      // B fragments: x[row][16 st + 2 t4 + {0, 1}] and [+8, +9], from the swizzled x panel
      uint32_t b[MT][2];
      const int kc = 16 * st % 64, panel = 16 * st / 64;
#pragma unroll
      for (int nt = 0; nt < MT; ++nt) {
        const int slot = 8 * nt + g;
        const uint32_t row = x_s + panel * MP * 128 + slot * 128 + 4 * t4;
        b[nt][0] = lds32(row + (((kc / 8) ^ (slot & 7)) * 16));
        b[nt][1] = lds32(row + (((kc / 8 + 1) ^ (slot & 7)) * 16));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // word q: channels 16c + 4q .. + 3, the rows of m16 tiles 2q and 2q + 1
        uint32_t pl[4], ph[4];
        word_to_bf16x2(word_of(lo, q), pl);
        word_to_bf16x2(word_of(hi, q), ph);
        const uint32_t a0[4] = {pl[0], pl[1], ph[0], ph[1]};
        const uint32_t a1[4] = {pl[2], pl[3], ph[2], ph[3]};
#pragma unroll
        for (int nt = 0; nt < MT; ++nt) {
          mma_bf16(acc[2 * q][nt], a0, b[nt][0], b[nt][1]);
          mma_bf16(acc[2 * q + 1][nt], a1, b[nt][0], b[nt][1]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && n + STAGES < n_tiles) {
      fence_proxy_async();
      load(n + STAGES);
    }
  }

  // the warps' sums, added in warp order
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int nt = 0; nt < MT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int slot = 8 * nt + 2 * t4 + (e & 1), ch = 16 * c + 2 * j + (e >> 1);
        red[(warp * MP + slot) * D_RED_STRIDE + ch] = acc[j][nt][e];
      }
  __syncthreads();
  // outputs as float4s, V a thread: channels n .. n + 3 of one row (N % 16
  // == 0 on this path, so all four are in range when n is)
  constexpr int V = MP * D_BN / 4 / C::THREADS;
  auto at = [&](int v, int& m, int& n) {
    const int e = 4 * (tid + C::THREADS * v);
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
    for (int w = 0; w < WARPS; ++w) {
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

// -- path 3: any shape, masked loads by threads --------------------------------------------

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

// -- planning and launch ----------------------------------------------------------------------

struct Plan {
  int path;
  int mt;        // masked and ring: n8 tiles of x rows a block
  int m_chunks;  // blocks along M
  int n_tiles;   // blocks along N
  int splits;    // blocks along K (1: no partials)
  int chunk;     // K tiles a split
  int tickets;   // ints of zeroed ticket scratch (0 with one split)
  int k_tile;    // contraction depth of one K tile
  int rows;      // rows of x a block
  int vec;       // masked: 16-byte weight loads and 4-byte x loads
};

constexpr int BLOCKS_PER_SM = 6;  // masked: the split target, about this many blocks resident on each SM

template <int MT>
constexpr int ring_min_blocks = Ring<MT>::MIN_BLOCKS;

Plan make_plan(const void* x, const void* w, int M, int N, int K, int sms) {
  Plan p{};
  const bool tma_ok = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                      N % 16 == 0 && K % 8 == 0 && K > 0;
  if (tma_ok && M > 64) {
    p.path = PATH_WGMMA;
    p.rows = P_BM;
    p.m_chunks = (M + P_BM - 1) / P_BM;
    p.n_tiles = (N + P_BN - 1) / P_BN;
    p.k_tile = P_BK;
    p.chunk = (K + P_BK - 1) / P_BK;
    p.splits = 1;
    return p;
  }
  p.path = tma_ok ? PATH_RING : PATH_MASKED;
  p.mt = M <= 8 ? 1 : M <= 16 ? 2 : 4;
  p.rows = 8 * p.mt;
  p.m_chunks = (M + p.rows - 1) / p.rows;
  const int bn = tma_ok ? D_BN : BN;
  p.k_tile = tma_ok ? D_BK : BK;
  p.n_tiles = (N + bn - 1) / bn;
  const int kt = (K + p.k_tile - 1) / p.k_tile;
  const long long tiles = (long long)p.m_chunks * p.n_tiles;
  long long s;
  if (tma_ok) {  // about MIN_BLOCKS blocks an SM, the f32 partials at most an eighth of the weight bytes
    const int min_blocks = p.mt == 1 ? ring_min_blocks<1> : p.mt == 2 ? ring_min_blocks<2> : ring_min_blocks<4>;
    s = (long long)min_blocks * sms / (tiles > 0 ? tiles : 1);
    const long long cap = (long long)K / (64LL * M);
    if (s > cap) s = cap;
  } else {
    s = (long long)BLOCKS_PER_SM * sms / (tiles > 0 ? tiles : 1);
  }
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

int launch_wgmma(const Plan& p, const void* x, const void* w, const void* scale, void* out, int M, int N, int K,
                 cudaStream_t stream) {
  CUtensorMap x_map, w_map;
  int e = encode_3d(&x_map, x, K, M, 1, 64, P_BM, 128);
  if (!e) e = encode_3d(&w_map, w, N, K / 2, 1, 128, P_BK / 2, 128, 1);
  if (e) return e;
  if (p.n_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qmm4_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P_SMEM);
  if (err != cudaSuccess) return (int)err;
  qmm4_wgmma_kernel<<<dim3(p.m_chunks, p.n_tiles), P_THREADS, P_SMEM, stream>>>(x_map, w_map, (const float*)scale,
                                                                                 (float*)out, M, N, K);
  return (int)cudaGetLastError();
}

template <int MT>
int launch_ring(const Plan& p, const void* x, const void* w, const void* scale, void* out, void* part, void* tickets,
                int M, int N, int K, cudaStream_t stream) {
  using C = Ring<MT>;
  CUtensorMap x_map, w_map;
  int e = encode_3d(&x_map, x, K, M, 1, 64, C::MP, 128);
  if (!e) e = encode_3d(&w_map, w, N, K / 2, 1, D_BN, D_BK / 2, 128, 1);
  if (e) return e;
  if (p.m_chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(qmm4_ring_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.n_tiles, p.splits, p.m_chunks);
  qmm4_ring_kernel<MT><<<grid, C::THREADS, C::SMEM, stream>>>(x_map, w_map, (const float*)scale, (float*)out,
                                                               (float*)part, (int*)tickets, M, N, K, p.chunk);
  return (int)cudaGetLastError();
}

template <int MT, bool VEC>
int launch_masked(const Plan& p, const void* x, const void* w, const void* scale, void* out, void* part,
                  void* tickets, int M, int N, int K, cudaStream_t stream) {
  if (p.n_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(p.m_chunks, p.n_tiles, p.splits);
  qmm_int4_kernel<MT, VEC><<<grid, THREADS, 0, stream>>>((const uint16_t*)x, (const uint8_t*)w, (const float*)scale,
                                                         (float*)out, (float*)part, (int*)tickets, M, N, K, p.chunk);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_masked_mt(const Plan& p, const void* x, const void* w, const void* scale, void* out, void* part,
                     void* tickets, int M, int N, int K, cudaStream_t stream) {
  if (p.mt == 1) return launch_masked<1, VEC>(p, x, w, scale, out, part, tickets, M, N, K, stream);
  if (p.mt == 2) return launch_masked<2, VEC>(p, x, w, scale, out, part, tickets, M, N, K, stream);
  return launch_masked<4, VEC>(p, x, w, scale, out, part, tickets, M, N, K, stream);
}

}  // namespace

// The launch's plan for x, w at M, N, K on a card of ``sms`` SMs: returns
// the rows of x a block and sets ``splits`` (``part`` must hold
// [splits, M, N] f32 when above 1), ``chunk`` (K tiles a split, each
// quantized_matmul_int4_path's ``k_tile`` deep) and ``tickets`` (ints of
// zeroed ticket scratch; every launch leaves them zero).
extern "C" int quantized_matmul_int4_plan(const void* x, const void* w, int M, int N, int K, int sms, int* splits,
                                          int* chunk, int* tickets) {
  if (M < 1 || N < 1 || K < 0 || sms < 1) return 0;
  const Plan p = make_plan(x, w, M, N, K, sms);
  *splits = p.splits;
  *chunk = p.chunk;
  *tickets = p.tickets;
  return p.rows;
}

// The path a launch on x, w at M, N, K takes (0: masked, any shape; 1: the
// decode ring; 2: TMA + wgmma) and the contraction depth of its K tiles.
extern "C" int quantized_matmul_int4_path(const void* x, const void* w, int M, int N, int K, int* k_tile) {
  const Plan p = M > 0 && N > 0 && K >= 0 ? make_plan(x, w, M, N, K, 1) : Plan{PATH_MASKED, 1, 0, 0, 1, 0, 0, BK, 8, 0};
  *k_tile = p.k_tile;
  return p.path;
}

extern "C" int quantized_matmul_int4(const void* x, const void* w, const void* scale, void* out, void* part,
                                     void* tickets, int M, int N, int K, int sms, void* stream) {
  if (M < 0 || N < 0 || K < 0 || sms < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const Plan p = make_plan(x, w, M, N, K, sms);
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.path) {
    case PATH_WGMMA: return launch_wgmma(p, x, w, scale, out, M, N, K, st);
    case PATH_RING:
      if (p.mt == 1) return launch_ring<1>(p, x, w, scale, out, part, tickets, M, N, K, st);
      if (p.mt == 2) return launch_ring<2>(p, x, w, scale, out, part, tickets, M, N, K, st);
      return launch_ring<4>(p, x, w, scale, out, part, tickets, M, N, K, st);
    default:
      return p.vec ? launch_masked_mt<true>(p, x, w, scale, out, part, tickets, M, N, K, st)
                   : launch_masked_mt<false>(p, x, w, scale, out, part, tickets, M, N, K, st);
  }
}

extern "C" const char* quantized_matmul_int4_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
