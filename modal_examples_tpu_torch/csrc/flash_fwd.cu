// Flash attention forward for Hopper (sm_90a): blockwise causal or full
// attention with an online softmax, GQA, and a query offset for a prompt
// chunk attending to a longer K/V.
//
// Replaces modal_examples_tpu/ops/flash_attention.py::_fwd_kernel (driven by
// _flash_forward; entries flash_attention, flash_attention_with_lse,
// flash_attention_chunked). The TPU kernel carried m, l and acc in VMEM
// scratch across a sequential k-block grid axis; Hopper blocks run in no
// order, so here one block owns a (batch, query head, 128-row query tile) and
// loops over the key tiles itself, up to the causal limit: key tiles wholly
// past the tile's last query position are never loaded, as on the TPU.
//
// Bound: operations at prefill lengths (4*S*Skv*D/2 FLOPs against
// 2*(S+Skv)*D*2 bytes per head). The design follows from that:
// - Both products run on the tensor cores as warpgroup MMAs (wgmma, bf16 in,
//   f32 sums). Two consumer warpgroups own 64 query rows each.
//   S = Q.K^T: m64n{BK}k16 with Q and K read from shared memory (K-major).
//   O += P.V: m64n{D}k16 with P from registers (the f32 scores' fragment is
//   the A operand's fragment, rounded to bf16 as PyTorch's flash kernel
//   does) and V from shared memory read MN-major (tnspB).
// - Tiles arrive by TMA (hopper.cuh) in the 128-byte swizzle the descriptors
//   read: Q once, K and V through a ring of STAGES stages, each with a "full"
//   mbarrier (completed by the TMA bytes) and an "empty" one (every consumer
//   thread arrives when its products on the stage are done). One thread
//   issues the loads; the tile after the one being multiplied is in flight.
//   Shared memory holds bf16 only: D=128 takes Q 32 KB + 2 x (K 32 + V 32) KB.
// - The tensor maps are 3-D over [B*H, S, D]: rows past S (or Skv) of one
//   head read as zeros, never the next head's rows.
// - The online softmax stays in the accumulator's registers: each thread
//   holds two rows; row max and sum reduce over the 4 threads of a row with
//   shuffles. Scores are scaled by sm_scale*log2(e) and exponentiated with
//   exp2f; l sums the f32 probabilities before their rounding to bf16.
// - Causal: only key tiles the diagonal crosses (or the ragged end of Skv)
//   are masked; with q_offset a multiple of 16 that can be two tiles. A
//   warpgroup skips the products of a tile wholly past its last row. The
//   grid launches the heaviest query tiles (the last ones) first.
// - A warpgroup waits for each of its products before it goes on; the other
//   warpgroup's products fill the tensor cores meanwhile. On an H100, issuing
//   Q.K_{j+1}^T ahead to overlap the softmax with P_j.V_j inside one
//   warpgroup was slower (and took more registers); a producer warpgroup
//   with setmaxnreg, FA3's ping-pong of the two warpgroups and a 3-stage ring
//   were no faster.
//
// Numerics: q is not scaled before Q.K^T (the TPU kernel scales it in f32);
// the f32 sums are scaled instead, which differs by f32 rounding. o is
// rounded to bf16 once at the end, and lse = m + log(l) is written per row.
// A row with no visible key gets zeros and lse = -inf.
#include "hopper.cuh"

#include <math.h>

namespace {

using namespace hopper;

constexpr int THREADS = 256;  // two consumer warpgroups
constexpr int BQ = 128;       // query rows per block, 64 per warpgroup
constexpr int STAGES = 2;     // K/V ring depth

template <int D>
struct Cfg {
  static constexpr int SW = D >= 64 ? 128 : 64;  // swizzle span: the bytes of one panel row
  static constexpr int PW = SW / 2;              // bf16 columns per panel
  static constexpr int NP = D / PW;              // panels per tile
  static constexpr int BK = D <= 128 ? 128 : 64;  // key rows per tile (64 at D=256, to fit)
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;  // one of K, V
  static constexpr uint32_t BAR_BYTES = 8 * (2 * STAGES + 1);
  // 1024 of slack to align the tiles; then Q, the ring, the barriers
  static constexpr uint32_t SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + BAR_BYTES;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap q_map,  // [B*Hq, S, D]
    const __grid_constant__ CUtensorMap k_map,  // [B*Hkv, Skv, D]
    const __grid_constant__ CUtensorMap v_map,
    __nv_bfloat16* __restrict__ o,  // [B, Hq, S, D]
    float* __restrict__ lse,        // [B, Hq, S]
    int Hq, int Hkv, int S, int Skv, int q_offset, int causal, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, SW = C::SW, PW = C::PW, NP = C::NP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = q_s + C::Q_BYTES;  // stage s: K at ring + 2s*KV_BYTES, V after it
  const uint32_t bars = ring + STAGES * 2 * C::KV_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t q_bar = bars + 16 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int q_plane = b * Hq + hq, kv_plane = b * Hkv + hq / (Hq / Hkv);
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int kv_end = causal ? min(Skv, q_offset + min(q0 + BQ, S)) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  auto load_kv = [&](int n) {
    const int s = n % STAGES;
    const uint32_t k_s = ring + 2 * s * C::KV_BYTES, v_s = k_s + C::KV_BYTES;
    mbar_expect_tx(full(s), 2 * C::KV_BYTES);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tma_load_3d(k_s + p * BK * SW, &k_map, full(s), p * PW, n * BK, kv_plane);
      tma_load_3d(v_s + p * BK * SW, &v_map, full(s), p * PW, n * BK, kv_plane);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), THREADS);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
    for (int p = 0; p < NP; ++p) tma_load_3d(q_s + p * BQ * SW, &q_map, q_bar, p * PW, q0, q_plane);
    for (int n = 0; n < min(STAGES, n_tiles); ++n) load_kv(n);
  }
  __syncwarp();

  // this thread's rows: r and r + 8 of its warpgroup's 64
  const int r = warp * 16 + lane / 4;
  const int wg_first = q_offset + q0 + wg * 64;  // query positions of the warpgroup's rows
  const int pos[2] = {wg_first + r, wg_first + r + 8};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES, k0 = j * BK;
    const uint32_t k_s = ring + 2 * s * C::KV_BYTES, v_s = k_s + C::KV_BYTES;
    mbar_wait(full(s), (j / STAGES) & 1);
    if (!causal || k0 <= wg_first + 63) {
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t panel = kk / (PW / 16), step = (kk % (PW / 16)) * 32;
        const uint64_t da = make_desc(q_s + panel * BQ * SW + wg * 64 * SW + step, 16, 8 * SW, SW);
        const uint64_t db = make_desc(k_s + panel * BK * SW + step, 16, 8 * SW, SW);
        Wgmma<BK>::ss(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const bool masked = (causal && k0 + BK - 1 > wg_first) || k0 + BK > Skv;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = k0 + 8 * jj + 2 * (lane % 4) + c;
            float x = sc[4 * jj + 2 * h + c] * scale_log2;
            if (masked && (col >= Skv || (causal && col > pos[h]))) x = -INFINITY;
            sc[4 * jj + 2 * h + c] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[h] - m_use);  // 0 while m is -inf
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(sc[4 * jj + 2 * h + c] - m_use);
            sc[4 * jj + 2 * h + c] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[h] = l[h] * alpha + sum;
        m[h] = m_new;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          acc[4 * jj + 2 * h] *= alpha;
          acc[4 * jj + 2 * h + 1] *= alpha;
        }
      }

      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(sc, kk, pa[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = make_desc(v_s + kk * 16 * SW, BK * SW, 8 * SW, SW);
        Wgmma<D>::rs(acc, pa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    mbar_arrive(empty(s));
    if (tid == 0 && j + STAGES < n_tiles) {
      mbar_wait(empty(s), (j / STAGES) & 1);  // every thread is done with stage s
      load_kv(j + STAGES);
    }
    __syncwarp();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wg * 64 + r + 8 * h;
    if (row >= S) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    __nv_bfloat16* out = o + ((size_t)q_plane * S + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * h] * inv, acc[4 * jj + 2 * h + 1] * inv);
    if (lane % 4 == 0)
      lse[(size_t)q_plane * S + row] = l[h] > 0.f ? (m[h] + log2f(l[h])) * LN2 : -INFINITY;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Hq, int Hkv, int S, int Skv, int q_offset, int causal,
           float sm_scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap q_map, k_map, v_map;
  int e = encode_3d(&q_map, q, D, S, B * Hq, C::PW, BQ, C::SW);
  // with no keys nothing is loaded; the maps only need to be valid
  const int kv_rows = Skv > 0 ? Skv : 1;
  if (!e) e = encode_3d(&k_map, Skv > 0 ? k : q, D, kv_rows, B * Hkv, C::PW, C::BK, C::SW);
  if (!e) e = encode_3d(&v_map, Skv > 0 ? v : q, D, kv_rows, B * Hkv, C::PW, C::BK, C::SW);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, THREADS, C::SMEM, stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)o, (float*)lse, Hq, Hkv, S, Skv, q_offset, causal,
      sm_scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Hq, int Hkv, int S, int Skv,
                         int D, int q_offset, int causal, float sm_scale,
                         void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lse, B, Hq, Hkv, S, Skv, q_offset, causal, sm_scale, st);
    case 64: return launch<64>(q, k, v, o, lse, B, Hq, Hkv, S, Skv, q_offset, causal, sm_scale, st);
    case 128: return launch<128>(q, k, v, o, lse, B, Hq, Hkv, S, Skv, q_offset, causal, sm_scale, st);
    case 256: return launch<256>(q, k, v, o, lse, B, Hq, Hkv, S, Skv, q_offset, causal, sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
