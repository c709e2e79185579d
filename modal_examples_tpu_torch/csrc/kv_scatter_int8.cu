// KV page scatter into an int8 cache for Hopper (sm_90a): quantize every
// layer's new K/V rows per (token, kv head) and write the int8 rows and their
// f32 scales into the paged cache, in place.
//
// Replaces the int8 branch of modal_examples_tpu/ops/paged_attention.py::
// _kv_scatter_kernel (entry scatter_kv_pages with QuantizedKV pages), which
// DMA'd four arrays (int8 K/V columns and their f32 scale columns, :1052-1056)
// after XLA had quantized the rows outside the pallas_call (:1011-1012).
// Here the quantization is fused into the scatter; the function is the same:
// for each (layer, token, array, kv head) row of D values, amax over D in
// f32, scale = amax / 127 (1 for an all-zero row), data = rint(x / scale)
// clipped to +-127. Both divisions are IEEE (__fdiv_rn, no reciprocal) and
// rintf rounds half to even, so the result is bitwise that of the plain
// version, which the prefix cache relies on.
//
// Bound: bytes. Each bf16 value is read once and written once as int8, plus
// one f32 scale a row. The card needs about 2 MB of loads in flight (3.35
// TB/s x ~0.6 us), some 15 KB an SM, so the design keeps many rows in
// flight rather than one: a group of `lanes` threads takes one row, each
// lane 8 values with one 16-byte load (16 lanes at D = 128, 8 at D = 64, the
// whole warp at D = 256); each group takes `rows_per_group` rows a pass and
// issues all of their loads before the first reduction; the amax is a
// shuffle reduction inside the group; each lane stores 8 bytes, so a group
// writes its int8 row contiguously, and the group's first lane its scale.
// The rows of one array are numbered (layer, token, head), head fastest, K
// before V, and a pass of a block takes groups_per_block x rows_per_group
// consecutive rows, so a warp reads and writes whole rows side by side; a
// row's (layer, token, head) comes from two divisions by a multiply-high
// (FastDivmod). The partition comes from the Python wrapper
// (ops/paged_attention.py::scatter_int8_partition, whose walk the CPU tests
// mirror): 4 rows a group where that still leaves half a wave of resident
// blocks (12 an SM at 40 registers), fewer otherwise (one layer's 512 rows
// over 64 blocks), and at most 96 blocks an SM, which stride over the rows
// (a prefill batch's 4.2 M rows in about 10 passes a block). Measured on an
// H100, a pass that loads its rows and computes (12 blocks an SM) beat
// prefetching the next pass's rows into registers (64 registers, 8 blocks),
// and 96 blocks an SM beat one wave of resident blocks striding over the
// whole batch. No shared memory, TMA or tensor cores: each value is used
// once, and staging it through shared memory would add a hop. The other
// limit is the instruction budget, above all the IEEE division: at 2048
// tokens x 32 layers there are 537 M of them, each a reciprocal on the
// special-function unit and its corrections, about as long to issue as the
// 0.49 ms byte bound, so they overlap the loads only while many rows are in
// flight. The quotient is rounded half to even to an integer by one
// conversion (__float2int_rn, rintf's rounding) rather than two.
//
// Dead or padded tokens all target page 0, slot 0: those writes race, which
// is harmless because page 0 is never attended.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_ROWS_PER_GROUP = 4;  // rows a group holds in flight in one pass
constexpr int MAXD = 256;              // 8 values a lane, 32 lanes

struct Partition {
  int lanes;             // threads of a group: a power of two, 8 * lanes >= D
  int rows_per_group;    // rows a group takes in one pass, 1..MAX_ROWS_PER_GROUP
  int groups_per_block;  // THREADS / lanes
  int blocks;            // the grid; the blocks stride over the rows
};

// n / d (so n % d too) for 0 <= n < 2^31 by a multiply-high and a shift (the
// round-up method: mul = ceil(2^(31 + ceil(log2 d)) / d)), computed once on
// the host: a row's numbering costs two of these instead of two divisions.
struct FastDivmod {
  unsigned d, mul, shr;
  static FastDivmod of(unsigned d) {
    unsigned log2 = 0;
    while ((1u << log2) < d) ++log2;
    if (d == 1) return {1u, 0u, 0u};
    return {d, (unsigned)(((1ull << (31 + log2)) + d - 1) / d), log2 - 1};
  }
  __device__ __forceinline__ unsigned div(unsigned n) const { return d == 1 ? n : __umulhi(n, mul) >> shr; }
};

__device__ __forceinline__ float group_max(float x, int lanes) {
  for (int off = lanes / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ uint32_t quantize4(uint32_t lo, uint32_t hi, float scale) {
  // 4 bf16 values (two words, lowest first) -> 4 int8 in one word; bf16 -> f32
  // is exact: the bits, shifted
  const float v[4] = {__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u),
                      __uint_as_float(hi << 16), __uint_as_float(hi & 0xffff0000u)};
  uint32_t out = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    // the IEEE quotient rounded half to even to an integer in one conversion
    // (rintf's rounding, bitwise the same on every finite quotient), clipped
    const int q = min(max(__float2int_rn(__fdiv_rn(v[e], scale)), -127), 127);
    out |= ((uint32_t)q & 0xffu) << (8 * e);
  }
  return out;
}

__device__ __forceinline__ float abs_max8(uint4 r) {
  float m = 0.f;
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    m = fmaxf(m, fmaxf(fabsf(__uint_as_float(w[i] << 16)), fabsf(__uint_as_float(w[i] & 0xffff0000u))));
  return m;
}

__global__ void __launch_bounds__(THREADS, 12) kv_scatter_int8_kernel(
    int8_t* __restrict__ k_pages,               // [L, P, ps, Hkv, D]
    int8_t* __restrict__ v_pages,
    float* __restrict__ k_scales,               // [L, P, ps, Hkv]
    float* __restrict__ v_scales,
    const __nv_bfloat16* __restrict__ k_new,    // [L, N, Hkv, D]
    const __nv_bfloat16* __restrict__ v_new,
    const int* __restrict__ page_idx,           // [N]
    const int* __restrict__ slot,               // [N]
    int P, int ps, int D, unsigned per_array,   // per_array = L * N * Hkv: K rows, then as many V rows
    FastDivmod by_heads, FastDivmod by_tokens, Partition part) {
  const unsigned rows = 2u * per_array;
  const int group = threadIdx.x / part.lanes, lane = threadIdx.x % part.lanes;
  const int d = 8 * lane;  // this lane's 8 values of a row
  const unsigned block_rows = (unsigned)(part.groups_per_block * part.rows_per_group);
  for (unsigned start = blockIdx.x * block_rows; start < rows; start += (unsigned)part.blocks * block_rows) {
    // every load of the pass goes out before its first reduction
    uint4 raw[MAX_ROWS_PER_GROUP];
#pragma unroll
    for (int j = 0; j < MAX_ROWS_PER_GROUP; ++j) {
      const unsigned row = start + (unsigned)(j * part.groups_per_block + group);
      raw[j] = make_uint4(0u, 0u, 0u, 0u);
      if (j < part.rows_per_group && row < rows && d < D) {
        const bool is_v = row >= per_array;
        const size_t r = is_v ? row - per_array : row;
        raw[j] = __ldg(reinterpret_cast<const uint4*>((is_v ? v_new : k_new) + r * D + d));
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_ROWS_PER_GROUP; ++j) {
      if (j >= part.rows_per_group) continue;  // uniform over the block
      // every lane of the warp takes part in the shuffles, live row or not
      const float amax = group_max(abs_max8(raw[j]), part.lanes);
      const unsigned row = start + (unsigned)(j * part.groups_per_block + group);
      if (row >= rows) continue;
      const bool is_v = row >= per_array;
      const unsigned r = is_v ? row - per_array : row;
      const unsigned t = by_heads.div(r), h = r - t * by_heads.d;  // t = layer * N + n
      const unsigned layer = by_tokens.div(t), n = t - layer * by_tokens.d;
      const size_t dst = (((size_t)layer * P + __ldg(page_idx + n)) * ps + __ldg(slot + n)) * by_heads.d + h;
      const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
      if (d < D) {
        const uint2 q = make_uint2(quantize4(raw[j].x, raw[j].y, scale), quantize4(raw[j].z, raw[j].w, scale));
        *reinterpret_cast<uint2*>((is_v ? v_pages : k_pages) + dst * D + d) = q;
      }
      if (lane == 0) (is_v ? v_scales : k_scales)[dst] = scale;
    }
  }
}

}  // namespace

// The block size the Python partition assumes.
extern "C" int kv_scatter_int8_threads() { return THREADS; }

extern "C" int kv_scatter_int8(void* k_pages, void* v_pages, void* k_scales, void* v_scales,
                               const void* k_new, const void* v_new, const void* page_idx,
                               const void* slot, int L, int N, int P, int ps, int Hkv, int D,
                               int lanes, int rows_per_group, int groups_per_block, int blocks,
                               void* stream) {
  const long long per_array = (long long)L * N * Hkv;
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 && 8 * lanes >= D;
  if (D <= 0 || D > MAXD || D % 8 != 0 || Hkv <= 0 || !lanes_ok || lanes * groups_per_block != THREADS ||
      rows_per_group < 1 || rows_per_group > MAX_ROWS_PER_GROUP || 2 * per_array >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (N == 0 || L == 0) return (int)cudaSuccess;
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  const Partition part{lanes, rows_per_group, groups_per_block, blocks};
  kv_scatter_int8_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (int8_t*)k_pages, (int8_t*)v_pages, (float*)k_scales, (float*)v_scales,
      (const __nv_bfloat16*)k_new, (const __nv_bfloat16*)v_new, (const int*)page_idx, (const int*)slot, P, ps, D,
      (unsigned)per_array, FastDivmod::of((unsigned)Hkv), FastDivmod::of((unsigned)N), part);
  return (int)cudaGetLastError();
}

extern "C" const char* kv_scatter_int8_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
