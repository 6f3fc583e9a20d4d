// Routed (mixture-of-experts) MLP for Hopper (sm_90a): every token through
// its own top-k experts only, bf16 weights straight into the tensor cores.
//
// Replaces no TPU kernel. The reference (src/repro/models/moe.py) dispatches
// and combines through one-hot einsums that XLA compiles; the port's plain
// version (models/moe.py `expert_mix`) runs every expert over every row in
// f32 after upcasting each expert's bf16 matrices, which on the card spent
// ~94% of a mixtral serving step in upcast copies and CUDA-core SGEMMs. It
// was added for that.
//
// What bounds it. Per (token, expert) pair the MLP is
//   h = silu(x Wg_e) * (x Wu_e)     (f values, f32),   y = w h Wd_e (d, f32)
// and a token's output sums its pairs' y in ascending expert order. At the
// serving shapes an expert sees 8 (decode, 32 slots, top-2 of 8) to ~64 rows
// (a 256-token prefill), 8-64 operations a weight byte against the card's
// ~295: a call is bound by reading every expert's three matrices once
// (mixtral: 8 x 3 x 4096 x 14336 x 2 B = 2.82 GB, 0.84 ms at 3.35 TB/s).
//
// Design. One C call launches four kernels on the caller's stream:
//   1. moe_dispatch_kernel, one block an expert: the expert's kept pairs in
//      token-major order (a stable counting sort: a pass counting the pairs
//      of lower experts, then ballots and warp prefix sums place each pair),
//      its offset and row count, each pair's token, gate weight and slot.
//      Nothing goes back to the host: the grids below are sized from host
//      bounds and each block reads its own work from these offsets.
//   2. moe_gate_up_kernel, grid (row tiles, f / 128): 64 rows of one expert
//      (gathered x rows) by 128 columns; A (64 x 64 bf16) and the Wg and Wu
//      tiles (64 x 128 bf16 each) stream through a 4-stage cp.async ring; 8
//      warps each hold 32 rows by 32 columns of G and of U in
//      mma.sync.m16n8k16 bf16 fragments (one A fragment feeds both). The
//      epilogue forms h = silu(G) U in f32 and stores it split exactly into
//      three bf16 planes, h = hi + mid + lo (each part the top 8 significant
//      bits of what the parts before it left: 24 bits in all), once per
//      element rather than once per down tile that reads it.
//   3. moe_down_kernel, grid (row tiles, d / 128): the three planes of h
//      rows by Wd tiles (64 x 128 bf16), a 3-stage ring; each plane's A
//      fragment meets the same Wd fragment, so no product is rounded. Tiles
//      of 32 rows for decode (two blocks an SM, every weight streams once at
//      up to 32 slots) or 128 for prompts (an expert's rows in one tile at a
//      256-token prompt). The epilogue scales the row by its gate weight.
//   4. moe_combine_kernel, one block a token: its kept pairs' rows added in
//      ascending expert order from 0 in f32, cast once to bf16. No atomics.
// In a tile, row fragments are dealt to the warps in turn, and those past
// the expert's rows are zero-filled and skipped. mma.sync and cp.async
// rather than wgmma and TMA: decode, most of the calls, streams the weights
// at the card's bandwidth with them already; prompts are where wgmma would
// pay.
//
// Precision and batch invariance. bf16 x bf16 products are exact in f32, so
// both products are the plain version's f32 products on upcast operands,
// summed in another order. Every output element is a sum over K in one
// fixed order: 16-deep tensor-core steps into a fresh f32 accumulator for
// each 64-deep stage (the tensor cores' accumulation truncates, so a long
// chain in one accumulator would drift), each stage's partial then added to
// the running sum in round-to-nearest. Tiles, K depth and K order never
// depend on the row count, and no K is split, so a row's bits are the same
// whatever rows share its expert, its tile or the call. The split of h is
// exact for |h| >= 2^-110 and 0; below that the part under 2^-133 (bf16's
// least subnormal) is dropped.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; one mixtral layer, the four
// kernels by CUDA events): decode at 8 and 32 slots 0.87 / 1.00 ms against
// the 0.84 ms bound; a 256-token prompt 2.19 ms (issuing the products, not
// the bytes, bounds it there); PERF.md has the table.
//
// Interface: x (T, d) bf16, Wg and Wu (E, d, f) bf16, Wd (E, f, d) bf16,
// topk_i (T, k) int64, topk_p (T, k) f32, keep (T, k) bool or NULL (every
// pair kept), all contiguous; d and f multiples of 128. Scratch from the
// wrapper: h (3, T k, f) bf16, y (T k, d) f32, the dispatch's arrays.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kBK = 64;            // K depth of a stage (one f32 partial)
constexpr int kNF = 4;             // n8 column groups of a warp (32 columns)
constexpr int kMaxK = 16;          // experts a token may pick
constexpr int kDownBN = 128;

// shared-memory rows, padded by 16 bytes so that the 8 rows an ldmatrix or
// a fragment load reads fall on distinct banks
constexpr int kALd = kBK + 8;      // A tile (bf16)
__host__ __device__ constexpr int b_ld(int bn) { return bn + 8; }

// Tiles. A warp holds 32 columns and kMF row fragments of 16, interleaved
// with the other warps' along the rows (fragment i of warp row wm holds rows
// (i kWarpRows + wm) 16 ...), so a tile that is part full keeps every warp
// busy. Gate/up tiles are 64 rows by 128 columns; down tiles 32 rows (one
// token a sequence: decode) or 128 (prompts), by 128 columns. The K order is
// the same in every tile, so the choice never changes a bit of the output.
struct GateUp {
  static constexpr int kBM = 64, kBN = 128;
  static constexpr int kWarpCols = kBN / (8 * kNF);          // 4
  static constexpr int kWarpRows = 2;
  static constexpr int kMF = kBM / 16 / kWarpRows;           // 2
  static constexpr int kStages = 4;
  static constexpr int kABytes = kBM * kALd * 2;
  static constexpr int kBBytes = kBK * b_ld(kBN) * 2;
  static constexpr int kRowsBytes = kBM * 4;   // the tile's token indices
  static constexpr int kStage = kABytes + 2 * kBBytes;
  static constexpr int kSmem = kRowsBytes + kStages * kStage;
};
template <int BM>
struct Down {
  static constexpr int kWarpCols = kDownBN / (8 * kNF);      // 4
  static constexpr int kWarpRows = 2;
  static constexpr int kMF = BM / 16 / kWarpRows;
  static constexpr int kStages = 3;
  static constexpr int kPlaneBytes = BM * kALd * 2;          // hi, mid, lo
  static constexpr int kABytes = 3 * kPlaneBytes;
  static constexpr int kBBytes = kBK * b_ld(kDownBN) * 2;
  static constexpr int kStage = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStage;
};

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8 x 8 tiles of 16-bit values, one row address per lane (lanes 8m to
// 8m + 7 give tile m's rows); register m gets tile m. Plain: lane (g, t)
// holds row g, columns 2t and 2t + 1; transposed: rows 2t and 2t + 1 of
// column g. Low half first.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* row) {
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(row)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(row)));
}

// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32. Not
// volatile: a function of its registers, which the compiler may schedule
// among the fragment loads.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of one 16-deep step for a warp's four n8 column groups:
// two transposed ldmatrix of the row-major (K x N) tile; b[j][0] holds k 0-7,
// b[j][1] k 8-15 of column group j.
template <int BLd>
__device__ __forceinline__ void load_b(uint32_t (&b)[kNF][2], const bf16* bs,
                                       int k0, int n0, int lane) {
  const int m = lane >> 3;
#pragma unroll
  for (int h = 0; h < kNF / 2; ++h) {
    uint32_t r[4];
    ldmatrix4<true>(r, bs + (k0 + (m & 1) * 8 + (lane & 7)) * BLd + n0 +
                           16 * h + (m >> 1) * 8);
    b[2 * h][0] = r[0];
    b[2 * h][1] = r[1];
    b[2 * h + 1][0] = r[2];
    b[2 * h + 1][1] = r[3];
  }
}

// v = hi + mid + lo exactly: each part the top 16 bits (a bf16) of what the
// parts before it left; each subtraction is exact (Sterbenz). Two
// neighbouring values, packed as bf16 pairs (the first in the low half).
__device__ __forceinline__ void split_pair(float2 v, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const uint32_t x = __float_as_uint(v.x), y = __float_as_uint(v.y);
  const float rx = v.x - __uint_as_float(x & 0xffff0000u);
  const float ry = v.y - __uint_as_float(y & 0xffff0000u);
  const uint32_t mx = __float_as_uint(rx), my = __float_as_uint(ry);
  const float lx = rx - __uint_as_float(mx & 0xffff0000u);
  const float ly = ry - __uint_as_float(my & 0xffff0000u);
  hi = __byte_perm(x, y, 0x7632);
  mid = __byte_perm(mx, my, 0x7632);
  lo = __byte_perm(__float_as_uint(lx), __float_as_uint(ly), 0x7632);
}

struct Tile {
  int expert, row0, rows;
};

// Row tile `slot` of the grid: the experts' tiles in expert order, each
// expert ceil(count / BM) of them. False past the last.
template <int BM>
__device__ __forceinline__ bool find_tile(const int* offsets, int E, int slot,
                                          Tile& t) {
  for (int e = 0; e < E; ++e) {
    const int start = offsets[e], n = offsets[e + 1] - start;
    const int tiles = (n + BM - 1) / BM;
    if (slot < tiles) {
      t.expert = e;
      t.row0 = start + slot * BM;
      t.rows = min(BM, n - slot * BM);
      return true;
    }
    slot -= tiles;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
moe_dispatch_kernel(const long long* __restrict__ topk_i,
                    const float* __restrict__ topk_p,
                    const unsigned char* __restrict__ keep, int pairs, int k,
                    int E, int* __restrict__ offsets, int* __restrict__ counts,
                    int* __restrict__ tok, float* __restrict__ gate,
                    int* __restrict__ slot_of) {
  __shared__ int warp_n[kThreads / 32];
  const int e = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int lower = 0;        // kept pairs of experts below e
  for (int base = 0; base < pairs; base += kThreads) {
    const int q = base + threadIdx.x;
    const bool in = q < pairs && (keep == nullptr || keep[q]) &&
                    topk_i[q] < e;
    lower += __syncthreads_count(in);
  }
  int placed = 0;
  for (int base = 0; base < pairs; base += kThreads) {
    const int q = base + threadIdx.x;
    const bool kept = q < pairs && (keep == nullptr || keep[q]);
    const bool mine = kept && topk_i[q] == e;
    const unsigned m = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int before = placed, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      before += w < warp ? warp_n[w] : 0;
      total += warp_n[w];
    }
    if (mine) {
      const int pos = lower + before + __popc(m & ((1u << lane) - 1u));
      tok[pos] = q / k;
      gate[pos] = topk_p[q];
      slot_of[q] = pos;
    }
    if (e == 0 && q < pairs && !kept) slot_of[q] = -1;
    placed += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    offsets[e] = lower;
    counts[e] = placed;
    if (e == E - 1) offsets[E] = lower + placed;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
moe_gate_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                   const bf16* __restrict__ wu,
                   const int* __restrict__ offsets,
                   const int* __restrict__ tok, bf16* __restrict__ h3,
                   int pairs, int E, int d, int f) {
  using C = GateUp;
  constexpr int BM = C::kBM, BN = C::kBN, kMF = C::kMF, kBLd = b_ld(BN);
  Tile t;
  if (!find_tile<BM>(offsets, E, blockIdx.x, t)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  int* rows = reinterpret_cast<int*>(smem);
  unsigned char* stages = smem + C::kRowsBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::kWarpCols, wn = warp % C::kWarpCols;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.y * BN;
  auto frag_row = [&](int i) { return (i * C::kWarpRows + wm) * 16; };
  for (int r = tid; r < BM; r += kThreads)
    rows[r] = r < t.rows ? tok[t.row0 + r] : -1;
  __syncthreads();
  const size_t wofs = (size_t)t.expert * d * f;
  const bf16* wge = wg + wofs;
  const bf16* wue = wu + wofs;
  const int KT = d / kBK;

  auto stage_a = [&](int s) {
    return reinterpret_cast<bf16*>(stages + s * C::kStage);
  };
  auto stage_b = [&](int s, int which) {
    return reinterpret_cast<bf16*>(stages + s * C::kStage + C::kABytes +
                                   which * C::kBBytes);
  };
  auto load = [&](int s, int kt) {
    bf16* as = stage_a(s);
    for (int i = tid; i < BM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = i % (kBK / 8);
      const int row = rows[r];
      const bf16* src = row >= 0 ? x + (size_t)row * d + kt * kBK + c * 8 : x;
      cp_async16(as + r * kALd + c * 8, src, row >= 0 ? 16 : 0);
    }
    bf16* bg = stage_b(s, 0);
    bf16* bu = stage_b(s, 1);
    for (int i = tid; i < kBK * (BN / 8); i += kThreads) {
      const int r = i / (BN / 8), c = i % (BN / 8);
      const size_t off = (size_t)(kt * kBK + r) * f + n0 + c * 8;
      cp_async16(bg + r * kBLd + c * 8, wge + off, 16);
      cp_async16(bu + r * kBLd + c * 8, wue + off, 16);
    }
  };

  float sg[kMF][kNF][4], su[kMF][kNF][4];
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) sg[i][j][v] = su[i][j][v] = 0.f;
  bool active[kMF];
#pragma unroll
  for (int i = 0; i < kMF; ++i) active[i] = frag_row(i) < t.rows;

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();
    const int next = kt + C::kStages - 1;
    if (next < KT) load(next % C::kStages, next);
    cp_async_commit();
    const int s = kt % C::kStages;
    const bf16* as = stage_a(s);
    const bf16* bg = stage_b(s, 0);
    const bf16* bu = stage_b(s, 1);
    float pg[kMF][kNF][4], pu[kMF][kNF][4];
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) pg[i][j][v] = pu[i][j][v] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t bgf[kNF][2], buf[kNF][2];
      load_b<kBLd>(bgf, bg, ks * 16, wn * 8 * kNF, lane);
      load_b<kBLd>(buf, bu, ks * 16, wn * 8 * kNF, lane);
#pragma unroll
      for (int i = 0; i < kMF; ++i) {
        if (!active[i]) continue;
        uint32_t a[4];
        const int m = lane >> 3;
        ldmatrix4<false>(a, as + (frag_row(i) + (m & 1) * 8 + (lane & 7)) *
                                     kALd + ks * 16 + (m >> 1) * 8);
#pragma unroll
        for (int j = 0; j < kNF; ++j) {
          mma(pg[i][j], a, bgf[j][0], bgf[j][1]);
          mma(pu[i][j], a, buf[j][0], buf[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          sg[i][j][v] += pg[i][j][v];
          su[i][j][v] += pu[i][j][v];
        }
  }
  cp_async_wait<0>();

  // h = silu(G) U, as the plain version's F.silu(G) * U, stored as its
  // exact three bf16 parts (planes hi, mid, lo), the down kernel's A
  const size_t plane = (size_t)pairs * f;
#pragma unroll
  for (int i = 0; i < kMF; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = frag_row(i) + g + 8 * half;
      if (r >= t.rows) continue;
      bf16* hrow = h3 + (size_t)(t.row0 + r) * f + n0 + wn * 8 * kNF + 2 * tq;
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        const float g0 = sg[i][j][2 * half], g1 = sg[i][j][2 * half + 1];
        float2 v;
        v.x = g0 / (1.0f + expf(-g0)) * su[i][j][2 * half];
        v.y = g1 / (1.0f + expf(-g1)) * su[i][j][2 * half + 1];
        uint32_t hi, mid, lo;
        split_pair(v, hi, mid, lo);
        *reinterpret_cast<uint32_t*>(hrow + 8 * j) = hi;
        *reinterpret_cast<uint32_t*>(hrow + plane + 8 * j) = mid;
        *reinterpret_cast<uint32_t*>(hrow + 2 * plane + 8 * j) = lo;
      }
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads, BM <= 32 ? 2 : 1)
moe_down_kernel(const bf16* __restrict__ h3, const bf16* __restrict__ wd,
                const int* __restrict__ offsets,
                const float* __restrict__ gate, float* __restrict__ y,
                int pairs, int E, int d, int f) {
  using C = Down<BM>;
  constexpr int kMF = C::kMF, kBLd = b_ld(kDownBN);
  Tile t;
  if (!find_tile<BM>(offsets, E, blockIdx.x, t)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::kWarpCols, wn = warp % C::kWarpCols;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.y * kDownBN;
  auto frag_row = [&](int i) { return (i * C::kWarpRows + wm) * 16; };
  const bf16* wde = wd + (size_t)t.expert * f * d;
  const size_t plane = (size_t)pairs * f;
  const bf16* hrows = h3 + (size_t)t.row0 * f;
  const int KT = f / kBK;

  auto stage_a = [&](int s, int part) {
    return reinterpret_cast<bf16*>(smem + s * C::kStage +
                                   part * C::kPlaneBytes);
  };
  auto stage_b = [&](int s) {
    return reinterpret_cast<bf16*>(smem + s * C::kStage + C::kABytes);
  };
  auto load = [&](int s, int kt) {
    for (int i = tid; i < 3 * BM * (kBK / 8); i += kThreads) {
      const int part = i / (BM * (kBK / 8)), rc = i % (BM * (kBK / 8));
      const int r = rc / (kBK / 8), c = rc % (kBK / 8);
      const bool in = r < t.rows;
      const bf16* src =
          in ? hrows + part * plane + (size_t)r * f + kt * kBK + c * 8 : h3;
      cp_async16(stage_a(s, part) + r * kALd + c * 8, src, in ? 16 : 0);
    }
    bf16* bs = stage_b(s);
    for (int i = tid; i < kBK * (kDownBN / 8); i += kThreads) {
      const int r = i / (kDownBN / 8), c = i % (kDownBN / 8);
      cp_async16(bs + r * kBLd + c * 8,
                 wde + (size_t)(kt * kBK + r) * d + n0 + c * 8, 16);
    }
  };

  float sy[kMF][kNF][4];
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) sy[i][j][v] = 0.f;
  bool active[kMF];
#pragma unroll
  for (int i = 0; i < kMF; ++i) active[i] = frag_row(i) < t.rows;

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();
    const int next = kt + C::kStages - 1;
    if (next < KT) load(next % C::kStages, next);
    cp_async_commit();
    const int s = kt % C::kStages;
    const bf16* bs = stage_b(s);
    float py[kMF][kNF][4];
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) py[i][j][v] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t bf[kNF][2];
      load_b<kBLd>(bf, bs, ks * 16, wn * 8 * kNF, lane);
#pragma unroll
      for (int i = 0; i < kMF; ++i) {
        if (!active[i]) continue;
        const int m = lane >> 3;
        const int at = (frag_row(i) + (m & 1) * 8 + (lane & 7)) * kALd +
                       ks * 16 + (m >> 1) * 8;
        // lo, mid, hi: each part meets the same Wd fragment
#pragma unroll
        for (int part = 2; part >= 0; --part) {
          uint32_t a[4];
          ldmatrix4<false>(a, stage_a(s, part) + at);
#pragma unroll
          for (int j = 0; j < kNF; ++j) mma(py[i][j], a, bf[j][0], bf[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) sy[i][j][v] += py[i][j][v];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kMF; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = frag_row(i) + g + 8 * half;
      if (r >= t.rows) continue;
      const float w = gate[t.row0 + r];
      float* yrow = y + (size_t)(t.row0 + r) * d + n0 + wn * 8 * kNF + 2 * tq;
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        float2 v;
        v.x = w * sy[i][j][2 * half];
        v.y = w * sy[i][j][2 * half + 1];
        *reinterpret_cast<float2*>(yrow + 8 * j) = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
moe_combine_kernel(const float* __restrict__ y,
                   const int* __restrict__ slot_of,
                   const long long* __restrict__ topk_i, int k, int d,
                   bf16* __restrict__ out) {
  const int tkn = blockIdx.x;
  // the token's kept pairs, in ascending expert order
  int slot[kMaxK];
  long long ex[kMaxK];
  int n = 0;
  for (int j = 0; j < k; ++j) {
    const int s = slot_of[tkn * k + j];
    if (s < 0) continue;
    const long long e = topk_i[tkn * k + j];
    int at = n++;
    while (at > 0 && ex[at - 1] > e) {
      ex[at] = ex[at - 1];
      slot[at] = slot[at - 1];
      --at;
    }
    ex[at] = e;
    slot[at] = s;
  }
  for (int c = threadIdx.x * 4; c < d; c += kThreads * 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < n; ++j) {
      const float4 v =
          *reinterpret_cast<const float4*>(y + (size_t)slot[j] * d + c);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    __nv_bfloat162* o =
        reinterpret_cast<__nv_bfloat162*>(out + (size_t)tkn * d + c);
    o[0] = __floats2bfloat162_rn(acc.x, acc.y);
    o[1] = __floats2bfloat162_rn(acc.z, acc.w);
  }
}

int set_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int row_tiles(int pairs, int E, int bm) {
  return (pairs + E * (bm - 1)) / bm;
}

// The gate/up kernel, then the down kernel of DM-row tiles.
template <int DM>
int launch_products(const void* x, const void* wg, const void* wu,
                    const void* wd, const int* off, const int* tok,
                    const float* gate, bf16* h3, float* y, int pairs, int E,
                    int d, int f, cudaStream_t s) {
  using G = GateUp;
  using D = Down<DM>;
  int e = set_smem((const void*)moe_gate_up_kernel, G::kSmem);
  if (e) return e;
  moe_gate_up_kernel<<<dim3(row_tiles(pairs, E, G::kBM), f / G::kBN),
                       kThreads, G::kSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
      static_cast<const bf16*>(wu), off, tok, h3, pairs, E, d, f);
  e = (int)cudaGetLastError();
  if (!e) e = set_smem((const void*)moe_down_kernel<DM>, D::kSmem);
  if (e) return e;
  moe_down_kernel<DM>
      <<<dim3(row_tiles(pairs, E, DM), d / kDownBN), kThreads, D::kSmem, s>>>(
          h3, static_cast<const bf16*>(wd), off, gate, y, pairs, E, d, f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The column multiple the kernels take for d and f, and the most experts
// a token may pick.
int moe_mlp_col_multiple() { return 128; }
int moe_mlp_max_k() { return kMaxK; }

// The four kernels on `stream`. tall: 128-row down tiles (prompts), else
// 32-row ones (one token a sequence); the output is the same bits either
// way. Scratch: h (3 x T k x f) bf16 (its three parts), y (T k x d) f32;
// offsets (E + 1), counts (E), tok, slot_of (T k each) int32; gate (T k)
// f32. keep may be NULL (every pair kept). Returns the number of kernels
// launched (4) or minus the CUDA error.
int moe_mlp_launch(const void* x, const void* wg, const void* wu,
                   const void* wd, const void* topk_i, const void* topk_p,
                   const void* keep, void* out, void* h, void* y,
                   void* offsets, void* counts, void* tok, void* gate,
                   void* slot_of, int T, int k, int E, int d, int f, int tall,
                   void* stream) {
  if (T <= 0 || k <= 0 || k > kMaxK || E <= 0 || d % 128 || f % 128)
    return -(int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pairs = T * k;
  int* off = static_cast<int*>(offsets);
  moe_dispatch_kernel<<<E, kThreads, 0, s>>>(
      static_cast<const long long*>(topk_i),
      static_cast<const float*>(topk_p),
      static_cast<const unsigned char*>(keep), pairs, k, E, off,
      static_cast<int*>(counts), static_cast<int*>(tok),
      static_cast<float*>(gate), static_cast<int*>(slot_of));
  int e = (int)cudaGetLastError();
  if (!e)
    e = tall ? launch_products<128>(
                   x, wg, wu, wd, off, static_cast<const int*>(tok),
                   static_cast<const float*>(gate), static_cast<bf16*>(h),
                   static_cast<float*>(y), pairs, E, d, f, s)
             : launch_products<32>(
                   x, wg, wu, wd, off, static_cast<const int*>(tok),
                   static_cast<const float*>(gate), static_cast<bf16*>(h),
                   static_cast<float*>(y), pairs, E, d, f, s);
  if (e) return -e;
  moe_combine_kernel<<<T, kThreads, 0, s>>>(
      static_cast<const float*>(y), static_cast<const int*>(slot_of),
      static_cast<const long long*>(topk_i), k, d, static_cast<bf16*>(out));
  e = (int)cudaGetLastError();
  return e ? -e : 4;
}

}  // extern "C"
