// Shared pieces of the two split-K paged-attention kernels
// (paged_attention.cu over a bf16 or f32 pool, paged_attention_int8.cu over
// an int8 pool): the split layout, the ring of page stages filled by TMA
// bulk copies, the per-page online softmax of a row group, the in-block
// combine of the row groups' states and the merge pass over a sequence's
// splits.
//
// Split layout. A sequence's live pages are [first, last), first =
// start / page and last = ceil(length / page). They are cut into
// n_splits contiguous runs of pages_per_split pages (the last run may be
// shorter), with
//   pages_per_split = max(kMinPagesPerSplit, ceil(live / kMaxSplits)).
// So the layout, and with it every rounding of the result, is a function
// of the sequence's own start, length and page size alone: never of the
// batch, the slot, the pool, the physical page ids or the card. One thread
// block computes one split of one (sequence, KV head): an online softmax
// over its pages, written as an f32 partial (m, l, acc) — or, when the
// sequence has a single split, as the output itself. The merge pass then
// combines each sequence's partials in split order. No atomics anywhere:
// two calls on the same inputs are bit-identical.
//
// Scores are kept in log2 units (q.k * log2(e) / sqrt(D)), so every
// exponential is one exp2f; m = -1e30 with l = 0 marks a softmax state that
// has seen no valid position, and it is weighted exactly 0 by any state
// that has (exp2f(-1e30 - m) = 0), or 1 x 0 by another empty one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pa {

constexpr int kThreads = 128;          // 4 warps per block
constexpr int kMinBlocks = 4;          // resident per SM: <= 128 registers
constexpr int kStages = 2;             // double buffer: page i + 1 in
                                       // flight while page i is computed
constexpr int kRows = 2;               // rows a row group takes at once
// the split layout (tests/test_torch_paged_attention_split.py reads these
// two from this file)
constexpr int kMinPagesPerSplit = 2;
constexpr int kMaxSplits = 8;
constexpr float kNegInf = -1e30f;
constexpr double kLog2e = 1.4426950408889634;

struct Split {
  int first;            // first live page
  int last;             // one past the last live page
  int pages_per_split;
  int n_splits;         // >= 1; a sequence with no live page has one, empty
};

__host__ __device__ inline Split split_plan(int start, int len, int page,
                                            int pages_per_seq) {
  Split s;
  s.first = (start > 0 ? start : 0) / page;
  s.last = (len + page - 1) / page;
  // inside the table for any input (a valid length never reaches past it)
  if (s.last > pages_per_seq) s.last = pages_per_seq;
  const int live = s.last > s.first ? s.last - s.first : 0;
  const int even = (live + kMaxSplits - 1) / kMaxSplits;
  s.pages_per_split = even > kMinPagesPerSplit ? even : kMinPagesPerSplit;
  s.n_splits = live > 0 ? (live + s.pages_per_split - 1) / s.pages_per_split
                        : 1;
  return s;
}

// Grid depth: no sequence of a table `pages_per_seq` wide has more splits.
__host__ __device__ inline int max_splits(int pages_per_seq) {
  int z = (pages_per_seq + kMinPagesPerSplit - 1) / kMinPagesPerSplit;
  if (z > kMaxSplits) z = kMaxSplits;
  return z > 1 ? z : 1;
}

// Longest run of pages a split of such a table holds.
__host__ __device__ inline int max_pages_per_split(int pages_per_seq) {
  return split_plan(0, pages_per_seq, 1, pages_per_seq).pages_per_split;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Ring of kStages page stages, each filled by TMA bulk copies
// (cp.async.bulk) that complete on the stage's mbarrier. One thread issues
// a page's copies; every thread waits on the stage's phase before reading
// it. Page i of a split goes to stage i % kStages, the stage's
// (i / kStages)-th fill, so its phase parity is (i / kStages) & 1.
struct PageRing {
  unsigned char* tiles;                // kStages x stage_bytes
  size_t stage_bytes;
  uint64_t* bars;                      // kStages mbarriers

  __device__ __forceinline__ unsigned char* stage(int i) const {
    return tiles + (i % kStages) * stage_bytes;
  }
  // Thread 0, once: arm every stage's barrier (one arrival per fill).
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(bars + s))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The issuing thread: page i will bring `bytes` into its stage.
  __device__ __forceinline__ void expect(int i, uint32_t bytes) const {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_addr(bars + i % kStages)),
        "r"(bytes)
        : "memory");
  }
  // The issuing thread: one contiguous copy (16-byte aligned, a multiple
  // of 16 bytes) into page i's stage at byte offset `off`.
  __device__ __forceinline__ void copy(int i, size_t off, const void* src,
                                       uint32_t bytes) const {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(stage(i) + off)),
        "l"(src), "r"(bytes), "r"(smem_addr(bars + i % kStages))
        : "memory");
  }
  // Every thread: wait until page i's copies have landed.
  __device__ __forceinline__ void wait(int i) const {
    const uint32_t bar = smem_addr(bars + i % kStages);
    const uint32_t parity = (i / kStages) & 1;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    }
  }
};

// 16 bytes of a row -> f32: eight bf16 (a shift or a mask each) or four
// f32.
template <typename T>
__device__ __forceinline__ void widen(const uint4& v, float* x);
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& v,
                                                     float* x) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void widen<float>(const uint4& v, float* x) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}

// Four packed int8 -> four exact floats with full-rate byte-permute and
// add instructions: each byte, biased by 128, becomes the low mantissa byte
// of 2^23, and one exact subtraction removes 2^23 + 128.
__device__ __forceinline__ void widen_int8x4(uint32_t w, float* x) {
  const uint32_t u = w ^ 0x80808080u;
  x[0] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440)) - 8388736.f;
  x[1] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7441)) - 8388736.f;
  x[2] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7442)) - 8388736.f;
  x[3] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7443)) - 8388736.f;
}

// One row group's online-softmax state for the block's REP heads, over
// this thread's E values of D.
template <int REP, int E>
struct State {
  float m[REP], l[REP], acc[REP][E];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
    }
  }
};

// Attend to one page tile in shared memory. A row group of G lanes covers
// one row (E values each); the block's kThreads / G groups take the page's
// rows kRows at a time: group g takes rows t0 + g and t0 + groups + g.
// `load_k(t, x)` / `load_v(t, x)` give this lane's E values of row t, as
// f32. Every group runs the same trip count, so the shuffles stay
// converged; a masked row is skipped, so its bytes never reach the sums.
// Scores of all kRows x REP dots are reduced together (independent
// chains), a G-lane xor butterfly that leaves the same bits in every lane.
template <int REP, int E, int G, class LoadK, class LoadV>
__device__ __forceinline__ void attend_page(
    State<REP, E>& st, const float (&qr)[REP][E], int page, int group,
    int base, int start, int len, float qk_scale, LoadK load_k,
    LoadV load_v) {
  constexpr int groups = kThreads / G;
  for (int t0 = 0; t0 < page; t0 += kRows * groups) {
    float s[kRows][REP];
    bool ok[kRows];
    int row[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int t = t0 + j * groups + group;
      const int pos = base + t;
      ok[j] = t < page && pos >= start && pos < len;
      row[j] = t < page ? t : 0;
      float kx[E];
      load_k(row[j], kx);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[r][e], kx[e], dot);
        s[j][r] = dot;
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
#pragma unroll
        for (int r = 0; r < REP; ++r)
          s[j][r] += __shfl_xor_sync(0xffffffffu, s[j][r], o);
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = st.m[r];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        s[j][r] *= qk_scale;
        if (ok[j]) mx = fmaxf(mx, s[j][r]);
      }
      if (mx > st.m[r]) {              // new max: rescale the state
        const float alpha = exp2f(st.m[r] - mx);
        st.m[r] = mx;
        st.l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) st.acc[r][e] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (!ok[j]) continue;
      float vx[E];
      load_v(row[j], vx);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = exp2f(s[j][r] - st.m[r]);
        st.l[r] += p;
#pragma unroll
        for (int e = 0; e < E; ++e)
          st.acc[r][e] = fmaf(p, vx[e], st.acc[r][e]);
      }
    }
  }
}

// Shared-memory layout of a split block, in bytes. Region A holds the
// kStages page tiles while the pages stream in and, after the last page,
// the row groups' accumulators; then the split's block-table slice; then
// the row groups' softmax statistics and merge weights; then the ring's
// mbarriers.
struct SmemLayout {
  size_t table;         // offset of the int table slice
  size_t stats;         // offset of the float statistics
  size_t bars;          // offset of the ring's mbarriers
  size_t total;
};

__host__ __device__ inline SmemLayout smem_layout(size_t stage_bytes,
                                                  int groups, int rep_tile,
                                                  int D, int pages_per_seq) {
  SmemLayout s;
  const size_t tiles = kStages * stage_bytes;
  const size_t accs = sizeof(float) * (size_t)groups * rep_tile * D;
  s.table = ((tiles > accs ? tiles : accs) + 15) / 16 * 16;
  s.stats = s.table + sizeof(int) *
            (((size_t)max_pages_per_split(pages_per_seq) + 3) / 4 * 4);
  s.bars = (s.stats + sizeof(float) * (3 * (size_t)groups * rep_tile +
                                       2 * (size_t)rep_tile) + 7) / 8 * 8;
  s.total = s.bars + sizeof(uint64_t) * kStages;
  return s;
}

// The block's row groups hold softmax states over disjoint rows of the
// split; combine them in group order and write the split's partial — or,
// when the sequence has one split, the output. Every thread calls this
// after the last page, with its group's state for its E values of D.
//   part: [B][H][Z][D] accumulators, then [B][H][Z][2] (m, l)
template <typename T, int REP, int E, int G>
__device__ __forceinline__ void finish_split(
    unsigned char* smem, const SmemLayout& lay, const State<REP, E>& st,
    int group, int lane, int nh, int B, int H, int Z, int b, int h0,
    int split, int n_splits, T* __restrict__ out,
    float* __restrict__ part) {
  constexpr int groups = kThreads / G;
  constexpr int D = G * E;
  const int tid = threadIdx.x;
  float* cacc = reinterpret_cast<float*>(smem);          // [groups][REP][D]
  float* cm = reinterpret_cast<float*>(smem + lay.stats);  // [groups][REP]
  float* cl = cm + groups * REP;
  float* cw = cl + groups * REP;
  float* fm = cw + groups * REP;                         // [REP]
  float* fl = fm + REP;
  __syncthreads();           // region A is no longer read as page tiles
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      cacc[(group * REP + r) * D + lane * E + e] = st.acc[r][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      cm[group * REP + r] = st.m[r];
      cl[group * REP + r] = st.l[r];
    }
  }
  __syncthreads();
  if (tid < REP) {
    const int r = tid;
    float mx = kNegInf;
    for (int g = 0; g < groups; ++g) mx = fmaxf(mx, cm[g * REP + r]);
    float sum = 0.f;
    for (int g = 0; g < groups; ++g) {
      const float w = exp2f(cm[g * REP + r] - mx);
      cw[g * REP + r] = w;
      sum += w * cl[g * REP + r];
    }
    fm[r] = mx;
    fl[r] = sum;
  }
  __syncthreads();
  for (int idx = tid; idx < nh * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    float a = 0.f;
    for (int g = 0; g < groups; ++g)
      a += cw[g * REP + r] * cacc[(g * REP + r) * D + d];
    const size_t row = (size_t)b * H + h0 + r;
    if (n_splits == 1)
      out[row * D + d] = from_float<T>(a / fmaxf(fl[r], 1e-30f));
    else
      part[(row * Z + split) * D + d] = a;
  }
  if (n_splits > 1 && tid < nh) {
    const size_t row = (size_t)b * H + h0 + tid;
    float* ml = part + (size_t)B * H * Z * D + (row * Z + split) * 2;
    ml[0] = fm[tid];
    ml[1] = fl[tid];
  }
}

// Merge pass: one block per (query head, sequence) combines the sequence's
// splits in split order. Sequences with one split were written directly.
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_splits_kernel(const int* __restrict__ lengths,
                    const int* __restrict__ starts,
                    const float* __restrict__ part, T* __restrict__ out,
                    int B, int H, int D, int page, int pages_per_seq,
                    int Z) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const Split sp = split_plan(starts ? starts[b] : 0, lengths[b], page,
                              pages_per_seq);
  if (sp.n_splits == 1) return;
  const size_t row = (size_t)b * H + h;
  const float* acc = part + row * Z * D;
  const float* ml = part + (size_t)B * H * Z * D + row * Z * 2;
  float mx = kNegInf;
  for (int s = 0; s < sp.n_splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float sum = 0.f;
  for (int s = 0; s < sp.n_splits; ++s)
    sum += exp2f(ml[2 * s] - mx) * ml[2 * s + 1];
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < sp.n_splits; ++s)
      a += exp2f(ml[2 * s] - mx) * acc[(size_t)s * D + d];
    out[row * D + d] = from_float<T>(a / fmaxf(sum, 1e-30f));
  }
}

// The merge pass, after the split pass on `stream`.
template <typename T>
cudaError_t launch_merge(const int* lengths, const int* starts,
                         const float* part, T* out, int B, int H, int D,
                         int page, int pages_per_seq, int Z,
                         cudaStream_t stream) {
  merge_splits_kernel<T><<<dim3(H, B), kThreads, 0, stream>>>(
      lengths, starts, part, out, B, H, D, page, pages_per_seq, Z);
  return cudaGetLastError();
}

// Floats of f32 partials a launch needs: [B][H][Z][D + 2].
inline size_t scratch_floats(int B, int H, int D, int pages_per_seq) {
  return (size_t)B * H * max_splits(pages_per_seq) * ((size_t)D + 2);
}

// Head tile of a block: all rep query heads of a KV head when rep <= 8
// (rounded up to a power of two), else tiles of 8 heads.
inline int rep_tile(int rep) {
  int t = 1;
  while (t < rep && t < 8) t <<= 1;
  return t;
}

// Calls f(std::integral_constant<int, REP>{}, std::integral_constant<int,
// G>{}) for the block's head tile and lanes per row (8, 16 or 32). Returns
// f's result, or -cudaErrorInvalidValue for any other G.
template <class F>
int dispatch(int rep, int G, F f) {
  auto by_g = [&](auto rep_c) {
    switch (G) {
      case 8: return f(rep_c, std::integral_constant<int, 8>{});
      case 16: return f(rep_c, std::integral_constant<int, 16>{});
      case 32: return f(rep_c, std::integral_constant<int, 32>{});
      default: return -(int)cudaErrorInvalidValue;
    }
  };
  switch (rep_tile(rep)) {
    case 1: return by_g(std::integral_constant<int, 1>{});
    case 2: return by_g(std::integral_constant<int, 2>{});
    case 4: return by_g(std::integral_constant<int, 4>{});
    default: return by_g(std::integral_constant<int, 8>{});
  }
}

}  // namespace pa
