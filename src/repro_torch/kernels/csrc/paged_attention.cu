// Split-K flash-decode attention over a block-paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py
// (`_kernel`, wrapper `paged_attention`): one query token per sequence,
// GQA with rep = H / K query heads per KV head, online softmax (m, l, acc)
// in f32, scale 1/sqrt(D), positions outside [starts[b], lengths[b]) masked,
// output acc / max(l, 1e-30) in q's dtype.
//
// Bound. The kernel must read the live K/V rows once. At the serving shape
// (B=8, H=32, K=8, D=128, page 16, length 256, bf16) that is 8.4 MB, about
// 2.5 us at 3.35 TB/s; at length 4096 it is 134 MB, about 40 us. Its
// 4 * tokens * H * D FLOPs sit far below the compute roof, so it is bound by
// bytes: the design's job is to keep enough loads in flight on every SM.
//
// Design (the split layout, the page ring, the per-page math and the merge
// are in paged_attention_common.cuh, shared with the int8 kernel).
//   * Grid (K x head tiles, B, splits): a block runs one split — a
//     contiguous run of a sequence's live pages: 2 pages at the serving
//     shape (8 splits, 512 blocks, about 4 per SM), 32 at length 4096
//     (8 splits: 512 blocks, one wave; the f32 partials' write and read
//     are 1.6% of the K/V bytes there) — and a second launch merges the
//     splits in order. Both launches come from one C call; the wrapper
//     hands in the partials' scratch, the kernel allocates nothing.
//   * The block reads its slice of the block table once into shared
//     memory; then one thread streams the pages with TMA bulk copies
//     (cp.async.bulk, one 4 KB copy per K or V tile, completion on an
//     mbarrier per stage) into a double buffer: page i + 1 is in flight
//     while page i is computed, and one barrier per page frees a stage.
//   * A thread owns E = 8 values of D (16 bytes of a bf16 row) for every
//     query head of its tile; a group of G = D / 8 lanes covers one K/V
//     row, and the block's 128 / G row groups take the page's rows two at
//     a time. Each K element is read once from shared memory and serves
//     all heads of the tile, whose q lives in registers; the 2 x rep scores
//     are reduced together by a log2(G)-step xor shuffle (4 steps at
//     D = 128).
//   * Each row group keeps its own online softmax (m, l, acc in registers);
//     acc is rescaled only when m grows. After its last page the block
//     combines its row groups in group order (finish_split).
//   * Fully masked pages are never loaded (the split covers live pages
//     only); a masked row inside a live page is skipped, so stale bytes
//     there never reach the sums.
//   * f32 q/K/V (the tests' type) runs the same code in full f32, two
//     16-byte vectors per thread row. D is 64, 128 or 256.
//
// Measured (PERF.md): at the serving shape the two launches and one chain
// of dependent loads (lengths -> table -> page) set the time; at length
// 4096 the card streams the pages at about the rate of a plain contiguous
// read of the same bytes.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers; the
// launches go on `stream`; nothing is allocated, nothing synchronises. A
// launch returns the number of kernels it launched (1, or 2 with the merge
// pass) or a negative CUDA error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "paged_attention_common.cuh"

namespace {

using namespace pa;

constexpr int E = 8;                   // values of D per thread

template <typename T, int REP, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ lengths,
                       const int* __restrict__ starts, T* __restrict__ out,
                       float* __restrict__ part, int B, int H, int K, int P,
                       int page, int pages_per_seq, int head_tiles, int Z,
                       float qk_scale) {
  constexpr int D = G * E;
  constexpr int groups = kThreads / G;
  const int kh = blockIdx.x / head_tiles;
  const int h0 = kh * (H / K) + (blockIdx.x % head_tiles) * REP;
  const int nh = min(REP, (kh + 1) * (H / K) - h0);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int len = lengths[b];
  const int start = starts ? starts[b] : 0;
  const Split sp = split_plan(start, len, page, pages_per_seq);
  if (split >= sp.n_splits) return;
  const int p_begin = sp.first + split * sp.pages_per_split;
  const int n_pages = max(min(sp.pages_per_split, sp.last - p_begin), 0);

  const int tid = threadIdx.x;
  const int group = tid / G;
  const int lane = tid % G;

  // stage: K tile | V tile, (page, D) each
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_elems = page * D;
  const size_t stage_bytes = 2 * (size_t)tile_elems * sizeof(T);
  const SmemLayout lay = smem_layout(stage_bytes, groups, REP, D,
                                     pages_per_seq);
  int* tbl = reinterpret_cast<int*>(smem + lay.table);

  // q of the tile's heads in registers (heads past nh stay 0)
  float qr[REP][E];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const T* qrow = q + ((size_t)b * H + h0 + r) * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] = r < nh ? to_float(qrow[e]) : 0.f;
  }
  const int* table = block_tables + (size_t)b * pages_per_seq + p_begin;
  for (int i = tid; i < n_pages; i += kThreads) tbl[i] = table[i];
  const PageRing ring{smem, stage_bytes,
                      reinterpret_cast<uint64_t*>(smem + lay.bars)};
  if (tid == 0) ring.init();
  __syncthreads();

  const uint32_t tile_bytes = tile_elems * sizeof(T);
  auto load_page = [&](int i) {        // thread 0: page i -> its stage
    if (i < n_pages) {
      const size_t off = ((size_t)kh * P + (size_t)tbl[i]) * tile_elems;
      ring.expect(i, 2 * tile_bytes);
      ring.copy(i, 0, k_pages + off, tile_bytes);
      ring.copy(i, tile_bytes, v_pages + off, tile_bytes);
    }
  };
  if (tid == 0)
    for (int i = 0; i < kStages - 1; ++i) load_page(i);

  State<REP, E> st;
  st.init();
  for (int i = 0; i < n_pages; ++i) {
    ring.wait(i);
    __syncthreads();                   // every thread is done with page i - 1
    if (tid == 0) load_page(i + kStages - 1);   // ... so refill its stage
    const T* kt = reinterpret_cast<const T*>(ring.stage(i));
    const T* vt = kt + tile_elems;
    // this lane's E values of row t: 16 bytes (bf16) or 2 x 16 (f32)
    auto row_of = [&](const T* tile) {
      return [=](int t, float (&x)[E]) {
        const uint4* src =
            reinterpret_cast<const uint4*>(tile + t * D + lane * E);
        constexpr int kVecs = E * sizeof(T) / 16;
#pragma unroll
        for (int j = 0; j < kVecs; ++j)
          widen<T>(src[j], x + j * (E / kVecs));
      };
    };
    attend_page<REP, E, G>(st, qr, page, group, (p_begin + i) * page, start,
                           len, qk_scale, row_of(kt), row_of(vt));
  }
  finish_split<T, REP, E, G>(smem, lay, st, group, lane, nh, B, H, Z, b, h0,
                             split, sp.n_splits, out, part);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* lengths, const int* starts, void* out, float* part,
           int B, int H, int K, int P, int page, int D, int pages_per_seq,
           cudaStream_t stream) {
  return dispatch(H / K, D / E, [&](auto rep_c, auto g_c) {
    constexpr int REP = decltype(rep_c)::value;
    constexpr int G = decltype(g_c)::value;
    const int head_tiles = (H / K + REP - 1) / REP;
    const int Z = max_splits(pages_per_seq);
    const size_t smem = smem_layout(2 * (size_t)page * D * sizeof(T),
                                    kThreads / G, REP, D, pages_per_seq)
                            .total;
    auto kernel = paged_attention_kernel<T, REP, G>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return -(int)e;
    }
    const float qk_scale = (float)(kLog2e / std::sqrt((double)D));
    kernel<<<dim3(K * head_tiles, B, Z), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), bt, lengths, starts, static_cast<T*>(out),
        part, B, H, K, P, page, pages_per_seq, head_tiles, Z, qk_scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return -(int)e;
    if (Z == 1) return 1;
    e = launch_merge<T>(lengths, starts, part, static_cast<T*>(out), B, H,
                        D, page, pages_per_seq, Z, stream);
    return e != cudaSuccess ? -(int)e : 2;
  });
}

}  // namespace

extern "C" {

// 1 when the kernel takes this head_dim and page size: D is 64, 128 or 256
// (8, 16 or 32 lanes of 8 values per row).
int paged_attention_shape_ok(int D, int page) {
  return (D == 64 || D == 128 || D == 256) && page >= 1;
}

// f32 values of partials scratch a launch needs (its `part` argument).
long long paged_attention_scratch_floats(int B, int H, int D,
                                         int pages_per_seq) {
  return (long long)scratch_floats(B, H, D, pages_per_seq);
}

// dtype: 0 = float32, 1 = bfloat16. starts may be NULL (all zeros).
int paged_attention_launch(const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* lengths, const void* starts, void* out,
                           void* part, int B, int H, int K, int P, int page,
                           int D, int pages_per_seq, int dtype,
                           void* stream) {
  if (!paged_attention_shape_ok(D, page) || K < 1 || H % K)
    return -(int)cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* st = static_cast<const int*>(starts);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, bt, ln, st, out, pt, B, H, K,
                         P, page, D, pages_per_seq, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, bt, ln, st, out, pt, B,
                                 H, K, P, page, D, pages_per_seq, s);
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
