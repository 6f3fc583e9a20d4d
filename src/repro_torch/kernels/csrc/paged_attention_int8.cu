// Split-K flash-decode attention over an int8 block-paged KV pool, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention_int8.py
// (`_kernel`, wrapper `paged_attention_int8`): one query token per sequence,
// GQA with rep = H / K query heads per KV head, K/V stored as int8 with one
// bf16 scale per (KV head, token) row, dequantized right after the load
// (k * scale in f32, in the TPU kernel's order: every element is widened
// and scaled before it meets q or p; q is never quantized), online softmax
// (m, l, acc) in f32, scale 1/sqrt(D), positions outside
// [starts[b], lengths[b]) masked, output acc / max(l, 1e-30) in q's dtype.
//
// Bound. The kernel must read each valid K/V row once, with its scale: at
// the serving shape (B=8, H=32, K=8, D=128, page 16, length 256) 4.39 MB,
// about 1.31 us at 3.35 TB/s; at length 4096 68 MB, about 20 us. It is
// bound by bytes.
//
// Design: paged_attention.cu's, over int8 tiles (the split layout, the
// page ring, the per-page math, the in-block combine and the merge pass are
// shared, in paged_attention_common.cuh).
//   * Grid (K x head tiles, B, splits), 2 pages per split at the serving
//     shape (512 blocks), 32 at length 4096 (512 blocks; the f32 partials'
//     round trip is 3% of the int8 K/V bytes there); a second launch
//     merges splits in order, both from one C call.
//   * The block's table slice is read once; one thread streams each page
//     as four TMA bulk copies into a double buffer — the (page, D) int8 K
//     and V tiles and the page's K and V scale rows (page * 2 bytes each,
//     whole 16-byte vectors for a page that is a multiple of 8).
//   * A thread owns E = 8 int8 values of D (an 8-byte shared-memory read;
//     G = D / 8 lanes per row, a 4-step shuffle at D = 128). 16 values per
//     thread would make the read 16 bytes, but double the registers that q
//     and acc take for the tile's heads. The int8 -> f32 widening is exact
//     (byte permute + one subtraction); the scale multiply follows, as in
//     the TPU kernel.
//   * Everything else as paged_attention.cu: q in registers, one online
//     softmax per row group rescaled only when m grows, masked rows and
//     pages skipped, the row groups combined in order at the end.
//
// Measured (PERF.md): at length 4096 the per-element work (widen, scale,
// 4 FMAs for the scores and 4 for the output per K and V byte, the score
// shuffles) outlasts the page copies, so the kernel is bound by issue,
// not bytes.
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

constexpr int E = 8;                   // int8 values of D per thread

template <typename T, int REP, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
paged_attention_int8_kernel(const T* __restrict__ q,
                            const int8_t* __restrict__ k_pages,
                            const __nv_bfloat16* __restrict__ k_scales,
                            const int8_t* __restrict__ v_pages,
                            const __nv_bfloat16* __restrict__ v_scales,
                            const int* __restrict__ block_tables,
                            const int* __restrict__ lengths,
                            const int* __restrict__ starts,
                            T* __restrict__ out, float* __restrict__ part,
                            int B, int H, int K, int P, int page,
                            int pages_per_seq, int head_tiles, int Z,
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

  // stage: K tile | V tile (int8, page * D each) | K scales | V scales
  // (bf16, page each)
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t tile_bytes = page * D;
  const uint32_t scale_bytes = page * 2;
  const size_t stage_bytes = 2 * (size_t)tile_bytes + 2 * (size_t)scale_bytes;
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

  auto load_page = [&](int i) {        // thread 0: page i -> its stage
    if (i < n_pages) {
      const size_t row0 = ((size_t)kh * P + (size_t)tbl[i]) * page;
      ring.expect(i, stage_bytes);
      ring.copy(i, 0, k_pages + row0 * D, tile_bytes);
      ring.copy(i, tile_bytes, v_pages + row0 * D, tile_bytes);
      ring.copy(i, 2 * tile_bytes, k_scales + row0, scale_bytes);
      ring.copy(i, 2 * tile_bytes + scale_bytes, v_scales + row0,
                scale_bytes);
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
    const int8_t* kt = reinterpret_cast<const int8_t*>(ring.stage(i));
    const int8_t* vt = kt + tile_bytes;
    const __nv_bfloat16* ksc =
        reinterpret_cast<const __nv_bfloat16*>(vt + tile_bytes);
    const __nv_bfloat16* vsc = ksc + page;
    // this lane's E values of row t, dequantized: (float)int8 * scale
    auto row_of = [&](const int8_t* tile, const __nv_bfloat16* scales) {
      return [=](int t, float (&x)[E]) {
        const uint2 v =
            *reinterpret_cast<const uint2*>(tile + t * D + lane * E);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
        for (int j = 0; j < E / 4; ++j) widen_int8x4(w[j], x + 4 * j);
        const float scale = __bfloat162float(scales[t]);
#pragma unroll
        for (int e = 0; e < E; ++e) x[e] *= scale;
      };
    };
    attend_page<REP, E, G>(st, qr, page, group, (p_begin + i) * page, start,
                           len, qk_scale, row_of(kt, ksc), row_of(vt, vsc));
  }
  finish_split<T, REP, E, G>(smem, lay, st, group, lane, nh, B, H, Z, b, h0,
                             split, sp.n_splits, out, part);
}

template <typename T>
int launch(const void* q, const int8_t* k, const __nv_bfloat16* ks,
           const int8_t* v, const __nv_bfloat16* vs, const int* bt,
           const int* lengths, const int* starts, void* out, float* part,
           int B, int H, int K, int P, int page, int D, int pages_per_seq,
           cudaStream_t stream) {
  return dispatch(H / K, D / E, [&](auto rep_c, auto g_c) {
    constexpr int REP = decltype(rep_c)::value;
    constexpr int G = decltype(g_c)::value;
    const int head_tiles = (H / K + REP - 1) / REP;
    const int Z = max_splits(pages_per_seq);
    const size_t smem = smem_layout(2 * (size_t)page * D + 4 * (size_t)page,
                                    kThreads / G, REP, D, pages_per_seq)
                            .total;
    auto kernel = paged_attention_int8_kernel<T, REP, G>;
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return -(int)e;
    }
    const float qk_scale = (float)(kLog2e / std::sqrt((double)D));
    kernel<<<dim3(K * head_tiles, B, Z), kThreads, smem, stream>>>(
        static_cast<const T*>(q), k, ks, v, vs, bt, lengths, starts,
        static_cast<T*>(out), part, B, H, K, P, page, pages_per_seq,
        head_tiles, Z, qk_scale);
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

// 1 when the kernel takes this head_dim and page size: D / E lanes per row
// is 8, 16 or 32, and a page's scale row (page bf16) is whole 16-byte
// vectors (page a multiple of 8).
int paged_attention_int8_shape_ok(int D, int page) {
  const int G = D / E;
  return D % E == 0 && (G == 8 || G == 16 || G == 32) && page >= 8 &&
         page % 8 == 0;
}

// f32 values of partials scratch a launch needs (its `part` argument).
long long paged_attention_int8_scratch_floats(int B, int H, int D,
                                              int pages_per_seq) {
  return (long long)scratch_floats(B, H, D, pages_per_seq);
}

// dtype of q and out: 0 = float32, 1 = bfloat16. Pages are int8, scales
// bf16. starts may be NULL (all zeros).
int paged_attention_int8_launch(const void* q, const void* k_pages,
                                const void* k_scales, const void* v_pages,
                                const void* v_scales,
                                const void* block_tables,
                                const void* lengths, const void* starts,
                                void* out, void* part, int B, int H, int K,
                                int P, int page, int D, int pages_per_seq,
                                int dtype, void* stream) {
  if (!paged_attention_int8_shape_ok(D, page) || K < 1 || H % K)
    return -(int)cudaErrorInvalidValue;
  const int8_t* k = static_cast<const int8_t*>(k_pages);
  const int8_t* v = static_cast<const int8_t*>(v_pages);
  const __nv_bfloat16* ks = static_cast<const __nv_bfloat16*>(k_scales);
  const __nv_bfloat16* vs = static_cast<const __nv_bfloat16*>(v_scales);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* st = static_cast<const int*>(starts);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, ks, v, vs, bt, ln, st, out, pt, B, H, K, P,
                         page, D, pages_per_seq, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, ks, v, vs, bt, ln, st, out, pt, B, H,
                                 K, P, page, D, pages_per_seq, s);
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
