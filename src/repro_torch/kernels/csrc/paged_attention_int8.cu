// Flash-decode attention over an int8 block-paged KV pool, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention_int8.py
// (`_kernel`, wrapper `paged_attention_int8`): one query token per sequence,
// GQA with rep = H / K query heads per KV head, K/V stored as int8 with one
// bf16 scale per (KV head, token) row, dequantized right after the load
// (k * scale in f32), online softmax (m, l, acc) in f32, scale 1/sqrt(D),
// positions outside [starts[b], lengths[b]) masked, output
// acc / max(l, 1e-30) in q's dtype.
//
// Design. The design of paged_attention.cu, with int8 tiles. One thread
// block per (kv_head, sequence) reads its own block-table row, length and
// start, then walks the sequence's live pages in order inside the block (the
// TPU kernel's sequential grid axis becomes this loop). Per page it
//   1. copies the (page, D) int8 K and V tiles into shared memory with
//      16-byte coalesced loads (one tile of one KV head is contiguous in the
//      pool; page * D is a whole number of 16-byte vectors), and the page's
//      K and V scales beside them as f32;
//   2. computes the rep x page scores, one warp per score, lanes split D,
//      dequantizing each K element in registers;
//   3. updates m and l per query head (one warp per head, lanes over page)
//      and keeps p in shared memory, zeroing p on masked positions (the TPU
//      kernel's fully-masked-page guard);
//   4. rescales and accumulates acc = acc * alpha + p V in registers, each
//      thread owning fixed (head, d) outputs and dequantizing V on the fly.
// Pages with no valid position are skipped: they leave m, l and acc
// unchanged in the TPU kernel too (alpha = 1, p = 0).
//
// Bound. The kernel must read each valid K/V row once: at the main serving
// shape (B=8, H=32, K=8, D=128, page=16, length 256) that is
// 8 seq x 256 tokens x 8 heads x 128 x 2 (k, v) x 1 B = 4.19 MB of int8,
// plus 65.5 kB of bf16 scales, 131 kB of bf16 q and output and 576 B of
// tables, lengths and starts: 4.39 MB, about 1.31 us at 3.35 TB/s. Its
// 34 MFLOP are far below the compute roof, so it is bound by bytes. Like
// paged_attention.cu, this simple design is latency-bound instead: B*K = 64
// blocks of 4 warps on 132 SMs, with a serial load -> barrier -> compute
// chain per page. What it leaves for later: split-K over pages, cp.async or
// TMA prefetch of the next page, dp4a or int8 tensor-core products on the
// quantized payload.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers; the
// launch goes on `stream`; the return value is cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 16;          // rep * D <= kMaxAcc * kThreads
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_int8_kernel(const T* __restrict__ q,
                            const int8_t* __restrict__ k_pages,
                            const __nv_bfloat16* __restrict__ k_scales,
                            const int8_t* __restrict__ v_pages,
                            const __nv_bfloat16* __restrict__ v_scales,
                            const int* __restrict__ block_tables,
                            const int* __restrict__ lengths,
                            const int* __restrict__ starts,
                            T* __restrict__ out, int H, int K, int P,
                            int page, int D, int pages_per_seq,
                            float scale) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / K;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // shared memory: K tile | V tile (int8) | K scales | V scales | q | p |
  // m | l | alpha (f32); page * D is a multiple of 16, so the f32 part
  // starts aligned
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ks = reinterpret_cast<int8_t*>(smem);
  int8_t* vs = ks + page * D;
  float* ksc = reinterpret_cast<float*>(vs + page * D);
  float* vsc = ksc + page;
  float* qs = vsc + page;
  float* ps = qs + rep * D;
  float* ms = ps + rep * page;
  float* ls = ms + rep;
  float* as = ls + rep;

  const int len = lengths[b];
  const int start = starts ? starts[b] : 0;
  const int* table = block_tables + (size_t)b * pages_per_seq;
  const T* qb = q + ((size_t)b * H + (size_t)kh * rep) * D;

  for (int i = tid; i < rep * D; i += kThreads) qs[i] = to_float(qb[i]);
  for (int r = tid; r < rep; r += kThreads) {
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;

  const int first = max(start, 0) / page;
  const int last = min((len + page - 1) / page, pages_per_seq);
  const int tile_vecs = page * D / 16;

  for (int i = first; i < last; ++i) {
    __syncthreads();  // previous page's tiles, scales and p are not read now
    const size_t row0 = ((size_t)kh * P + (size_t)table[i]) * page;
    const uint4* ksrc = reinterpret_cast<const uint4*>(k_pages + row0 * D);
    const uint4* vsrc = reinterpret_cast<const uint4*>(v_pages + row0 * D);
    uint4* kdst = reinterpret_cast<uint4*>(ks);
    uint4* vdst = reinterpret_cast<uint4*>(vs);
    for (int v = tid; v < tile_vecs; v += kThreads) {
      kdst[v] = __ldg(ksrc + v);
      vdst[v] = __ldg(vsrc + v);
    }
    for (int t = tid; t < page; t += kThreads) {
      ksc[t] = __bfloat162float(k_scales[row0 + t]);
      vsc[t] = __bfloat162float(v_scales[row0 + t]);
    }
    __syncthreads();

    // scores: one warp per (head, token), lanes split D; K dequantized as
    // (int8 value) * (row scale) in f32, as the TPU kernel does
    for (int it = warp; it < rep * page; it += kWarps) {
      const int r = it / page;
      const int t = it % page;
      const float kscale = ksc[t];
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s += qs[r * D + d] * (static_cast<float>(ks[t * D + d]) * kscale);
      s = warp_sum(s) * scale;
      const int pos = i * page + t;
      if (lane == 0) ps[it] = (pos >= start && pos < len) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax statistics: one warp per query head, lanes over tokens
    for (int r = warp; r < rep; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, ps[r * page + t]);
      mx = warp_max(mx);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const int pos = i * page + t;
        // zero p on masked positions: with m_new still -1e30 on a page
        // whose every position is masked, exp(s - m_new) would be exp(0)
        const float p = (pos >= start && pos < len)
                            ? expf(ps[r * page + t] - m_new) : 0.f;
        ps[r * page + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        as[r] = alpha;
        ls[r] = alpha * ls[r] + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p V; thread owns outputs tid + a * kThreads
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int idx = tid + a * kThreads;
      if (idx < rep * D) {
        const int r = idx / D;
        const int d = idx % D;
        float pv = 0.f;
        for (int t = 0; t < page; ++t)
          pv += ps[r * page + t] *
                (static_cast<float>(vs[t * D + d]) * vsc[t]);
        acc[a] = acc[a] * as[r] + pv;
      }
    }
  }
  __syncthreads();  // ls is final

  T* ob = out + ((size_t)b * H + (size_t)kh * rep) * D;
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int idx = tid + a * kThreads;
    if (idx < rep * D) {
      const int r = idx / D;
      ob[idx] = from_float<T>(acc[a] / fmaxf(ls[r], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const int8_t* k, const __nv_bfloat16* ks,
           const int8_t* v, const __nv_bfloat16* vs, const int* bt,
           const int* lengths, const int* starts, void* out, int B, int H,
           int K, int P, int page, int D, int pages_per_seq,
           cudaStream_t stream) {
  const int rep = H / K;
  const size_t smem = 2 * (size_t)page * D +
                      sizeof(float) * (2 * (size_t)page + (size_t)rep * D +
                                       (size_t)rep * page + 3 * (size_t)rep);
  auto kernel = paged_attention_int8_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(K, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), k, ks, v, vs, bt, lengths, starts,
      static_cast<T*>(out), H, K, P, page, D, pages_per_seq,
      (float)(1.0 / std::sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest rep * D the kernel's register accumulators hold.
int paged_attention_int8_max_rep_d() { return kMaxAcc * kThreads; }

// dtype of q and out: 0 = float32, 1 = bfloat16. Pages are int8, scales
// bf16. starts may be NULL (all zeros).
int paged_attention_int8_launch(const void* q, const void* k_pages,
                                const void* k_scales, const void* v_pages,
                                const void* v_scales,
                                const void* block_tables,
                                const void* lengths, const void* starts,
                                void* out, int B, int H, int K, int P,
                                int page, int D, int pages_per_seq,
                                int dtype, void* stream) {
  const int8_t* k = static_cast<const int8_t*>(k_pages);
  const int8_t* v = static_cast<const int8_t*>(v_pages);
  const __nv_bfloat16* ks = static_cast<const __nv_bfloat16*>(k_scales);
  const __nv_bfloat16* vs = static_cast<const __nv_bfloat16*>(v_scales);
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  const int* st = static_cast<const int*>(starts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, ks, v, vs, bt, ln, st, out, B, H, K, P, page,
                         D, pages_per_seq, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, ks, v, vs, bt, ln, st, out, B, H, K,
                                 P, page, D, pages_per_seq, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
