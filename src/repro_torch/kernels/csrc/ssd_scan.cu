// Mamba-2 SSD (state-space duality) scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:23
// (`_kernel`, wrapper `ssd_scan`). Per (batch, head) it runs the recurrence
//   state_t = state_{t-1} * exp(a_t) + x_t B_t^T      (P x N, f32)
//   y_t     = state_t C_t
// in the chunked SSD form: within a block of positions the output is the
// intra-block term ((C B^T) o L) x with L[i][j] = exp(cum_i - cum_j) for
// i >= j, plus the entering state's term (C state^T) * exp(cum_i); the state
// then moves on as state * exp(total) + (x * exp(total - cum))^T B.
//
// Design. One thread block per (head, batch) walks the whole sequence in
// order and keeps the P x N state in shared memory: the TPU kernel's
// sequential chunk axis (state carried in VMEM scratch across grid steps)
// becomes this loop, since Hopper blocks run in no order. The loop steps
// over sub-chunks of 32 positions (one per lane), WHATEVER the caller's
// chunk length: the SSD split is exact for any block length, so only the
// rounding differs from a 256-position chunk, whose L matrix alone (256 KB
// in f32) would not fit in the 227 KB a block may hold. The last sub-chunk
// of a ragged length (chunk 200 = 6 x 32 + 8) is masked. Per sub-chunk:
//   1. load x (32 x P), a (32), B and C (32 x N) through their strides (B
//      and C are slices of the conv output; bf16 or f32, widened to f32);
//   2. warp 0 forms the inclusive cumulative sum of a (a shuffle scan),
//      exp(cum_i), exp(total - cum_j) and exp(total);
//   3. G[i][j] = (C_i . B_j) * exp(cum_i - cum_j), the exponential taken
//      only where i >= j (above the diagonal G is 0 and no exp is computed,
//      so no inf meets a 0);
//   4. y_i = sum_j G[i][j] x_j + exp(cum_i) * (C_i . state_p), written to
//      y[b, t, h, :] directly;
//   5. state = state * exp(total) + sum_j (x_j exp(total - cum_j)) B_j^T.
// B and the state are stored with a row stride of N + 1 floats, so the
// lanes of a warp that walk different rows hit different banks.
//
// Bound. At the serving shape (b 8, s 512, h 24, p 64, n 128; x, a, y, the
// final state f32, B and C bf16) the kernel must move 59.1 MB, 17.6 us at
// 3.35 TB/s, and do at least 4 * b * s * h * p * n = 3.22 GFLOP (per
// position and head one multiply-add per state element for the update and
// one for the output), 48.1 us on the f32 CUDA cores at 67 TFLOP/s: it is
// bound by operations. The chunked form adds the intra-chunk products on
// top of that floor (this kernel: 32 x 32 x N per sub-chunk and head for
// C B^T, 32 x 32 x P / 2 for G x). What this simple design leaves for
// later: every product is a scalar FMA whose operands come from shared
// memory (about two shared loads per FMA, so shared-memory bandwidth, not
// the FMA units, sets its pace); register tiles of the state and the
// outputs, C B^T formed once per (batch, sub-chunk) instead of once per
// head, and tensor cores (wgmma in TF32, or bf16 B and C) are the levers.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers; the
// launch goes on `stream`; the return value is cudaGetLastError() (or the
// error of cudaFuncSetAttribute).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 32;                 // positions per sub-chunk (= lanes)
constexpr size_t kMaxSmem = 232448;      // 227 KB, Hopper's per-block limit

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const float* x;      // (b, s, h, p), p contiguous
  const float* a;      // (b, s, h), h contiguous
  const void* B;       // (b, s, n), n contiguous
  const void* C;
  const float* h0;     // (b, h, p, n) contiguous, or null (zero state)
  float* y;            // (b, s, h, p) contiguous
  float* hf;           // (b, h, p, n) contiguous
  int S, H, P, N;
  long long x_sb, x_ss, x_sh;            // strides in elements
  long long a_sb, a_ss;
  long long b_sb, b_ss, c_sb, c_ss;
};

// floats of shared memory: state P x (N+1) | x 32 x P | B 32 x (N+1) |
// C 32 x N | G 32 x 32 | cum 32 | exp(cum) 32 | exp(total - cum) 32 + 1
size_t smem_floats(int P, int N) {
  return (size_t)P * (N + 1) + (size_t)kSub * P + (size_t)kSub * (N + 1) +
         (size_t)kSub * N + (size_t)kSub * kSub + 3 * kSub + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Args args) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int S = args.S, H = args.H, P = args.P, N = args.N;
  const int ldn = N + 1;

  extern __shared__ float smem[];
  float* st = smem;                      // state, row p at p * ldn
  float* xs = st + (size_t)P * ldn;      // x, row j at j * P
  float* bs = xs + kSub * P;             // B, row j at j * ldn
  float* cs = bs + kSub * ldn;           // C, row i at i * N
  float* g = cs + kSub * N;              // G, row i at i * kSub
  float* cum = g + kSub * kSub;
  float* ecum = cum + kSub;              // exp(cum_i)
  float* dec = ecum + kSub;              // exp(total - cum_j); [kSub]: exp(total)

  const float* xb = args.x + b * args.x_sb + h * args.x_sh;
  const float* ab = args.a + b * args.a_sb + h;
  const T* Bb = static_cast<const T*>(args.B) + b * args.b_sb;
  const T* Cb = static_cast<const T*>(args.C) + b * args.c_sb;
  float* yb = args.y + ((size_t)b * S * H + h) * P;   // + t * H * P + p
  const size_t state_off = ((size_t)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += kThreads)
    st[(i / N) * ldn + i % N] = args.h0 ? args.h0[state_off + i] : 0.f;

  for (int t0 = 0; t0 < S; t0 += kSub) {
    const int q = min(kSub, S - t0);
    __syncthreads();  // the previous sub-chunk no longer reads the tiles

    // 1. tiles; rows past the ragged end are zero
    for (int i = tid; i < kSub * P; i += kThreads) {
      const int r = i / P;
      xs[i] = r < q ? xb[(t0 + r) * args.x_ss + i % P] : 0.f;
    }
    for (int i = tid; i < kSub * N; i += kThreads) {
      const int r = i / N, c = i % N;
      float bv = 0.f, cv = 0.f;
      if (r < q) {
        bv = to_float(Bb[(t0 + r) * args.b_ss + c]);
        cv = to_float(Cb[(t0 + r) * args.c_ss + c]);
      }
      bs[r * ldn + c] = bv;
      cs[i] = cv;
    }
    // 2. cumulative log decay (a = 0 past the end: cum stays at total)
    if (warp == 0) {
      float v = lane < q ? ab[(t0 + lane) * args.a_ss] : 0.f;
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      const float total = __shfl_sync(0xffffffffu, v, kSub - 1);
      cum[lane] = v;
      ecum[lane] = expf(v);
      dec[lane] = expf(total - v);
      if (lane == 0) dec[kSub] = expf(total);
    }
    __syncthreads();

    // 3. G = (C B^T) o L, lower triangle; one warp per row, lane = column
    for (int i = warp; i < q; i += kWarps) {
      const int j = lane;
      float gv = 0.f;
      if (j <= i) {
        float dot = 0.f;
        for (int k = 0; k < N; ++k) dot += cs[i * N + k] * bs[j * ldn + k];
        gv = dot * expf(cum[i] - cum[j]);
      }
      g[i * kSub + j] = gv;
    }
    __syncthreads();

    // 4. outputs: intra-chunk term + entering state's term
    for (int idx = tid; idx < q * P; idx += kThreads) {
      const int i = idx / P, p = idx % P;
      float off = 0.f;
      for (int k = 0; k < N; ++k) off += cs[i * N + k] * st[p * ldn + k];
      float diag = 0.f;
      for (int j = 0; j <= i; ++j) diag += g[i * kSub + j] * xs[j * P + p];
      yb[(size_t)(t0 + i) * H * P + p] = diag + off * ecum[i];
    }
    __syncthreads();

    // 5. state update: x rows weighted by their decay to the sub-chunk end
    for (int idx = tid; idx < q * P; idx += kThreads) xs[idx] *= dec[idx / P];
    __syncthreads();
    const float chunk_decay = dec[kSub];
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx % N;
      float acc = 0.f;
      for (int j = 0; j < q; ++j) acc += xs[j * P + p] * bs[j * ldn + n];
      st[p * ldn + n] = st[p * ldn + n] * chunk_decay + acc;
    }
  }
  __syncthreads();

  for (int i = tid; i < P * N; i += kThreads)
    args.hf[state_off + i] = st[(i / N) * ldn + i % N];
}

template <typename T>
int launch(const Args& args, int batch, cudaStream_t stream) {
  const size_t smem = smem_floats(args.P, args.N) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(args.H, batch);
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory one block needs for head dim P and state dim N.
long long ssd_scan_smem_bytes(int P, int N) {
  return (long long)(smem_floats(P, N) * sizeof(float));
}

// Largest shared-memory request the kernel makes (the per-block limit).
long long ssd_scan_max_smem_bytes() { return (long long)kMaxSmem; }

// bc_dtype: 0 = float32, 1 = bfloat16 (B and C share it). h0 may be NULL.
int ssd_scan_launch(const void* x, const void* a, const void* B,
                    const void* C, const void* h0, void* y, void* hf,
                    int batch, int S, int H, int P, int N, long long x_sb,
                    long long x_ss, long long x_sh, long long a_sb,
                    long long a_ss, long long b_sb, long long b_ss,
                    long long c_sb, long long c_ss, int bc_dtype,
                    void* stream) {
  Args args;
  args.x = static_cast<const float*>(x);
  args.a = static_cast<const float*>(a);
  args.B = B;
  args.C = C;
  args.h0 = static_cast<const float*>(h0);
  args.y = static_cast<float*>(y);
  args.hf = static_cast<float*>(hf);
  args.S = S;
  args.H = H;
  args.P = P;
  args.N = N;
  args.x_sb = x_sb;
  args.x_ss = x_ss;
  args.x_sh = x_sh;
  args.a_sb = a_sb;
  args.a_ss = a_ss;
  args.b_sb = b_sb;
  args.b_ss = b_ss;
  args.c_sb = c_sb;
  args.c_ss = c_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return launch<float>(args, batch, s);
  if (bc_dtype == 1) return launch<__nv_bfloat16>(args, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
