// Backward of the Mamba-2 SSD scan, for Hopper (sm_90a).
//
// Replaces no TPU kernel. It is the gradient of the forward scan
// (csrc/ssd_scan.cu, the port of src/repro/kernels/ssd_scan.py:23), whose
// Pallas kernel has no backward: the reference trains through jax.grad of
// its jnp chunked form (src/repro/models/ssm.py:66), which XLA compiles and
// fuses. The port's counterpart of that fused gradient is this kernel, so
// that no plain scan runs on the card when Mamba-2 trains
// (models/ssm.py SSDScan.backward).
//
// Per (batch, head), with S_t the P x N state after position t
// (S_t = exp(a_t) S_{t-1} + x_t B_t^T, y_t = S_t C_t) and dS_t the total
// gradient into S_t, the backward is a reverse scan:
//   dS_t = gy_t C_t^T + exp(a_{t+1}) dS_{t+1},  dS_last = gh + gy C^T,
//   dx_t = dS_t B_t,  dB_t = sum_h dS_t^T x_t,  dC_t = sum_h S_t^T gy_t,
//   dh0 = exp(a_0) dS_0,  da_t = exp(a_t) <S_{t-1}, dS_t>.
// The kernel takes it in the chunked form over sub-chunks of Q = 32
// positions (whatever the caller's chunk: the split is exact for any block
// length; a ragged tail is zero-filled, a = 0 and x = B = C = gy = 0). With
// cum the cumulative log decay inside the sub-chunk, L[i][j] =
// exp(cum_i - cum_j) for j <= i, e_t = exp(total - cum_t), S_in the state
// entering the sub-chunk and dS_out the gradient into the state leaving it:
//   G      = (C B^T) o L,           M = (gy x^T) o L        (Q x Q)
//   dx     = diag(e) B dS_out^T + G^T gy                     (Q x P)
//   dB_blk = diag(e) x dS_out + M^T C                        (Q x N)
//   dC_blk = diag(exp(cum)) gy S_in + M B                    (Q x N)
//   dS_in  = exp(total) dS_out + (diag(exp(cum)) gy)^T C     (P x N)
// and for the decays dcum_t = gy_t . y_t - x_t . dx_t, plus
// <S_out, dS_out> at the sub-chunk's last position, whose reverse
// cumulative sum inside the sub-chunk is da. No y is needed:
// gy_t . y_t = C_t . dC_blk_t (dC_blk_t = S_t^T gy_t over the block's rows).
//
// Design. One C call launches two kernels on the caller's stream.
//   1. ssd_bwd_kernel, one block of 8 warps per (P tile of 32 state rows,
//      head, batch), as the forward's blocks are cut: rows of the state
//      evolve independently, so each block carries its 32 x N slices of S
//      and dS through the whole sequence. 32 rows rather than the
//      forward's 16: the dB and dC partials are per (head, P tile), so
//      fewer tiles halve their scratch (50.3 MB at the train shape, b 4,
//      s 256, h 24, p 64, n 128) and the Q x Q x N products that each tile
//      repeats, while still giving 192 blocks at that shape (384 at the
//      serving shape). It first walks the sub-chunks forward, the state
//      in registers, and writes each entering state S_in to an f32
//      scratch (the state pass; 25.2 MB at the train shape, mostly
//      L2-resident until it is read back). It then walks them in reverse
//      with dS_out in shared memory: B, C, x, gy and S_in of the sub-chunk
//      go into shared memory (B and C widened to f32), and every product
//      above runs in f32 FMAs on the CUDA cores, as register-tiled products
//      out of shared memory (Q x Q and Q x P outputs: 4 x 4 tiles with
//      float4 loads along the reduction, split four ways and summed in
//      order; Q x N and P x N outputs: 4 rows x N/32 columns a thread). dx
//      and dh0 are written directly; the dB, dC and dcum partials go to an
//      f32 scratch.
//   2. ssd_bwd_reduce_kernel sums the partials in a fixed order: dB and dC
//      over the P tiles and heads (one thread per (batch, position, n),
//      written in B's type), dcum over the P tiles, then da as its reverse
//      cumulative sum inside each sub-chunk. No atomics: two calls give the
//      same bits.
//
// Bound. At the train shape (b 4, s 256, h 24, p 64, n 128; bf16 B and C;
// no h0, no gh) the backward must move 20.1 MB (x, gy and dx in f32, a and
// da, B, C, dB and dC), 6.0 us at 3.35 TB/s, and do at least
// 12 b s h p n = 2.42 GFLOP (per position, head and state element one
// multiply-add each for the state, dS, dx, dB, dC and da in the recurrent
// form). The card's least time for them is on the tensor cores, where an
// f32-accurate multiply-add is three TF32 products (the error-compensated
// split), two where one factor is bf16 (exact in TF32): the state, dS and
// dx terms (a factor of B or C) take two, dB, dC and da three, 6.04 GFLOP
// of TF32 at 495 TFLOP/s = 12.2 us (48.8 us at the serving shape). So the
// backward is bound by operations. This kernel's route, the f32 CUDA cores
// at 67 TFLOP/s, would take 36.1 us (144.2 us) for the same count. The
// chunked form here does, per sub-chunk and block
// of P = 32 rows, five P x Q x N products (the state pass, dS_in,
// B dS_out^T, x dS_out, gy S_in), three Q x Q x N (C B^T, M^T C, M B) and
// two Q x Q x P (gy x^T, G^T gy): 2 (5 PQN + 3 Q^2 N + 2 Q^2 P) FLOP, 3.42
// GFLOP at the train shape (1.41 x the least count) and 13.69 GFLOP at the
// serving shape (b 8, s 512; least 9.66). C B^T is formed again by every
// head and P tile of a batch row (the forward forms it once, in a pass of
// its own).
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers; the
// launches go on `stream`; ssd_scan_bwd_launch returns the number of kernels
// it launched (2), or minus the CUDA error. x and gy are contiguous
// (b, s, h, p) with P a multiple of 4, B and C 16-byte rows with N a
// multiple of 8 up to 256 (the wrapper pads and copies to that form), a
// contiguous; h0, gh and dh0 contiguous (b, h, p, n) or null.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kQ = 32;                   // positions per sub-chunk
constexpr int kPT = 32;                  // state rows per block
constexpr int kThreads = 256;            // 8 warps, 4 rows each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 256;
constexpr int kXld = kPT + 4;            // x and gy rows in shared memory
constexpr int kQld = kQ + 1;             // Q x Q matrices, the dx tile
constexpr size_t kMaxSmem = 232448;      // 227 KB, Hopper's per-block limit
static_assert(kQ == 32 && kPT == 32 && kWarps * 4 == kQ,
              "the thread layouts assume 32 x 32 tiles over 8 warps");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const float* x;      // (b, s, h, p) contiguous
  const float* a;      // (b, s, h) contiguous
  const void* B;       // (b, s, n), rows through strides
  const void* C;
  const float* h0;     // (b, h, p, n) contiguous, or null (zero state)
  const float* gy;     // (b, s, h, p) contiguous
  const float* gh;     // (b, h, p, n) contiguous, or null (zero)
  float* dx;           // (b, s, h, p)
  float* da;           // (b, s, h)
  void* dB;            // (b, s, n) contiguous, in B's type
  void* dC;
  float* dh0;          // (b, h, p, n), or null (not wanted)
  float* states;       // scratch (b, h, n_sub, n_pt, kPT, N): entering states
  float* part_bc;      // scratch (2, b, s, n_pt * h, N): dB, dC partials
  float* part_da;      // scratch (b, s, h, n_pt): dcum partials
  int batch, S, H, P, N, n_sub, n_pt;
  long long b_sb, b_ss, c_sb, c_ss;      // strides in elements
};

// Row stride of a Q x N or P x N tile in shared memory: = 4 mod 32 floats,
// so that float4 loads by 8 threads of 8 rows hit 32 banks.
__host__ __device__ inline int ld_n(int N) { return (N + 31) / 32 * 32 + 4; }

// Shared memory: B, C (Q x ld_n), dS, S (kPT x ld_n); x, gy (Q x kXld); G, M
// and dx (Q x kQld); the four partials of a Q x Q product (4 x Q x kQld);
// cum, e = exp(total - cum), exp(cum) (Q each); warp sums and scalars.
__host__ __device__ inline size_t bwd_smem_floats(int N) {
  return (size_t)4 * kQ * ld_n(N) + 2 * kQ * kXld + 7 * kQ * kQld + 3 * kQ +
         2 * kWarps;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum of v, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* wsum, int warp,
                                           int lane) {
  v = warp_sum(v);
  if (lane == 0) wsum[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += wsum[w];
  __syncthreads();
  return t;
}

// out[m][j] = sum_k A[m][k] Bm[j][k] for 32 x 32 outputs, A and Bm row-major
// in shared memory, K a multiple of 4. Thread (quarter q, mi, ni) sums rows
// mi + 8i and columns ni + 8j over the float4 chunks q, q + 4, ...; the four
// quarters' partials are added in order and handed to epi(m, j, value).
// The caller synchronises before reading what epi wrote.
template <typename Epi>
__device__ __forceinline__ void nt_tile(const float* A, int lda,
                                        const float* Bm, int ldb, int K,
                                        float* red, int tid, Epi epi) {
  const int qk = tid >> 6, r = tid & 63, mi = r >> 3, ni = r & 7;
  float acc[4][4] = {};
  for (int k = 4 * qk; k < K; k += 16) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (mi + 8 * i) * lda + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bm + (ni + 8 * j) * ldb + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(av[i].x, bv[j].x, s);
        s = fmaf(av[i].y, bv[j].y, s);
        s = fmaf(av[i].z, bv[j].z, s);
        acc[i][j] = fmaf(av[i].w, bv[j].w, s);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(qk * kQ + mi + 8 * i) * kQld + ni + 8 * j] = acc[i][j];
  __syncthreads();
  for (int o = tid; o < kQ * kQ; o += kThreads) {
    const int m = o >> 5, j = o & 31;
    float v = red[m * kQld + j];
#pragma unroll
    for (int q = 1; q < 4; ++q) v += red[(q * kQ + m) * kQld + j];
    epi(m, j, v);
  }
}

// acc[r][c] += sum_k u(4 warp + r, k) V[k][lane + 32 c] for k < K, columns
// below ncols: rows of the output per warp, columns across the lanes (u is
// read by every lane at one address, V by neighbouring lanes at neighbouring
// addresses).
template <int kNC, typename U>
__device__ __forceinline__ void tn_acc(float (&acc)[4][kNC], U u,
                                       const float* V, int ldv, int K,
                                       int ncols, int warp, int lane) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float uv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) uv[r] = u(4 * warp + r, k);
    const float* vr = V + k * ldv + lane;
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      if (lane + 32 * c < ncols) {
        const float v = vr[32 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(uv[r], v, acc[r][c]);
      }
    }
  }
}

// Q rows of B or C from position t0 into shared memory as f32 (row r at
// r * ld), 16-byte loads, zeros past the end of the sequence.
template <typename T>
__device__ __forceinline__ void load_bc(float* dst, int ld, const T* src,
                                        long long ss, int t0, int q, int N,
                                        int tid) {
  constexpr int kE = 16 / sizeof(T);
  const int per_row = N / kE;
  for (int i = tid; i < kQ * per_row; i += kThreads) {
    const int r = i / per_row, k = i - r * per_row;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < q)
      v = *reinterpret_cast<const uint4*>(src + (t0 + r) * ss + kE * k);
    const T* e = reinterpret_cast<const T*>(&v);
    float* d = dst + r * ld + kE * k;
#pragma unroll
    for (int j = 0; j < kE; j += 4)
      *reinterpret_cast<float4*>(d + j) = make_float4(
          to_float(e[j]), to_float(e[j + 1]), to_float(e[j + 2]),
          to_float(e[j + 3]));
  }
}

// The block's 32 columns of x or gy (rows t0 .. t0 + 31, position-major)
// into shared memory, one float4 a thread, zeros past the end and past P.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          const Args& args, int b, int h,
                                          int p0, int t0, int q, int tid) {
  const int r = tid >> 3, col = 4 * (tid & 7);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < q && p0 + col < args.P)
    v = *reinterpret_cast<const float4*>(
        src + (((size_t)b * args.S + t0 + r) * args.H + h) * args.P + p0 +
        col);
  *reinterpret_cast<float4*>(dst + r * kXld + col) = v;
}

// Warp 0: the cumulative log decay of the sub-chunk at t0 (a = 0 past the
// end), e = exp(total - cum), exp(cum); scal[0] = exp(total).
__device__ __forceinline__ void decays(const Args& args, int b, int h, int t0,
                                       int lane, float* cum, float* e,
                                       float* ecum, float* scal) {
  float c = t0 + lane < args.S
                ? args.a[((size_t)b * args.S + t0 + lane) * args.H + h]
                : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, c, o);
    if (lane >= o) c += u;
  }
  const float total = __shfl_sync(0xffffffffu, c, kQ - 1);
  cum[lane] = c;
  e[lane] = expf(total - c);
  ecum[lane] = expf(c);
  if (lane == 0) scal[0] = expf(total);
}

template <typename T, int kNC>
__global__ void __launch_bounds__(kThreads, kNC <= 4 ? 2 : 1)
ssd_bwd_kernel(Args args) {
  const int pt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int p0 = pt * kPT;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int S = args.S, H = args.H, P = args.P, N = args.N;
  const int ldn = ld_n(N);

  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                       // B[t][n]
  float* Cs = Bs + kQ * ldn;              // C[t][n]
  float* dS = Cs + kQ * ldn;              // dS_out[p][n]
  float* Ss = dS + kPT * ldn;             // S_in[p][n]
  float* xs = Ss + kPT * ldn;             // x[t][p]
  float* gys = xs + kQ * kXld;            // gy[t][p]
  float* G = gys + kQ * kXld;             // G[i][j]
  float* M = G + kQ * kQld;               // M[i][j]
  float* dxs = M + kQ * kQld;             // dx[t][p]
  float* red = dxs + kQ * kQld;           // 4 x Q x kQld
  float* cum = red + 4 * kQ * kQld;
  float* e = cum + kQ;
  float* ecum = e + kQ;
  float* wsum = ecum + kQ;
  float* scal = wsum + kWarps;

  const T* Bg = static_cast<const T*>(args.B) + b * args.b_sb;
  const T* Cg = static_cast<const T*>(args.C) + b * args.c_sb;
  const size_t st_step = (size_t)args.n_pt * kPT * N;   // per sub-chunk
  float* states = args.states +
                  (((size_t)b * H + h) * args.n_sub * args.n_pt + pt) *
                      kPT * N;
  const size_t state_off = ((size_t)b * H + h) * P * N;
  const int J = args.n_pt * H, jrow = pt * H + h;       // partials' rows
  float* part_b = args.part_bc;
  float* part_c = args.part_bc + (size_t)args.batch * S * J * N;

  // this thread's state elements: rows 4 warp + r, columns lane + 32 c
  float s[4][kNC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int p = p0 + 4 * warp + r, n = lane + 32 * c;
      s[r][c] = args.h0 && p < P && n < N
                    ? args.h0[state_off + (size_t)p * N + n] : 0.f;
    }

  // 1. the state pass: S_in of every sub-chunk to the scratch
  for (int c = 0; c < args.n_sub; ++c) {
    const int t0 = c * kQ, q = min(kQ, S - t0);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < kNC; ++cc) {
        const int n = lane + 32 * cc;
        if (n < N) states[c * st_step + (4 * warp + r) * N + n] = s[r][cc];
      }
    load_tile(xs, args.x, args, b, h, p0, t0, q, tid);
    load_bc<T>(Bs, ldn, Bg, args.b_ss, t0, q, N, tid);
    if (warp == 0) decays(args, b, h, t0, lane, cum, e, ecum, scal);
    __syncthreads();
    const float chunk_decay = scal[0];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < kNC; ++cc) s[r][cc] *= chunk_decay;
    tn_acc<kNC>(s, [&](int m, int k) { return xs[k * kXld + m] * e[k]; },
                Bs, ldn, kQ, N, warp, lane);
    __syncthreads();             // before the next sub-chunk's tiles land
  }

  // 2. the reverse walk. dS_out of the last sub-chunk is gh; the boundary
  // term <S_out, dS_out> of a sub-chunk is carried from the one after it.
  float bd = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kNC; ++c) {
      const int p = p0 + 4 * warp + r, n = lane + 32 * c;
      if (n < N) {
        const float g = args.gh && p < P
                            ? args.gh[state_off + (size_t)p * N + n] : 0.f;
        dS[(4 * warp + r) * ldn + n] = g;
        bd = fmaf(s[r][c], g, bd);
      }
    }
  float bdot = args.gh ? block_sum(bd, wsum, warp, lane) : 0.f;

  for (int c = args.n_sub - 1; c >= 0; --c) {
    const int t0 = c * kQ, q = min(kQ, S - t0);
    load_tile(xs, args.x, args, b, h, p0, t0, q, tid);
    load_tile(gys, args.gy, args, b, h, p0, t0, q, tid);
    load_bc<T>(Bs, ldn, Bg, args.b_ss, t0, q, N, tid);
    load_bc<T>(Cs, ldn, Cg, args.c_ss, t0, q, N, tid);
    {
      const float* src = states + c * st_step;
      for (int i = tid; i < kPT * N / 4; i += kThreads) {
        const int r = (4 * i) / N, n = 4 * i - r * N;
        *reinterpret_cast<float4*>(Ss + r * ldn + n) =
            *reinterpret_cast<const float4*>(src + 4 * i);
      }
    }
    if (warp == 0) decays(args, b, h, t0, lane, cum, e, ecum, scal);
    __syncthreads();

    // G = (C B^T) o L and M = (gy x^T) o L, lower triangle (the exp is
    // selected only where j <= i, so an inf above it never meets a 0)
    nt_tile(Cs, ldn, Bs, ldn, N, red, tid, [&](int i, int j, float v) {
      G[i * kQld + j] = j <= i ? v * expf(cum[i] - cum[j]) : 0.f;
    });
    __syncthreads();
    nt_tile(gys, kXld, xs, kXld, kPT, red, tid, [&](int i, int j, float v) {
      M[i * kQld + j] = j <= i ? v * expf(cum[i] - cum[j]) : 0.f;
    });
    __syncthreads();
    // dx = diag(e) B dS_out^T + G^T gy
    nt_tile(Bs, ldn, dS, ldn, N, red, tid, [&](int t, int p, float v) {
      dxs[t * kQld + p] = e[t] * v;
    });
    __syncthreads();
    float xdx[4];
    {
      float acc[4][1];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][0] = dxs[(4 * warp + r) * kQld + lane];
      tn_acc<1>(acc, [&](int m, int k) { return G[k * kQld + m]; }, gys, kXld,
                kQ, kPT, warp, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * warp + r;
        if (t < q && p0 + lane < P)
          args.dx[(((size_t)b * S + t0 + t) * H + h) * P + p0 + lane] =
              acc[r][0];
        xdx[r] = warp_sum(xs[t * kXld + lane] * acc[r][0]);
      }
    }
    // dB partial = diag(e) x dS_out + M^T C
    {
      float acc[4][kNC] = {};
      tn_acc<kNC>(acc, [&](int m, int k) { return xs[m * kXld + k]; }, dS,
                  ldn, kPT, N, warp, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < kNC; ++cc) acc[r][cc] *= e[4 * warp + r];
      tn_acc<kNC>(acc, [&](int m, int k) { return M[k * kQld + m]; }, Cs, ldn,
                  kQ, N, warp, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * warp + r;
        if (t >= q) continue;
        float* dst = part_b + (((size_t)b * S + t0 + t) * J + jrow) * N;
#pragma unroll
        for (int cc = 0; cc < kNC; ++cc)
          if (lane + 32 * cc < N) dst[lane + 32 * cc] = acc[r][cc];
      }
    }
    // dC partial = diag(exp(cum)) gy S_in + M B, and C_t . dC_t
    float cdc[4];
    {
      float acc[4][kNC] = {};
      tn_acc<kNC>(acc, [&](int m, int k) { return gys[m * kXld + k]; }, Ss,
                  ldn, kPT, N, warp, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < kNC; ++cc) acc[r][cc] *= ecum[4 * warp + r];
      tn_acc<kNC>(acc, [&](int m, int k) { return M[m * kQld + k]; }, Bs, ldn,
                  kQ, N, warp, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * warp + r;
        float* dst = part_c + (((size_t)b * S + t0 + t) * J + jrow) * N;
        float dot = 0.f;
#pragma unroll
        for (int cc = 0; cc < kNC; ++cc) {
          const int n = lane + 32 * cc;
          if (n < N) {
            dot = fmaf(Cs[t * ldn + n], acc[r][cc], dot);
            if (t < q) dst[n] = acc[r][cc];
          }
        }
        cdc[r] = warp_sum(dot);
      }
    }
    // dcum partial: gy . y - x . dx, the boundary term at the last position
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = 4 * warp + r;
        if (t < q)
          args.part_da[(((size_t)b * S + t0 + t) * H + h) * args.n_pt + pt] =
              cdc[r] - xdx[r] + (t == q - 1 ? bdot : 0.f);
      }
    __syncthreads();             // every read of dS_out is done
    // dS_in = exp(total) dS_out + (diag(exp(cum)) gy)^T C, in place
    {
      const float chunk_decay = scal[0];
      float acc[4][kNC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < kNC; ++cc) {
          const int n = lane + 32 * cc;
          acc[r][cc] = n < N ? dS[(4 * warp + r) * ldn + n] * chunk_decay
                             : 0.f;
        }
      tn_acc<kNC>(
          acc, [&](int m, int k) { return gys[k * kXld + m] * ecum[k]; }, Cs,
          ldn, kQ, N, warp, lane);
      float part = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * warp + r, p = p0 + row;
#pragma unroll
        for (int cc = 0; cc < kNC; ++cc) {
          const int n = lane + 32 * cc;
          if (n >= N) continue;
          dS[row * ldn + n] = acc[r][cc];
          part = fmaf(Ss[row * ldn + n], acc[r][cc], part);
          if (c == 0 && args.dh0 && p < P)
            args.dh0[state_off + (size_t)p * N + n] = acc[r][cc];
        }
      }
      // <S_out, dS_out> of the sub-chunk before this one
      if (c > 0) bdot = block_sum(part, wsum, warp, lane);
    }
    __syncthreads();             // before the next sub-chunk's tiles land
  }
}

// blockIdx.y 0: dB and dC, one thread per (batch, position, n), the
// partials summed over (P tile, head) in order; 1: da, one thread per
// (batch, sub-chunk, head), dcum summed over the P tiles and then
// accumulated from the sub-chunk's last position back to its first.
template <typename T>
__global__ void __launch_bounds__(256) ssd_bwd_reduce_kernel(Args args) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int J = args.n_pt * args.H, N = args.N;
  if (blockIdx.y == 0) {
    const long long total = (long long)args.batch * args.S * N;
    if (i >= total) return;
    const long long row = i / N, n = i - row * N;
    const float* pb = args.part_bc + row * J * N + n;
    const float* pc = pb + total * J;
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < J; ++j) {
      sb += pb[(long long)j * N];
      sc += pc[(long long)j * N];
    }
    store(static_cast<T*>(args.dB) + i, sb);
    store(static_cast<T*>(args.dC) + i, sc);
  } else {
    if (i >= (long long)args.batch * args.n_sub * args.H) return;
    const int hh = (int)(i % args.H);
    const int c = (int)((i / args.H) % args.n_sub);
    const int bb = (int)(i / ((long long)args.H * args.n_sub));
    float acc = 0.f;
    for (int t = min(args.S, (c + 1) * kQ) - 1; t >= c * kQ; --t) {
      const size_t at = ((size_t)bb * args.S + t) * args.H + hh;
      const float* pd = args.part_da + at * args.n_pt;
      float d = 0.f;
      for (int j = 0; j < args.n_pt; ++j) d += pd[j];
      acc += d;
      args.da[at] = acc;
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Dynamic shared memory above 48 KB must be asked for.
int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
const void* bwd_kernel_for(int N) {
  return N <= 128 ? (const void*)ssd_bwd_kernel<T, 4>
                  : (const void*)ssd_bwd_kernel<T, 8>;
}

template <typename T>
int launch(const Args& args, cudaStream_t stream) {
  const int es = sizeof(T);
  if (!aligned16(args.x) || !aligned16(args.gy) || args.P % 4 ||
      !aligned16(args.B) || !aligned16(args.C) || args.b_sb * es % 16 ||
      args.b_ss * es % 16 || args.c_sb * es % 16 || args.c_ss * es % 16)
    return -(int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_floats(args.N) * sizeof(float);
  if (smem > kMaxSmem) return -(int)cudaErrorInvalidValue;
  const void* kernel = bwd_kernel_for<T>(args.N);
  int e = set_smem(kernel, smem);
  if (e) return -e;
  const dim3 grid(args.n_pt, args.H, args.batch);
  if (args.N <= 128)
    ssd_bwd_kernel<T, 4><<<grid, kThreads, smem, stream>>>(args);
  else
    ssd_bwd_kernel<T, 8><<<grid, kThreads, smem, stream>>>(args);
  e = (int)cudaGetLastError();
  if (e) return -e;
  const long long n_bc = (long long)args.batch * args.S * args.N;
  const long long n_da = (long long)args.batch * args.n_sub * args.H;
  const long long work = n_bc > n_da ? n_bc : n_da;
  ssd_bwd_reduce_kernel<T><<<dim3((unsigned)((work + 255) / 256), 2), 256, 0,
                             stream>>>(args);
  e = (int)cudaGetLastError();
  return e ? -e : 2;
}

}  // namespace

extern "C" {

// State rows per block of the backward.
int ssd_scan_bwd_p_tile() { return kPT; }
// Bytes of shared memory one block of the backward needs for state dim N.
long long ssd_scan_bwd_smem_bytes(int N) {
  return (long long)(bwd_smem_floats(N) * sizeof(float));
}

// Blocks of the backward that one SM holds at once for state dim N
// (bc_dtype: 0 = float32, 1 = bfloat16), or minus the CUDA error.
int ssd_scan_bwd_blocks_per_sm(int N, int bc_dtype) {
  const void* k = bc_dtype == 1 ? bwd_kernel_for<__nv_bfloat16>(N)
                                : bwd_kernel_for<float>(N);
  const size_t smem = bwd_smem_floats(N) * sizeof(float);
  int e = set_smem(k, smem), blocks = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k, kThreads, smem);
  return e ? -e : blocks;
}

// Floats of the backward's scratch: the entering states, the dB and dC
// partials and the dcum partials, for `batch` sequences of S positions.
long long ssd_scan_bwd_scratch_floats(int batch, int S, int H, int P, int N) {
  const long long n_sub = (S + kQ - 1) / kQ, n_pt = (P + kPT - 1) / kPT;
  return (long long)batch * H * n_sub * n_pt * kPT * N +
         2LL * batch * S * n_pt * H * N + (long long)batch * S * H * n_pt;
}

// bc_dtype: 0 = float32, 1 = bfloat16 (B, C, dB and dC share it). h0, gh and
// dh0 may be NULL. scratch: ssd_scan_bwd_scratch_floats(...) floats. Returns
// the number of kernels launched (2) or minus the CUDA error.
int ssd_scan_bwd_launch(const void* x, const void* a, const void* B,
                        const void* C, const void* h0, const void* gy,
                        const void* gh, void* dx, void* da, void* dB,
                        void* dC, void* dh0, void* scratch, int batch, int S,
                        int H, int P, int N, long long b_sb, long long b_ss,
                        long long c_sb, long long c_ss, int bc_dtype,
                        void* stream) {
  if (N <= 0 || N % 8 || N > kMaxN || P <= 0 || S <= 0 || H <= 0 ||
      batch <= 0)
    return -(int)cudaErrorInvalidValue;
  Args args;
  args.x = static_cast<const float*>(x);
  args.a = static_cast<const float*>(a);
  args.B = B;
  args.C = C;
  args.h0 = static_cast<const float*>(h0);
  args.gy = static_cast<const float*>(gy);
  args.gh = static_cast<const float*>(gh);
  args.dx = static_cast<float*>(dx);
  args.da = static_cast<float*>(da);
  args.dB = dB;
  args.dC = dC;
  args.dh0 = static_cast<float*>(dh0);
  args.batch = batch;
  args.S = S;
  args.H = H;
  args.P = P;
  args.N = N;
  args.n_sub = (S + kQ - 1) / kQ;
  args.n_pt = (P + kPT - 1) / kPT;
  float* f = static_cast<float*>(scratch);
  args.states = f;
  f += (size_t)batch * H * args.n_sub * args.n_pt * kPT * N;
  args.part_bc = f;
  f += (size_t)2 * batch * S * args.n_pt * H * N;
  args.part_da = f;
  args.b_sb = b_sb;
  args.b_ss = b_ss;
  args.c_sb = c_sb;
  args.c_ss = c_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return launch<float>(args, s);
  if (bc_dtype == 1) return launch<__nv_bfloat16>(args, s);
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
