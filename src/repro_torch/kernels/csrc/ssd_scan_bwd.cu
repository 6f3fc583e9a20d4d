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
// The kernels take it in the chunked form over sub-chunks of Q = 32
// positions (whatever the caller's chunk: the split is exact for any block
// length; a ragged tail is zero-filled, a = 0 and x = B = C = gy = 0). With
// cum the cumulative log decay inside the sub-chunk, L[i][j] =
// exp(cum_i - cum_j) for j <= i, e_t = exp(total - cum_t), S_in the state
// entering the sub-chunk and dS_out the gradient into the state leaving it:
//   G      = (C B^T) o L,           M_h = (gy_h x_h^T) o L_h     (Q x Q)
//   dx     = diag(e) B dS_out^T + G^T gy                        (Q x P)
//   dB     = [diag(e_h) x_h]_{Q x hP} dS_out_{hP x N} + (sum_h M_h)^T C
//   dC     = [diag(exp(cum_h)) gy_h]_{Q x hP} S_in_{hP x N} + (sum_h M_h) B
//   dS_in  = exp(total) dS_out + (diag(exp(cum)) gy)^T C        (P x N)
// and for the decays dcum_t = gy_t . y_t - x_t . dx_t, plus
// <S_out, dS_out> at the sub-chunk's last position, whose reverse
// cumulative sum inside the sub-chunk is da. y is not kept by the forward:
// gy_t . y_t = exp(cum_t) gy_t . (C S_in^T)_t + sum_j M_h[t][j] (C B^T)[t][j],
// and the second sum is taken in the other order, gy_t . (G x)_t (one
// Q x Q x P product on the tensor cores, no Q x Q reduction), so no
// per-head dC is formed.
//
// Design. One C call launches three kernels on the caller's stream.
//   1. ssd_bwd_cb_kernel, four blocks per (sub-chunk, batch), 8 rows each:
//      the lower triangle of C B^T in f32 FMAs into an f32 scratch, once
//      per (batch, sub-chunk) for every head, as the forward's pass does.
//      The walk is launched as its programmatic dependent and waits for it
//      (griddepcontrol) only before its reverse walk reads the scratch.
//   2. ssd_bwd_walk_kernel, one block of 4 warps per (P tile of 16 state
//      rows, head, batch), as the forward's blocks are cut (384 blocks at
//      the train shape b 4, s 256, h 24, p 64, n 128; 3 per SM with bf16 B
//      and C). Warp w holds the state columns of its n-tiles (w, w + 4, ...)
//      as m16n8k8 accumulator fragments in registers. It first walks the
//      sub-chunks forward (the state pass: state = state exp(total) +
//      (x o e)^T B) and writes each entering state S_in to an f32 scratch
//      (b, n_sub, h, P, N). It then walks them in reverse with dS in
//      registers, writes each dS_out to a second scratch of that layout,
//      and per sub-chunk runs on the tensor cores y_off = C S_in^T and
//      dx_off = B dS_out^T (each warp over its own columns, the 4 partials
//      summed in warp order through shared memory), dS_in = dS_out
//      exp(total) + (gy o exp(cum))^T C, y_diag = G x and dx_diag = G^T gy
//      (each warp one 16 x 8 tile; G formed once per block from the C B^T
//      scratch). dx and dh0 are written directly, the dcum partial of the
//      P tile to a small scratch. The next sub-chunk's B and C come by TMA
//      tensor maps (128-byte swizzle, zero rows past the end) on mbarriers,
//      its x, gy, a and C B^T tile by cp.async, one stage ahead of the
//      compute (a double buffer); S_in is loaded into registers at the end
//      of the step before, behind its last barrier.
//   3. ssd_bwd_dbc_kernel, one block of 8 warps (16 above N 128) per (head
//      group, sub-chunk, batch), the walk's programmatic dependent; the G
//      head groups of a (sub-chunk, batch) form one thread-block cluster.
//      The block takes heads r, r + G, ... and runs dB and dC as two
//      Q x (its heads' P) x N products over the K dimension (head, state
//      row) in chunks of 32 rows, two cp.async stages deep (each warp a
//      32 x 32 tile of dB or dC), with the lower triangle of its heads'
//      sum of M_h = (gy_h x_h^T) o L_h beside them. Through distributed
//      shared memory every block then sums the G partial Ms in rank order
//      (sum_h M_h, formed once per (batch, sub-chunk)), and takes a share
//      of dB's and dC's 16 x 8 tiles: the G partials summed in rank order,
//      plus M^T C or M B. Last it sums the dcum partials of its heads over
//      the P tiles and takes their reverse cumulative sum (a warp shuffle
//      scan): da. No per-(head, P tile) dB or dC partial exists; the
//      per-group ones live in shared memory. G is the most, up to 8 and
//      dividing h, whose b x n_sub clusters the card holds at once (one
//      wave: a second wave of a few clusters costs a whole block's time):
//      6 at the train shape (192 blocks), 2 at the serving shape.
// Every sum runs in a fixed order and nothing uses atomics: two calls give
// the same bits. Scratch at the train shape: S_in and dS_out 25.2 MB each,
// C B^T 131 KB, dcum partials 393 KB (50.8 MB).
//
// Precision. Every product is mma.sync.m16n8k8 in TF32 with the
// error-compensated split a = a_hi + a_lo (a_hi rounded to TF32, a_lo the
// remainder, read by the tensor cores truncated to TF32):
// a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation, which keeps f32
// accuracy (the relative error of one product is ~2^-21 against TF32's
// 2^-11). bf16 B and C are exact in TF32 (their low halves are 0), so the
// products with a factor of B or C (the state pass, y_off, dx_off, dS_in,
// M^T C, M B) take two MMAs; G x, G^T gy, the Q x hP x N products of dB and
// dC and gy x^T take three, as does every product when B and C are f32.
// The tensor cores' f32 accumulation rounds toward zero; over a long K (the
// 1,536 state rows of kernel 3 at the train shape) that biased dB and dC by
// ~40x the plain version's error, so kernel 3's products start from 0 for
// every chunk of 32 rows and are added to f32 sums (round to nearest).
// C B^T itself is f32 FMAs; cumulative sums and exp stay f32 on the CUDA
// cores, and exp is selected only on the lower triangle (every exponent
// <= 0 for a <= 0), so an inf above the diagonal never meets a 0.
//
// Bound. At the train shape (bf16 B and C; no h0, no gh) the backward must
// move 20.1 MB (x, gy and dx in f32, a and da, B, C, dB and dC), 6.0 us at
// 3.35 TB/s, and do at least 12 b s h p n = 2.42 GFLOP (per position, head
// and state element one multiply-add each for the state, dS, dx, dB, dC and
// da in the recurrent form). As split-TF32 products at 495 TFLOP/s that is
// 6.04 GFLOP, 12.2 us (48.8 us at the serving shape, b 8, s 512): bound by
// operations. The chunked form here does, per (batch, head, sub-chunk),
// six P x Q x N products (the state pass, y_off, dx_off, dS_in, and dB and
// dC in kernel 3) and three Q x Q x P (G x, G^T gy, gy x^T): 2.72 GFLOP at
// the train shape, 1.12 x the least count. Its scratch adds bytes that
// the least count does not have: S_in written once and read twice, dS_out
// written and read once, 126 MB at the train shape, 37.6 us at 3.35 TB/s,
// which bounds this design above the 12.2 us (the walk and kernel 3 each
// move their share of it at 1.5-2.4 TB/s on the card).
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers; the
// launches go on `stream`; ssd_scan_bwd_launch returns the number of kernels
// it launched (3), or minus the CUDA error. x and gy are contiguous
// (b, s, h, p) with P a multiple of 4, B and C 16-byte rows with N a
// multiple of 8 up to 256 (the wrapper pads and copies to that form), a
// contiguous; h0, gh and dh0 contiguous (b, h, p, n) or null.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace {

constexpr int kQ = 32;                   // positions per sub-chunk
constexpr int kPT = 16;                  // state rows per walk block
constexpr int kWarps = 4;                // walk: 4 warps
constexpr int kThreads = kWarps * 32;
constexpr int kXld = kPT + 4;            // walk: x and gy rows in shared
constexpr int kQld = kQ + 4;             // walk: C B^T / G rows in shared
constexpr int kCbThreads = 256;
constexpr int kMaxN = 256;               // 8 n-tiles of 8 per warp
constexpr size_t kMaxSmem = 232448;      // 227 KB, Hopper's per-block limit
static_assert(kQ / 8 == kWarps, "walk warp w forms k-tile w of the update");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store2(float* p, float u, float v) {
  *reinterpret_cast<float2*>(p) = make_float2(u, v);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float u, float v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
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
  float* s_in;         // scratch (b, n_sub, h, P, N): entering states
  float* ds_out;       // scratch (b, n_sub, h, P, N): gradients leaving
  float* cb;           // scratch (b, n_sub, Q, Q): C B^T, lower triangle
  float* part_da;      // scratch (b, n_sub, Q, h, n_pt): dcum per P tile
  int batch, S, H, P, N, n_sub, n_pt;
  long long b_sb, b_ss, c_sb, c_ss;      // strides in elements
};

// ---- shared memory, copies, barriers ---------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte asynchronous copies global -> shared; bytes = 0 writes
// zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// One thread arms the barrier for one fill: the arrival, and the bytes the
// fill's tensor copies will bring.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
// TMA: the box of a 3-D tensor map at (c0, c1, c2), innermost first, into
// shared memory; completes on `bar`. Rows and columns outside the tensor
// arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
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
// The two bf16 of a packed pair, widened to f32 bit patterns (exact TF32).
__device__ __forceinline__ uint32_t bf16_lo(uint32_t v) { return v << 16; }
__device__ __forceinline__ uint32_t bf16_hi(uint32_t v) {
  return v & 0xffff0000u;
}

// ---- TF32 products (as csrc/ssd_scan.cu) -----------------------------------

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds a finite value.
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo: hi is v rounded to TF32, lo the exact remainder, passed as
// it is (the tensor cores read it truncated to TF32).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// An operand fragment as a TF32 pair. kExact: v is already a TF32 value (a
// widened bf16), lo is 0 and is not used.
template <int R, bool kExact>
struct Frag {
  uint32_t hi[R], lo[R];
  __device__ __forceinline__ void set(int r, float v) {
    if (kExact)
      hi[r] = __float_as_uint(v);
    else
      split(v, hi[r], lo[r]);
  }
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b at f32 accuracy, term `k` of three: 0 = a_lo b_hi, 1 = a_hi b_lo
// (each left out where its low half is 0), 2 = a_hi b_hi. Callers issue
// term k of all their independent products before term k + 1.
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma_term(int k, float (&d)[4],
                                         const Frag<4, kAExact>& a,
                                         const Frag<2, kBExact>& b) {
  if (k == 0 && !kAExact) mma(d, a.lo, b.hi);
  if (k == 1 && !kBExact) mma(d, a.hi, b.lo);
  if (k == 2) mma(d, a.hi, b.hi);
}

// Inside every 8-wide k-tile the k index is permuted, on both operands of a
// product (which leaves it unchanged): fragment slot t holds k = 2t and slot
// t + 4 holds k = 2t + 1. Then the pairs a thread holds are neighbours, as
// ldmatrix delivers them, as float2 loads read them and as the state's
// accumulator fragment holds them (so it doubles as a B operand).

__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// ---- B and C tiles ---------------------------------------------------------

// B and C tiles of a sub-chunk as the tensor maps deliver them: boxes of
// Q rows x 128 bytes (64 bf16 or 32 f32 columns), box after box, each row's
// 16-byte chunks swizzled (TMA's 128-byte swizzle: chunk k of row r at
// k ^ (r mod 8)), so that 8 rows read at one column hit 32 banks.
constexpr int kBox = kQ * 128;
__host__ __device__ inline int bc_boxes(int N, int elem) {
  return (N * elem + 127) / 128;
}
__device__ __forceinline__ int bc_chunk(int r, int k) {
  return (k >> 3) * kBox + r * 128 + (((k & 7) ^ (r & 7)) << 4);
}
__host__ __device__ inline size_t bc_tile_bytes(int N, int elem) {
  return (size_t)bc_boxes(N, elem) * kBox;
}

// ---- kernel 1: C B^T per (sub-chunk, batch) --------------------------------

// C B^T pass: B and C rows widened to f32, N + 4 floats apart.
__host__ __device__ inline int cb_ld(int N) { return N + 4; }
__host__ __device__ inline size_t cb_smem_bytes(int N) {
  return (size_t)(kQ + 8) * cb_ld(N) * sizeof(float);
}

// Block (c, b, z): rows 8z .. 8z + 7 of sub-chunk c's tile, which need C
// rows 8z .. 8z + 7 and B rows 0 .. 8z + 7. Thread (row i, column j) sums
// C_i . B_j over n in order, four at a time; above the diagonal it writes 0.
template <typename T>
__global__ void __launch_bounds__(kCbThreads) ssd_bwd_cb_kernel(Args args) {
  // the walk may start its state pass now; it waits for this grid before
  // its first read of C B^T
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int c = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, N = args.N, ld = cb_ld(N);
  const int t0 = c * kQ, q = min(kQ, args.S - t0);
  const int rows_b = 8 * z + 8, rows = rows_b + 8;
  extern __shared__ __align__(16) float smem_cb[];
  float* bs = smem_cb;                   // B row j at j * ld
  float* cs = bs + kQ * ld;              // C row 8z + r at r * ld
  const T* Bg = static_cast<const T*>(args.B) + b * args.b_sb;
  const T* Cg = static_cast<const T*>(args.C) + b * args.c_sb;
  auto row_src = [&](int r, int n) -> const T* {
    return r < rows_b ? Bg + (long long)(t0 + r) * args.b_ss + n
                      : Cg + (long long)(t0 + 8 * z + r - rows_b) * args.c_ss +
                            n;
  };
  auto row_dst = [&](int r) {
    return r < rows_b ? bs + r * ld : cs + (r - rows_b) * ld;
  };
  auto row_pos = [&](int r) { return r < rows_b ? r : 8 * z + r - rows_b; };
  constexpr int kE = 16 / sizeof(T);
  constexpr int kMax = ((kQ + 8) * (kMaxN / kE) + kCbThreads - 1) /
                       kCbThreads;
  const int per_row = N / kE;
  uint4 v[kMax];
#pragma unroll
  for (int m = 0; m < kMax; ++m) {
    const int i = tid + kCbThreads * m, r = i / per_row;
    const bool ok = r < rows && row_pos(r) < q;
    v[m] = ok ? *reinterpret_cast<const uint4*>(
                    row_src(r, kE * (i % per_row)))
              : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int m = 0; m < kMax; ++m) {
    const int i = tid + kCbThreads * m, r = i / per_row;
    if (r >= rows) break;
    const T* e = reinterpret_cast<const T*>(&v[m]);
    float* dst = row_dst(r) + kE * (i % per_row);
#pragma unroll
    for (int k = 0; k < kE; ++k) dst[k] = to_float(e[k]);
  }
  __syncthreads();
  const int i = 8 * z + (tid >> 5), j = tid & 31;
  float acc = 0.f;
  if (j <= i) {
    const float* cr = cs + (i - 8 * z) * ld;
    const float* br = bs + j * ld;
    for (int k = 0; k < N; k += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(cr + k);
      const float4 bv = *reinterpret_cast<const float4*>(br + k);
      acc += cv.x * bv.x;
      acc += cv.y * bv.y;
      acc += cv.z * bv.z;
      acc += cv.w * bv.w;
    }
  }
  args.cb[(((size_t)b * args.n_sub + c) * kQ + i) * kQ + j] = acc;
}

// ---- kernel 2: the walk, per (P tile, head, batch) -------------------------

// Shared memory of the walk: for each of two stages the B and the C tile
// (1024-byte aligned, as the swizzle needs) and the x, gy (Q x kXld) and
// C B^T (Q x kQld, turned into G in place) tiles; the (v o decay)^T
// fragments of the state update, TF32 hi and lo, [k-tile][lane] x 4; the
// y_off and dx_off partials, 4 warps x 4 tiles x 32 lanes x float4 each; the
// dcum row sums of the two P halves; warp sums; two mbarriers.
constexpr size_t kWalkTileFloats = 2 * kQ * kXld + kQ * kQld;
constexpr size_t kXdBytes = (size_t)(kQ / 8) * 32 * 16;
constexpr size_t kPartFloats = (size_t)kWarps * 4 * 32 * 4;
__host__ __device__ inline size_t walk_smem_bytes(int N, int elem) {
  return 4 * bc_tile_bytes(N, elem) + 2 * kWalkTileFloats * 4 +
         2 * kXdBytes + 2 * kPartFloats * 4 + (2 * kQ + kWarps) * 4 + 16;
}

struct Stage {
  unsigned char* B;   // swizzled tiles (bc_chunk)
  unsigned char* C;
  float* x;           // row j at j * kXld
  float* gy;
  float* cb;          // C B^T, then G: row i at i * kQld
};

// acc[mt][pn] += tile (Q x N, rows 16 mt + g (+ 8)) . st^T (state rows
// 8 pn + g) over the warp's n-tiles w, w + 4, ... (the forward's y_off).
template <typename T, int kNT>
__device__ __forceinline__ void tile_by_state(float (&acc)[2][2][4],
                                              const unsigned char* tile,
                                              const float (&st)[kNT][4],
                                              int warp, int lane,
                                              int n_tiles) {
  constexpr bool kExact = sizeof(T) == 2;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < kNT; ++jj) {
    const int j = warp + kWarps * jj;
    if (j >= n_tiles) break;
    Frag<2, false> sb[2];                // state rows 0-7 and 8-15
#pragma unroll
    for (int r = 0; r < 4; ++r) sb[r >> 1].set(r & 1, st[jj][r]);
    Frag<4, kExact> fa[2];               // tile rows 16 mt + (g, g + 8)
    if constexpr (kExact) {
      uint32_t m[4];                     // rows 8m + g, columns 2t, 2t + 1
      ldmatrix4<false>(m, tile + bc_chunk(lane, j));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        fa[mt].hi[0] = bf16_lo(m[2 * mt]);
        fa[mt].hi[1] = bf16_lo(m[2 * mt + 1]);
        fa[mt].hi[2] = bf16_hi(m[2 * mt]);
        fa[mt].hi[3] = bf16_hi(m[2 * mt + 1]);
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {   // f32: columns 8j + 2t, + 1
        const int i0 = 16 * mt + g, k = 2 * j + (t >> 1), w = 8 * (t & 1);
        const float2 v0 = *reinterpret_cast<const float2*>(
            tile + bc_chunk(i0, k) + w);
        const float2 v1 = *reinterpret_cast<const float2*>(
            tile + bc_chunk(i0 + 8, k) + w);
        fa[mt].set(0, v0.x);
        fa[mt].set(1, v1.x);
        fa[mt].set(2, v0.y);
        fa[mt].set(3, v1.y);
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_term<kExact, false>(k, acc[mt][0], fa[mt], sb[0]);
        mma_term<kExact, false>(k, acc[mt][1], fa[mt], sb[1]);
      }
  }
}

// st = st * decay + (v o dec)^T (16 x Q, the fragments formed by form_vd)
// . tile (Q x N), over the warp's n-tiles (the forward's state update).
template <typename T, int kNT>
__device__ __forceinline__ void update_state(float (&st)[kNT][4], float decay,
                                             const uint4* vd_hi,
                                             const uint4* vd_lo,
                                             const unsigned char* tile,
                                             int warp, int lane,
                                             int n_tiles) {
  constexpr bool kExact = sizeof(T) == 2;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < kNT; ++jj)
#pragma unroll
    for (int r = 0; r < 4; ++r) st[jj][r] *= decay;
#pragma unroll
  for (int kk = 0; kk < kQ / 8; ++kk) {
    Frag<4, false> fx;
    const uint4 xh = vd_hi[kk * 32 + lane], xl = vd_lo[kk * 32 + lane];
    fx.hi[0] = xh.x, fx.hi[1] = xh.y, fx.hi[2] = xh.z, fx.hi[3] = xh.w;
    fx.lo[0] = xl.x, fx.lo[1] = xl.y, fx.lo[2] = xl.z, fx.lo[3] = xl.w;
    if constexpr (kExact) {
#pragma unroll
      for (int q4 = 0; q4 < kNT / 4; ++q4) {
        // n-tiles warp + 4 (4 q4 + m), m = 0..3 (tile 0 stands in for a
        // tile past N); rows 8 kk + 2t and + 1 of column g
        const int jt = warp + kWarps * (4 * q4 + (lane >> 3));
        uint32_t m[4];
        ldmatrix4<true>(m, tile + bc_chunk(8 * kk + (lane & 7),
                                           jt < n_tiles ? jt : 0));
        Frag<2, true> fb[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fb[e].hi[0] = bf16_lo(m[e]);
          fb[e].hi[1] = bf16_hi(m[e]);
        }
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (warp + kWarps * (4 * q4 + e) < n_tiles)
              mma_term<false, true>(k, st[4 * q4 + e], fx, fb[e]);
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < kNT; ++jj) {
        const int j = warp + kWarps * jj;
        if (j >= n_tiles) break;
        // f32: rows r and r + 1, column 8j + g
        const int r = 8 * kk + 2 * t, k = 2 * j + (g >> 2);
        const int w = 4 * (g & 3);
        Frag<2, kExact> fb;
        fb.set(0, *reinterpret_cast<const float*>(tile + bc_chunk(r, k) + w));
        fb.set(1,
               *reinterpret_cast<const float*>(tile + bc_chunk(r + 1, k) + w));
#pragma unroll
        for (int kt = 0; kt < 3; ++kt)
          mma_term<false, kExact>(kt, st[jj], fx, fb);
      }
    }
  }
}

// (v o dec)^T fragments of a state update, once per block: warp w forms
// k-tile w, state rows g and g + 8, positions 8w + 2t and 8w + 2t + 1; dec
// is this lane's position's factor.
__device__ __forceinline__ void form_vd(const float* v, float dec,
                                        uint4* vd_hi, uint4* vd_lo, int warp,
                                        int lane) {
  const unsigned full = 0xffffffffu;
  const int g = lane >> 2, t = lane & 3, j0 = 8 * warp + 2 * t;
  const float d0 = __shfl_sync(full, dec, j0);
  const float d1 = __shfl_sync(full, dec, j0 + 1);
  Frag<4, false> fx;
  fx.set(0, v[j0 * kXld + g] * d0);
  fx.set(1, v[j0 * kXld + g + 8] * d0);
  fx.set(2, v[(j0 + 1) * kXld + g] * d1);
  fx.set(3, v[(j0 + 1) * kXld + g + 8] * d1);
  vd_hi[warp * 32 + lane] = make_uint4(fx.hi[0], fx.hi[1], fx.hi[2],
                                       fx.hi[3]);
  vd_lo[warp * 32 + lane] = make_uint4(fx.lo[0], fx.lo[1], fx.lo[2],
                                       fx.lo[3]);
}

// The warp's fragments of a 16 x N state slice (rows p0 + g (+ 8), columns
// 8j + 2t (+ 1) of its n-tiles j) to / from a (P, N) slab; rows past P are
// skipped / read as 0.
template <int kNT>
__device__ __forceinline__ void store_state(float* slab,
                                            const float (&st)[kNT][4], int p0,
                                            int P, int N, int warp,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < kNT; ++jj) {
    const int n = 8 * (warp + kWarps * jj) + 2 * t;
    if (n >= N) break;
    if (p0 + g < P) store2(slab + (size_t)(p0 + g) * N + n, st[jj][0],
                           st[jj][1]);
    if (p0 + g + 8 < P) store2(slab + (size_t)(p0 + g + 8) * N + n,
                               st[jj][2], st[jj][3]);
  }
}
template <int kNT>
__device__ __forceinline__ void load_state(float (&st)[kNT][4],
                                           const float* slab, int p0, int P,
                                           int N, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int jj = 0; jj < kNT; ++jj) {
    const int n = 8 * (warp + kWarps * jj) + 2 * t;
    float2 u = make_float2(0.f, 0.f), v = u;
    if (slab && n < N) {
      if (p0 + g < P)
        u = *reinterpret_cast<const float2*>(slab + (size_t)(p0 + g) * N + n);
      if (p0 + g + 8 < P)
        v = *reinterpret_cast<const float2*>(slab + (size_t)(p0 + g + 8) * N +
                                             n);
    }
    st[jj][0] = u.x, st[jj][1] = u.y, st[jj][2] = v.x, st[jj][3] = v.y;
  }
}

// The block's sum of this thread's v, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* wsum, int warp,
                                           int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) wsum[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += wsum[w];
  __syncthreads();
  return s;
}

// kNT: n-tiles of 8 columns per warp at most (N <= 32 * kNT). map_b and
// map_c: tensor maps of B and C, (n, s, b) in boxes of 128 bytes x Q rows
// with the 128-byte swizzle. Fill f brings sub-chunk f (f < n_sub: the state
// pass, B and x) or 2 n_sub - 1 - f (the reverse walk, B, C, x, gy and
// C B^T) into stage f & 1.
template <typename T, int kNT>
__global__ void __launch_bounds__(kThreads, kNT <= 4 ? 3 : 2)
ssd_bwd_walk_kernel(Args args, const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_c) {
  // kernel 3 may be scheduled now; it waits for this grid before reading
  // anything the walk writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int pt = blockIdx.x, p0 = pt * kPT, h = blockIdx.y, b = blockIdx.z;
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31;
  // warp-uniform as the compiler can see: no reconvergence before each
  // ldmatrix and mma
  const int warp = __shfl_sync(full, tid >> 5, 0);
  const int g = lane >> 2, t = lane & 3;
  const int S = args.S, H = args.H, P = args.P, N = args.N;
  const int n_sub = args.n_sub, n_fill = 2 * n_sub;
  const int n_tiles = N / 8;

  extern __shared__ __align__(1024) unsigned char smem[];
  const size_t tile_bytes = bc_tile_bytes(N, sizeof(T));
  float* tiles = reinterpret_cast<float*>(smem + 4 * tile_bytes);
  uint4* vd_hi = reinterpret_cast<uint4*>(tiles + 2 * kWalkTileFloats);
  uint4* vd_lo = vd_hi + (kQ / 8) * 32;
  float4* ypart = reinterpret_cast<float4*>(vd_lo + (kQ / 8) * 32);
  float4* dxpart = ypart + kWarps * 4 * 32;
  float* rowsum = reinterpret_cast<float*>(dxpart + kWarps * 4 * 32);
  float* wsum = rowsum + 2 * kQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(wsum + kWarps);
  auto stage = [&](int f) {
    unsigned char* bc = smem + (f & 1) * 2 * tile_bytes;
    float* tl = tiles + (f & 1) * kWalkTileFloats;
    return Stage{bc, bc + tile_bytes, tl, tl + kQ * kXld, tl + 2 * kQ * kXld};
  };
  auto sub_chunk = [&](int f) { return f < n_sub ? f : n_fill - 1 - f; };
  // fill f: thread 0 arms the stage's barrier and issues the tensor copies;
  // every thread its cp.async pieces
  auto fill = [&](int f) {
    const Stage sg = stage(f);
    const int c = sub_chunk(f), t0 = c * kQ, q = min(kQ, S - t0);
    const bool rev = f >= n_sub;
    if (tid == 0) {
      const int boxes = bc_boxes(N, sizeof(T));
      constexpr int kCols = 128 / sizeof(T);
      bar_expect(bars + (f & 1), (rev ? 2 : 1) * boxes * kBox);
      for (int k = 0; k < boxes; ++k)
        tma_load_3d(sg.B + k * kBox, &map_b, k * kCols, t0, b,
                    bars + (f & 1));
      if (rev)
        for (int k = 0; k < boxes; ++k)
          tma_load_3d(sg.C + k * kBox, &map_c, k * kCols, t0, b,
                      bars + (f & 1));
    }
    {  // x and gy: rows t0 .. t0 + 31, the block's 16 columns
      const int r = tid >> 2, col = 4 * (tid & 3);
      const bool ok = r < q && p0 + col < P;
      const size_t off = (((size_t)b * S + t0 + r) * H + h) * P + p0 + col;
      cp_async16(sg.x + r * kXld + col, ok ? args.x + off : args.x,
                 ok ? 16 : 0);
      if (rev)
        cp_async16(sg.gy + r * kXld + col, ok ? args.gy + off : args.gy,
                   ok ? 16 : 0);
    }
    if (tid < kQ) {  // a into column kPT of x's rows (padding otherwise)
      const bool ok = tid < q;
      cp_async4(sg.x + tid * kXld + kPT,
                ok ? args.a + ((size_t)b * S + t0 + tid) * H + h : args.a,
                ok ? 4 : 0);
    }
    if (rev) {  // the C B^T tile: 256 16-byte pieces
      const float* src = args.cb + ((size_t)b * n_sub + c) * kQ * kQ;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int i = tid + kThreads * m, r = i >> 3, k = 4 * (i & 7);
        cp_async16(sg.cb + r * kQld + k, src + r * kQ + k, 16);
      }
    }
    cp_async_commit();
  };

  if (tid == 0) {
    if (smem_addr(smem) % 1024) __trap();  // the swizzle needs 1024 bytes
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(bars + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  fill(0);

  const size_t bh_off = ((size_t)b * H + h) * P * N;       // h0, gh, dh0
  const size_t slab_step = (size_t)H * P * N;              // per sub-chunk
  const size_t slab0 = ((size_t)b * n_sub * H + h) * P * N;
  float st[kNT][4];                      // the state, then S_in
  load_state<kNT>(st, args.h0 ? args.h0 + bh_off : nullptr, p0, P, N, warp,
                  lane);

  // 1. the state pass: S_in of every sub-chunk to the scratch
  for (int f = 0; f < n_sub; ++f) {
    cp_async_wait<0>();                  // this fill's pieces landed
    bar_wait(bars + (f & 1), (f >> 1) & 1);
    __syncthreads();   // ... and every thread is done with the last stage
    if (f + 1 == n_sub)                  // the next fill reads C B^T
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
    fill(f + 1);
    const Stage tl = stage(f);
    store_state<kNT>(args.s_in + slab0 + f * slab_step, st, p0, P, N, warp,
                     lane);
    const float cum = warp_scan(tl.x[lane * kXld + kPT], lane);
    const float total = __shfl_sync(full, cum, kQ - 1);
    form_vd(tl.x, expf(total - cum), vd_hi, vd_lo, warp, lane);
    __syncthreads();
    update_state<T, kNT>(st, expf(total), vd_hi, vd_lo, tl.B, warp, lane,
                         n_tiles);
  }

  // 2. the reverse walk. dS_out of the last sub-chunk is gh; the boundary
  // term <S_out, dS_out> of a sub-chunk is carried from the one after it.
  float ds[kNT][4];
  load_state<kNT>(ds, args.gh ? args.gh + bh_off : nullptr, p0, P, N, warp,
                  lane);
  float bdot = 0.f;
  if (args.gh) {
    float part = 0.f;
#pragma unroll
    for (int jj = 0; jj < kNT; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) part = fmaf(st[jj][r], ds[jj][r], part);
    bdot = block_sum(part, wsum, warp, lane);
  }
  // S_in of each sub-chunk is loaded one step ahead, at the end of the
  // step before (st is free there), so its latency hides behind a barrier
  load_state<kNT>(st, args.s_in + slab0 + (n_sub - 1) * slab_step, p0, P, N,
                  warp, lane);
  const int mi = warp >> 1, pi = warp & 1;   // this warp's Q x 16 tile
  const int i0 = 16 * mi + g, i1 = i0 + 8, pl = 8 * pi + 2 * t;

  for (int f = n_sub; f < n_fill; ++f) {
    const int c = n_fill - 1 - f, t0 = c * kQ, q = min(kQ, S - t0);
    cp_async_wait<0>();
    bar_wait(bars + (f & 1), (f >> 1) & 1);
    __syncthreads();
    if (f + 1 < n_fill) fill(f + 1);
    const Stage tl = stage(f);
    store_state<kNT>(args.ds_out + slab0 + c * slab_step, ds, p0, P, N, warp,
                     lane);
    const float cum = warp_scan(tl.x[lane * kXld + kPT], lane);
    const float total = __shfl_sync(full, cum, kQ - 1);
    const float ecum = expf(cum);        // this lane's position
    form_vd(tl.gy, ecum, vd_hi, vd_lo, warp, lane);
    // G = (C B^T) o L in place, lower triangle (elements (warp + 4k, lane))
#pragma unroll
    for (int k = 0; k < kQ / kWarps; ++k) {
      const int i = warp + kWarps * k;
      const float ci = __shfl_sync(full, cum, i);
      float* e = tl.cb + i * kQld + lane;
      *e = lane <= i ? *e * expf(ci - cum) : 0.f;
    }
    // y_off = C S_in^T and dx_off = B dS_out^T over this warp's columns
    {
      float acc[2][2][4] = {};
      tile_by_state<T, kNT>(acc, tl.C, st, warp, lane, n_tiles);
#pragma unroll
      for (int tile = 0; tile < 4; ++tile) {
        const float* v = acc[tile >> 1][tile & 1];
        ypart[(warp * 4 + tile) * 32 + lane] = make_float4(v[0], v[1], v[2],
                                                           v[3]);
      }
    }
    {
      float acc[2][2][4] = {};
      tile_by_state<T, kNT>(acc, tl.B, ds, warp, lane, n_tiles);
#pragma unroll
      for (int tile = 0; tile < 4; ++tile) {
        const float* v = acc[tile >> 1][tile & 1];
        dxpart[(warp * 4 + tile) * 32 + lane] = make_float4(v[0], v[1], v[2],
                                                            v[3]);
      }
    }
    __syncthreads();   // G, the update's fragments, the partials

    // dS_in = dS_out exp(total) + (gy o exp(cum))^T C
    update_state<T, kNT>(ds, expf(total), vd_hi, vd_lo, tl.C, warp, lane,
                         n_tiles);

    // y_diag = G x (k-tiles up to the diagonal) and dx_diag = G^T gy
    // (k-tiles from the diagonal), this warp's 16 x 8 tile
    float yd[2][4] = {}, dxd[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kQ / 8; ++kk) {
      const int k0 = 8 * kk + 2 * t;
      if (kk <= 2 * mi + 1) {
        const float* gr = tl.cb + i0 * kQld + k0;
        Frag<4, false> fg;
        fg.set(0, gr[0]);
        fg.set(1, gr[8 * kQld]);
        fg.set(2, gr[1]);
        fg.set(3, gr[8 * kQld + 1]);
        Frag<2, false> fx;
        fx.set(0, tl.x[k0 * kXld + 8 * pi + g]);
        fx.set(1, tl.x[(k0 + 1) * kXld + 8 * pi + g]);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          mma_term<false, false>(k, yd[kk & 1], fg, fx);
      }
      if (kk >= 2 * mi) {
        const float* gc = tl.cb + k0 * kQld + 16 * mi + g;
        Frag<4, false> fg;
        fg.set(0, gc[0]);
        fg.set(1, gc[8]);
        fg.set(2, gc[kQld]);
        fg.set(3, gc[kQld + 8]);
        Frag<2, false> fy;
        fy.set(0, tl.gy[k0 * kXld + 8 * pi + g]);
        fy.set(1, tl.gy[(k0 + 1) * kXld + 8 * pi + g]);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          mma_term<false, false>(k, dxd[kk & 1], fg, fy);
      }
    }

    // y = y_diag + exp(cum_i) y_off, dx = dx_diag + e_i dx_off (the
    // partials summed in warp order); dx to its place; the dcum row sums
    {
      const float c0 = __shfl_sync(full, cum, i0);
      const float c1 = __shfl_sync(full, cum, i1);
      const float ec[2] = {expf(c0), expf(c1)};
      const float ee[2] = {expf(total - c0), expf(total - c1)};
      float4 yo = ypart[warp * 32 + lane], dxo = dxpart[warp * 32 + lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const float4 u = ypart[(w * 4 + warp) * 32 + lane];
        const float4 v = dxpart[(w * 4 + warp) * 32 + lane];
        yo.x += u.x, yo.y += u.y, yo.z += u.z, yo.w += u.w;
        dxo.x += v.x, dxo.y += v.y, dxo.z += v.z, dxo.w += v.w;
      }
      const float yoff[4] = {yo.x, yo.y, yo.z, yo.w};
      const float dxoff[4] = {dxo.x, dxo.y, dxo.z, dxo.w};
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = r < 2 ? i0 : i1, col = pl + (r & 1);
        const float y = (yd[0][r] + yd[1][r]) + ec[r >> 1] * yoff[r];
        const float dx = (dxd[0][r] + dxd[1][r]) + ee[r >> 1] * dxoff[r];
        rs[r >> 1] += tl.gy[row * kXld + col] * y -
                      tl.x[row * kXld + col] * dx;
        if (row < q && p0 + col < P)
          args.dx[(((size_t)b * S + t0 + row) * H + h) * P + p0 + col] = dx;
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        rs[k] += __shfl_xor_sync(full, rs[k], 1);
        rs[k] += __shfl_xor_sync(full, rs[k], 2);
      }
      if (t == 0) {
        rowsum[pi * kQ + i0] = rs[0];
        rowsum[pi * kQ + i1] = rs[1];
      }
    }
    // <S_in, dS_in>: the boundary term of the sub-chunk before this one
    float part = 0.f;
#pragma unroll
    for (int jj = 0; jj < kNT; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) part = fmaf(st[jj][r], ds[jj][r], part);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(full, part, o);
    if (lane == 0) wsum[warp] = part;
    if (c == 0 && args.dh0)
      store_state<kNT>(args.dh0 + bh_off, ds, p0, P, N, warp, lane);
    if (c > 0)
      load_state<kNT>(st, args.s_in + slab0 + (c - 1) * slab_step, p0, P, N,
                      warp, lane);
    __syncthreads();   // the row sums and warp sums
    if (warp == 0 && lane < q)
      args.part_da[((((size_t)b * n_sub + c) * kQ + lane) * H + h) *
                       args.n_pt + pt] =
          rowsum[lane] + rowsum[kQ + lane] + (lane == q - 1 ? bdot : 0.f);
    bdot = ((wsum[0] + wsum[1]) + wsum[2]) + wsum[3];
  }
}

// ---- kernel 3: dB, dC and da per (head group, sub-chunk, batch) ------------

constexpr int kG = 8;                    // head groups: blocks of a cluster
constexpr int kKC = 32;                  // state rows per chunk of K
constexpr int kXl = kKC + 8;             // x, gy rows (= 8 mod 32 floats)
constexpr int kMl = kQ + 4;              // M rows
// S_in and dS_out rows in shared memory: = 4 mod 32 floats, so that the
// B-fragment reads of rows 2t and columns g hit 32 banks
__host__ __device__ inline int dbc_ld(int N) { return (N + 31) / 32 * 32 + 4; }
// one stage: x and gy (Q x kKC), S_in and dS_out (kKC x N), a (Q)
__host__ __device__ inline int dbc_stage_floats(int N) {
  return 2 * kQ * kXl + 2 * kKC * dbc_ld(N) + kQ;
}
// two stages: two blocks an SM up to N 128 (four stages at one block an SM
// measured 7% slower at the train shape, 11% at the serving shape)
__host__ __device__ inline size_t dbc_smem_bytes(int N) {
  return 2 * (size_t)dbc_stage_floats(N) * sizeof(float);
}

// A block of 2 kCT warps per (head group r, sub-chunk c, batch b); the G
// blocks of (c, b) form one cluster. The block's heads are r, r + G, ...;
// K runs over its chunks (head, 32 state rows) in order, two cp.async
// stages deep. Warp w holds the partial dB (w < kCT) or dC tile of 32 rows
// x 32 columns (columns 32 (w mod kCT)) as 2 x 4 accumulator fragments,
// and warps 0-5 one lower-triangle 16 x 8 tile of M = sum_h (gy_h x_h^T)
// o L_h (warps 6 and 7 zero the two above it). Each chunk's products start
// from 0 and are added to the f32 sums once per chunk: the tensor cores'
// accumulation rounds toward zero, and along the whole K dimension (1,536
// at the train shape) that biased dB and dC by ~40x the plain version's
// error. Then, through distributed shared memory, every block sums the G
// partial Ms in rank order, and takes its share of the 16 x 8 output tiles
// of dB and dC: the G partials summed in rank order, plus M^T C or M B.
// Last, da for its heads.
template <typename T, int kCT>
__global__ void __launch_bounds__(64 * kCT, kCT <= 4 ? 2 : 1)
ssd_bwd_dbc_kernel(Args args) {
  constexpr bool kExact = sizeof(T) == 2;
  constexpr int kW = 2 * kCT, kS = 2;          // warps, stages
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = gridDim.x, r = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(full, tid >> 5, 0);
  const int g = lane >> 2, t = lane & 3;
  const int S = args.S, H = args.H, P = args.P, N = args.N;
  const int t0 = c * kQ, q = min(kQ, S - t0);
  const int ld = dbc_ld(N), sf = dbc_stage_floats(N);
  extern __shared__ __align__(16) float smem_d[];
  // everything below reads what the walk wrote
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  const int n_pc = (P + kKC - 1) / kKC;
  const int n_chunks = (H - r + G - 1) / G * n_pc;
  const size_t slab = ((size_t)b * args.n_sub + c) * H * P * N;
  auto fill = [&](int k) {
    if (k < n_chunks) {
      const int h = r + G * (k / n_pc), r0 = (k % n_pc) * kKC;
      float* st = smem_d + (k % kS) * sf;
      for (int i = tid; i < kQ * kKC / 4; i += 32 * kW) {
        // x and gy: positions t0 .., state rows r0 .. r0 + 31 of head h
        const int row = i >> 3, col = 4 * (i & 7);
        const bool ok = row < q && r0 + col < P;
        const size_t off =
            (((size_t)b * S + t0 + row) * H + h) * P + r0 + col;
        cp_async16(st + row * kXl + col, ok ? args.x + off : args.x,
                   ok ? 16 : 0);
        cp_async16(st + kQ * kXl + row * kXl + col,
                   ok ? args.gy + off : args.gy, ok ? 16 : 0);
      }
      const int per_row = N / 4;
      float* s = st + 2 * kQ * kXl;
      for (int i = tid; i < kKC * per_row; i += 32 * kW) {
        // S_in and dS_out: state rows r0 .. r0 + 31, every column
        const int row = i / per_row, col = 4 * (i - row * per_row);
        const bool ok = r0 + row < P;
        const size_t off = slab + ((size_t)h * P + r0 + row) * N + col;
        cp_async16(s + row * ld + col, ok ? args.s_in + off : args.s_in,
                   ok ? 16 : 0);
        cp_async16(s + kKC * ld + row * ld + col,
                   ok ? args.ds_out + off : args.ds_out, ok ? 16 : 0);
      }
      if (tid < kQ) {
        const bool ok = tid < q;
        cp_async4(s + 2 * kKC * ld + tid,
                  ok ? args.a + ((size_t)b * S + t0 + tid) * H + h : args.a,
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kS - 1; ++k) fill(k);

  const int which = warp / kCT, n0 = 32 * (warp % kCT);  // 0 dB, 1 dC
  const bool has_m = warp < 6;                    // M tile
  const int im0 = 16 * (warp < 2 ? 0 : 1) + g, im1 = im0 + 8;
  const int jx = 8 * (warp < 2 ? warp : warp - 2);   // its first column
  const int jm = jx + 2 * t;
  float acc[2][4][4] = {}, msum[4] = {};
  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait<kS - 2>();             // chunk k landed
    __syncthreads();   // ... for every thread, and stage k - 1 is free
    fill(k + kS - 1);
    const float* xs = smem_d + (k % kS) * sf;
    const float* gys = xs + kQ * kXl;
    const float* ss = gys + kQ * kXl;
    const float* dss = ss + kKC * ld;
    const float* as = dss + kKC * ld;
    const int rows = min(kKC, P - (k % n_pc) * kKC);
    const float cum = warp_scan(as[lane], lane);
    const float total = __shfl_sync(full, cum, kQ - 1);
    // the A rows g + 8i scaled by e (dB) or exp(cum) (dC)
    float sc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float ci = __shfl_sync(full, cum, g + 8 * i);
      sc[i] = which == 0 ? expf(total - ci) : expf(ci);
    }
    const float* av = which == 0 ? xs : gys;
    const float* bv = which == 0 ? dss : ss;
    // this head's L at the M tile, the exp only on the lower triangle
    const float ci0 = __shfl_sync(full, cum, im0);
    const float ci1 = __shfl_sync(full, cum, im1);
    const float cj0 = __shfl_sync(full, cum, jm);
    const float cj1 = __shfl_sync(full, cum, jm + 1);
    float part[2][4][4] = {}, pm[4] = {};
#pragma unroll
    for (int kk = 0; kk < kKC / 8; ++kk) {
      if (8 * kk >= rows) break;
      const int pr = 8 * kk + 2 * t;
      Frag<4, false> fa[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float2 u0 = *reinterpret_cast<const float2*>(
            av + (16 * mt + g) * kXl + pr);
        const float2 u1 = *reinterpret_cast<const float2*>(
            av + (16 * mt + g + 8) * kXl + pr);
        fa[mt].set(0, sc[2 * mt] * u0.x);
        fa[mt].set(1, sc[2 * mt + 1] * u1.x);
        fa[mt].set(2, sc[2 * mt] * u0.y);
        fa[mt].set(3, sc[2 * mt + 1] * u1.y);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 8 * j;
        if (n >= N) break;
        Frag<2, false> fb;
        fb.set(0, bv[pr * ld + n + g]);
        fb.set(1, bv[(pr + 1) * ld + n + g]);
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma_term<false, false>(term, part[mt][j], fa[mt], fb);
      }
      if (has_m) {                       // gy x^T: rows im, columns jm
        const float2 u0 =
            *reinterpret_cast<const float2*>(gys + im0 * kXl + pr);
        const float2 u1 =
            *reinterpret_cast<const float2*>(gys + im1 * kXl + pr);
        const float2 v =
            *reinterpret_cast<const float2*>(xs + (jx + g) * kXl + pr);
        Frag<4, false> fam;
        fam.set(0, u0.x);
        fam.set(1, u1.x);
        fam.set(2, u0.y);
        fam.set(3, u1.y);
        Frag<2, false> fbm;
        fbm.set(0, v.x);
        fbm.set(1, v.y);
#pragma unroll
        for (int term = 0; term < 3; ++term)
          mma_term<false, false>(term, pm, fam, fbm);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
    if (has_m) {
      msum[0] += jm <= im0 ? pm[0] * expf(ci0 - cj0) : 0.f;
      msum[1] += jm + 1 <= im0 ? pm[1] * expf(ci0 - cj1) : 0.f;
      msum[2] += jm <= im1 ? pm[2] * expf(ci1 - cj0) : 0.f;
      msum[3] += jm + 1 <= im1 ? pm[3] * expf(ci1 - cj1) : 0.f;
    }
  }

  // the block's partials to its shared memory, for the cluster to read
  __syncthreads();                       // every warp is done with stage 0
  float* pdb = smem_d;                   // [2][kQ][ld]: dB, dC partials
  float* pms = pdb + 2 * kQ * ld;        // [kQ][kMl]: M partial
  float* Ms = smem_d + sf;               // the cluster's M
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* d = pdb + (which * kQ + 16 * mt + g) * ld + n0 + 8 * j + 2 * t;
      if (n0 + 8 * j < N) {
        store2(d, acc[mt][j][0], acc[mt][j][1]);
        store2(d + 8 * ld, acc[mt][j][2], acc[mt][j][3]);
      }
    }
  if (has_m) {
    store2(pms + im0 * kMl + jm, msum[0], msum[1]);
    store2(pms + im1 * kMl + jm, msum[2], msum[3]);
  } else if (warp < 8) {                 // rows 0-15, columns 16-31
    const int zc = 16 + 8 * (warp - 6) + 2 * t;
    store2(pms + g * kMl + zc, 0.f, 0.f);
    store2(pms + (g + 8) * kMl + zc, 0.f, 0.f);
  }
  cluster.sync();
  for (int i = tid; i < kQ * kQ; i += 32 * kW) {
    const int o = (i >> 5) * kMl + (i & 31);
    float v = 0.f;
    for (int rr = 0; rr < G; ++rr) v += cluster.map_shared_rank(pms, rr)[o];
    Ms[o] = v;
  }
  __syncthreads();

  // this block's output tiles: 16 x 8 tile `task` of dB (then dC), tasks
  // r, r + G, ... of the 4 N / 8 in all
  const int nt_all = N / 8, n_tasks = 4 * nt_all;
  const T* Bg = static_cast<const T*>(args.B) + b * args.b_sb;
  const T* Cg = static_cast<const T*>(args.C) + b * args.c_sb;
  for (int task = r + G * warp; task < n_tasks; task += G * kW) {
    const int wh = task / (2 * nt_all), rem = task - wh * 2 * nt_all;
    const int mt = rem / nt_all, nt = rem - mt * nt_all;
    const int r0 = 16 * mt + g, r1 = r0 + 8, n = 8 * nt + 2 * t;
    float v[4] = {};
    for (int rr = 0; rr < G; ++rr) {
      const float* p = cluster.map_shared_rank(pdb, rr) + wh * kQ * ld + n;
      const float2 u0 = *reinterpret_cast<const float2*>(p + r0 * ld);
      const float2 u1 = *reinterpret_cast<const float2*>(p + r1 * ld);
      v[0] += u0.x, v[1] += u0.y, v[2] += u1.x, v[3] += u1.y;
    }
    // dB: + M^T C; dC: + M B, from 0, then added
    const T* src = wh == 0 ? Cg : Bg;
    const long long ss = wh == 0 ? args.c_ss : args.b_ss;
    float mm[4] = {};
#pragma unroll
    for (int kk = 0; kk < kQ / 8; ++kk) {
      const int i = 8 * kk + 2 * t;
      Frag<4, false> fm;
      if (wh == 0) {
        fm.set(0, Ms[i * kMl + r0]);
        fm.set(1, Ms[i * kMl + r1]);
        fm.set(2, Ms[(i + 1) * kMl + r0]);
        fm.set(3, Ms[(i + 1) * kMl + r1]);
      } else {
        fm.set(0, Ms[r0 * kMl + i]);
        fm.set(1, Ms[r1 * kMl + i]);
        fm.set(2, Ms[r0 * kMl + i + 1]);
        fm.set(3, Ms[r1 * kMl + i + 1]);
      }
      Frag<2, kExact> fb;
      fb.set(0, i < q ? to_float(src[(t0 + i) * ss + 8 * nt + g]) : 0.f);
      fb.set(1, i + 1 < q ? to_float(src[(t0 + i + 1) * ss + 8 * nt + g])
                          : 0.f);
#pragma unroll
      for (int term = 0; term < 3; ++term)
        mma_term<false, kExact>(term, mm, fm, fb);
    }
    T* dst = static_cast<T*>(wh == 0 ? args.dB : args.dC) +
             ((size_t)b * S + t0) * N + n;
    if (r0 < q) store2(dst + (size_t)r0 * N, v[0] + mm[0], v[1] + mm[1]);
    if (r1 < q) store2(dst + (size_t)r1 * N, v[2] + mm[2], v[3] + mm[3]);
  }

  // da: the dcum partials summed over the P tiles in order, then their
  // reverse cumulative sum inside the sub-chunk; this block's heads, one
  // warp each
  for (int hh = r + G * warp; hh < H; hh += G * kW) {
    float v = 0.f;
    if (lane < q) {
      const float* pd = args.part_da +
                        ((((size_t)b * args.n_sub + c) * kQ + lane) * H + hh) *
                            args.n_pt;
      for (int j = 0; j < args.n_pt; ++j) v += pd[j];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(full, v, o);
      if (lane + o < 32) v += u;
    }
    if (lane < q) args.da[((size_t)b * S + t0 + lane) * H + hh] = v;
  }
  cluster.sync();    // no block leaves while another reads its partials
}

// ---- launch ----------------------------------------------------------------

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Dynamic shared memory above 48 KB must be asked for.
int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// cuTensorMapEncodeTiled, through the runtime's driver entry point (so the
// library needs no link against the driver).
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// Tensor map of B or C: (n, s, b) with row and batch strides ss and sb
// elements, boxes of 128 bytes x kQ rows x 1, the 128-byte swizzle, zeros
// outside the tensor.
int encode_bc(CUtensorMap* map, const void* ptr, int es, int N, int S,
              int batch, long long ss, long long sb) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)S,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)(ss * es),
                                 (cuuint64_t)(sb * es)};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / es), (cuuint32_t)kQ, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(
      map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
const void* walk_kernel_for(int N) {
  return N <= 128 ? (const void*)ssd_bwd_walk_kernel<T, 4>
                  : (const void*)ssd_bwd_walk_kernel<T, 8>;
}

// kernel: 0 the C B^T pass, 1 the walk, 2 the dB / dC / da kernel.
template <typename T>
const void* kernel_for(int kernel, int N) {
  if (kernel == 0) return (const void*)ssd_bwd_cb_kernel<T>;
  if (kernel == 1) return walk_kernel_for<T>(N);
  return N <= 128 ? (const void*)ssd_bwd_dbc_kernel<T, 4>
                  : (const void*)ssd_bwd_dbc_kernel<T, 8>;
}
size_t smem_for(int kernel, int N, int es) {
  if (kernel == 0) return cb_smem_bytes(N);
  if (kernel == 1) return walk_smem_bytes(N, es);
  return dbc_smem_bytes(N);
}
int threads_for(int kernel, int N) {
  return kernel == 0 ? kCbThreads : kernel == 1 ? kThreads
                                                : (N <= 128 ? 256 : 512);
}

// Head groups (blocks of one cluster) of the dB / dC / da kernel for a call:
// the most, up to 8 and dividing H, whose b * n_sub clusters the card holds
// at once
// (one wave: more blocks would run a second, mostly idle wave, and the
// kernel's time is a block's whole walk over its chunks), else 1. The
// clusters an SM set holds are asked of the runtime once per shape of
// block and kept.
int dbc_groups(int batch, int n_sub, int H, int N, int bc_dtype) {
  static int cap[2][2][kG + 1];    // [dtype][N > 128][g], 0: not asked yet
  const int big = N > 128, top = H < kG ? H : kG;
  for (int g = top; g > 1; --g) {
    if (H % g) continue;                      // every block as many heads
    int& c = cap[bc_dtype][big][g];
    if (!c) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(g, 1, 1);
      cfg.blockDim = dim3(threads_for(2, N));
      cfg.dynamicSmemBytes = dbc_smem_bytes(N);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = g;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const void* k = bc_dtype == 1 ? kernel_for<__nv_bfloat16>(2, N)
                                    : kernel_for<float>(2, N);
      int n = 0;
      if (set_smem(k, cfg.dynamicSmemBytes) ||
          cudaOccupancyMaxActiveClusters(&n, k, &cfg))
        n = 0;
      c = n > 0 ? n : -1;
    }
    if (c > 0 && (long long)batch * n_sub <= c) return g;
  }
  return 1;
}

// A launch on `stream` that may start while the kernel before it runs
// (programmatic dependent launch; the kernel waits for it in-kernel), in
// clusters of `cluster` blocks along x.
template <typename... KArgs, typename... Params>
int launch_dependent(void (*kernel)(KArgs...), dim3 grid, int threads,
                     size_t smem, int cluster, cudaStream_t stream,
                     Params... params) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  int e = (int)cudaLaunchKernelEx(&cfg, kernel, params...);
  if (!e) e = (int)cudaGetLastError();
  return e;
}

template <typename T, int kNT>
int launch(const Args& args, cudaStream_t stream) {
  const int es = sizeof(T), N = args.N;
  if (!aligned16(args.x) || !aligned16(args.gy) || args.P % 4 ||
      !aligned16(args.B) || !aligned16(args.C) || args.b_sb * es % 16 ||
      args.b_ss * es % 16 || args.c_sb * es % 16 || args.c_ss * es % 16)
    return -(int)cudaErrorInvalidValue;
  auto cb_kernel = ssd_bwd_cb_kernel<T>;
  auto walk_kernel = ssd_bwd_walk_kernel<T, kNT>;
  auto dbc_kernel = ssd_bwd_dbc_kernel<T, kNT>;
  const size_t smem[3] = {cb_smem_bytes(N), walk_smem_bytes(N, es),
                          dbc_smem_bytes(N)};
  const void* kernels[3] = {(const void*)cb_kernel, (const void*)walk_kernel,
                            (const void*)dbc_kernel};
  int e = 0;
  for (int k = 0; k < 3 && !e; ++k) {
    if (smem[k] > kMaxSmem) return -(int)cudaErrorInvalidValue;
    e = set_smem(kernels[k], smem[k]);
  }
  if (e) return -e;
  CUtensorMap map_b{}, map_c{};
  e = encode_bc(&map_b, args.B, es, N, args.S, args.batch, args.b_ss,
                args.b_sb);
  if (!e)
    e = encode_bc(&map_c, args.C, es, N, args.S, args.batch, args.c_ss,
                  args.c_sb);
  if (e) return -e;
  cb_kernel<<<dim3(args.n_sub, args.batch, kQ / 8), kCbThreads, smem[0],
              stream>>>(args);
  e = (int)cudaGetLastError();
  if (!e)
    e = launch_dependent(walk_kernel, dim3(args.n_pt, args.H, args.batch),
                         kThreads, smem[1], 1, stream, args, map_b, map_c);
  const int G = dbc_groups(args.batch, args.n_sub, args.H, N, es == 2);
  if (!e)
    e = launch_dependent(dbc_kernel, dim3(G, args.n_sub, args.batch),
                         64 * kNT, smem[2], G, stream, args);
  return e ? -e : 3;
}

template <typename T>
int launch_n(const Args& args, cudaStream_t stream) {
  if (args.N <= 128) return launch<T, 4>(args, stream);
  return launch<T, 8>(args, stream);
}

}  // namespace

extern "C" {

// Positions per sub-chunk, state rows per walk block, C B^T blocks per
// sub-chunk and batch row; blocks of the third kernel (head groups, one
// cluster) per sub-chunk and batch row for a call's shape.
int ssd_scan_bwd_sub_chunk() { return kQ; }
int ssd_scan_bwd_p_tile() { return kPT; }
int ssd_scan_bwd_cb_split() { return kQ / 8; }
int ssd_scan_bwd_head_groups(int batch, int S, int H, int N, int bc_dtype) {
  return dbc_groups(batch, (S + kQ - 1) / kQ, H, N, bc_dtype);
}

// Bytes of shared memory one block of `kernel` (0 the C B^T pass, 1 the
// walk, 2 the dB / dC / da kernel) needs for state dim N (bc_dtype:
// 0 = float32, 1 = bfloat16).
long long ssd_scan_bwd_smem_bytes(int kernel, int N, int bc_dtype) {
  return (long long)smem_for(kernel, N, bc_dtype == 1 ? 2 : 4);
}

// Blocks of `kernel` that one SM holds at once, or minus the CUDA error.
int ssd_scan_bwd_blocks_per_sm(int kernel, int N, int bc_dtype) {
  if (kernel < 0 || kernel > 2) return -(int)cudaErrorInvalidValue;
  const int es = bc_dtype == 1 ? 2 : 4;
  const void* k = bc_dtype == 1 ? kernel_for<__nv_bfloat16>(kernel, N)
                                : kernel_for<float>(kernel, N);
  const size_t smem = smem_for(kernel, N, es);
  int e = set_smem(k, smem), blocks = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k, threads_for(kernel, N), smem);
  return e ? -e : blocks;
}

// Floats of the backward's scratch for `batch` sequences of S positions:
// the entering states and the leaving gradients (b, n_sub, H, P, N) each,
// C B^T (b, n_sub, Q, Q) and the dcum partials (b, n_sub, Q, H, P tiles).
long long ssd_scan_bwd_scratch_floats(int batch, int S, int H, int P, int N) {
  const long long n_sub = (S + kQ - 1) / kQ, n_pt = (P + kPT - 1) / kPT;
  return 2LL * batch * n_sub * H * P * N + (long long)batch * n_sub * kQ * kQ +
         (long long)batch * n_sub * kQ * H * n_pt;
}

// bc_dtype: 0 = float32, 1 = bfloat16 (B, C, dB and dC share it). h0, gh and
// dh0 may be NULL. scratch: ssd_scan_bwd_scratch_floats(...) floats. Returns
// the number of kernels launched (3) or minus the CUDA error.
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
  const size_t state = (size_t)batch * args.n_sub * H * P * N;
  float* f = static_cast<float*>(scratch);
  args.s_in = f;
  args.ds_out = f + state;
  args.cb = f + 2 * state;
  args.part_da = args.cb + (size_t)batch * args.n_sub * kQ * kQ;
  args.b_sb = b_sb;
  args.b_ss = b_ss;
  args.c_sb = c_sb;
  args.c_ss = c_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return launch_n<float>(args, s);
  if (bc_dtype == 1) return launch_n<__nv_bfloat16>(args, s);
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
