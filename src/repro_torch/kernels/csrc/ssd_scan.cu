// Mamba-2 SSD (state-space duality) scan, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:23
// (`_kernel`, wrapper `ssd_scan`). Per (batch, head) it runs the recurrence
//   state_t = state_{t-1} * exp(a_t) + x_t B_t^T      (P x N, f32)
//   y_t     = state_t C_t
// in the chunked SSD form: within a block of Q positions the output is the
// intra-block term ((C B^T) o L) x with L[i][j] = exp(cum_i - cum_j) for
// i >= j, plus the entering state's term (C state^T) * exp(cum_i); the state
// then moves on as state * exp(total) + (x * exp(total - cum))^T B.
//
// Design. One C call launches two kernels on the caller's stream.
//   1. ssd_scan_cb_kernel, four blocks per (sub-chunk, batch), 8 rows
//      each: the lower triangle of C B^T for the sub-chunk's Q x Q
//      positions (no decay, no head: B and C are shared by every head), in
//      f32 FMAs on the CUDA cores, into an f32 scratch the wrapper
//      allocates (b * ceil(s / Q) tiles of Q x Q; 512 KB at the serving
//      shape). It is formed once per (batch, sub-chunk) instead of once per
//      head as the earlier design did, and stays in L2 for the second
//      kernel. The scan is launched as its programmatic dependent: its
//      prologue overlaps this pass, and it waits for it (griddepcontrol)
//      before its first read of the scratch.
//   2. ssd_scan_kernel, one block per (P tile of 16 state rows, head,
//      batch): row p of the state evolves independently of every other
//      row, so each block carries its 16 x N slice of the state through the
//      whole sequence and no block waits for another. At the serving shape
//      (b 8, h 24, p 64) that is 4 x 24 x 8 = 768 blocks of 4 warps, 4 of
//      them per SM (the C B^T pass adds 4 x 16 x 8 = 512 blocks). The block
//      walks sub-chunks of Q = 32 positions, WHATEVER the caller's chunk
//      length: the SSD split is exact for any block length, and a ragged
//      tail (s 200 = 6 x 32 + 8) is zero-filled. Per sub-chunk, between two
//      barriers:
//        - the next sub-chunk's tiles go in flight into the other half of a
//          shared-memory double buffer: B and C (Q x N, bf16 or f32 as
//          given, through their strides) as TMA tensor copies, one per
//          128-byte box, with the 128-byte swizzle and zeros past the end,
//          completing on the stage's mbarrier; x (Q x 16) as one 16-byte
//          cp.async a thread. TMA rather than cp.async for B and C: 16 KB a
//          stage in 4 instructions instead of 8 copies a thread, which had
//          clogged the memory-instruction queue ahead of the shuffles.
//          a (Q) and the 6 C B^T values each thread needs go into
//          registers, one sub-chunk ahead (a register double buffer does
//          what a shared one would for so few values, and leaves the
//          shared memory for a fourth block per SM);
//        - every warp forms the cumulative sum of a itself (a shuffle scan,
//          one position per lane) and exp(total - cum_j), in f32 on the
//          CUDA cores;
//        - the block forms, once, the update's A fragments (x o decay)^T
//          and G = (C B^T) o L on the lower triangle only (above the
//          diagonal G is 0 by a select, so an inf from exp never meets a
//          0), both split into TF32 hi and lo and laid out as the MMA
//          fragments the warps load;
//        - warp w holds the state columns of its n-tiles (w, w + 4, ...) as
//          m16n8k8 accumulator fragments in registers, and the three
//          state-sized products run on the tensor cores:
//            y_off  = C (Q x N) . state^T (N x 16)   (per warp over its own
//                     columns; the 4 partials are summed in warp order
//                     through shared memory),
//            state  = state * exp(total) + (x o decay)^T (16 x Q) . B (Q x N),
//            y_diag = G (Q x Q) . x (Q x 16), each warp one 16 x 8 tile;
//          bf16 B and C reach the MMAs through ldmatrix (transposed for B);
//        - y = y_diag + exp(cum_i) * y_off goes to y[b, t, h, p] directly.
//      Inside every 8-wide k-tile the k index is permuted on both operands
//      (slot t <-> 2t, slot t + 4 <-> 2t + 1), which leaves a product
//      unchanged and puts in each thread the neighbouring pairs that
//      ldmatrix delivers and that the state's accumulator fragment holds
//      (so it doubles as the B operand of y_off).
//
// Precision. Every product is mma.sync.m16n8k8 in TF32 with the
// error-compensated split a = a_hi + a_lo (a_hi rounded to TF32, a_lo the
// remainder, read by the tensor cores truncated to TF32):
// a_lo b_hi + a_hi b_lo + a_hi b_hi with f32 accumulation, which
// keeps f32 accuracy (plain TF32 misses the reference's 2e-4 tolerance by
// ~12x at the reference sweep's scales). Where B and C are bf16 they are
// exact in TF32, their low halves are 0, and the products with them take
// two MMAs, not three. C B^T itself is formed in f32 FMAs. No atomics: the
// sums run in a fixed order, so two calls give the same bits.
//
// Bound. At the serving shape (b 8, s 512, h 24, p 64, n 128; x, a, y, the
// final state f32, B and C bf16) the kernel must move 59.1 MB, 17.6 us at
// 3.35 TB/s, and do at least 4 * b * s * h * p * n = 3.22 GFLOP (per
// position and head one multiply-add per state element for the update and
// one for the output): 48.1 us on the f32 CUDA cores at 67 TFLOP/s, or, as
// f32-accurate TF32 products on the tensor cores at 495 TFLOP/s, 2 x 3.22
// GFLOP = 13.0 us with bf16 B and C (3 x = 19.5 us with f32 B and C). On
// this route it is bound by bytes. The chunked form adds the intra-chunk
// products (Q x Q x 16 per sub-chunk, block and P tile) on top.
//
// Interface: plain C, loaded with ctypes. Pointers are device pointers; the
// launches go on `stream`; ssd_scan_launch returns the number of kernels it
// launched (2), or minus the CUDA error. Every copy moves 16-byte pieces, so
// the kernels take P a multiple of 4, N a multiple of 8 up to 256, and x,
// B and C whose bases and row and batch strides are 16-byte multiples; the
// wrapper pads or copies its inputs to that form.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kQ = 32;                   // positions per sub-chunk
constexpr int kPT = 16;                  // state rows per block (one m16 tile)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kXld = kPT + 4;            // x tile row stride in shared
constexpr int kCbThreads = 256;
constexpr int kMaxN = 256;               // 8 n-tiles of 8 per warp
constexpr size_t kMaxSmem = 232448;      // 227 KB, Hopper's per-block limit

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const float* x;      // (b, s, h, p)
  const float* a;      // (b, s, h)
  const void* B;       // (b, s, n), n contiguous
  const void* C;
  const float* h0;     // (b, h, p, n) contiguous, or null (zero state)
  float* y;            // (b, s, h, p) contiguous
  float* hf;           // (b, h, p, n) contiguous
  float* cb;           // (b, n_sub, Q, Q) scratch: C B^T per sub-chunk
  int S, H, P, N, n_sub;
  long long x_sb, x_ss, x_sh;            // strides in elements
  long long a_sb, a_ss;
  long long b_sb, b_ss, c_sb, c_ss;
};

// ---- shared memory and copies ----------------------------------------------

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// ---- TF32 products ---------------------------------------------------------

// v rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds a finite value: half an ulp is added to the
// magnitude bits and the 13 low bits are cleared. (The cvt instruction is
// emulated on sm_90 by a longer sequence that also guards inf and NaN.)
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo: hi is v rounded to TF32, lo the exact remainder, passed as
// it is (the tensor cores read a TF32 operand's top 19 bits, so lo enters
// truncated to TF32: |v - hi - lo_used| <= 2^-21 |v|).
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
// term k of all their independent products before term k + 1, so that no
// MMA waits on the one before it; the small terms enter first.
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
// ldmatrix delivers them and as the state's accumulator fragment holds them.

// ---- shared memory layout --------------------------------------------------

// G = (C B^T) o L as A fragments of y_diag: the lower-triangle tiles
// (m-tile, k-tile) (0,0) (0,1) (1,0) (1,1) (1,2) (1,3) of the Q x Q matrix.
constexpr int kGFrags = 6;
__device__ __forceinline__ int g_frag(int mt, int kt) {
  return mt == 0 ? kt : 2 + kt;
}

// B and C tiles of a sub-chunk as the tensor maps deliver them: boxes of
// Q rows x 128 bytes (64 bf16 or 32 f32 columns), box after box, each row's
// 16-byte chunks swizzled (TMA's 128-byte swizzle: chunk k of row r at
// k ^ (r mod 8)), so that 8 rows read at one column hit 32 banks.
constexpr int kBox = kQ * 128;
__host__ __device__ inline int bc_boxes(int N, int elem) {
  return (N * elem + 127) / 128;
}
// Byte offset of 16-byte chunk k of row r in a swizzled tile.
__device__ __forceinline__ int bc_chunk(int r, int k) {
  return (k >> 3) * kBox + r * 128 + (((k & 7) ^ (r & 7)) << 4);
}

// Shared memory: for each of two stages the B and the C tile (1024-byte
// aligned, as the swizzle needs); each stage's x tile, Q x kXld f32; G's
// fragments, TF32 hi and lo, [fragment][register][lane]; the (x o decay)^T
// fragments of the update, hi and lo, [k-tile][lane] x 4; the y_off
// partials, 4 warps x 4 tiles x 32 lanes x float4; two mbarriers.
__host__ __device__ inline size_t bc_stage_bytes(int N, int elem) {
  return 2 * (size_t)bc_boxes(N, elem) * kBox;
}
constexpr size_t kXTileBytes = (size_t)kQ * kXld * 4;
constexpr size_t kGBytes = (size_t)kGFrags * 4 * 32 * 2 * 4;
constexpr size_t kXdBytes = (size_t)(kQ / 8) * 32 * 16 * 2;
constexpr size_t kYpartBytes = (size_t)kWarps * 4 * 32 * 16;
__host__ __device__ inline size_t scan_smem_bytes(int N, int elem) {
  return 2 * bc_stage_bytes(N, elem) + 2 * kXTileBytes + kGBytes + kXdBytes +
         kYpartBytes + 16;
}

// C B^T pass: B and C rows widened to f32, N + 4 floats apart (16-byte
// rows whose float4 loads by 8 neighbouring threads hit 32 banks).
__host__ __device__ inline int cb_ld(int N) { return N + 4; }

struct Stage {
  unsigned char* B;   // swizzled tiles (bc_chunk)
  unsigned char* C;
  float* x;           // row j at j * kXld
};

// B and C of sub-chunk c into a stage: arm_bc (one thread, with a block
// barrier before the copies are issued) sets the bytes the stage's mbarrier
// waits for, and fill_bc issues one tensor copy per box (rows past the end
// arrive as zeros), B's from the thread `copy_b`, C's from `copy_c`.
template <typename T>
__device__ __forceinline__ void arm_bc(const Args& args, uint64_t* bar) {
  bar_expect(bar, 2 * bc_boxes(args.N, sizeof(T)) * kBox);
}

template <typename T>
__device__ __forceinline__ void fill_bc(
    const Args& args, const CUtensorMap* map_b, const CUtensorMap* map_c,
    const Stage& st, uint64_t* bar, int c, int b, bool copy_b,
    bool copy_c) {
  const int t0 = c * kQ, boxes = bc_boxes(args.N, sizeof(T));
  constexpr int kCols = 128 / sizeof(T);
  if (copy_b)
    for (int k = 0; k < boxes; ++k)
      tma_load_3d(st.B + k * kBox, map_b, k * kCols, t0, b, bar);
  if (copy_c)
    for (int k = 0; k < boxes; ++k)
      tma_load_3d(st.C + k * kBox, map_c, k * kCols, t0, b, bar);
}

// x rows of sub-chunk c (the block's 16 columns) into a stage: one 16-byte
// cp.async a thread, zero-filled past the end and past P.
__device__ __forceinline__ void fill_x(const Args& args, const Stage& st,
                                       int c, int b, int h, int p0,
                                       int tid) {
  const int t0 = c * kQ, q = min(kQ, args.S - t0);
  const float* xg = args.x + b * args.x_sb + h * args.x_sh + p0;
  const int r = tid >> 2, col = 4 * (tid & 3);
  const bool ok = r < q && p0 + col < args.P;
  cp_async16(st.x + r * kXld + col,
             ok ? xg + (long long)(t0 + r) * args.x_ss + col : xg,
             ok ? 16 : 0);
  cp_async_commit();
}

// ---- kernel 1: C B^T per (sub-chunk, batch) --------------------------------

// Block (c, b, z): rows 8z .. 8z + 7 of sub-chunk c's tile, which need C
// rows 8z .. 8z + 7 and B rows 0 .. 8z + 7. Thread (row i, column j) sums
// C_i . B_j over n in order, four at a time; above the diagonal it writes 0.
template <typename T>
__global__ void __launch_bounds__(kCbThreads) ssd_scan_cb_kernel(Args args) {
  // the scan may start its prologue now; it waits for this grid before
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
  // row r of the load: B row r, or C row 8z + r - rows_b; its position
  auto row_src = [&](int r, int n) -> const T* {
    return r < rows_b ? Bg + (long long)(t0 + r) * args.b_ss + n
                      : Cg + (long long)(t0 + 8 * z + r - rows_b) * args.c_ss +
                            n;
  };
  auto row_dst = [&](int r) {
    return r < rows_b ? bs + r * ld : cs + (r - rows_b) * ld;
  };
  auto row_pos = [&](int r) { return r < rows_b ? r : 8 * z + r - rows_b; };
  // every 16-byte load of the thread in flight before the first store
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

// ---- kernel 2: the scan, per (P tile, head, batch) --------------------------

// G's element that this thread forms for fragment f: warp w forms register
// w of it, row g (+ 8 for registers 1 and 3) + 16 mt and k slot 2t (+ 1
// for registers 2 and 3) + 8 kt of the tile's (m-tile, k-tile) (mt, kt).
__device__ __forceinline__ int g_mt(int f) { return f < 2 ? 0 : 1; }
__device__ __forceinline__ int g_kt(int f) { return f < 2 ? f : f - 2; }
__device__ __forceinline__ int g_row(int f, int w, int g) {
  return 16 * g_mt(f) + g + 8 * (w & 1);
}
__device__ __forceinline__ int g_col(int f, int w, int t) {
  return 8 * g_kt(f) + 2 * t + (w >> 1);
}

// kNT: n-tiles of 8 columns per warp at most (N <= 32 * kNT). map_b and
// map_c: tensor maps of B and C, (n, s, b) in boxes of 128 bytes x Q rows
// with the 128-byte swizzle.
template <typename T, int kNT>
__global__ void __launch_bounds__(kThreads, kNT <= 4 ? 4 : 2)
ssd_scan_kernel(Args args, const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_c) {
  constexpr bool kExact = sizeof(T) == 2;  // bf16 B and C are TF32 values
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31;
  // warp-uniform as the compiler can see: no reconvergence before each
  // ldmatrix and mma
  const int warp = __shfl_sync(full, tid >> 5, 0);
  const int g = lane >> 2, t = lane & 3;
  const int S = args.S, H = args.H, P = args.P, N = args.N;
  const int n_tiles = N / 8;

  extern __shared__ __align__(1024) unsigned char smem[];
  const size_t bc_bytes = bc_stage_bytes(N, sizeof(T));
  float* x_tiles = reinterpret_cast<float*>(smem + 2 * bc_bytes);
  uint32_t* g_hi = reinterpret_cast<uint32_t*>(x_tiles + 2 * kQ * kXld);
  uint32_t* g_lo = g_hi + kGFrags * 4 * 32;
  uint4* xd_hi = reinterpret_cast<uint4*>(g_lo + kGFrags * 4 * 32);
  uint4* xd_lo = xd_hi + (kQ / 8) * 32;
  float4* ypart = reinterpret_cast<float4*>(xd_lo + (kQ / 8) * 32);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ypart + kWarps * 4 * 32);
  auto stage = [&](int c) {
    unsigned char* bc = smem + (c & 1) * bc_bytes;
    return Stage{bc, bc + bc_bytes / 2, x_tiles + (c & 1) * kQ * kXld};
  };
  // B and C of sub-chunk c: armed by thread 0 before a barrier, then
  // issued by the first threads of warps 0 and 1 (the warps with the
  // lighter half of y_diag)
  auto fill_b_c = [&](int c) {
    fill_bc<T>(args, &map_b, &map_c, stage(c), bars + (c & 1), c, b,
               tid == 0, tid == 32);
  };

  if (tid == 0) {
    if (smem_addr(smem) % 1024) __trap();  // the swizzle needs 1024 bytes
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(bars + i)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    arm_bc<T>(args, bars);                 // stage 0's fill
  }
  __syncthreads();

  // state[p0 + g (+8)][8 j + 2t (+1)] of the warp's n-tiles j = warp + 4 jj
  float st[kNT][4];
  const size_t state_off = ((size_t)b * H + h) * P * N;
#pragma unroll
  for (int jj = 0; jj < kNT; ++jj) {
    const int j = warp + kWarps * jj;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + g + 8 * (r >> 1), n = 8 * j + 2 * t + (r & 1);
      st[jj][r] = args.h0 && j < n_tiles && p < P
                      ? args.h0[state_off + (size_t)p * N + n] : 0.f;
    }
  }

  // Registers one sub-chunk ahead: a at this lane's position, and the
  // C B^T values this thread turns into G (element (g_row, g_col) of
  // fragment f); pointers move on by one sub-chunk per step.
  const long long a_step = (long long)kQ * args.a_ss;
  const float* a_ptr = args.a + b * args.a_sb + h + lane * args.a_ss;
  const float* cb_ptr = args.cb + (size_t)b * args.n_sub * kQ * kQ;
  float a_cur = lane < S ? *a_ptr : 0.f, a_next = 0.f;
  fill_b_c(0);
  fill_x(args, stage(0), 0, b, h, p0, tid);
  // Up to here the C B^T pass may still be running (programmatic launch);
  // wait for it (and its writes) before the first read of the scratch.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float cbv[kGFrags], cbn[kGFrags] = {};
#pragma unroll
  for (int f = 0; f < kGFrags; ++f)
    cbv[f] = cb_ptr[g_row(f, warp, g) * kQ + g_col(f, warp, t)];
  const int mi = warp >> 1, pi = warp & 1;   // this warp's y tile
  // y rows 16 mi + g and + 8, columns p0 + 8 pi + 2t and + 1
  const int pc = p0 + 8 * pi + 2 * t;
  const size_t y_step = (size_t)kQ * H * P;
  float* y_row0 = args.y + (((size_t)b * S + 16 * mi + g) * H + h) * P + pc;
  float* y_row1 = y_row0 + (size_t)8 * H * P;

  for (int c = 0; c < args.n_sub; ++c) {
    cp_async_wait_all();                     // this sub-chunk's tiles landed
    bar_wait(bars + (c & 1), (c >> 1) & 1);
    __syncthreads();   // ... and every thread is done with the last one
    a_ptr += a_step;
    cb_ptr += kQ * kQ;
    if (c + 1 < args.n_sub) {
      if (tid == 0) arm_bc<T>(args, bars + ((c + 1) & 1));
      fill_x(args, stage(c + 1), c + 1, b, h, p0, tid);
      a_next = (c + 1) * kQ + lane < S ? *a_ptr : 0.f;
#pragma unroll
      for (int f = 0; f < kGFrags; ++f)
        cbn[f] = cb_ptr[g_row(f, warp, g) * kQ + g_col(f, warp, t)];
    }
    const Stage tl = stage(c);
    const int q = min(kQ, S - c * kQ);     // positions in this sub-chunk

    // cumulative log decay, one position per lane (a = 0 past the end)
    float cum = a_cur;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(full, cum, o);
      if (lane >= o) cum += u;
    }
    const float total = __shfl_sync(full, cum, kQ - 1);

    // (x o decay)^T fragments of the update, once per block: warp w forms
    // k-tile w, rows p = g and g + 8, positions 8w + 2t and 8w + 2t + 1
    {
      const int j0 = 8 * warp + 2 * t;
      const float dec = expf(total - cum);   // decay from here to the end
      const float d0 = __shfl_sync(full, dec, j0);
      const float d1 = __shfl_sync(full, dec, j0 + 1);
      Frag<4, false> fx;
      fx.set(0, tl.x[j0 * kXld + g] * d0);
      fx.set(1, tl.x[j0 * kXld + g + 8] * d0);
      fx.set(2, tl.x[(j0 + 1) * kXld + g] * d1);
      fx.set(3, tl.x[(j0 + 1) * kXld + g + 8] * d1);
      xd_hi[warp * 32 + lane] = make_uint4(fx.hi[0], fx.hi[1], fx.hi[2],
                                           fx.hi[3]);
      xd_lo[warp * 32 + lane] = make_uint4(fx.lo[0], fx.lo[1], fx.lo[2],
                                           fx.lo[3]);
    }

    // G = (C B^T) o L on the lower triangle, once per block: the exp is
    // selected only where j <= i (every exponent <= 0 for a <= 0), so an
    // inf above the diagonal never meets a 0
#pragma unroll
    for (int f = 0; f < kGFrags; ++f) {
      const int i = g_row(f, warp, g), j = g_col(f, warp, t);
      const float ci = __shfl_sync(full, cum, i);
      const float cj = __shfl_sync(full, cum, j);
      uint32_t hi, lo;
      split(j <= i ? cbv[f] * expf(ci - cj) : 0.f, hi, lo);
      g_hi[(f * 4 + warp) * 32 + lane] = hi;
      g_lo[(f * 4 + warp) * 32 + lane] = lo;
    }

    // 1. y_off partial over this warp's state columns: C . state^T
    {
      float yo[2][2][4] = {};
#pragma unroll
      for (int jj = 0; jj < kNT; ++jj) {
        const int j = warp + kWarps * jj;
        if (j >= n_tiles) break;
        Frag<2, false> sb[2];                // p rows 0-7 and 8-15
#pragma unroll
        for (int r = 0; r < 4; ++r) sb[r >> 1].set(r & 1, st[jj][r]);
        Frag<4, kExact> fa[2];               // C rows 16 mt + (g, g + 8)
        if constexpr (kExact) {
          uint32_t m[4];                     // rows 8m + g, columns 2t, 2t+1
          ldmatrix4<false>(m, tl.C + bc_chunk(lane, j));
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            fa[mt].hi[0] = bf16_lo(m[2 * mt]);
            fa[mt].hi[1] = bf16_lo(m[2 * mt + 1]);
            fa[mt].hi[2] = bf16_hi(m[2 * mt]);
            fa[mt].hi[3] = bf16_hi(m[2 * mt + 1]);
          }
        } else {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {       // f32: columns 8j + 2t, +1
            const int i0 = 16 * mt + g, k = 2 * j + (t >> 1), w = 8 * (t & 1);
            const float2 v0 = *reinterpret_cast<const float2*>(
                tl.C + bc_chunk(i0, k) + w);
            const float2 v1 = *reinterpret_cast<const float2*>(
                tl.C + bc_chunk(i0 + 8, k) + w);
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
            mma_term<kExact, false>(k, yo[mt][0], fa[mt], sb[0]);
            mma_term<kExact, false>(k, yo[mt][1], fa[mt], sb[1]);
          }
      }
#pragma unroll
      for (int tile = 0; tile < 4; ++tile) {
        const float* v = yo[tile >> 1][tile & 1];
        ypart[(warp * 4 + tile) * 32 + lane] = make_float4(v[0], v[1], v[2],
                                                           v[3]);
      }
    }
    __syncthreads();   // the update's and G's fragments, the partials
    if (c + 1 < args.n_sub) fill_b_c(c + 1);

    // 2. state = state * exp(total) + (x o decay)^T . B
    {
      const float chunk_decay = expf(total);
#pragma unroll
      for (int jj = 0; jj < kNT; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) st[jj][r] *= chunk_decay;
#pragma unroll
      for (int kk = 0; kk < kQ / 8; ++kk) {
        Frag<4, false> fx;
        const uint4 xh = xd_hi[kk * 32 + lane], xl = xd_lo[kk * 32 + lane];
        fx.hi[0] = xh.x, fx.hi[1] = xh.y, fx.hi[2] = xh.z, fx.hi[3] = xh.w;
        fx.lo[0] = xl.x, fx.lo[1] = xl.y, fx.lo[2] = xl.z, fx.lo[3] = xl.w;
        if constexpr (kExact) {
#pragma unroll
          for (int q4 = 0; q4 < kNT / 4; ++q4) {
            // n-tiles warp + 4 (4 q4 + m), m = 0..3 (tile 0 stands in for
            // a tile past N); rows 8 kk + 2t and + 1 of column g
            const int jt = warp + kWarps * (4 * q4 + (lane >> 3));
            uint32_t m[4];
            ldmatrix4<true>(m, tl.B + bc_chunk(8 * kk + (lane & 7),
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
            fb.set(0, *reinterpret_cast<const float*>(tl.B + bc_chunk(r, k) +
                                                      w));
            fb.set(1, *reinterpret_cast<const float*>(
                          tl.B + bc_chunk(r + 1, k) + w));
#pragma unroll
            for (int kt = 0; kt < 3; ++kt)
              mma_term<false, kExact>(kt, st[jj], fx, fb);
          }
        }
      }
    }

    // 3. y_diag of this warp's tile: G . x over the lower-triangle k-tiles,
    // two at a time into two accumulators
    float yd[2][4] = {};
#pragma unroll
    for (int k2 = 0; k2 < kQ / 16; ++k2) {
      if (k2 > mi) break;                    // above the diagonal
      Frag<4, false> fg[2];
      Frag<2, false> fx[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = 2 * k2 + e, f = g_frag(mi, kk);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fg[e].hi[r] = g_hi[(f * 4 + r) * 32 + lane];
          fg[e].lo[r] = g_lo[(f * 4 + r) * 32 + lane];
        }
        fx[e].set(0, tl.x[(8 * kk + 2 * t) * kXld + 8 * pi + g]);
        fx[e].set(1, tl.x[(8 * kk + 2 * t + 1) * kXld + 8 * pi + g]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          mma_term<false, false>(k, yd[e], fg[e], fx[e]);
    }

    // 4. y = y_diag + exp(cum_i) * (sum of the partials, in warp order)
    const int i0 = 16 * mi + g, i1 = i0 + 8;
    const float e0 = expf(__shfl_sync(full, cum, i0));
    const float e1 = expf(__shfl_sync(full, cum, i1));
    float4 off = ypart[(0 * 4 + warp) * 32 + lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float4 v = ypart[(w * 4 + warp) * 32 + lane];
      off.x += v.x;
      off.y += v.y;
      off.z += v.z;
      off.w += v.w;
    }
    if (i0 < q) {
      if (pc < P) y_row0[0] = (yd[0][0] + yd[1][0]) + e0 * off.x;
      if (pc + 1 < P) y_row0[1] = (yd[0][1] + yd[1][1]) + e0 * off.y;
    }
    if (i1 < q) {
      if (pc < P) y_row1[0] = (yd[0][2] + yd[1][2]) + e1 * off.z;
      if (pc + 1 < P) y_row1[1] = (yd[0][3] + yd[1][3]) + e1 * off.w;
    }
    y_row0 += y_step;
    y_row1 += y_step;
    a_cur = a_next;
#pragma unroll
    for (int f = 0; f < kGFrags; ++f) cbv[f] = cbn[f];
  }

#pragma unroll
  for (int jj = 0; jj < kNT; ++jj) {
    const int j = warp + kWarps * jj;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = p0 + g + 8 * (r >> 1), n = 8 * j + 2 * t + (r & 1);
      if (j < n_tiles && p < P)
        args.hf[state_off + (size_t)p * N + n] = st[jj][r];
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
const void* scan_kernel_for(int N) {
  return N <= 128 ? (const void*)ssd_scan_kernel<T, 4>
                  : (const void*)ssd_scan_kernel<T, 8>;
}

template <typename T, int kNT>
int launch(const Args& args, int batch, cudaStream_t stream) {
  const int es = sizeof(T);
  // 16-byte copies only: the caller pads or copies to this form
  if (!aligned16(args.x) || args.P % 4 || args.x_sb % 4 || args.x_ss % 4 ||
      args.x_sh % 4 || !aligned16(args.B) || !aligned16(args.C) ||
      args.b_sb * es % 16 || args.b_ss * es % 16 || args.c_sb * es % 16 ||
      args.c_ss * es % 16)
    return -(int)cudaErrorInvalidValue;
  const size_t cb_smem = (size_t)(kQ + 8) * cb_ld(args.N) * sizeof(float);
  const size_t smem = scan_smem_bytes(args.N, es);
  if (cb_smem > kMaxSmem || smem > kMaxSmem) return -(int)cudaErrorInvalidValue;
  auto cb_kernel = ssd_scan_cb_kernel<T>;
  auto kernel = ssd_scan_kernel<T, kNT>;
  int e = set_smem((const void*)cb_kernel, cb_smem);
  if (!e) e = set_smem((const void*)kernel, smem);
  if (e) return -e;
  CUtensorMap map_b{}, map_c{};
  e = encode_bc(&map_b, args.B, es, args.N, args.S, batch, args.b_ss,
                args.b_sb);
  if (!e)
    e = encode_bc(&map_c, args.C, es, args.N, args.S, batch, args.c_ss,
                  args.c_sb);
  if (e) return -e;
  cb_kernel<<<dim3(args.n_sub, batch, 4), kCbThreads, cb_smem, stream>>>(
      args);
  e = (int)cudaGetLastError();
  if (e) return -e;
  // the scan's prologue overlaps the C B^T pass (programmatic dependent
  // launch); it waits in-kernel before reading the scratch
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((args.P + kPT - 1) / kPT, args.H, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = (int)cudaLaunchKernelEx(&cfg, kernel, args, map_b, map_c);
  if (!e) e = (int)cudaGetLastError();
  return e ? -e : 2;
}

template <typename T>
int launch_n(const Args& args, int batch, cudaStream_t stream) {
  if (args.N <= 128) return launch<T, 4>(args, batch, stream);
  return launch<T, 8>(args, batch, stream);
}

}  // namespace

extern "C" {

// Positions per sub-chunk, state rows per scan block, C B^T blocks per
// sub-chunk and batch row.
int ssd_scan_sub_chunk() { return kQ; }
int ssd_scan_p_tile() { return kPT; }
int ssd_scan_cb_split() { return kQ / 8; }
// Bytes of shared memory one scan block needs for state dim N
// (bc_dtype: 0 = float32, 1 = bfloat16).
long long ssd_scan_smem_bytes(int N, int bc_dtype) {
  return (long long)scan_smem_bytes(N, bc_dtype == 1 ? 2 : 4);
}

// Scan blocks that one SM holds at once for state dim N, or minus the CUDA
// error.
int ssd_scan_blocks_per_sm(int N, int bc_dtype) {
  const int es = bc_dtype == 1 ? 2 : 4;
  const void* k = bc_dtype == 1 ? scan_kernel_for<__nv_bfloat16>(N)
                                : scan_kernel_for<float>(N);
  const size_t smem = scan_smem_bytes(N, es);
  int e = set_smem(k, smem), blocks = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k, kThreads, smem);
  return e ? -e : blocks;
}

// Floats of the C B^T scratch for `batch` sequences of S positions.
long long ssd_scan_scratch_floats(int batch, int S) {
  return (long long)batch * ((S + kQ - 1) / kQ) * kQ * kQ;
}

// bc_dtype: 0 = float32, 1 = bfloat16 (B and C share it). h0 may be NULL.
// scratch: ssd_scan_scratch_floats(batch, S) floats. P a multiple of 4, N
// of 8, and 16-byte rows of x, B and C (see the interface note above).
// Returns the number of kernels launched (2) or minus the CUDA error.
int ssd_scan_launch(const void* x, const void* a, const void* B,
                    const void* C, const void* h0, void* y, void* hf,
                    void* scratch, int batch, int S, int H, int P, int N,
                    long long x_sb, long long x_ss, long long x_sh,
                    long long a_sb, long long a_ss, long long b_sb,
                    long long b_ss, long long c_sb, long long c_ss,
                    int bc_dtype, void* stream) {
  if (N <= 0 || N % 8 || N > kMaxN || P <= 0 || S <= 0)
    return -(int)cudaErrorInvalidValue;
  Args args;
  args.x = static_cast<const float*>(x);
  args.a = static_cast<const float*>(a);
  args.B = B;
  args.C = C;
  args.h0 = static_cast<const float*>(h0);
  args.y = static_cast<float*>(y);
  args.hf = static_cast<float*>(hf);
  args.cb = static_cast<float*>(scratch);
  args.S = S;
  args.H = H;
  args.P = P;
  args.N = N;
  args.n_sub = (S + kQ - 1) / kQ;
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
  if (bc_dtype == 0) return launch_n<float>(args, batch, s);
  if (bc_dtype == 1) return launch_n<__nv_bfloat16>(args, batch, s);
  return -(int)cudaErrorInvalidValue;
}

}  // extern "C"
