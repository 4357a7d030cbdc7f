// Hand-written Hopper (sm_90a) kernels for K4, the fused window attention
// of the token policies (transformer_ring / transformer_ulysses).
//
// Which Pallas function each kernel replaces:
//
//   attn_fwd_tc, attn_fwd_window, attn_fwd_kernel
//       gymfx_tpu/ops/fused_attention.py::_forward_batched (pallas body
//       _kernel): o = softmax(q k^T * scale) v over the whole window,
//       optionally causal.
//   attn_bwd_dq_tc + attn_bwd_dkdv_tc (one attention_backward call),
//   attn_bwd_window, attn_bwd_kernel
//       gymfx_tpu/ops/fused_attention.py::_backward_batched (pallas body
//       _bwd_kernel): recompute P normalised, dV = P^T dO, dP = dO V^T,
//       delta = rowsum(dP P), dS = P (dP - delta) scale, dQ = dS K,
//       dK = dS^T Q.
//
// The *_tc kernels take bfloat16 and run every product on the tensor
// cores; the f32 kernels run plain f32 FMA on the CUDA cores: the
// *_window kernels for windows of up to 64 (every default-dtype
// transformer_ring run: window 32, 4 heads of 32), attn_fwd_kernel /
// attn_bwd_kernel (streamed) above.  The wrapper (ops/fused_attention.py)
// picks the route by dtype, and the f32 kernels by the window alone
// (f32_kernels), before the launch.
//
// Why not the Pallas design: on the TPU a whole W x W f32 score block
// sits in VMEM (4 MB at W = 1024).  A Hopper block has 227 KB of shared
// memory and no state carried between blocks, so the long-window kernels
// stream 64-row tiles through shared memory and never form a score
// block in memory; only up to W = 64 does a (b, h)'s whole window fit
// one warp's share of an SM, and there the window kernels do hold it.
//
// ---- The bfloat16 route: tensor-core kernels -------------------------
//
// Inputs: (B, S, H, DP) bf16 read through their b, s, h element strides
// with a unit d stride, every row 16-byte aligned; DP is the head dim
// zero-padded to a multiple of 16 (the wrapper pads and, where a stride
// or pointer is not aligned, copies; scale stays 1/sqrt(original D)).
// Outputs are contiguous (B, S, H, DP) bf16.  S <= 1024, DP <= 128.
//
// Tiles and stages.  A warp owns 16 rows per m-tile.  The forward CTA is
// 4 warps x 1 m-tile (64 queries); K/V stream in 64-row tiles through a
// ring of 2 shared-memory stages filled with 16-byte cp.async copies
// (rows past S zero-filled by the copy), so the next tile's copy is in
// flight while the current one is multiplied; one __syncthreads per
// tile.  A shared-memory row is DP + 8 bf16 (an odd number of 16-byte
// chunks), so the 8 row addresses of an ldmatrix land in 8 different
// bank groups.
//
// Fragments.  Every product is mma.sync.aligned.m16n8k16.row.col with
// bf16 operands and f32 accumulators.  A operands (16 rows x 16) come
// from ldmatrix.x4; B operands from ldmatrix.x4 (when the tile is stored
// n-major, as K for Q K^T) or ldmatrix.x4.trans (when stored k-major, as
// V for P V), two n-tiles of 8 per instruction, each B fragment feeding
// the warp's m-tiles.  The f32 accumulator of a score tile (rows g,
// g + 8; columns 2c, 2c + 1 of each 8-wide n-tile, g = lane / 4,
// c = lane % 4) is exactly the A fragment of the next product once packed
// to bf16 pairs, so P and dS go from registers to the tensor cores and
// never to shared memory.
//
// Softmax.  Scores are scaled into the log2 domain (x = s * scale *
// log2 e, folded into one FMA before ex2.approx).  The forward is online:
// per row a running max m, a sum l of the f32 p (each thread sums its
// own columns as a tree; the 4 threads of a row add theirs at the end)
// and O rescaled by exp2(m_old - m_new) when the max grows; one division
// by l at the end, as _kernel divides PV by sum(p).  Causal and ragged-S
// masks set scores to -inf, only in the tiles that reach past S or cross
// the diagonal; rows past S are not stored.
//
// Backward, deterministic and with no atomics, two kernels:
//   attn_bwd_dq_tc     one CTA per (b, h, 128 query rows) (64 above DP =
//                      64), K/V streaming through the ring twice.  Pass
//                      A: m, l and delta = sum_j p_ij dP_ij (an online
//                      sum of e * dP rescaled like l, divided by l at the
//                      end); lse = m + log2 l.  Pass B: p = exp2(x - lse)
//                      (P normalised first, no division per pair), dS =
//                      p (dP - delta) scale, dQ += dS K.  lse and delta go
//                      to an f32 (2, B, H, S) scratch.
//   attn_bwd_dkdv_tc   one CTA per (b, h, 128 key rows) (64 above DP =
//                      64), Q/dO tiles with their lse and delta streaming
//                      through the ring: S^T = K Q^T and dP^T = V dO^T
//                      recomputed, dV += P^T dO and dK += dS^T Q in
//                      registers.
// Every sum has a fixed order (the mma's, then the tile order), and each
// output element is written by the one CTA that owns its row, so two
// calls give the same bits.
//
// Rounding points (tests/ and chip_smoke.py hold the kernels to an
// emulation of exactly these, gymfx_tpu_torch/ops/cases.py): inputs are
// bf16; products accumulate in f32; P (forward: per tile, against the
// running max; backward: normalised) is rounded to bf16 before P V and
// P^T dO; dS is rounded to bf16 before dS K and dS^T Q; row max, sums,
// lse and delta stay f32; outputs are rounded to bf16 once.
//
// What bounds them on the H100 (data sheet: 3.35 TB/s, 989 TFLOP/s
// bf16 dense).  At the update's shape (B = 4096, S = 256, H = 4, D = 32):
//   forward   bytes: q, k, v read and o written, 1.07 GB = 320.5 us,
//             against 137 GFLOP of products = 139 us.
//   backward  q, k, v, dO read and dq, dk, dv written, 1.88 GB = 560.9 us,
//             against 9 products of 2 D FLOP per (query, key) pair
//             (S and dP in each of pass A, pass B and the dK/dV kernel,
//             dQ, dV, dK) = 618 GFLOP = 625 us: the operations.
// What holds them back (PERF.md, measured on the card): the forward's
// 64-query CTAs each read every K/V tile of their (b, h) from L2, 2.15
// GB in all; its memory skeleton alone (the same copies, no arithmetic)
// takes most of its time.  Between the copies, each warp's loop is a
// chain of dependent steps (mma, row max, exp2, mma) that four to five
// warps per scheduler do not hide.  The backward does three exp2 per pair
// (pass A, pass B, the dK/dV kernel), and each of its 128-row CTAs reads
// the whole window of the other operand from L2 (the dQ kernel twice).
// wgmma,
// which reads B once per 64 rows, and TMA multicast across a cluster of
// the CTAs that share K/V, are the next steps.
//
// ---- The float32 route, windows of up to 64: attn_*_window -------------
//
// Inputs: (B, S, H, DP) f32 read through their b, s, h element strides
// with a unit d stride, every row 16-byte aligned; DP is the head dim
// zero-padded to a multiple of 32 (the wrapper pads and, where a stride
// or pointer is not aligned, copies; scale stays 1/sqrt(original D)).
// Outputs are contiguous (B, S, H, DP).  S <= 64, DP <= 128.
//
// What bounds them on the H100 (data sheet: 3.35 TB/s, 67 TFLOP/s f32
// on the CUDA cores) at the update minibatch of transformer_ring's
// default run, (4096, 32, 4, 32):
//   forward   q, k, v read and o written, 268 MB = 80.1 us, against
//             2 products of 2 D FLOP per (query, key) pair, 2.15 GFLOP
//             = 32 us: the bytes.
//   backward  q, k, v, dO read and dq, dk, dv written, 470 MB = 140.2
//             us, against 5 products (S, dP, dV, dQ, dK), 5.37 GFLOP =
//             80 us at the CUDA cores' peak: the bytes, with the
//             products at 57% of them.
// Measured there (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md):
// the forward 101.5-102.0 us, its memory skeleton (the same grid and
// copies, no arithmetic: attention_probe.cu) 90.4-91.8; the backward
// 212.5-214.1 us, its skeleton 161.0-162.5.  The streamed kernels (below)
// took 626.5-633.0 and 1,479.6-1,493.2 us on the same card: their
// 128-row CTAs (64 in the backward) gave 3/4 (1/2) of the threads
// zero rows at S = 32, each score was one thread's serial chain of D
// FMAs, the tiles were staged by 4-byte loads into 16 KB of zero
// padding, and the backward formed 9 products and 3 expf a pair.
//
// Design.  One warp owns one (b, h): it stages the window's q, k, v (and
// dO) rows into its own shared memory, SP = 32 or 64 rows (zero past S)
// of DP + 4 floats, with 16-byte cp.async copies (a (b, h) row is 128
// contiguous bytes at D = 32, so a warp's copy is whole 128-byte lines,
// and the four warps of a CTA at H = 4 read one contiguous 16 KB block
// of each operand).  Warps never wait on each other: no __syncthreads,
// only __syncwarp.  The whole window is on chip, so the softmax is one
// pass: the exact row max and sum over the row, no online rescale.
// Every product is a 32 x 32 register tile a warp (a thread 4 rows x 8
// columns: rows 4 rg + r, rg = lane / 4), both operands read from shared
// memory as float4 (12 LDS.128 per 128 FMA; rows DP + 4 or SP + 4 floats
// long, so a quarter-warp's 16-byte reads fall in distinct banks):
//   tile_nt  C = A B^T (S = Q K^T, dP = dO V^T; the thread's columns
//            cg + 4 n, cg = lane % 4, so a row's 4 threads are a quad
//            and its max and sums are two shuffles),
//   tile_nn  C = A B (O = P V, dQ = dS K),
//   tile_tn  C = A^T B (dV = P^T dO, dK = dS^T Q),
// the last two with the thread's columns 4 cg .. 4 cg + 3 and 16 + 4 cg
// .. 16 + 4 cg + 3 of a 32-column chunk (two float4 stores a row).
// The backward recomputes S once, forms P and dP once, keeps P and dS
// in registers and shared memory, and makes dQ, dK and dV from them: 5
// products a pair, one expf a pair, no atomics.  At SP = 32 P goes over
// v's rows (dP was its last use) and dS over dO's once dV is made, so a
// warp needs 4 operand tiles: 18.4 KB, 3 CTAs of 4 warps an SM.
//
// Why the CUDA cores and not 3xTF32 on the tensor cores: at the CUDA
// cores' peak the backward's 5 products take 57% of its byte time, and
// its memory skeleton is three quarters of what it measures; 3xTF32
// would triple the tensor work, add the operand splits and, since an
// m16n8k8.tf32 accumulator is not the next product's A fragment, move P
// and dS through shared memory all the same.  Plain TF32 is out: the
// route is held to 1e-4 x max|plain| and TF32 rounds inputs to 2^-11.
//
// Why not persistent, double-buffered CTAs: at 3-4 CTAs (12-16 warps)
// an SM, each warp alone in its load, compute and store, the warps that
// copy and the warps that multiply are already different warps.
//
// Rounding points (ops/cases.py emulates exactly these, in this order):
// every dot product is one fmaf per term in increasing k (head dim for S
// and dP, key for O and dQ, query for dV and dK), from 0; x = s * scale;
// e = expf(x - m); a row's l (plain adds) and delta (fmaf of p, dP) sum
// the thread's keys (j % 4 == cg) in increasing j, then the quad adds
// (c0 + c1) + (c2 + c3); p = e * (1 / l); dS = (p (dP - delta)) scale;
// o = (sum_j e v) * (1 / l).  The elementwise steps are __f*_rn, never
// contracted.  The sums have a fixed order and each output element is
// written by one thread, so two calls give the same bits.
//
// ---- The float32 route, longer windows: attn_fwd_kernel / attn_bwd_kernel
//
// The streamed kernels, for 64 < S <= 1024 (no main-path configuration runs
// them).  Inputs are read as (B, S, H, D) through their element strides;
// o, dq, dk, dv are written contiguous (B, S, H, D).  One row per thread
// group (TPR threads share a row, DPT dims each, partial dot products
// joined with warp shuffles), K/V rows read from shared memory as
// broadcast float4 loads.  The forward keeps an online softmax; the
// backward is one block per (b, h): phase 1 (threads own query rows)
// streams K/V for m, l, delta and then dQ; phase 2 (threads own key
// rows) streams Q/dO for dK and dV.
//
// Each extern "C" entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError()
// (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWindow = 1024;

// ======================================================================
// bfloat16: tensor-core kernels
// ======================================================================

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;   // rows of a streamed tile, and keys per online-softmax step
constexpr int kStages = 2;  // stages of a streamed operand's ring

struct TcStrides {
  long long t[4][3];  // [q, k, v, dO][b, s, h], in elements; d stride 1
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed copy groups of this thread are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half), rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error ~2^-22, results
// below 2^-126 flushed to 0, 2^-inf = 0): one instruction where exp2f
// adds a denormal range fix-up around it.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
struct Tc {
  static constexpr int LD = DP + 8;          // shared-memory row, in bf16
  static constexpr int TILE = kTile * LD;    // one 64-row tile, in bf16
  static constexpr int KS = DP / 16;         // k-steps over the head dim
  static constexpr int ND = DP / 8;          // n-tiles over the head dim
  static constexpr int CHUNKS = DP / 8;      // 16-byte chunks per row
};

// Rows r0 .. r0 + ROWS - 1 of one (b, h) slice (row stride ss elements)
// into a [ROWS][DP + 8] shared tile, by the CTA's THREADS threads; rows at
// or past S are zero-filled.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* tile, const bf16* base, long long ss, int r0,
                                                int S) {
  constexpr int CH = Tc<DP>::CHUNKS, N = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (N % THREADS == 0 || e < N) {
      const int r = e / CH, c = e % CH;
      const int row = r0 + r;
      const bool ok = row < S;
      const bf16* src = base + static_cast<long long>(ok ? row : 0) * ss + c * 8;
      cp_async16(smem_addr(tile + r * Tc<DP>::LD + c * 8), src, ok);
    }
  }
}

// A fragment (rows row0 .. row0 + 15, columns col0 .. col0 + 15) of a
// row-major shared tile
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int col0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, smem_addr(tile + (row0 + (lane & 15)) * Tc<DP>::LD + col0 + (lane >> 4) * 8));
}

// B fragments of two n-tiles (n0 .. n0 + 15) at k-step k0 .. k0 + 15 from
// a tile stored n-major ([n][k], as K for Q K^T): b[0], b[1] for n-tile
// n0 / 8, b[2], b[3] for the next
template <int DP>
__device__ __forceinline__ void load_b_nmajor(uint32_t (&b)[4], const bf16* tile, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const int n = n0 + (lane & 7) + ((lane >> 4) << 3);
  const int k = k0 + ((lane >> 3) & 1) * 8;
  ldsm_x4(b, smem_addr(tile + n * Tc<DP>::LD + k));
}

// The same from a tile stored k-major ([k][n], as V for P V)
template <int DP>
__device__ __forceinline__ void load_b_kmajor(uint32_t (&b)[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const int k = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int n = n0 + (lane >> 4) * 8;
  ldsm_x4_t(b, smem_addr(tile + k * Tc<DP>::LD + n));
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

template <int MT, int N>
__device__ __forceinline__ void zero(float (&acc)[MT][N][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) zero(acc[mt]);
}

// acc[mt] (16 rows x 64 columns each) = A (rows a_row0 + 16 mt .. + 15
// of a_tile, over DP) times the 64 rows of b_tile (n-major).  Each B
// fragment read from shared memory feeds MT products.
template <int DP, int MT>
__device__ __forceinline__ void product_nmajor(float (&acc)[MT][8][4], const bf16* a_tile,
                                               int a_row0, const bf16* b_tile) {
  zero(acc);
#pragma unroll
  for (int ks = 0; ks < Tc<DP>::KS; ++ks) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) load_a<DP>(a[mt], a_tile, a_row0 + 16 * mt, ks * 16);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      load_b_nmajor<DP>(b, b_tile, np * 16, ks * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// out[mt] (16 rows x DP each) += P[mt] (16 x 64 f32 accumulators, rounded
// to bf16 here) times the 64 rows of tile b (k-major, 64 x DP)
template <int DP, int MT>
__device__ __forceinline__ void product_kmajor(float (&out)[MT][Tc<DP>::ND][4],
                                               const float (&p)[MT][8][4], const bf16* b_tile) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack_bf16(p[mt][2 * ks][0], p[mt][2 * ks][1]);
      a[mt][1] = pack_bf16(p[mt][2 * ks][2], p[mt][2 * ks][3]);
      a[mt][2] = pack_bf16(p[mt][2 * ks + 1][0], p[mt][2 * ks + 1][1]);
      a[mt][3] = pack_bf16(p[mt][2 * ks + 1][2], p[mt][2 * ks + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < Tc<DP>::ND / 2; ++dp) {
      uint32_t b[4];
      load_b_kmajor<DP>(b, b_tile, ks * 16, dp * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(out[mt][2 * dp], a[mt], b[0], b[1]);
        mma_bf16(out[mt][2 * dp + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// Rows row (accumulator elements 0, 1) and row + 8 (2, 3) of a 16 x DP
// accumulator, as bf16 into contiguous (B, S, H, DP) at (b, ., h); rows
// at or past S are not stored.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[Tc<DP>::ND][4], int b,
                                           int h, int row, int S, int H) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i >= S) continue;
    bf16* dst = out + ((static_cast<long long>(b) * S + i) * H + h) * DP + 2 * c;
#pragma unroll
    for (int n = 0; n < Tc<DP>::ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Set to -inf the entries of a 16 x 64 score tile (rows row, row + 8;
// columns col0 + 8 n + 2 c + e) whose column is past S or, when causal,
// whose key comes after its query.  ``keys_are_columns`` says which index
// is the key (the rows' own tails past S are never stored).  Called only
// for tiles that reach past S or cross the diagonal.
__device__ __forceinline__ void mask_scores(float (&s)[8][4], int row, int col0, int S,
                                            bool causal, bool keys_are_columns) {
  const int c = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + 8 * n + 2 * c + (e & 1), r = row + 8 * (e >> 1);
      const int j = keys_are_columns ? col : r, i = keys_are_columns ? r : col;
      if (col >= S || (causal && j > i)) s[n][e] = -INFINITY;
    }
}

// Row r (0: row g, 1: row g + 8) of a 16 x 64 accumulator tile reduced
// over this thread's 16 columns by a tree (depth 4, where a running
// reduction would chain 16 dependent operations).
template <typename F>
__device__ __forceinline__ float tree_reduce(const float (&x)[8][4], int r, F op) {
  float a[8];
#pragma unroll
  for (int n = 0; n < 8; ++n) a[n] = op(x[n][2 * r], x[n][2 * r + 1]);
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int n = 0; n < w; ++n) a[n] = op(a[n], a[n + w]);
  return a[0];
}

struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

// The running max of rows row, row + 8 over a (masked, unscaled) score
// tile, in the log2 domain: m_new = max(m, max_j s_j * scale_log2) (the
// scale is positive, so scaling the max is the max of the scaled).  mu
// is the value subtracted before exp2 (0 while the row has no key yet).
__device__ __forceinline__ void running_max(const float (&s)[8][4], float scale_log2,
                                            float (&m)[2], float (&mu)[2], float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mx = fmaxf(m[r], quad_max(tree_reduce(s, r, Max())) * scale_log2);
    mu[r] = mx == -INFINITY ? 0.f : mx;
    alpha[r] = fast_exp2(m[r] - mu[r]);
    m[r] = mx;
  }
}

// The forward: one CTA per (b, h, BM = 16 MT WARPS queries); K/V tiles
// stream through the ring.
template <int DP, int WARPS, int MT>
__global__ void __launch_bounds__(WARPS * 32)
attn_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            bf16* __restrict__ o, TcStrides st, int S, int H, int causal, float scale_log2,
            int ntiles) {
  using T = Tc<DP>;
  constexpr int BM = 16 * MT * WARPS, THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // [kStages][TILE]
  bf16* sv = sk + kStages * T::TILE;         // [kStages][TILE]
  bf16* sq = sv + kStages * T::TILE;         // [BM][LD]

  const int tile = blockIdx.x % ntiles, bh = blockIdx.x / ntiles;
  const int h = bh % H, b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = tile * BM, wrow = warp * 16 * MT;
  const int qrow = q0 + wrow + (lane >> 2);  // rows qrow + 16 mt, + 8
  const bf16* kb = k + b * st.t[1][0] + h * st.t[1][2];
  const bf16* vb = v + b * st.t[2][0] + h * st.t[2][2];
  const long long kss = st.t[1][1], vss = st.t[2][1];

  const int kend = causal ? min(S, q0 + BM) : S;
  const int nkt = (kend + kTile - 1) / kTile;
  auto load_keys = [&](int kt) {
    const int stage = kt % kStages;
    load_tile_async<DP, kTile, THREADS>(sk + stage * T::TILE, kb, kss, kt * kTile, S);
    load_tile_async<DP, kTile, THREADS>(sv + stage * T::TILE, vb, vss, kt * kTile, S);
  };
  load_tile_async<DP, BM, THREADS>(sq, q + b * st.t[0][0] + h * st.t[0][2], st.t[0][1], q0, S);
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {  // the ring's first kStages - 1 tiles
    if (kt < nkt) load_keys(kt);
    cp_async_commit();
  }

  uint32_t qf[MT][T::KS][4];
  float acc[MT][T::ND][4];
  zero(acc);
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }

  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t has landed; every warp is done with tile t - 1
    if (t + kStages - 1 < nkt) load_keys(t + kStages - 1);
    cp_async_commit();
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ks = 0; ks < T::KS; ++ks) load_a<DP>(qf[mt][ks], sq, wrow + 16 * mt, ks * 16);
    }
    const bf16* kt = sk + (t % kStages) * T::TILE;
    const int k0 = t * kTile;

    float s[MT][8][4];
    zero(s);
#pragma unroll
    for (int ks = 0; ks < T::KS; ++ks)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        load_b_nmajor<DP>(bb, kt, np * 16, ks * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt][ks], bb[0], bb[1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt][ks], bb[2], bb[3]);
        }
      }
    const bool masked = k0 + kTile > S || (causal && k0 + kTile - 1 > q0 + wrow);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (masked) mask_scores(s[mt], qrow + 16 * mt, k0, S, causal, true);
      float mu[2], alpha[2];
      running_max(s[mt], scale_log2, m[mt], mu, alpha);
#pragma unroll
      for (int n = 0; n < T::ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] *= alpha[e >> 1];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][n][e] = fast_exp2(fmaf(s[mt][n][e], scale_log2, -mu[e >> 1]));
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l[mt][r] = fmaf(l[mt][r], alpha[r], tree_reduce(s[mt], r, Add()));
    }
    product_kmajor<DP, MT>(acc, s, sv + (t % kStages) * T::TILE);
  }
  // one division by l per output element, as _kernel divides PV by sum(p)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float lt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lt[r] = quad_sum(l[mt][r]);
#pragma unroll
    for (int n = 0; n < T::ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] /= lt[e >> 1];
    store_rows<DP>(o, acc[mt], b, h, qrow + 16 * mt, S, H);
  }
}

// dQ and the row statistics: one CTA per (b, h, BM = 16 MT WARPS
// queries); pass A over the key tiles, then pass B over them again,
// through the ring.
template <int DP, int WARPS, int MT>
__global__ void __launch_bounds__(WARPS * 32)
attn_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ g, bf16* __restrict__ dq, float* __restrict__ stats,
               TcStrides st, int S, int H, int causal, float scale, float scale_log2, int ntiles,
               long long plane) {
  using T = Tc<DP>;
  constexpr int BM = 16 * MT * WARPS, THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // [kStages][TILE]
  bf16* sv = sk + kStages * T::TILE;         // [kStages][TILE]
  bf16* sq = sv + kStages * T::TILE;         // [BM][LD]
  bf16* sg = sq + BM * T::LD;                // [BM][LD]

  const int tile = blockIdx.x % ntiles, bh = blockIdx.x / ntiles;
  const int h = bh % H, b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = tile * BM, wrow = warp * 16 * MT;
  const int qrow = q0 + wrow + (lane >> 2);
  const bf16* kb = k + b * st.t[1][0] + h * st.t[1][2];
  const bf16* vb = v + b * st.t[2][0] + h * st.t[2][2];
  const long long kss = st.t[1][1], vss = st.t[2][1];

  const int kend = causal ? min(S, q0 + BM) : S;
  const int nkt = (kend + kTile - 1) / kTile;
  // virtual tiles 0 .. nkt - 1: pass A; nkt .. 2 nkt - 1: pass B
  auto load_keys = [&](int it) {
    const int stage = it % kStages, r0 = (it % nkt) * kTile;
    load_tile_async<DP, kTile, THREADS>(sk + stage * T::TILE, kb, kss, r0, S);
    load_tile_async<DP, kTile, THREADS>(sv + stage * T::TILE, vb, vss, r0, S);
  };
  load_tile_async<DP, BM, THREADS>(sq, q + b * st.t[0][0] + h * st.t[0][2], st.t[0][1], q0, S);
  load_tile_async<DP, BM, THREADS>(sg, g + b * st.t[3][0] + h * st.t[3][2], st.t[3][1], q0, S);
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < 2 * nkt) load_keys(it);
    cp_async_commit();
  }

  float m[MT][2], l[MT][2], num[MT][2], lse[MT][2], delta[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = num[mt][r] = lse[mt][r] = delta[mt][r] = 0.f;
    }
  float dacc[MT][T::ND][4];
  zero(dacc);

  for (int it = 0; it < 2 * nkt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < 2 * nkt) load_keys(it + kStages - 1);
    cp_async_commit();
    const bf16* kt = sk + (it % kStages) * T::TILE;
    const bool pass_b = it >= nkt;
    const int k0 = (pass_b ? it - nkt : it) * kTile;

    if (it == nkt) {  // end of pass A: the row statistics
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float lt = quad_sum(l[mt][r]);
          delta[mt][r] = quad_sum(num[mt][r]) / lt;
          lse[mt][r] = m[mt][r] + log2f(lt);
        }
    }

    float s[MT][8][4], dp[MT][8][4];
    product_nmajor<DP, MT>(s, sq, wrow, kt);
    product_nmajor<DP, MT>(dp, sg, wrow, sv + (it % kStages) * T::TILE);
    const bool masked = k0 + kTile > S || (causal && k0 + kTile - 1 > q0 + wrow);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (masked) mask_scores(s[mt], qrow + 16 * mt, k0, S, causal, true);
      if (!pass_b) {
        float mu[2], alpha[2];
        running_max(s[mt], scale_log2, m[mt], mu, alpha);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = fast_exp2(fmaf(s[mt][n][e], scale_log2, -mu[e >> 1]));
            s[mt][n][e] = p;
            dp[mt][n][e] *= p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[mt][r] = fmaf(l[mt][r], alpha[r], tree_reduce(s[mt], r, Add()));
          num[mt][r] = fmaf(num[mt][r], alpha[r], tree_reduce(dp[mt], r, Add()));
        }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = fast_exp2(fmaf(s[mt][n][e], scale_log2, -lse[mt][r]));
            s[mt][n][e] = p * (dp[mt][n][e] - delta[mt][r]) * scale;  // dS
          }
      }
    }
    if (pass_b) product_kmajor<DP, MT>(dacc, s, kt);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    store_rows<DP>(dq, dacc[mt], b, h, qrow + 16 * mt, S, H);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = qrow + 16 * mt + 8 * r;
        if (i < S) {
          const long long at = static_cast<long long>(bh) * S + i;
          stats[at] = lse[mt][r];
          stats[plane + at] = delta[mt][r];
        }
      }
    }
  }
}

// dK and dV: one CTA per (b, h, BM = 16 MT WARPS keys), streaming Q/dO
// tiles with their lse and delta through the ring.
template <int DP, int WARPS, int MT>
__global__ void __launch_bounds__(WARPS * 32)
attn_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ g, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, const float* __restrict__ stats, TcStrides st, int S,
                 int H, int causal, float scale, float scale_log2, int ntiles, long long plane) {
  using T = Tc<DP>;
  constexpr int BM = 16 * MT * WARPS, THREADS = 32 * WARPS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kStages][TILE]
  bf16* sg = sq + kStages * T::TILE;         // [kStages][TILE]
  bf16* sk = sg + kStages * T::TILE;         // [BM][LD]
  bf16* sv = sk + BM * T::LD;                // [BM][LD]
  float* slse = reinterpret_cast<float*>(sv + BM * T::LD);  // [kStages][64]
  float* sdelta = slse + kStages * kTile;                     // [kStages][64]

  const int tile = blockIdx.x % ntiles, bh = blockIdx.x / ntiles;
  const int h = bh % H, b = bh / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = tile * BM, wrow = warp * 16 * MT;
  const int krow = k0 + wrow + (lane >> 2);  // this thread's keys: krow + 16 mt, + 8
  const int c = lane & 3;
  const bf16* qb = q + b * st.t[0][0] + h * st.t[0][2];
  const bf16* gb = g + b * st.t[3][0] + h * st.t[3][2];
  const long long qss = st.t[0][1], gss = st.t[3][1];
  const float* lse_b = stats + static_cast<long long>(bh) * S;

  // queries before k0 see none of these keys when causal
  const int first = causal ? k0 / kTile : 0;
  const int nqt = (S + kTile - 1) / kTile;
  auto load_queries = [&](int qt) {
    const int stage = (qt - first) % kStages, i0 = qt * kTile;
    load_tile_async<DP, kTile, THREADS>(sq + stage * T::TILE, qb, qss, i0, S);
    load_tile_async<DP, kTile, THREADS>(sg + stage * T::TILE, gb, gss, i0, S);
    for (int e = threadIdx.x; e < 2 * kTile; e += THREADS) {
      const int r = e & (kTile - 1), i = i0 + r;
      const bool lo = e < kTile, ok = i < S;
      const float* src = lse_b + (lo ? 0 : plane) + (ok ? i : 0);
      float* dst = (lo ? slse : sdelta) + stage * kTile + r;
      cp_async4(smem_addr(dst), src, ok);
    }
  };
  load_tile_async<DP, BM, THREADS>(sk, k + b * st.t[1][0] + h * st.t[1][2], st.t[1][1], k0, S);
  load_tile_async<DP, BM, THREADS>(sv, v + b * st.t[2][0] + h * st.t[2][2], st.t[2][1], k0, S);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (first + j < nqt) load_queries(first + j);
    cp_async_commit();
  }

  float dka[MT][T::ND][4], dva[MT][T::ND][4];
  zero(dka);
  zero(dva);

  for (int qt = first; qt < nqt; ++qt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (qt + kStages - 1 < nqt) load_queries(qt + kStages - 1);
    cp_async_commit();
    const int stage = (qt - first) % kStages;
    const bf16* qt_s = sq + stage * T::TILE;
    const bf16* gt_s = sg + stage * T::TILE;
    const float* lse_s = slse + stage * kTile;
    const float* delta_s = sdelta + stage * kTile;
    const int i0 = qt * kTile;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float s[MT][8][4], dp[MT][8][4];
    product_nmajor<DP, MT>(s, sk, wrow, qt_s);
    product_nmajor<DP, MT>(dp, sv, wrow, gt_s);
    const bool masked = i0 + kTile > S || (causal && k0 + wrow + 16 * MT - 1 > i0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (masked) mask_scores(s[mt], krow + 16 * mt, i0, S, causal, false);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + 2 * c;
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              fast_exp2(fmaf(s[mt][n][e], scale_log2, -((e & 1) ? ls.y : ls.x)));
          s[mt][n][e] = p;
          dp[mt][n][e] = p * (dp[mt][n][e] - ((e & 1) ? dl.y : dl.x)) * scale;  // dS^T
        }
      }
    }
    product_kmajor<DP, MT>(dva, s, gt_s);   // dV += P^T dO
    product_kmajor<DP, MT>(dka, dp, qt_s);  // dK += dS^T Q
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    store_rows<DP>(dk, dka[mt], b, h, krow + 16 * mt, S, H);
    store_rows<DP>(dv, dva[mt], b, h, krow + 16 * mt, S, H);
  }
}

// Warps of a CTA and m-tiles (16 rows) of a warp: the forward 4 x 1 (64
// queries a CTA); the backward 4 x 2 (128 rows a CTA, each B fragment
// feeding two products) up to DP = 64, 4 x 1 above, where two m-tiles
// would not fit in registers (at DP = 48 and 64 the dK/dV kernel already
// spills: PERF.md).
constexpr int kFwdWarps = 4, kFwdMT = 1, kBwdWarps = 4;
template <int DP>
constexpr int bwd_mt() {
  return DP <= 64 ? 2 : 1;
}

template <int DP>
constexpr int fwd_smem() {
  return (2 * kStages * Tc<DP>::TILE + 16 * kFwdWarps * kFwdMT * Tc<DP>::LD) * 2;
}

template <int DP>
constexpr int bwd_smem() {
  return (2 * kStages * Tc<DP>::TILE + 2 * 16 * kBwdWarps * bwd_mt<DP>() * Tc<DP>::LD) * 2 +
         2 * kStages * kTile * 4;
}

// Opt in to more than 48 KB of dynamic shared memory once per kernel.
template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

TcStrides read_tc_strides(const long long* s, int n) {
  TcStrides st{};
  for (int a = 0; a < n; ++a)
    for (int x = 0; x < 3; ++x) st.t[a][x] = s[3 * a + x];
  return st;
}

template <int DP>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, const TcStrides& st, int B,
                  int S, int H, int causal, float scale_log2, cudaStream_t stream) {
  constexpr int BM = 16 * kFwdWarps * kFwdMT, SMEM = fwd_smem<DP>();
  auto kernel = attn_fwd_tc<DP, kFwdWarps, kFwdMT>;
  static const int attr = allow_smem(kernel, SMEM);
  if (attr != 0) return attr;
  const int ntiles = (S + BM - 1) / BM;
  const long long blocks = static_cast<long long>(B) * H * ntiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(blocks), 32 * kFwdWarps, SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), st, S, H, causal, scale_log2, ntiles);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                  void* dv, void* stats, const TcStrides& st, int B, int S, int H, int causal,
                  float scale, float scale_log2, cudaStream_t stream) {
  constexpr int MT = bwd_mt<DP>(), BM = 16 * kBwdWarps * MT, SMEM = bwd_smem<DP>();
  auto dq_kernel = attn_bwd_dq_tc<DP, kBwdWarps, MT>;
  auto dkdv_kernel = attn_bwd_dkdv_tc<DP, kBwdWarps, MT>;
  static const int attr_dq = allow_smem(dq_kernel, SMEM);
  static const int attr_dkdv = allow_smem(dkdv_kernel, SMEM);
  if (attr_dq != 0) return attr_dq;
  if (attr_dkdv != 0) return attr_dkdv;
  const int ntiles = (S + BM - 1) / BM;
  const long long blocks = static_cast<long long>(B) * H * ntiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long plane = static_cast<long long>(B) * H * S;
  dq_kernel<<<static_cast<unsigned>(blocks), 32 * kBwdWarps, SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq), static_cast<float*>(stats), st, S, H,
      causal, scale, scale_log2, ntiles, plane);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  dkdv_kernel<<<static_cast<unsigned>(blocks), 32 * kBwdWarps, SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(g), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const float*>(stats), st, S, H, causal, scale, scale_log2, ntiles, plane);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the kernels a call at DP launches: out[0]
// the forward, out[1] the dQ kernel, out[2] the dK/dV kernel.
template <int DP>
void smem_report(int* out) {
  out[0] = fwd_smem<DP>();
  out[1] = out[2] = bwd_smem<DP>();
}

#define GYMFX_FOR_EACH_DP(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

int dispatch_fwd_tc(const void* q, const void* k, const void* v, void* o, const TcStrides& st,
                    int B, int S, int H, int DP, int causal, float scale_log2, cudaStream_t s) {
  switch (DP) {
#define GYMFX_CASE(N) \
  case N:             \
    return launch_fwd_tc<N>(q, k, v, o, st, B, S, H, causal, scale_log2, s);
    GYMFX_FOR_EACH_DP(GYMFX_CASE)
#undef GYMFX_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_bwd_tc(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                    void* dv, void* stats, const TcStrides& st, int B, int S, int H, int DP,
                    int causal, float scale, float scale_log2, cudaStream_t s) {
  switch (DP) {
#define GYMFX_CASE(N) \
  case N:             \
    return launch_bwd_tc<N>(q, k, v, g, dq, dk, dv, stats, st, B, S, H, causal, scale, scale_log2, s);
    GYMFX_FOR_EACH_DP(GYMFX_CASE)
#undef GYMFX_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ======================================================================
// float32: CUDA-core kernels
// ======================================================================

constexpr int kTileFloats = 4096;  // one shared-memory tile: rows x padded D

struct Strides {
  long long t[4][4];  // [q, k, v, dO][b, s, h, d], in elements
};

// Thread part c of a row owns the float4 chunks c, c + TPR, c + 2 TPR, ...
// of the padded head dim: the TPR threads of a row read neighbouring
// 16-byte chunks of a shared-memory row, so a broadcast row read has no
// bank conflicts.
template <int TPR>
__device__ __forceinline__ int dim_of(int i, int e, int c) {
  return (i * TPR + c) * 4 + e;
}

template <int DPT, int TPR>
__device__ __forceinline__ void load_row(float (&r)[DPT], const float* row, long long sd, int D,
                                         int c, bool valid) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dim_of<TPR>(i, e, c);
      r[4 * i + e] = (valid && d < D) ? row[d * sd] : 0.f;
    }
  }
}

template <int DPT, int TPR>
__device__ __forceinline__ void store_row(float* row, const float (&r)[DPT], int D, int c) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = dim_of<TPR>(i, e, c);
      if (d < D) row[d] = r[4 * i + e];
    }
  }
}

// Full dot product of a row held in registers (split over the TPR
// threads of the row) with a shared-memory row; every thread of the row
// gets the sum.  Called uniformly by the whole block (shuffles).
template <int DPT, int TPR>
__device__ __forceinline__ float dot_row(const float (&r)[DPT], const float4* row, int c) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const float4 x = row[i * TPR + c];
    s += r[4 * i] * x.x;
    s += r[4 * i + 1] * x.y;
    s += r[4 * i + 2] * x.z;
    s += r[4 * i + 3] * x.w;
  }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <int DPT, int TPR>
__device__ __forceinline__ void axpy_row(float (&acc)[DPT], float a, const float4* row, int c) {
#pragma unroll
  for (int i = 0; i < DPT / 4; ++i) {
    const float4 x = row[i * TPR + c];
    acc[4 * i] += a * x.x;
    acc[4 * i + 1] += a * x.y;
    acc[4 * i + 2] += a * x.z;
    acc[4 * i + 3] += a * x.w;
  }
}

// Rows r0 .. r0 + kTileFloats / DPAD - 1 of one (b, h) slice into a
// shared-memory tile [rows][DPAD], zero past S and past D.
template <int DPAD>
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long ss,
                                          long long sd, int r0, int S, int D) {
  for (int e = threadIdx.x; e < kTileFloats; e += kThreads) {
    const int j = r0 + e / DPAD, d = e % DPAD;
    tile[e] = (j < S && d < D) ? base[j * ss + d * sd] : 0.f;
  }
}

template <int DPT, int TPR>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, Strides st, int S, int H,
                int D, int causal, float scale, int ntiles) {
  constexpr int ROWS = kThreads / TPR, DPAD = DPT * TPR, TILE = kTileFloats / DPAD;
  constexpr int CH = 16;  // keys scored per online-softmax update
  __shared__ __align__(16) float ks[kTileFloats];
  __shared__ __align__(16) float vs[kTileFloats];
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);

  const int tile = blockIdx.x % ntiles;
  const int bh = blockIdx.x / ntiles;
  const int h = bh % H, b = bh / H;
  const int r = threadIdx.x / TPR, c = threadIdx.x % TPR;
  const int q0 = tile * ROWS, i = q0 + r;
  const bool valid = i < S;

  const long long(&t)[4][4] = st.t;
  const float* qb = q + b * t[0][0] + h * t[0][2];
  const float* kb = k + b * t[1][0] + h * t[1][2];
  const float* vb = v + b * t[2][0] + h * t[2][2];

  float qr[DPT], acc[DPT];
  load_row<DPT, TPR>(qr, qb + (valid ? i : 0) * t[0][1], t[0][3], D, c, valid);
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const int kend = causal ? min(S, q0 + ROWS) : S;
  for (int k0 = 0; k0 < kend; k0 += TILE) {
    __syncthreads();
    load_tile<DPAD>(ks, kb, t[1][1], t[1][3], k0, S, D);
    load_tile<DPAD>(vs, vb, t[2][1], t[2][3], k0, S, D);
    __syncthreads();
    const int nk = min(TILE, kend - k0);
    for (int j0 = 0; j0 < nk; j0 += CH) {
      float s[CH];
      float mt = m;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int j = j0 + u;
        float x = -INFINITY;
        if (j < nk) {  // uniform across the block
          x = dot_row<DPT, TPR>(qr, ks4 + j * (DPAD / 4), c) * scale;
          if (causal && k0 + j > i) x = -INFINITY;
        }
        s[u] = x;
        mt = fmaxf(mt, x);
      }
      if (mt != -INFINITY) {
        const float alpha = expf(m - mt);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[d] *= alpha;
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          if (j0 + u < nk) {
            const float p = expf(s[u] - mt);
            l += p;
            axpy_row<DPT, TPR>(acc, p, vs4 + (j0 + u) * (DPAD / 4), c);
          }
        }
        m = mt;
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[d] /= l;
    store_row<DPT, TPR>(o + ((static_cast<long long>(b) * S + i) * H + h) * D, acc, D, c);
  }
}

template <int DPT, int TPR>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g, float* __restrict__ dq,
                float* __restrict__ dk, float* __restrict__ dv, Strides st, int S, int H, int D,
                int causal, float scale) {
  constexpr int ROWS = kThreads / TPR, DPAD = DPT * TPR, TILE = kTileFloats / DPAD;
  constexpr int CH = 8;
  __shared__ __align__(16) float t0[kTileFloats];
  __shared__ __align__(16) float t1[kTileFloats];
  __shared__ float row_m[kMaxWindow], row_l[kMaxWindow], row_delta[kMaxWindow];
  const float4* t04 = reinterpret_cast<const float4*>(t0);
  const float4* t14 = reinterpret_cast<const float4*>(t1);

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int r = threadIdx.x / TPR, c = threadIdx.x % TPR;
  const long long(&t)[4][4] = st.t;
  const float* qb = q + b * t[0][0] + h * t[0][2];
  const float* kb = k + b * t[1][0] + h * t[1][2];
  const float* vb = v + b * t[2][0] + h * t[2][2];
  const float* gb = g + b * t[3][0] + h * t[3][2];
  const long long out_row = static_cast<long long>(H) * D;
  const long long out_base = static_cast<long long>(b) * S * out_row + static_cast<long long>(h) * D;

  // ---- phase 1: query rows; row statistics and dQ -------------------------
  for (int q0 = 0; q0 < S; q0 += ROWS) {
    const int i = q0 + r;
    const bool valid = i < S;
    float qr[DPT], gr[DPT], dqr[DPT];
    load_row<DPT, TPR>(qr, qb + (valid ? i : 0) * t[0][1], t[0][3], D, c, valid);
    load_row<DPT, TPR>(gr, gb + (valid ? i : 0) * t[3][1], t[3][3], D, c, valid);
    const int kend = causal ? min(S, q0 + ROWS) : S;

    // pass A: m, l and delta = sum_j p_ij (dO_i . v_j), online
    float m = -INFINITY, l = 0.f, acc = 0.f;
    for (int k0 = 0; k0 < kend; k0 += TILE) {
      __syncthreads();
      load_tile<DPAD>(t0, kb, t[1][1], t[1][3], k0, S, D);
      load_tile<DPAD>(t1, vb, t[2][1], t[2][3], k0, S, D);
      __syncthreads();
      const int nk = min(TILE, kend - k0);
      for (int j0 = 0; j0 < nk; j0 += CH) {
        float s[CH], dpv[CH];
        float mt = m;
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int j = j0 + u;
          float x = -INFINITY, y = 0.f;
          if (j < nk) {
            x = dot_row<DPT, TPR>(qr, t04 + j * (DPAD / 4), c) * scale;
            y = dot_row<DPT, TPR>(gr, t14 + j * (DPAD / 4), c);
            if (causal && k0 + j > i) x = -INFINITY;
          }
          s[u] = x;
          dpv[u] = y;
          mt = fmaxf(mt, x);
        }
        if (mt != -INFINITY) {
          const float alpha = expf(m - mt);
          l *= alpha;
          acc *= alpha;
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            if (j0 + u < nk) {
              const float e = expf(s[u] - mt);
              l += e;
              acc += e * dpv[u];
            }
          }
          m = mt;
        }
      }
    }
    const float delta = acc / l;

    // pass B: dQ_i = sum_j dS_ij k_j with p = e / l
#pragma unroll
    for (int d = 0; d < DPT; ++d) dqr[d] = 0.f;
    for (int k0 = 0; k0 < kend; k0 += TILE) {
      __syncthreads();
      load_tile<DPAD>(t0, kb, t[1][1], t[1][3], k0, S, D);
      load_tile<DPAD>(t1, vb, t[2][1], t[2][3], k0, S, D);
      __syncthreads();
      const int nk = min(TILE, kend - k0);
      for (int j = 0; j < nk; ++j) {
        float x = dot_row<DPT, TPR>(qr, t04 + j * (DPAD / 4), c) * scale;
        const float dp = dot_row<DPT, TPR>(gr, t14 + j * (DPAD / 4), c);
        if (causal && k0 + j > i) x = -INFINITY;
        const float p = expf(x - m) / l;
        const float ds = p * (dp - delta) * scale;
        axpy_row<DPT, TPR>(dqr, ds, t04 + j * (DPAD / 4), c);
      }
    }
    if (valid) {
      store_row<DPT, TPR>(dq + out_base + i * out_row, dqr, D, c);
      if (c == 0) {
        row_m[i] = m;
        row_l[i] = l;
        row_delta[i] = delta;
      }
    }
  }
  __syncthreads();

  // ---- phase 2: key rows; dK and dV ---------------------------------------
  for (int j0 = 0; j0 < S; j0 += ROWS) {
    const int j = j0 + r;
    const bool valid = j < S;
    float kr[DPT], vr[DPT], dkr[DPT], dvr[DPT];
    load_row<DPT, TPR>(kr, kb + (valid ? j : 0) * t[1][1], t[1][3], D, c, valid);
    load_row<DPT, TPR>(vr, vb + (valid ? j : 0) * t[2][1], t[2][3], D, c, valid);
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      dkr[d] = 0.f;
      dvr[d] = 0.f;
    }
    const int istart = causal ? (j0 / TILE) * TILE : 0;
    for (int i0 = istart; i0 < S; i0 += TILE) {
      __syncthreads();
      load_tile<DPAD>(t0, qb, t[0][1], t[0][3], i0, S, D);
      load_tile<DPAD>(t1, gb, t[3][1], t[3][3], i0, S, D);
      __syncthreads();
      const int ni = min(TILE, S - i0);
      for (int ii = 0; ii < ni; ++ii) {
        const int i = i0 + ii;
        float x = dot_row<DPT, TPR>(kr, t04 + ii * (DPAD / 4), c) * scale;
        const float dp = dot_row<DPT, TPR>(vr, t14 + ii * (DPAD / 4), c);
        if (causal && j > i) x = -INFINITY;
        const float p = expf(x - row_m[i]) / row_l[i];
        const float ds = p * (dp - row_delta[i]) * scale;
        axpy_row<DPT, TPR>(dvr, p, t14 + ii * (DPAD / 4), c);
        axpy_row<DPT, TPR>(dkr, ds, t04 + ii * (DPAD / 4), c);
      }
    }
    if (valid) {
      store_row<DPT, TPR>(dk + out_base + j * out_row, dkr, D, c);
      store_row<DPT, TPR>(dv + out_base + j * out_row, dvr, D, c);
    }
  }
}

Strides read_strides(const long long* s, int n) {
  Strides st{};
  for (int a = 0; a < n; ++a)
    for (int x = 0; x < 4; ++x) st.t[a][x] = s[4 * a + x];
  return st;
}

template <int DPT, int TPR>
int launch_fwd(const void* q, const void* k, const void* v, void* o, const Strides& st, int B,
               int S, int H, int D, int causal, float scale, cudaStream_t stream) {
  constexpr int ROWS = kThreads / TPR;
  const int ntiles = (S + ROWS - 1) / ROWS;
  const long long blocks = static_cast<long long>(B) * H * ntiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  attn_fwd_kernel<DPT, TPR><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), st, S, H, D, causal, scale, ntiles);
  return static_cast<int>(cudaGetLastError());
}

template <int DPT, int TPR>
int launch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
               void* dv, const Strides& st, int B, int S, int H, int D, int causal, float scale,
               cudaStream_t stream) {
  const long long blocks = static_cast<long long>(B) * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  attn_bwd_kernel<DPT, TPR><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), st, S, H, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_fwd(const void* q, const void* k, const void* v, void* o, const Strides& st, int B,
                 int S, int H, int D, int causal, float scale, cudaStream_t s) {
  if (D <= 16) return launch_fwd<16, 1>(q, k, v, o, st, B, S, H, D, causal, scale, s);
  if (D <= 32) return launch_fwd<32, 1>(q, k, v, o, st, B, S, H, D, causal, scale, s);
  if (D <= 64) return launch_fwd<32, 2>(q, k, v, o, st, B, S, H, D, causal, scale, s);
  return launch_fwd<32, 4>(q, k, v, o, st, B, S, H, D, causal, scale, s);
}

int dispatch_bwd(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
                 void* dv, const Strides& st, int B, int S, int H, int D, int causal, float scale,
                 cudaStream_t s) {
  if (D <= 16) return launch_bwd<16, 1>(q, k, v, g, dq, dk, dv, st, B, S, H, D, causal, scale, s);
  if (D <= 32) return launch_bwd<16, 2>(q, k, v, g, dq, dk, dv, st, B, S, H, D, causal, scale, s);
  if (D <= 64) return launch_bwd<16, 4>(q, k, v, g, dq, dk, dv, st, B, S, H, D, causal, scale, s);
  return launch_bwd<16, 8>(q, k, v, g, dq, dk, dv, st, B, S, H, D, causal, scale, s);
}

// ======================================================================
// float32, windows of up to 64: one warp per (b, h), one pass
// ======================================================================

constexpr int kWindowMax = 64;

template <int SP, int DP>
struct Win {
  static constexpr int LD = DP + 4;      // a staged row, in floats
  static constexpr int LP = SP + 4;      // a row of P or dS
  static constexpr int TILE = SP * LD;   // one operand of one (b, h)
  static constexpr int CHUNKS = DP / 4;  // 16-byte chunks of a row
  // forward: q, k, v; a 32-row block of P over q's rows (SP <= DP) or
  // in a scratch of its own
  static constexpr bool P_ON_Q = SP <= DP;
  static constexpr int FWD = 3 * TILE + (P_ON_Q ? 0 : 32 * LP);
  // backward: q, k, v, dO; at SP = 32 P over v's rows and dS over
  // dO's, else both in scratch of their own
  static constexpr bool OVERLAY = SP == 32;
  static constexpr int BWD = 4 * TILE + (OVERLAY ? 0 : 2 * SP * LP);
};

// Warps a CTA for a warp's share of ``floats``: 4 while four warps fit in
// 112 KB (two CTAs an SM or more), else 2, else 1.
__host__ __device__ constexpr int win_warps(int floats) {
  return floats * 16 <= 112 * 1024 ? 4 : floats * 8 <= 112 * 1024 ? 2 : 1;
}

// The rows 0 .. SP - 1 of one (b, h) (row stride ss elements) into a
// warp's [SP][DP + 4] tile, zero from row S on, by 16-byte cp.async.
template <int SP, int DP>
__device__ __forceinline__ void stage_rows(float* tile, const float* base, long long ss, int S,
                                           int lane) {
  using W = Win<SP, DP>;
#pragma unroll
  for (int i = 0; i < SP * W::CHUNKS / 32; ++i) {
    const int e = lane + 32 * i, r = e / W::CHUNKS, c = e % W::CHUNKS;
    const bool ok = r < S;
    cp_async16(smem_addr(tile + r * W::LD + 4 * c),
               base + static_cast<long long>(ok ? r : 0) * ss + 4 * c, ok);
  }
}

template <int N>
__device__ __forceinline__ void zero_rows(float (&c)[4][N]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < N; ++n) c[r][n] = 0.f;
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

// c[r][n] = sum over k < K of a[(4 rg + r) LDA + k] b[(cg + 4 n) LDB + k],
// one fmaf per k in increasing k (S = Q K^T, dP = dO V^T)
template <int K, int LDA, int LDB>
__device__ __forceinline__ void tile_nt(float (&c)[4][8], const float* a, const float* b, int rg,
                                        int cg) {
  zero_rows(c);
#pragma unroll (K <= 32 ? K / 4 : 2)
  for (int k = 0; k < K; k += 4) {
    float4 x[4], y[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = *reinterpret_cast<const float4*>(a + (4 * rg + r) * LDA + k);
#pragma unroll
    for (int n = 0; n < 8; ++n) y[n] = *reinterpret_cast<const float4*>(b + (cg + 4 * n) * LDB + k);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < 8; ++n) c[r][n] = fmaf(lane_of(x[r], e), lane_of(y[n], e), c[r][n]);
  }
}

// c[r][e] (row 4 rg + r; column 4 cg + e for e < 4, 16 + 4 cg + e - 4
// above, of the 32 columns at b) = sum over k < K of a[(4 rg + r) LDA +
// k] b[k LDB + column], one fmaf per k in increasing k (O = P V, dQ = dS K)
template <int K, int LDA, int LDB>
__device__ __forceinline__ void tile_nn(float (&c)[4][8], const float* a, const float* b, int rg,
                                        int cg) {
  zero_rows(c);
#pragma unroll (K <= 32 ? K / 4 : 2)
  for (int k = 0; k < K; k += 4) {
    float4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = *reinterpret_cast<const float4*>(a + (4 * rg + r) * LDA + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 y0 = *reinterpret_cast<const float4*>(b + (k + kk) * LDB + 4 * cg);
      const float4 y1 = *reinterpret_cast<const float4*>(b + (k + kk) * LDB + 16 + 4 * cg);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float xs = lane_of(x[r], kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c[r][e] = fmaf(xs, lane_of(y0, e), c[r][e]);
          c[r][4 + e] = fmaf(xs, lane_of(y1, e), c[r][4 + e]);
        }
      }
    }
  }
}

// c[r][e] (row 4 rg + r of the result, a column of a; columns as
// tile_nn) = sum over k < K of a[k LDA + 4 rg + r] b[k LDB + column], one
// fmaf per k in increasing k (dV = P^T dO, dK = dS^T Q)
template <int K, int LDA, int LDB>
__device__ __forceinline__ void tile_tn(float (&c)[4][8], const float* a, const float* b, int rg,
                                        int cg) {
  zero_rows(c);
#pragma unroll (K <= 32 ? K : 4)
  for (int k = 0; k < K; ++k) {
    const float4 x = *reinterpret_cast<const float4*>(a + k * LDA + 4 * rg);
    const float4 y0 = *reinterpret_cast<const float4*>(b + k * LDB + 4 * cg);
    const float4 y1 = *reinterpret_cast<const float4*>(b + k * LDB + 16 + 4 * cg);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float xs = lane_of(x, r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[r][e] = fmaf(xs, lane_of(y0, e), c[r][e]);
        c[r][4 + e] = fmaf(xs, lane_of(y1, e), c[r][4 + e]);
      }
    }
  }
}

// A tile_nn / tile_tn result's rows row0 + 4 rg + r below S into
// contiguous (B, S, H, DP) at (b, ., h), columns col0 + (4 cg, 16 + 4 cg)
template <int DP>
__device__ __forceinline__ void store_tile(float* out, const float (&c)[4][8], int b, int h,
                                           int row0, int col0, int S, int H, int rg, int cg) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + 4 * rg + r;
    if (i >= S) continue;
    float* dst = out + ((static_cast<long long>(b) * S + i) * H + h) * DP + col0 + 4 * cg;
    *reinterpret_cast<float4*>(dst) = make_float4(c[r][0], c[r][1], c[r][2], c[r][3]);
    *reinterpret_cast<float4*>(dst + 16) = make_float4(c[r][4], c[r][5], c[r][6], c[r][7]);
  }
}

// A 32-row block of a score-shaped value, s[t][r][n] at row 4 rg + r and
// key 32 t + cg + 4 n, into [32][LP] rows at p
template <int T, int LP>
__device__ __forceinline__ void store_scores(float* p, const float (&s)[T][4][8], int rg, int cg) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int n = 0; n < 8; ++n) p[(4 * rg + r) * LP + 32 * t + cg + 4 * n] = s[t][r][n];
}

// Rows i0 + r (r < 4) of a 32-row block of raw scores s[t][r][n] (key
// 32 t + cg + 4 n): x = s * scale, -inf from key S on and, when causal,
// past the diagonal; then s := e = expf(x - m), m the row's max, and
// rl = 1 / l, l the row's sum of e
template <int T>
__device__ __forceinline__ void row_softmax(float (&s)[T][4][8], float (&rl)[4], int i0, int S,
                                            int causal, float scale, int cg) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + r;
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int j = 32 * t + cg + 4 * n;
        const float x = (j >= S || (causal && j > i)) ? -INFINITY : __fmul_rn(s[t][r][n], scale);
        s[t][r][n] = x;
        m = fmaxf(m, x);
      }
    m = quad_max(m);
    float l = 0.f;
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float e = expf(__fsub_rn(s[t][r][n], m));
        s[t][r][n] = e;
        l = __fadd_rn(l, e);
      }
    rl[r] = __fdiv_rn(1.f, quad_sum(l));
  }
}

// The forward: one warp per (b, h), WARPS a CTA.
template <int SP, int DP>
__global__ void __launch_bounds__(32 * win_warps(Win<SP, DP>::FWD))
attn_fwd_window(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, TcStrides st, int units,
                int S, int H, int causal, float scale) {
  using W = Win<SP, DP>;
  constexpr int WARPS = win_warps(W::FWD), T = SP / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * WARPS + warp;
  if (u >= units) return;  // warp-uniform; no CTA barrier follows
  const int b = u / H, h = u % H;
  float* sq = reinterpret_cast<float*>(smem) + warp * W::FWD;
  float* sk = sq + W::TILE;
  float* sv = sk + W::TILE;
  stage_rows<SP, DP>(sq, q + b * st.t[0][0] + h * st.t[0][2], st.t[0][1], S, lane);
  stage_rows<SP, DP>(sk, k + b * st.t[1][0] + h * st.t[1][2], st.t[1][1], S, lane);
  stage_rows<SP, DP>(sv, v + b * st.t[2][0] + h * st.t[2][2], st.t[2][1], S, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();  // every lane's copies have landed
  const int rg = lane >> 2, cg = lane & 3;
#pragma unroll 1
  for (int qb = 0; qb < T; ++qb) {
    const int i0 = 32 * qb;
    float s[T][4][8];
#pragma unroll
    for (int t = 0; t < T; ++t) tile_nt<DP, W::LD, W::LD>(s[t], sq + i0 * W::LD, sk + 32 * t * W::LD, rg, cg);
    float rl[4];
    row_softmax<T>(s, rl, i0 + 4 * rg, S, causal, scale, cg);
    float* sp = W::P_ON_Q ? sq + i0 * W::LD : sv + W::TILE;
    __syncwarp();  // every lane is done with q's rows of this block (and the last block's P)
    store_scores<T, W::LP>(sp, s, rg, cg);
    __syncwarp();
#pragma unroll 1
    for (int dc = 0; dc < DP / 32; ++dc) {
      float acc[4][8];
      tile_nn<SP, W::LP, W::LD>(acc, sp, sv + 32 * dc, rg, cg);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = __fmul_rn(acc[r][e], rl[r]);
      store_tile<DP>(o, acc, b, h, i0, 32 * dc, S, H, rg, cg);
    }
  }
}

// The backward: one warp per (b, h), WARPS a CTA.
template <int SP, int DP>
__global__ void __launch_bounds__(32 * win_warps(Win<SP, DP>::BWD))
attn_bwd_window(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g, float* __restrict__ dq,
                float* __restrict__ dk, float* __restrict__ dv, TcStrides st, int units, int S,
                int H, int causal, float scale) {
  using W = Win<SP, DP>;
  constexpr int WARPS = win_warps(W::BWD), T = SP / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * WARPS + warp;
  if (u >= units) return;  // warp-uniform; no CTA barrier follows
  const int b = u / H, h = u % H;
  float* sq = reinterpret_cast<float*>(smem) + warp * W::BWD;
  float* sk = sq + W::TILE;
  float* sv = sk + W::TILE;
  float* sg = sv + W::TILE;
  float* sp = W::OVERLAY ? sv : sg + W::TILE;          // P, [SP][LP]
  float* sds = W::OVERLAY ? sg : sp + SP * W::LP;      // dS, [SP][LP]
  stage_rows<SP, DP>(sq, q + b * st.t[0][0] + h * st.t[0][2], st.t[0][1], S, lane);
  stage_rows<SP, DP>(sk, k + b * st.t[1][0] + h * st.t[1][2], st.t[1][1], S, lane);
  stage_rows<SP, DP>(sv, v + b * st.t[2][0] + h * st.t[2][2], st.t[2][1], S, lane);
  stage_rows<SP, DP>(sg, g + b * st.t[3][0] + h * st.t[3][2], st.t[3][1], S, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  const int rg = lane >> 2, cg = lane & 3;
  // a 32-row block of P and of dP, then dS in dp; at SP = 32 (one block)
  // both stay in registers past the loop
  float s[T][4][8], dp[T][4][8];
#pragma unroll 1
  for (int qb = 0; qb < T; ++qb) {
    const int i0 = 32 * qb;
#pragma unroll
    for (int t = 0; t < T; ++t) tile_nt<DP, W::LD, W::LD>(s[t], sq + i0 * W::LD, sk + 32 * t * W::LD, rg, cg);
    float rl[4];
    row_softmax<T>(s, rl, i0 + 4 * rg, S, causal, scale, cg);
#pragma unroll
    for (int t = 0; t < T; ++t) tile_nt<DP, W::LD, W::LD>(dp[t], sg + i0 * W::LD, sv + 32 * t * W::LD, rg, cg);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float delta = 0.f;
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float p = __fmul_rn(s[t][r][n], rl[r]);
          s[t][r][n] = p;
          delta = fmaf(p, dp[t][r][n], delta);
        }
      delta = quad_sum(delta);
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          dp[t][r][n] = __fmul_rn(__fmul_rn(s[t][r][n], __fsub_rn(dp[t][r][n], delta)), scale);
    }
    if constexpr (!W::OVERLAY) {
      store_scores<T, W::LP>(sp + i0 * W::LP, s, rg, cg);
      store_scores<T, W::LP>(sds + i0 * W::LP, dp, rg, cg);
    }
  }
  if constexpr (W::OVERLAY) {
    __syncwarp();  // every lane is done with v (P goes over it)
    store_scores<T, W::LP>(sp, s, rg, cg);
  }
  __syncwarp();
#pragma unroll 1
  for (int jt = 0; jt < T; ++jt)
#pragma unroll 1
    for (int dc = 0; dc < DP / 32; ++dc) {  // dV = P^T dO
      float acc[4][8];
      tile_tn<SP, W::LP, W::LD>(acc, sp + 32 * jt, sg + 32 * dc, rg, cg);
      store_tile<DP>(dv, acc, b, h, 32 * jt, 32 * dc, S, H, rg, cg);
    }
  if constexpr (W::OVERLAY) {
    __syncwarp();  // every lane is done with dO (dS goes over it)
    store_scores<T, W::LP>(sds, dp, rg, cg);
  }
  __syncwarp();
#pragma unroll 1
  for (int it = 0; it < T; ++it)
#pragma unroll 1
    for (int dc = 0; dc < DP / 32; ++dc) {  // dQ = dS K
      float acc[4][8];
      tile_nn<SP, W::LP, W::LD>(acc, sds + 32 * it * W::LP, sk + 32 * dc, rg, cg);
      store_tile<DP>(dq, acc, b, h, 32 * it, 32 * dc, S, H, rg, cg);
    }
#pragma unroll 1
  for (int jt = 0; jt < T; ++jt)
#pragma unroll 1
    for (int dc = 0; dc < DP / 32; ++dc) {  // dK = dS^T Q
      float acc[4][8];
      tile_tn<SP, W::LP, W::LD>(acc, sds + 32 * jt, sq + 32 * dc, rg, cg);
      store_tile<DP>(dk, acc, b, h, 32 * jt, 32 * dc, S, H, rg, cg);
    }
}

template <int SP, int DP>
int launch_fwd_window(const void* q, const void* k, const void* v, void* o, const TcStrides& st,
                      int B, int S, int H, int causal, float scale, cudaStream_t stream) {
  constexpr int WARPS = win_warps(Win<SP, DP>::FWD), SMEM = WARPS * Win<SP, DP>::FWD * 4;
  auto kernel = attn_fwd_window<SP, DP>;
  static const int attr = allow_smem(kernel, SMEM);
  if (attr != 0) return attr;
  const long long units = static_cast<long long>(B) * H;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>((units + WARPS - 1) / WARPS), 32 * WARPS, SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), st, static_cast<int>(units), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int SP, int DP>
int launch_bwd_window(const void* q, const void* k, const void* v, const void* g, void* dq,
                      void* dk, void* dv, const TcStrides& st, int B, int S, int H, int causal,
                      float scale, cudaStream_t stream) {
  constexpr int WARPS = win_warps(Win<SP, DP>::BWD), SMEM = WARPS * Win<SP, DP>::BWD * 4;
  auto kernel = attn_bwd_window<SP, DP>;
  static const int attr = allow_smem(kernel, SMEM);
  if (attr != 0) return attr;
  const long long units = static_cast<long long>(B) * H;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>((units + WARPS - 1) / WARPS), 32 * WARPS, SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(g), static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), st, static_cast<int>(units), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory (bytes) and warps of a CTA of the window kernels
// at (SP, DP): out[0], out[1] the forward's, out[2], out[3] the backward's.
template <int SP, int DP>
void window_report(int* out) {
  using W = Win<SP, DP>;
  out[0] = win_warps(W::FWD) * W::FWD * 4;
  out[1] = win_warps(W::FWD);
  out[2] = win_warps(W::BWD) * W::BWD * 4;
  out[3] = win_warps(W::BWD);
}

#define GYMFX_FOR_EACH_WINDOW(X) \
  X(32, 32) X(32, 64) X(32, 96) X(32, 128) X(64, 32) X(64, 64) X(64, 96) X(64, 128)

bool bad_window(int B, int S, int H, int DP) {
  return B < 1 || H < 1 || S < 1 || S > kWindowMax || DP < 32 || DP > 128 || DP % 32 != 0;
}

bool bad_shape(int B, int S, int H, int D) {
  return B < 1 || H < 1 || S < 1 || S > kMaxWindow || D < 1 || D > 128;
}

}  // namespace

extern "C" {

// float32, CUDA cores.  strides: 12 (q, k, v) element strides in
// (b, s, h, d) order.
int gymfx_attn_fwd_f32(const void* q, const void* k, const void* v, void* o,
                       const long long* strides, int B, int S, int H, int D, int causal,
                       float scale, void* stream) {
  if (bad_shape(B, S, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_fwd(q, k, v, o, read_strides(strides, 3), B, S, H, D, causal, scale,
                      static_cast<cudaStream_t>(stream));
}

// strides: 16 (q, k, v, dO) element strides in (b, s, h, d) order.
int gymfx_attn_bwd_f32(const void* q, const void* k, const void* v, const void* g, void* dq,
                       void* dk, void* dv, const long long* strides, int B, int S, int H, int D,
                       int causal, float scale, void* stream) {
  if (bad_shape(B, S, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_bwd(q, k, v, g, dq, dk, dv, read_strides(strides, 4), B, S, H, D, causal,
                      scale, static_cast<cudaStream_t>(stream));
}

// float32, windows of up to 64 (attn_fwd_window).  DP: the (padded) head
// dim, 32, 64, 96 or 128.  strides: 9 (q, k, v) element strides in
// (b, s, h) order; the d stride is 1 and every row is 16-byte aligned.
int gymfx_attn_fwd_f32_window(const void* q, const void* k, const void* v, void* o,
                              const long long* strides, int B, int S, int H, int DP, int causal,
                              float scale, void* stream) {
  if (bad_window(B, S, H, DP)) return static_cast<int>(cudaErrorInvalidValue);
  const TcStrides st = read_tc_strides(strides, 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GYMFX_CASE(A, D)                 \
  if ((S <= 32 ? 32 : 64) == A && DP == D) \
    return launch_fwd_window<A, D>(q, k, v, o, st, B, S, H, causal, scale, s);
  GYMFX_FOR_EACH_WINDOW(GYMFX_CASE)
#undef GYMFX_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// strides: 12 (q, k, v, dO) in (b, s, h) order.
int gymfx_attn_bwd_f32_window(const void* q, const void* k, const void* v, const void* g,
                              void* dq, void* dk, void* dv, const long long* strides, int B, int S,
                              int H, int DP, int causal, float scale, void* stream) {
  if (bad_window(B, S, H, DP)) return static_cast<int>(cudaErrorInvalidValue);
  const TcStrides st = read_tc_strides(strides, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GYMFX_CASE(A, D)                 \
  if ((S <= 32 ? 32 : 64) == A && DP == D) \
    return launch_bwd_window<A, D>(q, k, v, g, dq, dk, dv, st, B, S, H, causal, scale, s);
  GYMFX_FOR_EACH_WINDOW(GYMFX_CASE)
#undef GYMFX_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory (bytes) and warps a CTA of the window kernels a
// call at (S, DP) launches; see window_report.  Returns 0, or
// cudaErrorInvalidValue for a shape they do not take.
int gymfx_attn_f32_window_smem(int S, int DP, int* out) {
  if (bad_window(1, S, 1, DP)) return static_cast<int>(cudaErrorInvalidValue);
#define GYMFX_CASE(A, D)                 \
  if ((S <= 32 ? 32 : 64) == A && DP == D) { \
    window_report<A, D>(out);            \
    return 0;                            \
  }
  GYMFX_FOR_EACH_WINDOW(GYMFX_CASE)
#undef GYMFX_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// bfloat16, tensor cores.  DP: the (padded) head dim, a multiple of 16
// up to 128.  strides: 9 (q, k, v) element strides in (b, s, h) order;
// the d stride is 1 and every row is 16-byte aligned.  scale_log2 =
// scale * log2(e).
int gymfx_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                        const long long* strides, int B, int S, int H, int DP, int causal,
                        float scale_log2, void* stream) {
  if (bad_shape(B, S, H, DP)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_fwd_tc(q, k, v, o, read_tc_strides(strides, 3), B, S, H, DP, causal,
                         scale_log2, static_cast<cudaStream_t>(stream));
}

// strides: 12 (q, k, v, dO) in (b, s, h) order.  stats: an f32 (2, B, H,
// S) scratch (per query row: lse = m + log2 l, then delta).
int gymfx_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* g, void* dq,
                        void* dk, void* dv, void* stats, const long long* strides, int B, int S,
                        int H, int DP, int causal, float scale, float scale_log2, void* stream) {
  if (bad_shape(B, S, H, DP)) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_bwd_tc(q, k, v, g, dq, dk, dv, stats, read_tc_strides(strides, 4), B, S, H, DP,
                         causal, scale, scale_log2, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory, in bytes, of the bf16 kernels at DP; see
// smem_report.  Returns 0, or cudaErrorInvalidValue for a DP it does not
// take.
int gymfx_attn_bf16_smem(int DP, int* out) {
  switch (DP) {
#define GYMFX_CASE(N)   \
  case N:               \
    smem_report<N>(out); \
    return 0;
    GYMFX_FOR_EACH_DP(GYMFX_CASE)
#undef GYMFX_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
