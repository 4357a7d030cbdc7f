// Probe kernels for K4 (attention_kernels.cu) at the policies' head dim,
// D = 32: the kernels' memory traffic without their arithmetic, to tell
// the cost of the copies from the cost of the products and the softmax
// (gymfx_tpu_torch/profile_attention.py).
//
// attn_probe_skeleton  the bf16 forward's (attn_fwd_tc) grid (one
//                      128-thread CTA per (b, h, 64 queries)) and copies:
//                      the query tile in
//                      by 16-byte cp.async into rows of D + 8 bf16; with
//                      kv, every K/V tile of the (b, h) through the same
//                      2-stage ring, one cp.async wait and __syncthreads
//                      per tile; the query tile out to o with the
//                      forward's store pattern (4 bytes a thread, a warp
//                      writing 16-byte pieces of 8 rows).
// attn_probe_f32_window  the f32 window kernels' (attn_fwd_window /
//                      attn_bwd_window at S = 32) grid, one warp per
//                      (b, h), 4 warps a CTA, with their dynamic shared
//                      memory, and copies: NIN operands of the (b, h)
//                      staged by 16-byte cp.async into rows of D + 4
//                      floats, then NOUT outputs written from them with
//                      the kernels' store pattern (a thread 4 rows of two
//                      float4): the forward's 3 in and 1 out, the
//                      backward's 4 in and 3 out.
// attn_probe_floor     an empty kernel at a grid, block and dynamic shared
//                      memory (opted in above 48 KB): the launch floor of
//                      a kernel of that shape.
//
// Inputs are contiguous (B, S, H, 32) bf16 (the skeleton) or (B, 32, H,
// 32) f32 (the window skeleton).  The entry points launch on the caller's
// stream and return cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kRows = 64, kThreads = 128, kD = 32, kLD = kD + 8, kChunks = kD / 8;
constexpr int kTile = kRows * kLD;

__device__ __forceinline__ void cp_async16(const void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, long long ss, int r0,
                                          int S) {
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads, r = e / kChunks, c = e % kChunks;
    const bool ok = r0 + r < S;
    cp_async16(tile + r * kLD + c * 8, base + (ok ? r0 + r : 0) * ss + c * 8, ok);
  }
}

template <bool KV>
__global__ void __launch_bounds__(kThreads)
attn_probe_skeleton(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int S, int H, int ntiles) {
  __shared__ __align__(16) bf16 smem[5 * kTile];
  bf16* sk = smem;              // [2][kTile]
  bf16* sv = sk + 2 * kTile;    // [2][kTile]
  bf16* sq = sv + 2 * kTile;    // [kTile]
  const int tile = blockIdx.x % ntiles, bh = blockIdx.x / ntiles;
  const int h = bh % H, b = bh / H;
  const long long ss = static_cast<long long>(H) * kD;
  const long long base = static_cast<long long>(b) * S * ss + h * kD;
  const int q0 = tile * kRows, lane = threadIdx.x & 31;
  load_tile(sq, q + base, ss, q0, S);
  uint32_t sink = 0;
  if (KV) {
    const int nkt = (S + kRows - 1) / kRows;
    load_tile(sk, k + base, ss, 0, S);
    load_tile(sv, v + base, ss, 0, S);
    asm volatile("cp.async.commit_group;\n" ::);
    for (int t = 0; t < nkt; ++t) {
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      if (t + 1 < nkt) {
        load_tile(sk + ((t + 1) & 1) * kTile, k + base, ss, (t + 1) * kRows, S);
        load_tile(sv + ((t + 1) & 1) * kTile, v + base, ss, (t + 1) * kRows, S);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      // one shared-memory read per tile keeps the copies live
      sink += *reinterpret_cast<const uint32_t*>(sk + (t & 1) * kTile + 2 * lane);
    }
  } else {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  const int row0 = (threadIdx.x >> 5) * 16 + (lane >> 2), c = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r, i = q0 + row;
    if (i >= S) continue;
    bf16* dst = o + base + i * ss + 2 * c;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          *reinterpret_cast<const uint32_t*>(sq + row * kLD + 8 * n + 2 * c) + (sink == 1u);
  }
}

constexpr int kWin = 32, kWinLD = kD + 4, kWinTile = kWin * kWinLD, kWinWarps = 4;

template <int NIN, int NOUT>
__global__ void __launch_bounds__(32 * kWinWarps)
attn_probe_f32_window(const float* __restrict__ a0, const float* __restrict__ a1,
                      const float* __restrict__ a2, const float* __restrict__ a3,
                      float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2,
                      int units, int H) {
  extern __shared__ __align__(16) unsigned char wsmem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWinWarps + warp;
  if (u >= units) return;
  const int b = u / H, h = u % H;
  float* tiles = reinterpret_cast<float*>(wsmem) + warp * NIN * kWinTile;
  const float* in[4] = {a0, a1, a2, a3};
  float* out[3] = {o0, o1, o2};
  const long long ss = static_cast<long long>(H) * kD;
  const long long base = static_cast<long long>(b) * kWin * ss + h * kD;
#pragma unroll
  for (int t = 0; t < NIN; ++t)
#pragma unroll
    for (int i = 0; i < kWin * kD / 4 / 32; ++i) {
      const int e = lane + 32 * i, r = e / (kD / 4), c = e % (kD / 4);
      cp_async16(tiles + t * kWinTile + r * kWinLD + 4 * c, in[t] + base + r * ss + 4 * c, true);
    }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncwarp();
  const int rg = lane >> 2, cg = lane & 3;
#pragma unroll
  for (int t = 0; t < NOUT; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * rg + r;
      const float* src = tiles + t * kWinTile + row * kWinLD + 4 * cg;
      float* dst = out[t] + base + row * ss + 4 * cg;
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      *reinterpret_cast<float4*>(dst + 16) = *reinterpret_cast<const float4*>(src + 16);
    }
}

__global__ void attn_probe_floor() {}

template <typename K>
int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

extern "C" {

int gymfx_attn_probe_skeleton(const void* q, const void* k, const void* v, void* o, int B, int S,
                              int H, int kv, void* stream) {
  const int ntiles = (S + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(B) * H * ntiles;
  if (B < 1 || H < 1 || S < 1 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  if (kv)
    attn_probe_skeleton<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(qb, kb, vb, ob,
                                                                                 S, H, ntiles);
  else
    attn_probe_skeleton<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(qb, kb, vb, ob,
                                                                                  S, H, ntiles);
  return static_cast<int>(cudaGetLastError());
}

// The f32 window kernels' skeleton on contiguous (B, 32, H, 32) f32:
// bwd 0 reads q, k, v and writes o0; bwd 1 reads q, k, v, g and writes
// o0, o1, o2.
int gymfx_attn_probe_f32_window(const void* q, const void* k, const void* v, const void* g,
                                void* o0, void* o1, void* o2, int B, int H, int bwd,
                                void* stream) {
  const long long units = static_cast<long long>(B) * H;
  if (B < 1 || H < 1 || units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((units + kWinWarps - 1) / kWinWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *a0 = static_cast<const float*>(q), *a1 = static_cast<const float*>(k),
              *a2 = static_cast<const float*>(v), *a3 = static_cast<const float*>(g);
  float *p0 = static_cast<float*>(o0), *p1 = static_cast<float*>(o1),
        *p2 = static_cast<float*>(o2);
  if (bwd) {
    constexpr int SMEM = kWinWarps * 4 * kWinTile * 4;
    static const int attr = allow_smem(attn_probe_f32_window<4, 3>, SMEM);
    if (attr != 0) return attr;
    attn_probe_f32_window<4, 3><<<blocks, 32 * kWinWarps, SMEM, s>>>(a0, a1, a2, a3, p0, p1, p2,
                                                                      static_cast<int>(units), H);
  } else {
    constexpr int SMEM = kWinWarps * 3 * kWinTile * 4;
    static const int attr = allow_smem(attn_probe_f32_window<3, 1>, SMEM);
    if (attr != 0) return attr;
    attn_probe_f32_window<3, 1><<<blocks, 32 * kWinWarps, SMEM, s>>>(a0, a1, a2, a0, p0, p0, p0,
                                                                      static_cast<int>(units), H);
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel: grid CTAs of threads threads with smem bytes of
// dynamic shared memory.
int gymfx_attn_probe_floor(int grid, int threads, int smem, void* stream) {
  static const int attr = allow_smem(attn_probe_floor, 227 * 1024);
  if (attr != 0) return attr;
  attn_probe_floor<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
