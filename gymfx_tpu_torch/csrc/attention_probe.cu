// Probe kernels for K4's bf16 forward (attention_kernels.cu attn_fwd_tc)
// at the policies' head dim, D = 32: its memory traffic without its
// arithmetic, to tell the cost of the copies from the cost of the
// products and the softmax (gymfx_tpu_torch/profile_attention.py).
//
// attn_probe_skeleton  the forward's grid (one 128-thread CTA per
//                      (b, h, 64 queries)) and copies: the query tile in
//                      by 16-byte cp.async into rows of D + 8 bf16; with
//                      kv, every K/V tile of the (b, h) through the same
//                      2-stage ring, one cp.async wait and __syncthreads
//                      per tile; the query tile out to o with the
//                      forward's store pattern (4 bytes a thread, a warp
//                      writing 16-byte pieces of 8 rows).
//
// Inputs are contiguous (B, S, H, 32) bf16.  The entry point launches on
// the caller's stream and returns cudaGetLastError() (0 = launched).

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

}  // extern "C"
