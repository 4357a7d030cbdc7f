// Hand-written Hopper (sm_90a) kernels for the data path at scale.
//
//   K6 q16_decode       replaces gymfx_tpu/ops/tape_decode.py::decode_q16_block
//                       (pallas body _decode_kernel): the f32 view of a stacked
//                       block of compressed tape columns,
//                       out[c, j] = float(base[c] + int(delta[c, j])) / inv[c].
//   K7 scaled_windows   replaces gymfx_tpu/ops/window_zscore.py::
//                       batched_scaled_windows (pallas body _kernel): for each
//                       step s of a batch, the window padded_features[s : s+W]
//                       z-scored with that step's moments, zero where the step
//                       is neutral, clipped to +-clip when clip > 0.
//
// What bounds them: bytes.  Both are one pass of a few operations per
// element.  K6 reads 2 bytes and writes 4 per element (a whole 262,144-bar
// tape group of 5 columns is 7.9 MB, 2.3 us at 3.35 TB/s); K7 writes
// B x W x F f32 (262,143 x 32 x 5 at the export's shape: 167.8 MB, 50 us)
// and reads each feature row and moment row once.  What K7 spends beside
// the bytes is instructions: an IEEE division and a NaN-propagating clip
// per element, so its design keeps the rest of an element's work small.
//
// What the designs do about it.  K6: one thread per 8 elements of a row,
// a 2-D grid over (row chunk, column); when every row starts on a 16-byte
// boundary (rows % 8 == 0 and aligned pointers, decided by the wrapper)
// a thread does one 16-byte int16 load and two 16-byte f32 stores, else
// eight masked scalar accesses.  The base and the divisor are read from
// device memory: divisors stay runtime values, so the compiler cannot turn
// the division into a reciprocal multiply (the bitwise contract of
// gymfx_tpu/data/compress.py).
//
// K7 is a tiled, staged pass over a persistent grid (a few CTAs an SM,
// each walking tiles blockIdx.x, + gridDim.x, ...; the wrapper sizes the
// grid so that every CTA walks the same number of tiles, give or take
// one).  A tile is up to `tile` (256 at the export's shape) consecutive
// batch entries.  Its steps come into registers one
// tile ahead; from them the CTA derives each step's clamped window start
// and moment row into shared memory, then stages with cp.async the
// tile's moments (mean and std interleaved, one (mean, std) pair per
// step and feature) and, when the tile's window starts run consecutively
// (the export's steps 1..n inside the clamp), the union of its windows:
// T + W - 1 rows, one contiguous span, copied in 16-byte pieces from its
// aligned interior and 4-byte pieces at its ragged ends.  A tile whose
// starts do not run consecutively (steps in any order, or clamped) reads
// each step's window from device memory through the read-only cache.
// Each CTA holds two tiles' buffers: the copies of tile k + 1 are issued
// before tile k is computed, so they overlap its stores.  The stores are
// most of the bytes; reading the inputs beside them is what the pass pays
// over a write of its output alone.  The output of
// a tile is T x W x F contiguous floats (W % 8 == 0, so each step's face
// is whole 16-byte quads): thread q of the tile writes quads q, q + 256,
// ... as streaming float4 stores (__stcs, evict-first, so the 168 MB of
// write-once output does not push the inputs out of L2).  Index arithmetic
// has no 64-bit division and no run-time `%`: the quad's step comes from
// host-computed magic numbers (ops/window_zscore.magic), and its feature
// from a compile-time modulus in the F = 5 instantiation (the export's)
// or from magic numbers in the other (any F).  ops/cases.py models this
// tiling and the staged copies on the CPU (scaled_windows_tiling).
//
// Clamping follows XLA's: K7's window start is clamped to
// [0, rows(padded_features) - W] (dynamic_slice) and its moment row to
// [0, rows(feat_mean) - 1] (gather).
//
// Bitwise contract with the plain PyTorch versions
// (gymfx_tpu_torch/ops/tape_decode.py, ops/window_zscore.py): build with
// -fmad=false and without --use_fast_math (IEEE division); int32 -> f32
// rounds to nearest (__int2float_rn, what a C cast does); clip is
// NaN-propagating max / min (fmaxf / fminf alone drop NaN); the neutral
// select is a select.  K7 does no nan_to_num: NaN and +-inf inputs pass
// through the z-score and the clip as XLA computes them.
//
// Each extern "C" entry point launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// ---------------------------------------------------------------- K6
__device__ __forceinline__ float decode_one(int base, short d, float inv) {
  return __int2float_rn(base + (int)d) / inv;
}

__global__ void q16_decode_kernel(const short* __restrict__ delta,
                                  const int* __restrict__ base,
                                  const float* __restrict__ inv,
                                  float* __restrict__ out, long long rows,
                                  int vectorized) {
  const int c = blockIdx.y;
  const long long j0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (j0 >= rows) return;
  const int b = base[c];
  const float v = inv[c];
  const short* src = delta + (long long)c * rows;
  float* dst = out + (long long)c * rows;
  if (vectorized) {
    // rows % 8 == 0: eight whole elements, one 16-byte load, two stores
    int4 raw = *reinterpret_cast<const int4*>(src + j0);
    const short* d = reinterpret_cast<const short*>(&raw);
    float4 lo = make_float4(decode_one(b, d[0], v), decode_one(b, d[1], v),
                            decode_one(b, d[2], v), decode_one(b, d[3], v));
    float4 hi = make_float4(decode_one(b, d[4], v), decode_one(b, d[5], v),
                            decode_one(b, d[6], v), decode_one(b, d[7], v));
    *reinterpret_cast<float4*>(dst + j0) = lo;
    *reinterpret_cast<float4*>(dst + j0 + 4) = hi;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      long long j = j0 + k;
      if (j < rows) dst[j] = decode_one(b, src[j], v);
    }
  }
}

// ---------------------------------------------------------------- K7
constexpr int kWinThreads = 256;
constexpr int kWinMinBlocks = 4;  // CTAs an SM the registers must leave room for
constexpr int kWinTemplateF = 5;  // the export's F; every other F takes magic numbers
// (the compile-time F runs the export's shape 0.7-1.5% faster: PERF.md section 6)

// The launch, built once per shape by ops/window_zscore._scaled_windows_plan
// and passed as kWinGeometryInts 4-byte fields, the clip's bits last.
struct WinGeometry {
  int grid;        // persistent CTAs
  int tile;        // batch entries a tile (T)
  int tiles;       // ceil(batch / T)
  int batch;
  int window;      // W, a multiple of 8
  int features;    // F
  int face_quads;  // W * F / 4, the float4s of one step's output
  unsigned fq_lo, fq_hi, fq_shift;  // magic numbers of face_quads
  unsigned f_lo, f_hi, f_shift;     // magic numbers of F
  int span_floats;  // a buffer's window span, 0 when no span is staged
  int buf_bytes;    // one tile's buffer (16-byte multiple)
  int max_start;    // rows(padded_features) - W
  int max_moment;   // rows(feat_mean) - 1
  float clip;
};
constexpr int kWinGeometryInts = 18;
static_assert(sizeof(WinGeometry) == kWinGeometryInts * sizeof(int), "4-byte fields only");

// q / d for 0 <= q < 2^31 by (lo, hi, shift) = ops/window_zscore.magic(d)
__device__ __forceinline__ unsigned magic_div(unsigned j, unsigned lo, unsigned hi,
                                              unsigned shift) {
  return (__umulhi(j, lo) + (hi ? j : 0u)) >> shift;
}

// i / F and i % F for 0 <= i < 2^31: a compile-time divisor in the F = 5
// instantiation, magic numbers in the other
template <int kF>
__device__ __forceinline__ int div_f(int i, const WinGeometry& g) {
  if constexpr (kF > 0) {
    return (int)((unsigned)i / (unsigned)kF);
  } else {
    return (int)magic_div(i, g.f_lo, g.f_hi, g.f_shift);
  }
}
template <int kF>
__device__ __forceinline__ int mod_f(int i, const WinGeometry& g) {
  if constexpr (kF > 0) {
    return (int)((unsigned)i % (unsigned)kF);
  } else {
    return i - (int)magic_div(i, g.f_lo, g.f_hi, g.f_shift) * g.features;
  }
}

__device__ __forceinline__ int clamp_to(int s, int hi) { return s < 0 ? 0 : (s > hi ? hi : s); }

// jmin(jmax(y, -c), c) for a clip c > 0 (never NaN): NaN passes through
__device__ __forceinline__ float clip_nan(float y, float c) {
  return (y != y) ? y : fminf(fmaxf(y, -c), c);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One tile's buffer in shared memory: the window span (span_floats, 16-byte
// aligned), the (mean, std) pairs (T x F), then per step its clamped window
// start, its moment row and its neutral flag.
struct WinBuf {
  float* span;
  float2* ms;
  int* start;
  int* row;
  int* flag;
};

__device__ __forceinline__ WinBuf win_buf(unsigned char* smem, const WinGeometry& g, int f,
                                          int which) {
  unsigned char* base = smem + which * g.buf_bytes;
  WinBuf b;
  b.span = reinterpret_cast<float*>(base);
  b.ms = reinterpret_cast<float2*>(base + 4 * g.span_floats);
  b.start = reinterpret_cast<int*>(b.ms + g.tile * f);
  b.row = b.start + g.tile;
  b.flag = b.row + g.tile;
  return b;
}

// The steps of tile `tl` a thread holds: its own (thread t < the tile's
// entries) and the tile's first.
struct TileSteps {
  int own, first;
};

__device__ __forceinline__ TileSteps load_steps(const int* __restrict__ steps,
                                                const WinGeometry& g, int tl) {
  const int b0 = tl * g.tile;
  const int tv = min(g.tile, g.batch - b0);
  TileSteps s;
  s.first = __ldg(steps + b0);
  s.own = (int)threadIdx.x < tv ? __ldg(steps + b0 + threadIdx.x) : 0;
  return s;
}

// Stage tile `tl` into buffer `b`: each step's start and row into shared
// memory, then the cp.async copies of its moments and (when its starts run
// consecutively and a span is staged) its window span.  Returns whether
// the span was staged; `lead` is the span's first float within the buffer
// (the source's offset past a 16-byte boundary, 0-3).  The neutral flag of
// thread t's step is loaded into `flag` and written to shared memory by
// the caller after the tile before it is computed.  Every thread of the
// CTA must call it (it holds a barrier).
template <int kF>
__device__ __forceinline__ bool stage_tile(const WinGeometry& g, WinBuf b, int tl, TileSteps s,
                                           const float* __restrict__ feats,
                                           const float* __restrict__ mean,
                                           const float* __restrict__ stdv,
                                           const unsigned char* __restrict__ neutral,
                                           int& lead, int& flag) {
  const int f = kF ? kF : g.features;
  const int tid = threadIdx.x;
  const int tv = min(g.tile, g.batch - tl * g.tile);
  const int start0 = clamp_to(s.first, g.max_start);
  bool consecutive = true;
  flag = 0;
  if (tid < tv) {
    const int start = clamp_to(s.own, g.max_start);
    const int row = clamp_to(s.own, g.max_moment);
    b.start[tid] = start;
    b.row[tid] = row;
    flag = __ldg(neutral + row);
    consecutive = start == start0 + tid;
  }
  const bool staged = __syncthreads_and(consecutive) && g.span_floats > 0;
  // the moments: (mean, std) of each step's row, feature by feature
  const int pairs = tv * f;
  for (int i = tid; i < pairs; i += kWinThreads) {
    const int t = div_f<kF>(i, g);
    const long long src = (long long)b.row[t] * f + (i - t * f);
    cp_async4(&b.ms[i].x, mean + src);
    cp_async4(&b.ms[i].y, stdv + src);
  }
  lead = 0;
  if (staged) {
    // rows start0 .. start0 + tv + W - 2: 4-byte pieces up to the first
    // 16-byte boundary of the source, 16-byte pieces, 4-byte pieces after
    const float* src = feats + (long long)start0 * f;
    const int len = (tv + g.window - 1) * f;
    lead = (int)((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
    const int head = min((4 - lead) & 3, len);
    const int quads = (len - head) >> 2;
    const int tail = head + 4 * quads;
    float* dst = b.span + lead;
    if (tid < head) cp_async4(dst + tid, src + tid);
    for (int k = tid; k < quads; k += kWinThreads) cp_async16(dst + head + 4 * k, src + head + 4 * k);
    if (tail + tid < len) cp_async4(dst + tail + tid, src + tail + tid);
  }
  return staged;
}

// The output of tile `tl` from buffer `b`: thread q takes quads q, q + 256,
// ... of the tile's T x W x F floats.  kStaged: the windows from the span.
template <int kF, bool kStaged>
__device__ __forceinline__ void compute_tile(const WinGeometry& g, WinBuf b, int tl, int lead,
                                             const float* __restrict__ feats,
                                             float* __restrict__ out) {
  const int f = kF ? kF : g.features;
  const int b0 = tl * g.tile;
  const int quads = min(g.tile, g.batch - b0) * g.face_quads;
  float4* dst = reinterpret_cast<float4*>(out) + (long long)b0 * g.face_quads;
  const float clip = g.clip;
  for (int q = threadIdx.x; q < quads; q += kWinThreads) {
    const int t = (int)magic_div(q, g.fq_lo, g.fq_hi, g.fq_shift);
    const int e0 = (q - t * g.face_quads) * 4;  // the quad's first element in the face
    int feat = mod_f<kF>(e0, g);
    const float2* ms = b.ms + t * f;
    const bool neutral_step = b.flag[t] != 0;
    float x[4];
    if (kStaged) {
      const float* win = b.span + lead + t * f + e0;
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = win[k];
    } else {
      const float* win = feats + (long long)b.start[t] * f + e0;
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = __ldg(win + k);
    }
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 m = ms[feat];
      const float z = (x[k] - m.x) / m.y;
      float y = neutral_step ? 0.f : z;
      if (clip > 0.f) y = clip_nan(y, clip);
      v[k] = y;
      feat = (feat + 1 == f) ? 0 : feat + 1;
    }
    __stcs(dst + q, make_float4(v[0], v[1], v[2], v[3]));
  }
}

template <int kF>
__global__ void __launch_bounds__(kWinThreads, kWinMinBlocks)
scaled_windows_kernel(const float* __restrict__ feats, const float* __restrict__ mean,
                      const float* __restrict__ stdv, const unsigned char* __restrict__ neutral,
                      const int* __restrict__ steps, float* __restrict__ out, WinGeometry g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = kF ? kF : g.features;
  int tl = blockIdx.x;
  if (tl >= g.tiles) return;
  int cur = 0, lead = 0, flag = 0;
  bool staged = stage_tile<kF>(g, win_buf(smem, g, f, 0), tl, load_steps(steps, g, tl), feats,
                               mean, stdv, neutral, lead, flag);
  cp_async_commit();
  if ((int)threadIdx.x < g.tile) win_buf(smem, g, f, 0).flag[threadIdx.x] = flag;
  TileSteps next_steps{0, 0};
  if (tl + (int)gridDim.x < g.tiles) next_steps = load_steps(steps, g, tl + gridDim.x);
  for (;;) {
    const int next = tl + gridDim.x;
    const bool more = next < g.tiles;
    int next_lead = 0, next_flag = 0;
    bool next_staged = false;
    if (more) {  // uniform: stage tile k + 1 while tile k's copies land
      next_staged = stage_tile<kF>(g, win_buf(smem, g, f, cur ^ 1), next, next_steps, feats,
                                   mean, stdv, neutral, next_lead, next_flag);
      if (next + (int)gridDim.x < g.tiles) next_steps = load_steps(steps, g, next + gridDim.x);
    }
    cp_async_commit();
    cp_async_wait_one();  // tile k's copies
    __syncthreads();
    const WinBuf b = win_buf(smem, g, f, cur);
    if (staged) {
      compute_tile<kF, true>(g, b, tl, lead, feats, out);
    } else {
      compute_tile<kF, false>(g, b, tl, lead, feats, out);
    }
    if (more && (int)threadIdx.x < g.tile) win_buf(smem, g, f, cur ^ 1).flag[threadIdx.x] = next_flag;
    __syncthreads();  // buffer `cur` is free for tile k + 2
    if (!more) break;
    tl = next;
    cur ^= 1;
    staged = next_staged;
    lead = next_lead;
  }
}

unsigned int blocks_for(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

int gymfx_q16_decode(const void* delta, const void* base, const void* inv,
                     void* out, int columns, long long rows, int vectorized,
                     void* stream) {
  const int threads = 256;
  dim3 grid(blocks_for((rows + 7) / 8, threads), (unsigned int)columns);
  q16_decode_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const short*>(delta), static_cast<const int*>(base),
      static_cast<const float*>(inv), static_cast<float*>(out), rows,
      vectorized);
  return (int)cudaGetLastError();
}

// K7's launch constants, which ops/window_zscore.py holds against its own:
// {threads, the templated F, ints in WinGeometry}
void gymfx_scaled_windows_constants(int* out) {
  out[0] = kWinThreads;
  out[1] = kWinTemplateF;
  out[2] = kWinGeometryInts;
}

// K7 CTAs that fit on one SM with `smem_bytes` of shared memory, for the
// F = 5 instantiation (templated != 0) or the other (0 on error)
int gymfx_scaled_windows_blocks_per_sm(int templated, int smem_bytes) {
  int blocks = 0;
  cudaError_t rc = templated
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, scaled_windows_kernel<kWinTemplateF>, kWinThreads, (size_t)smem_bytes)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, scaled_windows_kernel<0>,
                                                      kWinThreads, (size_t)smem_bytes);
  return rc == cudaSuccess ? blocks : 0;
}

// geometry: a WinGeometry as kWinGeometryInts ints (ops/window_zscore.py
// _scaled_windows_plan); two tile buffers of shared memory
int gymfx_scaled_windows(const void* feats, const void* mean, const void* stdv,
                         const void* neutral, const void* steps, void* out,
                         const int* geometry, void* stream) {
  WinGeometry g;
  memcpy(&g, geometry, sizeof(g));
  const size_t smem = 2 * (size_t)g.buf_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feats);
  const float* m = static_cast<const float*>(mean);
  const float* sd = static_cast<const float*>(stdv);
  const unsigned char* nb = static_cast<const unsigned char*>(neutral);
  const int* s = static_cast<const int*>(steps);
  float* o = static_cast<float*>(out);
  if (g.features == kWinTemplateF) {
    scaled_windows_kernel<kWinTemplateF><<<g.grid, kWinThreads, smem, st>>>(f, m, sd, nb, s, o, g);
  } else {
    scaled_windows_kernel<0><<<g.grid, kWinThreads, smem, st>>>(f, m, sd, nb, s, o, g);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
