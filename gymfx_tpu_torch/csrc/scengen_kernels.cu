// Hand-written Hopper (sm_90a) kernel for the scenario generator.
//
//   K10 scengen_scan  has no Pallas counterpart: it is the port's counterpart
//                     of the jax.lax.scan over bars in
//                     gymfx_tpu/scengen/engine.py::paths_from_shocks (:232),
//                     which XLA compiles into one loop.  One generation's
//                     tape: open, high, low, close (n, A), the spread and
//                     slippage multipliers (n,), the FLAG_* bits and the
//                     regime (n,), from the drawn shocks.
//
// What it computes is the port's plain version,
// gymfx_tpu_torch/ops/scengen_scan.py::paths_plain, bit for bit: per bar,
// the regime transition (the row's partial sums c0, c1 = c0 + row[1], c2 =
// c1 + row[2] in float32, in engine.py's order), the crash, recovery and
// drought counters, then per asset ret = (drift + vol_t * eps) + overlay,
// the gap, open = expf(logp + gap), logp = (logp + gap) + ret, close =
// expf(logp), the wicks max/min(open, close) * expf(+-hl_range * vol_t *
// |z|), and the bar's spread, slippage, flags and regime.  Every float
// operation is the plain version's, unfused (this library is built with
// -fmad=false and without --use_fast_math: expf is the math library's
// accurate one, as torch.exp on the card).
//
// What bounds it: the serial chain.  Its bytes at bench.py --scengen's
// shape (65,536 bars x 4 assets: 8 (n, A) arrays and 8 (n,) arrays of 4
// bytes) are ~10.5 MB, 3.1 us at 3.35 TB/s; but bar t + 1 needs bar t's
// regime, counters and log prices, so n bars cost n times the latency of
// one bar's dependent operations: the regime's three selects and
// compares, the counters' compares, and the two adds of the log price
// (~40-60 cycles a bar, ~1.5-2 ms at 65,536 bars and 1.75 GHz).
//
// What the design does about it: one CTA of four warps a generation, a
// tile of bars at a time, in four passes.  The shocks are staged into
// shared memory in double-buffered tiles with cp.async by every thread
// (4-byte pieces: the tile's five per-bar columns, then its four (tile, A)
// blocks), the copies of tile k + 1 issued before tile k runs.  1. The
// three chains are independent of one another: warp 0 walks the regime
// (the row's thresholds picked by the last regime with selects), warp 1
// the crash and recovery counters, warp 2 the drought counter, at once,
// each reading its uniforms a group of bars ahead into registers and
// recording each bar's state in shared memory.  2. Every thread: each
// (bar, asset)'s ret = (drift + vol_t * eps) + overlay and gap, in place
// of its shocks, and each bar's spread, slippage, flags and regime,
// written out.  3. Warp 0: lane a carries the log prices of assets a,
// a + 32, ... in registers through the tile, two adds a bar, writing the
// open and close logs in place.  4. Every thread: the four expf and the
// wicks of each element, written coalesced.  So the serial walks hold only
// their chain's own operations.  The first design, one warp walking every
// operation of a bar, took 29 ms at the shape above on an H100 (700 W);
// with the exponentials moved to four warps, 16.6 ms.
// A parallel prefix over the log prices behind a scalar regime chain would
// reorder the float sums: it is a later redesign (ROADMAP.md).
//
// The extern "C" entry point launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <string.h>

namespace {

// FLAG_* bits (gymfx_tpu_torch/scengen/params.py)
constexpr int kFlagTrend = 1;
constexpr int kFlagDrought = 2;
constexpr int kFlagCrash = 4;
constexpr int kFlagGap = 8;
constexpr int kFlagHighvol = 16;
constexpr int kTrendUp = 1, kTrendDown = 2, kHighvol = 3;

struct ScanArgs {
  // inputs: the per-bar uniforms and the Monday mask (n,), the per-asset
  // shocks (n, A) (eps already mixed by the Cholesky factor), log(s0) (A,)
  const float* regime_u;
  const float* crash_u;
  const float* gap_u;
  const float* drought_u;
  const int* monday;
  const float* eps;
  const float* gap_z;
  const float* hi_z;
  const float* lo_z;
  const float* logp0;
  // outputs: open, high, low, close (n, A); spread, slip (n,); flags,
  // regime (n,) int32
  float* ohlc[4];
  float* spread;
  float* slip;
  int* flags;
  int* regime;
};
constexpr int kScanPointers = 18;

// The scenario's constants, as ops/scengen_scan.py::scan_constants orders
// them (43 32-bit words).
struct ScanConsts {
  float trans[16];  // row-major 4 x 4 transition matrix
  float drift[4], vol[4], spread[4];
  float hl_range, p_crash, crash_drop, recov_gain, crash_spread, p_gap, gap_size,
      weekend_gap_size, p_drought, drought_spread, drought_vol;
  int crash_len, recovery_len, drought_len, regime0;
};
constexpr int kScanConsts = 43;
static_assert(sizeof(ScanConsts) == kScanConsts * 4, "ScanConsts is 43 words");

// per-bar columns of a staged tile, then the per-asset blocks
constexpr int kBarColumns = 5;
constexpr int kAssetBlocks = 4;
constexpr int kMaxPerLane = 8;  // assets a lane of warp 0: A <= 256
constexpr int kThreads = 128;   // four warps: three chains, then every thread

__device__ __forceinline__ float pick4(int r, float a0, float a1, float a2, float a3) {
  return r == 0 ? a0 : (r == 1 ? a1 : (r == 2 ? a2 : a3));
}

// torch.maximum / torch.minimum: NaN-propagating (fmaxf / fminf alone drop NaN)
__device__ __forceinline__ float max_nan(float x, float y) {
  return (x != x || y != y) ? __int_as_float(0x7fffffff) : fmaxf(x, y);
}
__device__ __forceinline__ float min_nan(float x, float y) {
  return (x != x || y != y) ? __int_as_float(0x7fffffff) : fminf(x, y);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage bars [t0, t0 + len) into buf, every thread of the CTA: the five
// per-bar columns at buf[c * tile + j], then the four (len, A) blocks at
// buf[kBarColumns * tile + b * tile * A + j * A + a].
__device__ __forceinline__ void stage(float* buf, const ScanArgs& a, long long t0, int len,
                                      int tile, int n_assets, int tid) {
  const float* bar_cols[kBarColumns] = {a.regime_u, a.crash_u, a.gap_u, a.drought_u,
                                        reinterpret_cast<const float*>(a.monday)};
  for (int c = 0; c < kBarColumns; ++c)
    for (int j = tid; j < len; j += kThreads) cp_async4(buf + c * tile + j, bar_cols[c] + t0 + j);
  const float* blocks[kAssetBlocks] = {a.eps, a.gap_z, a.hi_z, a.lo_z};
  const long long base = t0 * n_assets;
  const int count = len * n_assets;
  for (int b = 0; b < kAssetBlocks; ++b) {
    float* dst = buf + kBarColumns * tile + b * tile * n_assets;
    for (int j = tid; j < count; j += kThreads) cp_async4(dst + j, blocks[b] + base + j);
  }
}

// Bars a chain warp reads ahead into registers before it walks them.
constexpr int kGroup = 8;

__global__ void __launch_bounds__(kThreads)
scengen_scan_kernel(ScanArgs a, ScanConsts k, long long n, int n_assets, int tile) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile_words = kBarColumns * tile + kAssetBlocks * tile * n_assets;
  float* bufs[2] = {smem, smem + tile_words};
  // the chains' record of each bar of a tile: the regime, the crash state
  // (bit 0 in the drop phase, bit 1 in the recovery tail), the drought bit
  int* rec_regime = reinterpret_cast<int*>(smem + 2 * tile_words);
  int* rec_crash = rec_regime + tile;
  int* rec_drought = rec_crash + tile;

  const float neg_crash_drop = -k.crash_drop;
  const float neg_hl = -k.hl_range;
  // each chain's carry lives in its own warp's registers across tiles
  int regime = k.regime0, crash_left = 0, recov_left = 0, drought_left = 0;
  // the transition rows' partial sums, sequenced as engine.py's step
  float c0[4], c1[4], c2[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    c0[r] = k.trans[4 * r];
    c1[r] = __fadd_rn(c0[r], k.trans[4 * r + 1]);
    c2[r] = __fadd_rn(c1[r], k.trans[4 * r + 2]);
  }
  // warp 0 lane l's log prices (assets l, l + 32, ...; kMaxPerLane at
  // most, which the entry point checks)
  float logp[kMaxPerLane];
  const int mine = warp == 0 && n_assets > lane ? (n_assets - lane + 31) / 32 : 0;
#pragma unroll
  for (int q = 0; q < kMaxPerLane; ++q) logp[q] = q < mine ? a.logp0[lane + 32 * q] : 0.0f;

  const long long n_tiles = (n + tile - 1) / tile;
  stage(bufs[0], a, 0, (int)min((long long)tile, n), tile, n_assets, tid);
  cp_async_commit();
  for (long long ti = 0; ti < n_tiles; ++ti) {
    const long long t0 = ti * tile;
    const int len = (int)min((long long)tile, n - t0);
    if (ti + 1 < n_tiles) {
      const long long t1 = t0 + tile;
      stage(bufs[(ti + 1) & 1], a, t1, (int)min((long long)tile, n - t1), tile, n_assets, tid);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // the tile's shocks, staged by every thread, are in
    float* buf = bufs[ti & 1];
    const float* u_reg = buf;
    const float* u_crash = buf + tile;
    const float* u_gap = buf + 2 * tile;
    const float* u_drought = buf + 3 * tile;
    const int* monday = reinterpret_cast<const int*>(buf + 4 * tile);
    // eps and gap_z become each element's ret and gap, then its open and
    // close logs, in place; hi_z and lo_z are read by the epilogue
    float* s_eps = buf + kBarColumns * tile;
    float* s_gap = s_eps + tile * n_assets;
    const float* s_hi = s_gap + tile * n_assets;
    const float* s_lo = s_hi + tile * n_assets;

    // 1. the three chains, each walked by its own warp at once (every lane
    // alike, lane 0 writes), its inputs read a group ahead
    if (warp == 0) {  // the regime: the row's thresholds picked by the last
      for (int g = 0; g < len; g += kGroup) {
        float u[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) u[i] = g + i < len ? u_reg[g + i] : 0.0f;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (g + i >= len) break;
          const float t_c0 = pick4(regime, c0[0], c0[1], c0[2], c0[3]);
          const float t_c1 = pick4(regime, c1[0], c1[1], c1[2], c1[3]);
          const float t_c2 = pick4(regime, c2[0], c2[1], c2[2], c2[3]);
          regime = u[i] < t_c0 ? 0 : (u[i] < t_c1 ? 1 : (u[i] < t_c2 ? 2 : 3));
          if (lane == 0) rec_regime[g + i] = regime;
        }
      }
    } else if (warp == 1) {  // the flash crash: drop phase, then the recovery tail
      for (int g = 0; g < len; g += kGroup) {
        bool start[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) start[i] = g + i < len && u_crash[g + i] < k.p_crash;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (g + i >= len) break;
          if (crash_left == 0 && recov_left == 0 && start[i]) crash_left = k.crash_len;
          const bool in_crash = crash_left > 0;
          const int crash_next = max(crash_left - (int)in_crash, 0);
          if (in_crash && crash_next == 0) recov_left = k.recovery_len;
          const bool in_recov = !in_crash && recov_left > 0;
          recov_left = in_recov ? recov_left - 1 : recov_left;
          crash_left = crash_next;
          if (lane == 0) rec_crash[g + i] = (in_crash ? 1 : 0) | (in_recov ? 2 : 0);
        }
      }
    } else if (warp == 2) {  // the liquidity drought
      for (int g = 0; g < len; g += kGroup) {
        bool start[kGroup];
#pragma unroll
        for (int i = 0; i < kGroup; ++i) start[i] = g + i < len && u_drought[g + i] < k.p_drought;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (g + i >= len) break;
          if (drought_left == 0 && start[i]) drought_left = k.drought_len;
          const bool in_drought = drought_left > 0;
          drought_left = max(drought_left - (int)in_drought, 0);
          if (lane == 0) rec_drought[g + i] = in_drought;
        }
      }
    }
    __syncthreads();  // the tile's records are in

    // 2. every thread: each element's ret and gap, in place of its shocks;
    // each bar's spread, slippage, flags and regime, written out
    const int count = len * n_assets;
    for (int e = tid; e < count; e += kThreads) {
      const int j = e / n_assets;
      const int r = rec_regime[j], crash = rec_crash[j];
      const bool in_drought = rec_drought[j] != 0;
      const float vol_t = __fmul_rn(pick4(r, k.vol[0], k.vol[1], k.vol[2], k.vol[3]),
                                    in_drought ? k.drought_vol : 1.0f);
      const float overlay =
          __fadd_rn(crash & 1 ? neg_crash_drop : 0.0f, crash & 2 ? k.recov_gain : 0.0f);
      const float drift = pick4(r, k.drift[0], k.drift[1], k.drift[2], k.drift[3]);
      const bool is_monday = monday[j] != 0;
      const bool gap_evt = u_gap[j] < k.p_gap || is_monday;
      const float gsz = is_monday ? k.weekend_gap_size : k.gap_size;
      s_eps[e] = __fadd_rn(__fadd_rn(drift, __fmul_rn(vol_t, s_eps[e])), overlay);
      s_gap[e] = gap_evt ? __fmul_rn(s_gap[e], gsz) : 0.0f;
    }
    for (int j = tid; j < len; j += kThreads) {
      const int r = rec_regime[j];
      const bool in_crash = rec_crash[j] & 1, in_drought = rec_drought[j] != 0;
      const bool gap_evt = u_gap[j] < k.p_gap || monday[j] != 0;
      const float sp = __fmul_rn(
          __fmul_rn(pick4(r, k.spread[0], k.spread[1], k.spread[2], k.spread[3]),
                    in_drought ? k.drought_spread : 1.0f),
          in_crash ? k.crash_spread : 1.0f);
      a.spread[t0 + j] = sp;
      a.slip[t0 + j] = __fadd_rn(1.0f, __fmul_rn(0.5f, __fsub_rn(sp, 1.0f)));
      a.flags[t0 + j] = (r == kTrendUp || r == kTrendDown ? kFlagTrend : 0) |
                        (in_drought ? kFlagDrought : 0) | (in_crash ? kFlagCrash : 0) |
                        (gap_evt ? kFlagGap : 0) | (r == kHighvol ? kFlagHighvol : 0);
      a.regime[t0 + j] = r;
    }
    __syncthreads();  // the tile's rets and gaps are in

    // 3. the log prices, warp 0: lane a carries assets a, a + 32, ... and
    // writes each bar's open and close logs over its gap and ret
    if (warp == 0) {
#pragma unroll
      for (int q = 0; q < kMaxPerLane; ++q) {
        if (q >= mine) break;
        float lp = logp[q];
        const int asset = lane + 32 * q;
        for (int g = 0; g < len; g += kGroup) {
          float ret[kGroup], gap[kGroup];
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            const int at = (g + i < len ? g + i : g) * n_assets + asset;
            ret[i] = s_eps[at];
            gap[i] = s_gap[at];
          }
#pragma unroll
          for (int i = 0; i < kGroup; ++i) {
            if (g + i >= len) break;
            const int at = (g + i) * n_assets + asset;
            const float open_log = __fadd_rn(lp, gap[i]);
            lp = __fadd_rn(open_log, ret[i]);
            s_eps[at] = open_log;
            s_gap[at] = lp;
          }
        }
        logp[q] = lp;
      }
    }
    __syncthreads();  // the tile's logs are in

    // 4. every thread: each element's prices and wicks, written coalesced
    const long long base = t0 * n_assets;
    for (int e = tid; e < count; e += kThreads) {
      const int j = e / n_assets;
      const int r = rec_regime[j];
      const float vol_t = __fmul_rn(pick4(r, k.vol[0], k.vol[1], k.vol[2], k.vol[3]),
                                    rec_drought[j] != 0 ? k.drought_vol : 1.0f);
      const float open_ = expf(s_eps[e]);
      const float close = expf(s_gap[e]);
      const float hi = __fmul_rn(max_nan(open_, close),
                                 expf(__fmul_rn(__fmul_rn(k.hl_range, vol_t), fabsf(s_hi[e]))));
      const float lo = __fmul_rn(min_nan(open_, close),
                                 expf(__fmul_rn(__fmul_rn(neg_hl, vol_t), fabsf(s_lo[e]))));
      a.ohlc[0][base + e] = open_;
      a.ohlc[1][base + e] = hi;
      a.ohlc[2][base + e] = lo;
      a.ohlc[3][base + e] = close;
    }
    __syncthreads();  // every thread is done with this buffer before it is staged again
  }
}

}  // namespace

extern "C" {

int gymfx_scengen_pointer_count() { return kScanPointers; }

int gymfx_scengen_const_count() { return kScanConsts; }

int gymfx_scengen_max_assets() { return 32 * kMaxPerLane; }

// The dynamic shared memory a launch at (tile, n_assets) takes: two tiles
// of shocks and one tile of the chains' records (three words a bar).
long long gymfx_scengen_smem_bytes(int tile, int n_assets) {
  return (2LL * (kBarColumns * (long long)tile + kAssetBlocks * (long long)tile * n_assets) +
          3LL * tile) * 4;
}

// ptrs: the 18 device pointers of ScanArgs in its order, all contiguous.
// consts: the 43 words of ScanConsts, in host memory (copied into the
// launch's parameters).  One CTA of kThreads.
int gymfx_scengen_scan(void* const* ptrs, const int* consts, long long n, int n_assets, int tile,
                       void* stream) {
  if (n <= 0 || n_assets <= 0) return (int)cudaSuccess;
  if (n_assets > 32 * kMaxPerLane || tile <= 0) return (int)cudaErrorInvalidValue;
  ScanArgs a;
  a.regime_u = static_cast<const float*>(ptrs[0]);
  a.crash_u = static_cast<const float*>(ptrs[1]);
  a.gap_u = static_cast<const float*>(ptrs[2]);
  a.drought_u = static_cast<const float*>(ptrs[3]);
  a.monday = static_cast<const int*>(ptrs[4]);
  a.eps = static_cast<const float*>(ptrs[5]);
  a.gap_z = static_cast<const float*>(ptrs[6]);
  a.hi_z = static_cast<const float*>(ptrs[7]);
  a.lo_z = static_cast<const float*>(ptrs[8]);
  a.logp0 = static_cast<const float*>(ptrs[9]);
  for (int i = 0; i < 4; ++i) a.ohlc[i] = static_cast<float*>(ptrs[10 + i]);
  a.spread = static_cast<float*>(ptrs[14]);
  a.slip = static_cast<float*>(ptrs[15]);
  a.flags = static_cast<int*>(ptrs[16]);
  a.regime = static_cast<int*>(ptrs[17]);
  ScanConsts k;
  memcpy(&k, consts, sizeof(k));
  const long long smem = gymfx_scengen_smem_bytes(tile, n_assets);
  static long long smem_allowed = 48 * 1024;  // raised once, to the most a launch asked for
  if (smem > smem_allowed) {
    const cudaError_t rc = cudaFuncSetAttribute(
        scengen_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
    smem_allowed = smem;
  }
  scengen_scan_kernel<<<1, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      a, k, n, n_assets, tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
