// Hand-written Hopper (sm_90a) kernels for the env rollout's hot path.
//
// Three kernels, one per Pallas kernel of the JAX package's rollout:
//
//   K1 step_obs       replaces gymfx_tpu/ops/window_zscore.py::fused_step_obs
//                     (pallas body _step_obs_kernel): the scaled feature
//                     window of the policy input.
//   K2 fill_brackets  replaces gymfx_tpu/ops/env_dynamics.py::fused_fill_brackets
//                     (pallas body _fill_bracket_kernel): pending-order fill,
//                     SL/TP brackets and financing accrual at the bar open.
//   K3 mark_reward    replaces gymfx_tpu/ops/env_dynamics.py::fused_mark_reward
//                     (pallas body _mark_reward_kernel): mark to market,
//                     drawdown carries and the pnl / dd reward at the close,
//                     and the sharpe reward over its per-env ring buffer
//                     (the JAX package computes that one on its XLA path
//                     only: gymfx_tpu/core/rewards.py:47-78).
//
// What bounds them: bytes, and at these sizes the launch.  Each is an
// elementwise pass that does a few dozen flops per element, far below
// the H100's ~20 flops per byte of f32 ridge, so the least time is the
// bytes moved over 3.35 TB/s.  K1 reads the (N, W, F) window plus the
// (N, F) moments and writes the window once; K2 / K3 read and write each
// per-env ledger field once.  At the flagship shapes (N = 8192, W = 32,
// F = 5) that is ~10.8 MB for K1 (3.2 us at 3.35 TB/s), ~1.25 MB for K2
// (153 bytes per env: 66 in, 66 out, the advance flag, the bar's O/H/L
// and one counter read and written in place; the close and the accrual
// only with financing) and ~0.5 MB for K3 (66 bytes per env), so K2 and
// K3 are well under a microsecond of bandwidth and pay mostly their
// launch and one chain of dependent arithmetic per env.
//
// What the design does about it: one pass, every input read once and
// every output written once, no intermediate in device memory.  K1
// streams blocks of whole envs in 16-byte vectors with the block's
// moments staged in shared memory and no run-time integer division
// (below).  K2 and K3 are one thread per env over structure-of-arrays
// field pointers (the EnvState tensors themselves; the Pallas kernels'
// packing into (env_block, n_fields) faces existed for VMEM tiling and
// would only add stack/unbind copies here).  Both issue every load
// first, with none behind a branch, so each pays one memory round trip,
// and both run in CTAs of 64 so that the flagship's 8,192 envs reach 128
// SMs; K2 writes its outputs into one block per type and specialises the
// flags that cost the most at compile time.  The remaining static config
// choices arrive as an integer of flags: uniform branches, no divergence.
//
// Bitwise contract with the plain PyTorch versions (core/broker.py,
// core/rewards.py, core/obs.py): build with -fmad=false (no FMA
// contraction) and without --use_fast_math (IEEE division); round with
// rintf (round-half-even, as jnp.round / torch.round); max / min / clamp
// propagate NaN as XLA and torch do (fmaxf / fminf alone drop it); sign
// keeps NaN and signed zero as XLA does; every jnp.where is a select of
// two values that are both computed.
//
// Each extern "C" entry point launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float jsign(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}
__device__ __forceinline__ float quantize(float x, float tick) {
  float safe = tick > 0.f ? tick : 1.f;
  float q = rintf(x / safe) * safe;
  return tick > 0.f ? q : x;
}
__device__ __forceinline__ float snap_in_bar(float price, float low, float high,
                                             float tick) {
  float q = quantize(jmin(jmax(price, low), high), tick);
  float down = q - tick;
  float up = q + tick;
  q = (q > high && down >= low) ? down : q;
  q = (q < low && up <= high) ? up : q;
  return q;
}
__device__ __forceinline__ float opening_units(float pos, float target) {
  bool same_sign = pos * target > 0.f;
  float opening = jmax(fabsf(target) - fabsf(pos), 0.f);
  return (!same_sign && target != 0.f && pos != 0.f) ? fabsf(target) : opening;
}

// ---------------------------------------------------------------- K1
// Two tilings of one function; the wrapper picks per call
// (ops/window_zscore.py, modelled on the CPU by ops/cases.py
// step_obs_tiling and step_obs_row_tiling):
//
// Row groups (path 1, the flagship's F = 5 with W a multiple of 4 and
// both pointers on 16-byte boundaries): a thread computes kRowGroup rows
// of one env, 20 floats, so the feature of each element is a
// compile-time constant; it reads its env's F means and stds and its
// neutral flag into registers (the 8 threads of one env share them
// through L1), and the binary mask arrives as a bit word.  No index
// arithmetic per element.  The window moves coalesced: a warp's 32
// groups are 160 neighbouring float4s, which its lanes load and store
// 32 at a time through shared memory (each lane loading its own 80
// bytes would spread every warp access over an 80-byte stride).
//
// Env blocks (path 0, any shape and alignment): a CTA of kObsThreads
// streams a block of `eb` whole envs, eb * W * F contiguous floats.  It
// stages the block's moments and a select code (bit 0 neutral env, bit 1
// binary-mask column) in shared memory once, then moves the faces in
// 16-byte vectors, kObsVectors a thread in flight.  Elements before the
// output's first 16-byte boundary and after its last go through the same
// arithmetic one by one (the scalar path); the input is read as float4
// only when it shares the output's alignment.  The env and feature of
// element j (j < eb * W * F, 32-bit and local to the block) come from
// j / (W * F) and j / F by the multiply-high and shift that a compiler
// emits for a constant divisor, with the constants computed on the host
// (window_zscore.magic): q = (umulhi(j, lo) + (hi ? j : 0)) >> shift,
// exact for every j < 2^31.
//
// Both grids cover every SM a few CTAs deep and walk the rest.
constexpr int kObsThreads = 256;
constexpr int kObsVectors = 2;
constexpr int kRowFeatures = 5;
constexpr int kRowThreads = 128;
constexpr int kRowGroup = 4;  // rows a thread: 4 x 5 floats = 5 float4

struct ObsGeometry {
  int path;                     // 0 env blocks, 1 row groups
  int env_block;                // path 0: envs a CTA takes at a time
  int grid;
  int f_lo, f_hi, f_shift;      // path 0: j / F
  int wf_lo, wf_hi, wf_shift;   // path 0: j / (W * F); path 1: group / (W / kRowGroup)
  int mask_bits;                // path 1: bit f set for a binary-mask column
  int n_envs, window, features;
  float clip;
};
constexpr int kObsGeometryInts = sizeof(ObsGeometry) / sizeof(int);

__device__ __forceinline__ unsigned magic_div(unsigned j, unsigned lo, unsigned hi,
                                              unsigned shift) {
  return (__umulhi(j, lo) + (hi ? j : 0u)) >> shift;
}

// core/obs.scale_feature_window for one element, op for op
__device__ __forceinline__ float scale_value(float w, float mean, float std, bool neutral,
                                             bool raw, float clip) {
  float z = (w - mean) / std;
  float v = neutral ? 0.f : z;
  v = raw ? w : v;
  if (clip > 0.f) v = jmin(jmax(v, -clip), clip);
  // nan_to_num(nan=0, posinf=clip, neginf=-clip): the JAX package's
  // `clip or 0.0` is clip itself for any nonzero clip, 0 for clip == 0
  return (v != v) ? 0.f : (v == INFINITY ? clip : (v == -INFINITY ? -clip : v));
}

__global__ void __launch_bounds__(kRowThreads)
step_obs_rows_kernel(const float4* __restrict__ win, const float* __restrict__ mean,
                     const float* __restrict__ stdv, const unsigned char* __restrict__ neutral,
                     float4* __restrict__ out, long long n_groups, float clip, ObsGeometry g) {
  constexpr int F = kRowFeatures, E = kRowGroup * F, V = E / 4;
  static_assert(E % 4 == 0, "a row group fills whole float4s");
  // each warp moves its 32 groups' 32 * V float4 through shared memory:
  // lane l takes float4s l, l + 32, ... (coalesced), then reads back its
  // own group's V (an 80-byte stride, no bank conflict within a
  // quarter-warp's 16-byte accesses)
  __shared__ float4 stage[kRowThreads / 32][32 * V];
  const int lane = threadIdx.x & 31;
  float4* sw = stage[threadIdx.x >> 5];
  const long long warps = (long long)gridDim.x * (kRowThreads / 32);
  for (long long w0 = (long long)blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
       w0 * 32 < n_groups; w0 += warps) {
    const long long g0 = w0 * 32, grp = g0 + lane;
    const int span = (int)min(32LL, n_groups - g0) * V;  // float4s of this warp's groups
    const bool own = grp < n_groups;
    const long long env = magic_div((unsigned)(own ? grp : g0), g.wf_lo, g.wf_hi, g.wf_shift);
    float4 r[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (32 * i + lane < span) r[i] = __ldg(win + g0 * V + 32 * i + lane);
    float mu[F], sd[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      mu[f] = __ldg(mean + env * F + f);
      sd[f] = __ldg(stdv + env * F + f);
    }
    const bool neut = __ldg(neutral + env);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (32 * i + lane < span) sw[32 * i + lane] = r[i];
    __syncwarp();
    if (own) {
      float x[E];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float4 q = sw[lane * V + v];
        x[4 * v] = q.x;
        x[4 * v + 1] = q.y;
        x[4 * v + 2] = q.z;
        x[4 * v + 3] = q.w;
      }
#pragma unroll
      for (int k = 0; k < E; ++k)
        x[k] = scale_value(x[k], mu[k % F], sd[k % F], neut, (g.mask_bits >> (k % F)) & 1, clip);
#pragma unroll
      for (int v = 0; v < V; ++v)
        sw[lane * V + v] = make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (32 * i + lane < span) out[g0 * V + 32 * i + lane] = sw[32 * i + lane];
    __syncwarp();  // the next span overwrites sw
  }
}

__device__ __forceinline__ float scale_one(float w, unsigned j, const float2* ms,
                                           const unsigned char* code,
                                           const ObsGeometry& g, unsigned features,
                                           float clip) {
  unsigned env = magic_div(j, g.wf_lo, g.wf_hi, g.wf_shift);
  unsigned f = j - magic_div(j, g.f_lo, g.f_hi, g.f_shift) * features;
  unsigned m = env * features + f;
  float2 mv = ms[m];
  unsigned char c = code[m];
  return scale_value(w, mv.x, mv.y, c & 1, c & 2, clip);
}

__global__ void __launch_bounds__(kObsThreads)
step_obs_kernel(const float* __restrict__ win, const float* __restrict__ mean,
                const float* __restrict__ stdv, const unsigned char* __restrict__ neutral,
                const unsigned char* __restrict__ mask, float* __restrict__ out,
                long long n_envs, int window_features, int features, float clip,
                ObsGeometry g) {
  extern __shared__ float2 obs_smem[];
  const int eb = g.env_block;
  float2* ms = obs_smem;
  unsigned char* code = reinterpret_cast<unsigned char*>(obs_smem + eb * features);
  const unsigned tid = threadIdx.x;
  const long long n_blocks = (n_envs + eb - 1) / eb;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long env0 = b * eb;
    const int envs = (int)min((long long)eb, n_envs - env0);
    const unsigned count = (unsigned)(envs * window_features);
    const float* src = win + env0 * window_features;
    float* dst = out + env0 * window_features;
    unsigned head = ((16u - (unsigned)(reinterpret_cast<unsigned long long>(dst) & 15u)) & 15u) >> 2;
    head = min(head, count);
    const unsigned n_vec = (count - head) >> 2;
    const unsigned tail0 = head + 4u * n_vec;
    const bool vec_in = (reinterpret_cast<unsigned long long>(src + head) & 15u) == 0;
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
    float4* dst4 = reinterpret_cast<float4*>(dst + head);

    // the first pass's faces are in flight while the moments are staged
    float4 r[kObsVectors];
#pragma unroll
    for (int u = 0; u < kObsVectors; ++u) {
      unsigned v = tid + u * kObsThreads;
      if (v < n_vec) {
        if (vec_in) {
          r[u] = __ldg(src4 + v);
        } else {
          const float* p = src + head + 4u * v;
          r[u] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
        }
      }
    }
    __syncthreads();  // the previous block's reads of the staged moments are done
    const unsigned staged = (unsigned)(envs * features);
    for (unsigned k = tid; k < staged; k += kObsThreads) {
      unsigned e = magic_div(k, g.f_lo, g.f_hi, g.f_shift);
      unsigned f = k - e * (unsigned)features;
      ms[k] = make_float2(__ldg(mean + env0 * features + k), __ldg(stdv + env0 * features + k));
      unsigned char c = neutral[env0 + e] ? 1 : 0;
      if (mask != nullptr && mask[f]) c |= 2;
      code[k] = c;
    }
    __syncthreads();

    for (unsigned v0 = 0; v0 < n_vec; v0 += kObsThreads * kObsVectors) {
      if (v0 > 0) {
#pragma unroll
        for (int u = 0; u < kObsVectors; ++u) {
          unsigned v = v0 + tid + u * kObsThreads;
          if (v < n_vec) {
            if (vec_in) {
              r[u] = __ldg(src4 + v);
            } else {
              const float* p = src + head + 4u * v;
              r[u] = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kObsVectors; ++u) {
        unsigned v = v0 + tid + u * kObsThreads;
        if (v < n_vec) {
          unsigned j = head + 4u * v;
          float4 o;
          o.x = scale_one(r[u].x, j, ms, code, g, features, clip);
          o.y = scale_one(r[u].y, j + 1, ms, code, g, features, clip);
          o.z = scale_one(r[u].z, j + 2, ms, code, g, features, clip);
          o.w = scale_one(r[u].w, j + 3, ms, code, g, features, clip);
          dst4[v] = o;
        }
      }
    }
    // the scalar path: at most three elements before the vectors, three after
    if (tid < head) dst[tid] = scale_one(__ldg(src + tid), tid, ms, code, g, features, clip);
    if (tid < count - tail0) {
      unsigned j = tail0 + tid;
      dst[j] = scale_one(__ldg(src + j), j, ms, code, g, features, clip);
    }
  }
}

// ---------------------------------------------------------------- K2
enum FillFloat {
  kPos, kEntry, kCash, kCommPaid, kLastCost, kPnlSum, kPnlSumsq, kOpenComm,
  kPendTarget, kPendSl, kPendTp, kBracketSl, kBracketTp, kNumFillFloats
};
enum FillBool { kPendActive, kPendForced, kNumFillBools };
enum FillInt { kTradeCount, kTradesWon, kTradesLost, kNumFillInts };
enum Bar { kOpen, kHigh, kLow, kClose, kAccrual, kNumBars };
enum FillParam { kSlippage, kCommission, kPriceTick, kSizeStep, kMinQty, kNumFillParams };

constexpr int kSlipOpen = 1, kSlipLimit = 2, kSlipMatch = 4, kFinancing = 8;
constexpr int kLimitShift = 4;  // 0 cross, 1 touch, 2 conservative
constexpr int kOhlc = 64;

// Each param of K2 and K3 is one value for every row, or a column of n
// values, one per row (a portfolio's pairs: the Pallas kernels' (b, NP)
// params block); bit k of `par_rows` says which param k is.  A shared
// param is read at offset 0 by every thread (one cached value), so the
// single-pair paths move the bytes they moved before.
__device__ __forceinline__ float param_at(const float* const* par, int k, int par_rows, int e) {
  return __ldg(par[k] + (((par_rows >> k) & 1) ? e : 0));
}

// Outputs are three blocks, one per type, (fields, n) row-major: field k
// of env e at out_f[k * n + e] (ops/env_dynamics.py fill_outputs).
struct FillArgs {
  const float* in_f[kNumFillFloats];
  const unsigned char* in_b[kNumFillBools];
  const int* in_i[kNumFillInts];
  float* out_f;
  unsigned char* out_b;
  int* out_i;
  int* diag;  // (n, diag_stride), in place: column diag_idx gains the denials
  const unsigned char* advance;
  const float* bar[kNumBars];  // close and accrual are null without financing
  const float* par[kNumFillParams];
};
constexpr int kFillPointers = static_cast<int>(kNumFillFloats) + kNumFillBools + kNumFillInts + 3 + 2 +
                              kNumBars + kNumFillParams;
constexpr int kFillThreads = 64;

struct Ledger {
  float pos, entry, cash, comm_paid, last_cost, pnl_sum, pnl_sumsq, open_comm;
  int trade_count, won, lost;
};

struct FillParams {
  float slippage, commission, tick, size_step, min_qty;
};

// core/broker.py apply_fill
__device__ void apply_fill(Ledger& s, float fill_price, float target,
                           const FillParams& p) {
  float pos = s.pos;
  float delta = target - pos;
  float fill = quantize(fill_price * (1.f + p.slippage * jsign(delta)), p.tick);
  float abs_pos = fabsf(pos);
  float abs_target = fabsf(target);
  bool same_sign = pos * target > 0.f;
  float closed = same_sign ? jmax(abs_pos - abs_target, 0.f) : abs_pos;
  closed = (delta == 0.f) ? 0.f : closed;
  float realized = closed * (fill - s.entry) * jsign(pos);
  float commission = p.commission * fill * fabsf(delta);
  float comm_close = p.commission * fill * closed;
  float comm_open = commission - comm_close;
  float cash = s.cash - delta * fill - commission;
  bool adding = same_sign && (abs_target > abs_pos);
  bool flipping = !same_sign && target != 0.f && pos != 0.f;
  bool opening = pos == 0.f && target != 0.f;
  float added = (s.entry * abs_pos + fill * (abs_target - abs_pos)) /
                jmax(abs_target, 1e-30f);
  float entry = adding ? added : s.entry;
  entry = (flipping || opening) ? fill : entry;
  entry = (target == 0.f) ? 0.f : entry;
  bool closed_trade = pos != 0.f && (target == 0.f || flipping);
  float net = realized - (s.open_comm + comm_close);
  float open_comm = closed_trade ? comm_open : s.open_comm + comm_open;
  s.pos = target;
  s.entry = entry;
  s.cash = cash;
  s.comm_paid = s.comm_paid + commission;
  s.last_cost = s.last_cost + commission;
  s.trade_count += closed_trade ? 1 : 0;
  s.pnl_sum = s.pnl_sum + (closed_trade ? net : 0.f);
  s.pnl_sumsq = s.pnl_sumsq + (closed_trade ? net * net : 0.f);
  s.won += (closed_trade && net > 0.f) ? 1 : 0;
  s.lost += (closed_trade && net < 0.f) ? 1 : 0;
  s.open_comm = (target == 0.f) ? 0.f : open_comm;
}

__device__ __forceinline__ Ledger select_ledger(bool c, const Ledger& a, const Ledger& b) {
  return Ledger{c ? a.pos : b.pos, c ? a.entry : b.entry, c ? a.cash : b.cash,
                c ? a.comm_paid : b.comm_paid, c ? a.last_cost : b.last_cost,
                c ? a.pnl_sum : b.pnl_sum, c ? a.pnl_sumsq : b.pnl_sumsq,
                c ? a.open_comm : b.open_comm, c ? a.trade_count : b.trade_count,
                c ? a.won : b.won, c ? a.lost : b.lost};
}

// One thread per env, CTAs of kFillThreads so that N = 8192 spreads over
// 128 SMs.  The flags that remove the most work from the chain are
// template parameters (kMatch: both snap_in_bar calls of the brackets and
// the one of the fill; kFinance: the close, the accrual and their
// product; kGaps: the ohlc policy's gap triggers), 8 instantiations; slip_open,
// slip_limit and the limit-fill policy stay uniform run-time flags.
//
// Every load, the counter read of the in-place update included, comes
// first.  After the fill's target is known the chain splits: the
// position after the fill is the target itself, so the brackets, their
// triggers and their fill prices do not wait for the first apply_fill;
// only the second apply_fill joins the two.  Both ledgers are computed
// for every env and `advance` selects, as the plain version's
// select(advance, ...) does.
template <bool kMatch, bool kFinance, bool kGaps>
__global__ void __launch_bounds__(kFillThreads)
fill_brackets_kernel(FillArgs a, int n, int diag_stride, int diag_idx, int flags,
                     int par_rows) {
  const int e = blockIdx.x * kFillThreads + threadIdx.x;
  if (e >= n) return;
  const bool slip_open = flags & kSlipOpen;
  const bool slip_limit = flags & kSlipLimit;
  const int limit = (flags >> kLimitShift) & 3;
  const bool cross = limit == 0;
  const bool strict = limit == 2;

  // ---- every load
  const FillParams p{param_at(a.par, kSlippage, par_rows, e),
                     param_at(a.par, kCommission, par_rows, e),
                     param_at(a.par, kPriceTick, par_rows, e),
                     param_at(a.par, kSizeStep, par_rows, e),
                     param_at(a.par, kMinQty, par_rows, e)};
  const Ledger s0{__ldg(a.in_f[kPos] + e), __ldg(a.in_f[kEntry] + e),
                  __ldg(a.in_f[kCash] + e), __ldg(a.in_f[kCommPaid] + e),
                  __ldg(a.in_f[kLastCost] + e), __ldg(a.in_f[kPnlSum] + e),
                  __ldg(a.in_f[kPnlSumsq] + e), __ldg(a.in_f[kOpenComm] + e),
                  __ldg(a.in_i[kTradeCount] + e), __ldg(a.in_i[kTradesWon] + e),
                  __ldg(a.in_i[kTradesLost] + e)};
  const float pend_target = __ldg(a.in_f[kPendTarget] + e);
  const float pend_sl = __ldg(a.in_f[kPendSl] + e);
  const float pend_tp = __ldg(a.in_f[kPendTp] + e);
  const float bsl0 = __ldg(a.in_f[kBracketSl] + e);
  const float btp0 = __ldg(a.in_f[kBracketTp] + e);
  const bool pend_active = __ldg(a.in_b[kPendActive] + e);
  const bool pend_forced = __ldg(a.in_b[kPendForced] + e);
  const bool advance = __ldg(a.advance + e);
  const float o = __ldg(a.bar[kOpen] + e), h = __ldg(a.bar[kHigh] + e),
              l = __ldg(a.bar[kLow] + e);
  float close = 0.f, rate = 0.f;
  if (kFinance) {
    close = __ldg(a.bar[kClose] + e);
    rate = __ldg(a.bar[kAccrual] + e);
  }
  int* diag = a.diag + (long long)e * diag_stride + diag_idx;
  const int diag0 = *diag;

  // ---- broker.fill_pending: the order's size and target
  const float pos0 = s0.pos;
  const float delta = (pend_active ? pend_target : pos0) - pos0;
  float qty = quantize(fabsf(delta), p.size_step);
  const bool forced = pend_active && pend_forced;
  qty = forced ? fabsf(delta) : qty;
  const bool denied = pend_active && !forced && delta != 0.f &&
                      (qty < p.min_qty || (p.size_step > 0.f && qty <= 0.f));
  // apply_fill leaves the position at exactly this target
  const float target = denied ? pos0 : pos0 + jsign(delta) * qty;

  // ---- what waits only for the target: the fill price ...
  float fill_price = o;
  if (!slip_open || kMatch) {
    float direction = jsign(target - pos0);
    float fin = o * (1.f + p.slippage * (slip_open ? 1.f : 0.f) * direction);
    if (kMatch) fin = snap_in_bar(fin, l, h, p.tick);
    float denom = 1.f + p.slippage * direction;
    fill_price = fin / (denom == 0.f ? 1.f : denom);
  }
  // ... the brackets after the fill ...
  const bool entered = pend_active && target != 0.f && opening_units(pos0, target) > 0.f;
  float sl = entered ? quantize(pend_sl, p.tick) : bsl0;
  float tp = entered ? quantize(pend_tp, p.tick) : btp0;
  const bool flat = target == 0.f;
  sl = flat ? 0.f : sl;
  tp = flat ? 0.f : tp;

  // ... and broker.check_brackets on the position `target`
  const float pos = target;
  const bool has_pos = pos != 0.f;
  const bool lng = pos > 0.f;
  const bool has_sl = sl > 0.f, has_tp = tp > 0.f;
  const bool sl_trig = has_pos && has_sl && (lng ? l <= sl : h >= sl);
  const bool tp_trig = has_pos && has_tp &&
                       (lng ? (strict ? h > tp : h >= tp) : (strict ? l < tp : l <= tp));
  const float sl_fill = lng ? (o <= sl ? o : sl) : (o >= sl ? o : sl);
  const float tp_fill = cross ? (lng ? (o >= tp ? o : tp) : (o <= tp ? o : tp)) : tp;
  bool exit_sl, exit_tp;
  if (kGaps) {
    bool gap_sl = has_pos && has_sl && (lng ? o <= sl : o >= sl);
    bool gap_tp = has_pos && has_tp &&
                  (lng ? (strict ? o > tp : o >= tp) : (strict ? o < tp : o <= tp));
    exit_sl = gap_sl || (sl_trig && !gap_tp && (lng ? !tp_trig : true));
    exit_tp = (gap_tp || tp_trig) && !exit_sl;
  } else {
    exit_sl = sl_trig;
    exit_tp = tp_trig && !sl_trig;
  }
  const bool exiting = exit_sl || exit_tp;
  const float exit_dir = -jsign(pos);
  const float denom = 1.f + p.slippage * exit_dir;
  const float safe_denom = denom == 0.f ? 1.f : denom;
  float sl_adj = sl_fill;
  if (!slip_open || kMatch) {
    bool sl_gap = has_pos && has_sl && (lng ? o <= sl : o >= sl);
    float sl_scale = sl_gap ? (slip_open ? 1.f : 0.f) : 1.f;
    float sl_final = sl_fill * (1.f + p.slippage * sl_scale * exit_dir);
    if (kMatch) sl_final = snap_in_bar(sl_final, l, h, p.tick);
    sl_adj = sl_final / safe_denom;
  }
  float tp_adj;
  if (slip_limit) {
    float tp_final = tp_fill * (1.f + p.slippage * exit_dir);
    if (kMatch) tp_final = snap_in_bar(tp_final, l, h, p.tick);
    tp_final = lng ? jmax(tp_final, tp) : jmin(tp_final, tp);
    tp_adj = tp_final / safe_denom;
  } else {
    tp_adj = tp_fill / safe_denom;
  }
  const float adj_price = exit_sl ? sl_adj : tp_adj;

  // ---- the two fills, one after the other
  Ledger s = s0;
  apply_fill(s, fill_price, target, p);
  apply_fill(s, exiting ? adj_price : o, exiting ? 0.f : pos, p);

  // ---- select(advance, ...), then the financing accrual
  s = select_ledger(advance, s, s0);
  if (kFinance) {
    float accrual = s.pos * close * rate;
    s.cash = s.cash + (advance ? accrual : 0.f);
  }

  float* out_f = a.out_f + e;
  const long long stride = n;
  out_f[kPos * stride] = s.pos;
  out_f[kEntry * stride] = s.entry;
  out_f[kCash * stride] = s.cash;
  out_f[kCommPaid * stride] = s.comm_paid;
  out_f[kLastCost * stride] = s.last_cost;
  out_f[kPnlSum * stride] = s.pnl_sum;
  out_f[kPnlSumsq * stride] = s.pnl_sumsq;
  out_f[kOpenComm * stride] = s.open_comm;
  out_f[kPendTarget * stride] = advance ? 0.f : pend_target;
  out_f[kPendSl * stride] = advance ? 0.f : pend_sl;
  out_f[kPendTp * stride] = advance ? 0.f : pend_tp;
  out_f[kBracketSl * stride] = advance ? (exiting ? 0.f : sl) : bsl0;
  out_f[kBracketTp * stride] = advance ? (exiting ? 0.f : tp) : btp0;
  a.out_b[kPendActive * stride + e] = advance ? false : pend_active;
  a.out_b[kPendForced * stride + e] = advance ? false : pend_forced;
  a.out_i[kTradeCount * stride + e] = s.trade_count;
  a.out_i[kTradesWon * stride + e] = s.won;
  a.out_i[kTradesLost * stride + e] = s.lost;
  *diag = diag0 + ((advance && denied) ? 1 : 0);
}

// ---------------------------------------------------------------- K3
enum MarkIn { kMPos, kMCash, kMEq, kMPrev, kMPeak, kMDdMoney, kMDdPct, kMRewardPeak, kNumMarkIn };
enum MarkOut { kOEq, kOPrev, kOPeak, kODdMoney, kODdPct, kORewardPeak, kNumMarkOut };
enum MarkParam { kInitialCash, kRewardScale, kPenaltyLambda, kNumMarkParams };
constexpr int kRewardPnl = 0, kRewardDd = 1, kRewardSharpe = 2;

struct MarkArgs {
  const float* in[kNumMarkIn];
  const float* close;
  const unsigned char* mark;
  const unsigned char* live;
  float* out[kNumMarkOut];
  float* reward;
  const float* par[kNumMarkParams];
};
constexpr int kMarkPointers = kNumMarkIn + 3 + kNumMarkOut + 1 + kNumMarkParams;
constexpr int kMarkThreads = 64;

// The sharpe reward's ring: the (n, window) buffer, its write slot and
// live length in, the new buffer and the two counters out (new tensors:
// the input state is left as it was), the annualization factor.  Null
// pointers for the other rewards.
struct SharpeArgs {
  const float* buf;
  const int* idx;
  const int* len;
  float* out_buf;
  int* out_idx;
  int* out_len;
  const float* annualization;
};
constexpr int kSharpePointers = 7;

// One thread per env, CTAs of kMarkThreads so that N = 8192 spreads over
// 128 SMs.  Every load comes first, none behind a branch, so the kernel
// pays one memory round trip: the mark is computed for every env and
// `mark` selects it, as the plain version's select(mark_pred, ...) does;
// the reward kind is a uniform branch after the loads.
//
// The sharpe path reads and writes its env's ring row (window floats; 16-
// byte loads and stores where the window is a multiple of 4 and both
// buffers are 16-byte aligned), writing the step's return into the live
// slot on the way and summing the new row in slot order, one running sum
// for x and one for x^2: the plain version's order
// (core/rewards.ordered_sums), so the two agree bit for bit.
__device__ __forceinline__ void sharpe_slot(float& v, int slot, int write_slot, float r,
                                            float& total, float& total_sq) {
  v = slot == write_slot ? r : v;
  total = total + v;
  total_sq = total_sq + v * v;
}

__global__ void __launch_bounds__(kMarkThreads)
mark_reward_kernel(MarkArgs a, SharpeArgs s, int n, int reward_kind, int window,
                   int par_rows) {
  const int e = blockIdx.x * kMarkThreads + threadIdx.x;
  if (e >= n) return;
  // ---- every load
  const float initial_cash = param_at(a.par, kInitialCash, par_rows, e);
  const float reward_scale = param_at(a.par, kRewardScale, par_rows, e);
  const float penalty_lambda = param_at(a.par, kPenaltyLambda, par_rows, e);
  const float pos = __ldg(a.in[kMPos] + e), cash = __ldg(a.in[kMCash] + e);
  const float eq0 = __ldg(a.in[kMEq] + e), prev0 = __ldg(a.in[kMPrev] + e);
  const float peak0 = __ldg(a.in[kMPeak] + e);
  const float dd_money0 = __ldg(a.in[kMDdMoney] + e), dd_pct0 = __ldg(a.in[kMDdPct] + e);
  float reward_peak = __ldg(a.in[kMRewardPeak] + e);
  const float close = __ldg(a.close + e);
  const bool mark = __ldg(a.mark + e);
  const bool live = __ldg(a.live + e);

  // ---- broker.mark_to_market, selected by `mark`
  const float marked = cash + pos * close;
  const float peak_m = jmax(peak0, marked);
  const float money_down = peak_m - marked;
  const float peak_equity = initial_cash + peak_m;
  const float pct_down = peak_equity > 0.f ? money_down / peak_equity * 100.f : 0.f;
  const float eq = mark ? marked : eq0;
  const float prev = mark ? eq0 : prev0;
  const float peak_eq = mark ? peak_m : peak0;
  const float dd_money = mark ? jmax(dd_money0, money_down) : dd_money0;
  const float dd_pct = mark ? jmax(dd_pct0, pct_down) : dd_pct0;

  // ---- rewards.compute_reward
  const float initial = initial_cash == 0.f ? 1.f : initial_cash;
  const float r_norm = (eq - prev) / initial;
  float reward;
  if (reward_kind == kRewardPnl) {
    reward = live ? r_norm * reward_scale : 0.f;
  } else if (reward_kind == kRewardSharpe) {
    const int idx0 = __ldg(s.idx + e), len0 = __ldg(s.len + e);
    const float annualization = __ldg(s.annualization);
    const long long row = (long long)e * window;
    // the slot this step writes (none when the env is not live)
    const int write_slot = live ? idx0 : -1;
    float total = 0.f, total_sq = 0.f;
    const bool vec = (window & 3) == 0 &&
        ((reinterpret_cast<unsigned long long>(s.buf) |
          reinterpret_cast<unsigned long long>(s.out_buf)) & 15) == 0;
    if (vec) {
      const float4* in4 = reinterpret_cast<const float4*>(s.buf + row);
      float4* out4 = reinterpret_cast<float4*>(s.out_buf + row);
#pragma unroll 4
      for (int k = 0; k < window / 4; ++k) {
        float4 v = __ldg(in4 + k);
        sharpe_slot(v.x, 4 * k, write_slot, r_norm, total, total_sq);
        sharpe_slot(v.y, 4 * k + 1, write_slot, r_norm, total, total_sq);
        sharpe_slot(v.z, 4 * k + 2, write_slot, r_norm, total, total_sq);
        sharpe_slot(v.w, 4 * k + 3, write_slot, r_norm, total, total_sq);
        out4[k] = v;
      }
    } else {
      for (int k = 0; k < window; ++k) {
        float v = __ldg(s.buf + row + k);
        sharpe_slot(v, k, write_slot, r_norm, total, total_sq);
        s.out_buf[row + k] = v;
      }
    }
    const int len = live ? min(len0 + 1, window) : len0;
    s.out_idx[e] = live ? (idx0 + 1) % window : idx0;
    s.out_len[e] = len;
    const float nf = (float)max(len, 1);
    const float mean = total / nf;
    const float var = (total_sq - nf * (mean * mean)) / jmax(nf - 1.f, 1.f);
    const float stdv = sqrtf(jmax(var, 0.f));
    const float sharpe = (len >= 2 && stdv > 0.f)
        ? mean / (stdv > 0.f ? stdv : 1.f) * sqrtf(annualization) : 0.f;
    reward = live ? sharpe : 0.f;
  } else {
    const float peak = live ? jmax(reward_peak, jmax(eq, prev)) : reward_peak;
    const bool peak_positive = (initial_cash + peak) > 0.f;
    const float dd_norm = peak_positive ? (peak - eq) / initial : 0.f;
    const float r = r_norm - penalty_lambda * dd_norm;
    reward_peak = peak;
    reward = live ? r : 0.f;
  }
  a.out[kOEq][e] = eq;
  a.out[kOPrev][e] = prev;
  a.out[kOPeak][e] = peak_eq;
  a.out[kODdMoney][e] = dd_money;
  a.out[kODdPct][e] = dd_pct;
  a.out[kORewardPeak][e] = reward_peak;
  a.reward[e] = reward;
}

template <typename Args>
Args unpack(void* const* ptrs) {
  static_assert(sizeof(Args) % sizeof(void*) == 0, "pointer-only struct");
  Args args;
  void** slots = reinterpret_cast<void**>(&args);
  for (size_t k = 0; k < sizeof(Args) / sizeof(void*); ++k) slots[k] = ptrs[k];
  return args;
}

unsigned int blocks_for(long long n, int threads) {
  return (unsigned int)((n + threads - 1) / threads);
}

using FillKernel = void (*)(FillArgs, int, int, int, int, int);
// indexed by slip_match | financing << 1 | ohlc << 2
constexpr FillKernel kFillKernels[8] = {
    fill_brackets_kernel<false, false, false>, fill_brackets_kernel<true, false, false>,
    fill_brackets_kernel<false, true, false>,  fill_brackets_kernel<true, true, false>,
    fill_brackets_kernel<false, false, true>,  fill_brackets_kernel<true, false, true>,
    fill_brackets_kernel<false, true, true>,   fill_brackets_kernel<true, true, true>,
};

// nothing but the launch: the floor under a kernel's time at its grid
__global__ void launch_floor_kernel() {}

// K2's memory skeleton: its launch, every load and every store, none of
// its arithmetic (the outputs are not K2's; chip_smoke.py times it beside
// the launch floor and the kernel)
__global__ void __launch_bounds__(kFillThreads)
fill_skeleton_kernel(FillArgs a, int n, int diag_stride, int diag_idx) {
  const int e = blockIdx.x * kFillThreads + threadIdx.x;
  if (e >= n) return;
  float sum = __ldg(a.bar[kOpen] + e) + __ldg(a.bar[kHigh] + e) + __ldg(a.bar[kLow] + e);
  for (int k = 0; k < kNumFillParams; ++k) sum += __ldg(a.par[k]);
  const bool advance = __ldg(a.advance + e);
  int* diag = a.diag + (long long)e * diag_stride + diag_idx;
  const int diag0 = *diag;
  const long long stride = n;
  for (int k = 0; k < kNumFillFloats; ++k)
    a.out_f[k * stride + e] = __ldg(a.in_f[k] + e) + (k == kCash ? sum : 0.f);
  for (int k = 0; k < kNumFillBools; ++k)
    a.out_b[k * stride + e] = advance ? 0 : __ldg(a.in_b[k] + e);
  for (int k = 0; k < kNumFillInts; ++k) a.out_i[k * stride + e] = __ldg(a.in_i[k] + e);
  *diag = diag0 + (advance ? 1 : 0);
}

// K3's memory skeleton: its launch, every load and every store, none of
// its arithmetic but one sum (the outputs are not K3's; chip_smoke.py
// times it beside the launch floor and the kernel)
__global__ void __launch_bounds__(kMarkThreads)
mark_skeleton_kernel(MarkArgs a, int n) {
  const int e = blockIdx.x * kMarkThreads + threadIdx.x;
  if (e >= n) return;
  float sum = __ldg(a.in[kMPos] + e) + __ldg(a.in[kMCash] + e) + __ldg(a.close + e);
  for (int k = 0; k < kNumMarkParams; ++k) sum += __ldg(a.par[k]);
  const bool keep = __ldg(a.mark + e) && __ldg(a.live + e);
  for (int k = 0; k < kNumMarkOut; ++k) a.out[k][e] = __ldg(a.in[kMEq + k] + e);
  a.reward[e] = keep ? sum : 0.f;
}

}  // namespace

extern "C" {

int gymfx_fill_pointer_count() { return kFillPointers; }
int gymfx_mark_pointer_count() { return kMarkPointers; }
int gymfx_sharpe_pointer_count() { return kSharpePointers; }
// K1's launch constants, which ops/window_zscore.py holds against its own:
// {threads, vectors a thread, row-group features, row-group threads,
//  rows a group, ints in ObsGeometry}
void gymfx_step_obs_constants(int* out) {
  const int c[6] = {kObsThreads, kObsVectors, kRowFeatures, kRowThreads, kRowGroup,
                    kObsGeometryInts};
  for (int k = 0; k < 6; ++k) out[k] = c[k];
}
int gymfx_fill_threads() { return kFillThreads; }
int gymfx_mark_threads() { return kMarkThreads; }

// K1 CTAs of `path` that fit on one SM at `smem_bytes` of shared memory
// (0 on error)
int gymfx_step_obs_blocks_per_sm(int path, int smem_bytes) {
  int blocks = 0;
  cudaError_t rc = path == 1
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, step_obs_rows_kernel,
                                                      kRowThreads, 0)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, step_obs_kernel, kObsThreads,
                                                      (size_t)smem_bytes);
  return rc == cudaSuccess ? blocks : 0;
}

// geometry: an ObsGeometry as 14 ints, the clip's bits last
// (ops/window_zscore.py _step_obs_plan)
int gymfx_step_obs(const void* win, const void* mean, const void* stdv,
                   const void* neutral, const void* mask, void* out,
                   const int* geometry, void* stream) {
  ObsGeometry g;
  static_assert(sizeof(ObsGeometry) == kObsGeometryInts * sizeof(int), "4-byte fields only");
  memcpy(&g, geometry, sizeof(g));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.path == 1) {
    step_obs_rows_kernel<<<g.grid, kRowThreads, 0, st>>>(
        static_cast<const float4*>(win), static_cast<const float*>(mean),
        static_cast<const float*>(stdv), static_cast<const unsigned char*>(neutral),
        static_cast<float4*>(out), (long long)g.n_envs * (g.window / kRowGroup), g.clip, g);
  } else {
    const size_t smem = (size_t)g.env_block * g.features * (sizeof(float2) + 1);
    step_obs_kernel<<<g.grid, kObsThreads, smem, st>>>(
        static_cast<const float*>(win), static_cast<const float*>(mean),
        static_cast<const float*>(stdv), static_cast<const unsigned char*>(neutral),
        static_cast<const unsigned char*>(mask), static_cast<float*>(out), g.n_envs,
        g.window * g.features, g.features, g.clip, g);
  }
  return (int)cudaGetLastError();
}

// par_rows: bit k set where param k is a column of n values (param_at)
int gymfx_fill_brackets(void* const* ptrs, long long n, int diag_stride,
                        int diag_idx, int flags, int par_rows, void* stream) {
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int which = ((flags & kSlipMatch) ? 1 : 0) | ((flags & kFinancing) ? 2 : 0) |
                    ((flags & kOhlc) ? 4 : 0);
  kFillKernels[which]<<<blocks_for(n, kFillThreads), kFillThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      unpack<FillArgs>(ptrs), (int)n, diag_stride, diag_idx, flags, par_rows);
  return (int)cudaGetLastError();
}

// sharpe_ptrs: a SharpeArgs (nulls unless reward_kind is the sharpe
// reward); window: the ring's length (>= 1 for the sharpe reward);
// par_rows as K2's
int gymfx_mark_reward(void* const* ptrs, void* const* sharpe_ptrs, long long n,
                      int reward_kind, int window, int par_rows, void* stream) {
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (reward_kind == kRewardSharpe && window < 1) return (int)cudaErrorInvalidValue;
  mark_reward_kernel<<<blocks_for(n, kMarkThreads), kMarkThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      unpack<MarkArgs>(ptrs), unpack<SharpeArgs>(sharpe_ptrs), (int)n, reward_kind, window,
      par_rows);
  return (int)cudaGetLastError();
}

int gymfx_mark_skeleton(void* const* ptrs, long long n, void* stream) {
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mark_skeleton_kernel<<<blocks_for(n, kMarkThreads), kMarkThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(unpack<MarkArgs>(ptrs), (int)n);
  return (int)cudaGetLastError();
}

int gymfx_fill_skeleton(void* const* ptrs, long long n, int diag_stride, int diag_idx,
                        void* stream) {
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fill_skeleton_kernel<<<blocks_for(n, kFillThreads), kFillThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(unpack<FillArgs>(ptrs), (int)n,
                                                              diag_stride, diag_idx);
  return (int)cudaGetLastError();
}

int gymfx_launch_floor(int grid, int threads, int smem_bytes, void* stream) {
  launch_floor_kernel<<<grid, threads, (size_t)smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
