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
//                     drawdown carries and the pnl / dd reward at the close.
//
// What bounds them: bytes.  Each is an elementwise pass that does a few
// dozen flops per element, far below the H100's ~20 flops per byte of
// f32 ridge, so the least time is the bytes moved over 3.35 TB/s.  K1
// reads the (N, W, F) window plus the (N, F) moments and writes the
// window once; K2 / K3 read and write each per-env ledger field once.
// At the flagship shapes (N = 8192, W = 32, F = 5) that is ~10.8 MB for
// K1 (3.2 us at 3.35 TB/s), ~1.25 MB for K2 (153 bytes per env: 66 in,
// 66 out, the advance flag, the bar's O/H/L and one counter read and
// written in place; the close and the accrual only with financing) and
// ~0.5 MB for K3 (66 bytes per env), so K2 and K3 are well under a
// microsecond of bandwidth and pay mostly their launch.
//
// What the design does about it: one pass, every input read once and
// every output written once, no intermediate in device memory.  K1 is
// one thread per (env, row, feature) element with coalesced reads of the
// window; K2 and K3 are one thread per env over structure-of-arrays
// field pointers (the EnvState tensors themselves; the Pallas kernels'
// packing into (env_block, n_fields) faces existed for VMEM tiling and
// would only add stack/unbind copies here).  The static config choices
// arrive as an integer of flags: uniform branches, no divergence.
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
__global__ void step_obs_kernel(const float* __restrict__ win,
                                const float* __restrict__ mean,
                                const float* __restrict__ stdv,
                                const unsigned char* __restrict__ neutral,
                                const unsigned char* __restrict__ mask,
                                float* __restrict__ out, long long total,
                                int window_features, int features,
                                float clip) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long env = i / window_features;
  int f = (int)(i % features);
  long long m = env * features + f;
  float w = win[i];
  float z = (w - mean[m]) / stdv[m];
  float v = neutral[env] ? 0.f : z;
  if (mask != nullptr && mask[f]) v = w;
  if (clip > 0.f) v = jmin(jmax(v, -clip), clip);
  // nan_to_num(nan=0, posinf=clip, neginf=-clip): the JAX package's
  // `clip or 0.0` is clip itself for any nonzero clip, 0 for clip == 0
  v = (v != v) ? 0.f : (v == INFINITY ? clip : (v == -INFINITY ? -clip : v));
  out[i] = v;
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

struct FillArgs {
  const float* in_f[kNumFillFloats];
  float* out_f[kNumFillFloats];
  const unsigned char* in_b[kNumFillBools];
  unsigned char* out_b[kNumFillBools];
  const int* in_i[kNumFillInts];
  int* out_i[kNumFillInts];
  int* diag;  // (n, diag_stride), in place: column diag_idx gains the denials
  const unsigned char* advance;
  const float* bar[kNumBars];  // accrual is null without financing
  const float* par[kNumFillParams];
};
constexpr int kFillPointers = 2 * kNumFillFloats + 2 * kNumFillBools +
                              2 * kNumFillInts + 2 + kNumBars + kNumFillParams;

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

__global__ void fill_brackets_kernel(FillArgs a, long long n, int diag_stride,
                                     int diag_idx, int flags) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const bool slip_open = flags & kSlipOpen;
  const bool slip_limit = flags & kSlipLimit;
  const bool slip_match = flags & kSlipMatch;
  const int limit = (flags >> kLimitShift) & 3;
  const bool cross = limit == 0;
  const bool strict = limit == 2;
  const bool ohlc = flags & kOhlc;
  FillParams p{*a.par[kSlippage], *a.par[kCommission], *a.par[kPriceTick],
               *a.par[kSizeStep], *a.par[kMinQty]};

  Ledger s{a.in_f[kPos][e], a.in_f[kEntry][e], a.in_f[kCash][e],
           a.in_f[kCommPaid][e], a.in_f[kLastCost][e], a.in_f[kPnlSum][e],
           a.in_f[kPnlSumsq][e], a.in_f[kOpenComm][e],
           a.in_i[kTradeCount][e], a.in_i[kTradesWon][e], a.in_i[kTradesLost][e]};
  float pend_target = a.in_f[kPendTarget][e];
  float pend_sl = a.in_f[kPendSl][e];
  float pend_tp = a.in_f[kPendTp][e];
  float bsl = a.in_f[kBracketSl][e];
  float btp = a.in_f[kBracketTp][e];
  bool pend_active = a.in_b[kPendActive][e];
  bool pend_forced = a.in_b[kPendForced][e];
  const bool advance = a.advance[e];
  const float o = a.bar[kOpen][e], h = a.bar[kHigh][e], l = a.bar[kLow][e];
  int denied_count = 0;

  if (advance) {
    // ---- broker.fill_pending
    float pos = s.pos;
    float delta = (pend_active ? pend_target : pos) - pos;
    float qty = quantize(fabsf(delta), p.size_step);
    bool forced = pend_active && pend_forced;
    qty = forced ? fabsf(delta) : qty;
    bool denied = pend_active && !forced && delta != 0.f &&
                  (qty < p.min_qty || (p.size_step > 0.f && qty <= 0.f));
    float target = denied ? pos : pos + jsign(delta) * qty;
    denied_count = denied ? 1 : 0;
    float fill_price = o;
    if (!slip_open || slip_match) {
      float direction = jsign(target - pos);
      float fin = o * (1.f + p.slippage * (slip_open ? 1.f : 0.f) * direction);
      if (slip_match) fin = snap_in_bar(fin, l, h, p.tick);
      float denom = 1.f + p.slippage * direction;
      fill_price = fin / (denom == 0.f ? 1.f : denom);
    }
    apply_fill(s, fill_price, target, p);
    bool entered = pend_active && s.pos != 0.f && opening_units(pos, target) > 0.f;
    bsl = entered ? quantize(pend_sl, p.tick) : bsl;
    btp = entered ? quantize(pend_tp, p.tick) : btp;
    bool flat = s.pos == 0.f;
    bsl = flat ? 0.f : bsl;
    btp = flat ? 0.f : btp;
    pend_active = false;
    pend_forced = false;
    pend_target = 0.f;
    pend_sl = 0.f;
    pend_tp = 0.f;

    // ---- broker.check_brackets
    pos = s.pos;
    bool has_pos = pos != 0.f;
    bool lng = pos > 0.f;
    float sl = bsl, tp = btp;
    bool has_sl = sl > 0.f, has_tp = tp > 0.f;
    bool sl_trig = has_pos && has_sl && (lng ? l <= sl : h >= sl);
    bool tp_trig = has_pos && has_tp &&
                   (lng ? (strict ? h > tp : h >= tp) : (strict ? l < tp : l <= tp));
    float sl_fill = lng ? (o <= sl ? o : sl) : (o >= sl ? o : sl);
    float tp_fill = cross ? (lng ? (o >= tp ? o : tp) : (o <= tp ? o : tp)) : tp;
    bool exit_sl, exit_tp;
    if (ohlc) {
      bool gap_sl = has_pos && has_sl && (lng ? o <= sl : o >= sl);
      bool gap_tp = has_pos && has_tp &&
                    (lng ? (strict ? o > tp : o >= tp) : (strict ? o < tp : o <= tp));
      exit_sl = gap_sl || (sl_trig && !gap_tp && (lng ? !tp_trig : true));
      exit_tp = (gap_tp || tp_trig) && !exit_sl;
    } else {
      exit_sl = sl_trig;
      exit_tp = tp_trig && !sl_trig;
    }
    bool exiting = exit_sl || exit_tp;
    float exit_dir = -jsign(pos);
    float denom = 1.f + p.slippage * exit_dir;
    float safe_denom = denom == 0.f ? 1.f : denom;
    float sl_adj = sl_fill;
    if (!(slip_open && !slip_match)) {
      bool sl_gap = has_pos && has_sl && (lng ? o <= sl : o >= sl);
      float sl_scale = sl_gap ? (slip_open ? 1.f : 0.f) : 1.f;
      float sl_final = sl_fill * (1.f + p.slippage * sl_scale * exit_dir);
      if (slip_match) sl_final = snap_in_bar(sl_final, l, h, p.tick);
      sl_adj = sl_final / safe_denom;
    }
    float tp_adj;
    if (slip_limit) {
      float tp_final = tp_fill * (1.f + p.slippage * exit_dir);
      if (slip_match) tp_final = snap_in_bar(tp_final, l, h, p.tick);
      tp_final = lng ? jmax(tp_final, tp) : jmin(tp_final, tp);
      tp_adj = tp_final / safe_denom;
    } else {
      tp_adj = tp_fill / safe_denom;
    }
    float adj_price = exit_sl ? sl_adj : tp_adj;
    apply_fill(s, exiting ? adj_price : o, exiting ? 0.f : pos, p);
    bsl = exiting ? 0.f : sl;
    btp = exiting ? 0.f : tp;
  }
  if (flags & kFinancing) {
    float accrual = s.pos * a.bar[kClose][e] * a.bar[kAccrual][e];
    s.cash = s.cash + (advance ? accrual : 0.f);
  }

  a.out_f[kPos][e] = s.pos;
  a.out_f[kEntry][e] = s.entry;
  a.out_f[kCash][e] = s.cash;
  a.out_f[kCommPaid][e] = s.comm_paid;
  a.out_f[kLastCost][e] = s.last_cost;
  a.out_f[kPnlSum][e] = s.pnl_sum;
  a.out_f[kPnlSumsq][e] = s.pnl_sumsq;
  a.out_f[kOpenComm][e] = s.open_comm;
  a.out_f[kPendTarget][e] = pend_target;
  a.out_f[kPendSl][e] = pend_sl;
  a.out_f[kPendTp][e] = pend_tp;
  a.out_f[kBracketSl][e] = bsl;
  a.out_f[kBracketTp][e] = btp;
  a.out_b[kPendActive][e] = pend_active;
  a.out_b[kPendForced][e] = pend_forced;
  a.out_i[kTradeCount][e] = s.trade_count;
  a.out_i[kTradesWon][e] = s.won;
  a.out_i[kTradesLost][e] = s.lost;
  a.diag[e * diag_stride + diag_idx] += denied_count;
}

// ---------------------------------------------------------------- K3
enum MarkIn { kMPos, kMCash, kMEq, kMPrev, kMPeak, kMDdMoney, kMDdPct, kMRewardPeak, kNumMarkIn };
enum MarkOut { kOEq, kOPrev, kOPeak, kODdMoney, kODdPct, kORewardPeak, kNumMarkOut };
enum MarkParam { kInitialCash, kRewardScale, kPenaltyLambda, kNumMarkParams };
constexpr int kRewardPnl = 0, kRewardDd = 1;

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

__global__ void mark_reward_kernel(MarkArgs a, long long n, int reward_kind) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float initial_cash = *a.par[kInitialCash];
  float eq = a.in[kMEq][e], prev = a.in[kMPrev][e], peak_eq = a.in[kMPeak][e];
  float dd_money = a.in[kMDdMoney][e], dd_pct = a.in[kMDdPct][e];
  float reward_peak = a.in[kMRewardPeak][e];
  const bool live = a.live[e];
  if (a.mark[e]) {
    // ---- broker.mark_to_market
    float marked = a.in[kMCash][e] + a.in[kMPos][e] * a.close[e];
    float peak = jmax(peak_eq, marked);
    float money_down = peak - marked;
    float peak_equity = initial_cash + peak;
    float pct_down = peak_equity > 0.f ? money_down / peak_equity * 100.f : 0.f;
    prev = eq;
    eq = marked;
    peak_eq = peak;
    dd_money = jmax(dd_money, money_down);
    dd_pct = jmax(dd_pct, pct_down);
  }
  // ---- rewards.compute_reward
  float initial = initial_cash == 0.f ? 1.f : initial_cash;
  float r_norm = (eq - prev) / initial;
  float reward;
  if (reward_kind == kRewardPnl) {
    reward = live ? r_norm * *a.par[kRewardScale] : 0.f;
  } else {
    float peak = live ? jmax(reward_peak, jmax(eq, prev)) : reward_peak;
    bool peak_positive = (initial_cash + peak) > 0.f;
    float dd_norm = peak_positive ? (peak - eq) / initial : 0.f;
    float r = r_norm - *a.par[kPenaltyLambda] * dd_norm;
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

}  // namespace

extern "C" {

int gymfx_fill_pointer_count() { return kFillPointers; }
int gymfx_mark_pointer_count() { return kMarkPointers; }

int gymfx_step_obs(const void* win, const void* mean, const void* stdv,
                   const void* neutral, const void* mask, void* out,
                   long long n_envs, int window, int features, float clip,
                   void* stream) {
  const int threads = 256;
  long long total = n_envs * window * features;
  step_obs_kernel<<<blocks_for(total, threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win), static_cast<const float*>(mean),
      static_cast<const float*>(stdv),
      static_cast<const unsigned char*>(neutral),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out), total,
      window * features, features, clip);
  return (int)cudaGetLastError();
}

int gymfx_fill_brackets(void* const* ptrs, long long n, int diag_stride,
                        int diag_idx, int flags, void* stream) {
  const int threads = 128;
  fill_brackets_kernel<<<blocks_for(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      unpack<FillArgs>(ptrs), n, diag_stride, diag_idx, flags);
  return (int)cudaGetLastError();
}

int gymfx_mark_reward(void* const* ptrs, long long n, int reward_kind,
                      void* stream) {
  const int threads = 128;
  mark_reward_kernel<<<blocks_for(n, threads), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      unpack<MarkArgs>(ptrs), n, reward_kind);
  return (int)cudaGetLastError();
}

}  // extern "C"
