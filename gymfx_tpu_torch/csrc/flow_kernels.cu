// Hand-written Hopper (sm_90a) kernel for the LOB venue's order flow.
//
//   K9 bar_flow    has no Pallas counterpart: it is the port's counterpart
//                  of the jax.random draws inside the reference's jitted
//                  step (gymfx_tpu/lob/flow.py::bar_messages, keyed by
//                  bar_key, called at gymfx_tpu/lob/venue.py:263-267),
//                  which XLA compiles into one program.  One bar's flow
//                  messages (kind, side, price, qty, oid) for every env.
//
// What it computes is the port's plain version,
// gymfx_tpu_torch/lob/flow.py::bar_messages(bar_key(seed, t), o, h, l, c,
// M, fp), bit for bit: each env's stream key fold_in(PRNGKey(seed), t)
// (the threefry-2x32 block of the count (0, t) under the key (0, seed)),
// its six-way split, randint's two halves of the jitter, qty and band
// keys, then per message i the nine 32-bit draws y1 ^ y2 of the block of
// the count (0, i) under each of the nine stream keys (lob/prng.py), and
// the float32 path of reference_path and the selects of bar_messages.
// Every float operation is the plain version's, unfused (this library is
// built with -fmad=false, and the intrinsics below round each operation
// on its own): the threshold compares, the path's IEEE division, its
// segments a + (b - a) * clamp(...), rintf (half to even) and the cancel
// target's floorf(u * max(i, 1)).  randint's modulus and multiplier come
// from the host, and its uint32 products and sums wrap as the plain
// version's masks make them.  The three kind thresholds are the float64
// sums of the scenario's probabilities rounded once to float32 on the
// host, as flow.py's _f32 computes them.
//
// What bounds it: operations.  An env needs 13 threefry blocks for its
// keys, and a message 6 (its kind, side, price jitter and qty; 3 in a
// crash window, which forces the side and qty), 2 more for an ADD's band
// and 1 more for a cancel's target, each ~66 int32 operations in their
// fewest instructions (20 rounds of add, rotate and xor, the key
// injections): at the venue's 8,192 envs x 64 lob_volatile messages
// ~271M operations, ~16 us at the card's 16.7 TOP/s int32 rate, against
// 10.5 MB written (3.1 us at 3.35 TB/s).  The plain version runs all nine
// draws of every message as ~700 int64 elementwise kernels over (N, 9, M)
// tensors, because PyTorch has no uint32 arithmetic on CUDA.
//
// What the design does about it: the words stay uint32 in registers, and
// each rotation is one funnel shift.  One warp an env: lane l draws
// messages l, l + 32, ... (2 a lane at M = 64), so the grid holds N warps
// and every block of a message runs in its own lane.  The keys are a
// three-deep chain, derived once a warp and shared by shuffles: every
// lane computes the fold_in, lane j < 6 the split key j, lane j < 6 then
// randint's half j % 2 of split key 2 + j / 2 (lanes above 5 repeat lane
// 5's work, which costs nothing: the warp issues it once), and the nine
// stream keys are broadcast from those lanes.  Each lane so derives 3
// blocks and draws 9 a message: the band's two, which only an ADD needs,
// and the target's one, which only a cancel needs, cost the warp an
// issue as soon as one of its 32 messages needs them, which at every
// scenario's mix is nearly always.  Packing those draws across the lanes
// (ballots, prefix counts, shared memory) ran 23.10 against 23.67 us at
// the venue's shape (chip_smoke.py, H100 80GB HBM3, 700 W, one pair in
// one call): 2%, too little for the code it adds, so it is not kept.  The
// five streams are written row by row, each lane a consecutive int32:
// coalesced.
//
// The extern "C" entry point launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kEnvsPerBlock = 4;  // one warp an env
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kParity = 0x1BD11BDAu;
constexpr unsigned kOneBits = 0x3F800000u;  // the bits of float32 1.0
constexpr int kPriceCap = 1 << 20;
constexpr int kQtyCap = 1 << 10;
// msg kinds (gymfx_tpu/lob/book.py)
constexpr int kNoop = 0;
constexpr int kAdd = 1;
constexpr int kCancel = 2;
constexpr int kMarket = 3;

struct FlowArgs {
  const unsigned* t;  // the (N,) bar rows' low 32-bit words, every t_stride-th word
  const int* ohlc[4];  // (N,) open, high, low, close ticks
  int* out[5];         // (N, M) kind, side, price, qty, oid
};
constexpr int kFlowPointers = 10;

// The scenario's constants, as ops/lob_flow.py::flow_constants orders
// them (18 32-bit words).
struct FlowConsts {
  unsigned seed;     // PRNGKey(flow_seed)'s second word
  float thr[3];      // NOOP below thr[0], ADD below thr[1], CANCEL below thr[2]
  unsigned span[3];  // randint's span of the price jitter, the qty jitter, the band
  unsigned mult[3];  // randint's multiplier (2^16 mod span)^2 mod span of each
  int lo[3];         // randint's minval of each
  int base_qty, market_qty, crash_at, crash_len, crash_qty;
};
constexpr int kFlowConsts = 18;
static_assert(sizeof(FlowConsts) == kFlowConsts * 4, "FlowConsts is 18 words");

__device__ __forceinline__ unsigned rotl(unsigned x, int r) { return __funnelshift_l(x, x, r); }

// The Threefry-2x32 block function (20 rounds) of the count (0, x1) under
// the key (k0, k1): lob/prng.py::threefry2x32.
__device__ __forceinline__ uint2 threefry(unsigned k0, unsigned k1, unsigned x1) {
  const unsigned k2 = k0 ^ k1 ^ kParity;
  unsigned a = k0, b = x1 + k1;
#define GYMFX_ROUND(r) a += b; b = rotl(b, r) ^ a;
#define GYMFX_ROUNDS_0 GYMFX_ROUND(13) GYMFX_ROUND(15) GYMFX_ROUND(26) GYMFX_ROUND(6)
#define GYMFX_ROUNDS_1 GYMFX_ROUND(17) GYMFX_ROUND(29) GYMFX_ROUND(16) GYMFX_ROUND(24)
  GYMFX_ROUNDS_0 a += k1; b += k2 + 1u;
  GYMFX_ROUNDS_1 a += k2; b += k0 + 2u;
  GYMFX_ROUNDS_0 a += k0; b += k1 + 3u;
  GYMFX_ROUNDS_1 a += k1; b += k2 + 4u;
  GYMFX_ROUNDS_0 a += k2; b += k0 + 5u;
#undef GYMFX_ROUNDS_1
#undef GYMFX_ROUNDS_0
#undef GYMFX_ROUND
  return make_uint2(a, b);
}

// random_bits' word of count i under key k: the block's y1 ^ y2.
__device__ __forceinline__ unsigned draw(uint2 k, unsigned i) {
  const uint2 y = threefry(k.x, k.y, i);
  return y.x ^ y.y;
}

// prng.py::bits_to_uniform: the top 23 bits as the mantissa of a float in
// [1, 2), minus 1.
__device__ __forceinline__ float uniform(unsigned bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | kOneBits), 1.0f);
}

// prng.py::bits_to_randint of draw j (0: price jitter, 1: qty jitter, 2:
// band): the two words folded by the span, uint32 arithmetic.
__device__ __forceinline__ int randint(unsigned higher, unsigned lower, const FlowConsts& k,
                                       int j) {
  const unsigned span = k.span[j];
  const unsigned offset = (higher % span) * k.mult[j] + lower % span;
  return (int)((unsigned)k.lo[j] + offset % span);
}

__device__ __forceinline__ uint2 shfl(uint2 v, int src) {
  return make_uint2(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src));
}

__device__ __forceinline__ int clamp_tick(int x) { return min(max(x, 1), kPriceCap - 1); }

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

__global__ void __launch_bounds__(kEnvsPerBlock * 32)
bar_flow_kernel(FlowArgs a, FlowConsts k, long long n_envs, int n_msgs, int t_stride) {
  const int lane = threadIdx.x & 31;
  const long long env = (long long)blockIdx.x * kEnvsPerBlock + (threadIdx.x >> 5);
  if (env >= n_envs) return;  // whole warps only: env is uniform in a warp

  // the keys: fold_in(PRNGKey(seed), t); lane j < 6 split key j; lane j <
  // 6 half j % 2 of split key 2 + j / 2 (randint's split of the jitter,
  // qty and band keys)
  const uint2 key = threefry(0u, k.seed, a.t[env * t_stride]);
  const int j = min(lane, 5);
  const uint2 split = threefry(key.x, key.y, (unsigned)j);
  const uint2 parent = shfl(split, 2 + j / 2);
  const uint2 half = threefry(parent.x, parent.y, (unsigned)(j & 1));
  const uint2 k_kind = shfl(split, 0), k_side = shfl(split, 1), k_cxl = shfl(split, 5);
  const uint2 k_jit_hi = shfl(half, 0), k_jit_lo = shfl(half, 1);
  const uint2 k_qty_hi = shfl(half, 2), k_qty_lo = shfl(half, 3);
  const uint2 k_band_hi = shfl(half, 4), k_band_lo = shfl(half, 5);

  // reference_path: O -> L -> H -> C on a bull bar (c >= o), else O -> H
  // -> L -> C, at t = linspace(0, 3, M) in float32
  const int o = a.ohlc[0][env], h = a.ohlc[1][env], l = a.ohlc[2][env], c = a.ohlc[3][env];
  const bool bull = c >= o;
  const float of = (float)o, cf = (float)c;
  const float w0 = (float)(bull ? l : h), w1 = (float)(bull ? h : l);
  const float d0 = __fsub_rn(w0, of), d1 = __fsub_rn(w1, w0), d2 = __fsub_rn(cf, w1);
  const int div = n_msgs - 1;
  const long long crash_end = (long long)k.crash_at + k.crash_len;
  const long long row = env * n_msgs;

  for (int i = lane; i < n_msgs; i += 32) {
    const unsigned u = (unsigned)i;
    float t = 0.0f;
    if (div > 0) {
      const float step = __fdiv_rn((float)i, (float)div);
      t = i < div ? __fadd_rn(__fmul_rn(0.0f, __fsub_rn(1.0f, step)), __fmul_rn(3.0f, step))
                  : 3.0f;
    }
    const float seg0 = __fadd_rn(of, __fmul_rn(d0, clamp01(t)));
    const float seg1 = __fadd_rn(w0, __fmul_rn(d1, clamp01(__fsub_rn(t, 1.0f))));
    const float seg2 = __fadd_rn(w1, __fmul_rn(d2, clamp01(__fsub_rn(t, 2.0f))));
    const int path = clamp_tick((int)rintf(t <= 1.0f ? seg0 : (t <= 2.0f ? seg1 : seg2)));

    const int jitter = randint(draw(k_jit_hi, u), draw(k_jit_lo, u), k, 0);
    const int mid = clamp_tick(min(max(path + jitter, l), h));
    const float u_kind = uniform(draw(k_kind, u));
    int kind = u_kind < k.thr[0] ? kNoop
             : u_kind < k.thr[1] ? kAdd
             : u_kind < k.thr[2] ? kCancel : kMarket;
    int side = uniform(draw(k_side, u)) < 0.5f ? 1 : -1;
    const int band = 1 + randint(draw(k_band_hi, u), draw(k_band_lo, u), k, 2);
    const int add_price = clamp_tick(mid - side * band);
    // one draw for both sizes
    const int qty_jitter = randint(draw(k_qty_hi, u), draw(k_qty_lo, u), k, 1);
    int qty = (kind == kMarket ? k.market_qty : k.base_qty) + qty_jitter;
    int oid = 1 + i;
    if (kind == kCancel) {
      const float u_cxl = uniform(draw(k_cxl, u));
      oid = min(1 + (int)floorf(__fmul_rn(u_cxl, (float)max(i, 1))), i);
    }
    // flash-crash burst: a contiguous window of forced market sells
    if (k.crash_at >= 0 && i >= k.crash_at && (long long)i < crash_end) {
      kind = kMarket;
      side = -1;
      qty = k.crash_qty;
    }
    qty = min(max(qty, 1), kQtyCap);
    const long long at = row + i;
    a.out[0][at] = kind;
    a.out[1][at] = side;
    a.out[2][at] = kind == kAdd ? add_price : mid;
    a.out[3][at] = qty;
    a.out[4][at] = oid;
  }
}

}  // namespace

extern "C" {

int gymfx_flow_pointer_count() { return kFlowPointers; }

int gymfx_flow_const_count() { return kFlowConsts; }

// ptrs: the (N,) bar rows (int32, t_stride 1, or int64, t_stride 2: the
// low word of each), the four (N,) int32 OHLC ticks and the five (N, M)
// int32 outputs, all contiguous.  consts: the 18 words of FlowConsts, in
// host memory (copied into the launch's parameters).
int gymfx_bar_flow(void* const* ptrs, const int* consts, long long n_envs, int n_msgs,
                   int t_stride, void* stream) {
  if (n_envs <= 0 || n_msgs <= 0) return (int)cudaSuccess;
  FlowArgs a;
  a.t = static_cast<const unsigned*>(ptrs[0]);
  for (int i = 0; i < 4; ++i) a.ohlc[i] = static_cast<const int*>(ptrs[1 + i]);
  for (int i = 0; i < 5; ++i) a.out[i] = static_cast<int*>(ptrs[5 + i]);
  FlowConsts k;
  memcpy(&k, consts, sizeof(k));
  const unsigned blocks = (unsigned)((n_envs + kEnvsPerBlock - 1) / kEnvsPerBlock);
  bar_flow_kernel<<<blocks, kEnvsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      a, k, n_envs, n_msgs, t_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
