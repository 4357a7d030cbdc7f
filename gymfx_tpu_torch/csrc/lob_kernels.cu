// Hand-written Hopper (sm_90a) kernel for the LOB venue's stream matching.
//
//   K5 lob_stream  replaces gymfx_tpu/ops/lob_match.py::fused_process_stream
//                  (pallas body _stream_kernel): a message stream matched
//                  through one fixed-capacity book per program, price-time
//                  priority, exact int32 — matching, resting, cancels and
//                  queue compaction, plus one nine-field fill record per
//                  message.
//
// What it computes is gymfx_tpu/lob/book.py::process_stream (the port's
// plain version: gymfx_tpu_torch/lob/book.py::process_stream).  Each
// message takes exactly the branch that book.py's lax.switch / lax.cond
// takes (NOOP; ADD: match the opposite half, rest the remainder on its
// own; CANCEL: cancel on its own half; MARKET: match the opposite half).
// The results are the argsort engine's on every book whose live levels
// have distinct prices, which every book built by these operations has
// (resting joins the level at its price).  Two eligible levels at one
// price would each count only strictly better levels as prior, where the
// argsort engine interleaves them by slot.
//
// What bounds it: the book is sequential over messages, so a book's
// stream is one chain of dependent steps.  The bytes are small (a
// D = 24, Q = 4 book is 432 int32 = 1.7 KB each way, a 16-message stream
// 320 B in and 576 B of fill records out: ~35 MB for 8,192 books, 10.6 us
// at 3.35 TB/s) and so is the arithmetic (a few int32 operations per
// slot of the touched half per message).  What costs time is latency:
// the chain of warp-synchronous steps per message.
//
// What the design does about it: one warp per book, both halves in
// shared memory for the whole stream (read once, written once), lane l
// owning levels l and l + 32 (so D <= 64) with their Q <= 8 slots.  The
// TPU kernel's dense select-all-branches form is not carried over: a
// warp takes only the branch its message needs (uniform across the
// warp, no divergence).  Matching is sort-free, as in the TPU kernel:
// a slot's fill is clip(take - prior, 0, avail), prior = the eligible
// lots of strictly better level keys (a loop over the level keys in
// shared memory) plus the FIFO prefix within its level; live levels
// never share a price, so this is the sorted cumsum walk.  First-matching
// and first-free levels come from warp ballots; compaction is an
// in-lane pass over the level's slots (live slots first, then the
// rest, each in order: the stable argsort of qty == 0).  Stats reduce
// with warp shuffles; messages arrive 32 at a time, one per lane, and
// are broadcast with shuffles.  Sums are taken mod 2^32 as int32 sums
// wrap in XLA and torch.
//
// The extern "C" entry point launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int kPriceCap = 1 << 20;
constexpr int kAgentOid = 1 << 29;
constexpr int kMaxDepth = 64;
constexpr int kMaxSlots = 8;
constexpr int kWarpsPerBlock = 4;
constexpr int kFillCols = 9;
constexpr unsigned kFull = 0xffffffffu;

// msg kinds (gymfx_tpu/lob/book.py)
constexpr int kAdd = 1;
constexpr int kCancel = 2;
constexpr int kMarket = 3;

struct LobArgs {
  const int* in[6];   // bid price, bid qty, bid oid, ask price, ask qty, ask oid
  const int* msg[5];  // kind, side, price, qty, oid: (B, M)
  int* out[6];        // the final books, same layout as in
  int* fills;         // (B, M, 9)
};
constexpr int kLobPointers = 18;

struct Half {
  int* price;  // (D,)
  int* qty;    // (D, Q)
  int* oid;    // (D, Q)
};

struct Stats {
  unsigned filled, value, events, agent_qty, agent_value;
  int pmin, pmax;
};

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Write a level's slots back front-compacted: slots with qty != 0 first,
// then the rest, each group in slot order (book.py's stable argsort of
// qty == 0, which carries each slot's oid along).  Returns the level's
// new quantity sum (mod 2^32).
__device__ __forceinline__ unsigned store_compacted(int* qty, int* oid,
                                                    const int* tq, const int* to,
                                                    int Q) {
  int w = 0;
  unsigned sum = 0;
  for (int s = 0; s < Q; ++s) {
    if (tq[s] != 0) {
      qty[w] = tq[s];
      oid[w] = to[s];
      sum += (unsigned)tq[s];
      ++w;
    }
  }
  for (int s = 0; s < Q; ++s) {
    if (tq[s] == 0) {
      qty[w] = 0;
      oid[w] = to[s];
      ++w;
    }
  }
  return sum;
}

// book.py::_match_half: take `take` lots against one half; the taker buys
// (against_asks: eligible prices <= limit, best = lowest) or sells
// (eligible prices >= limit, best = highest).  key/lav: D ints of scratch.
__device__ Stats match_half(Half h, int D, int Q, int take, int limit,
                            bool against_asks, int* key, int* lav, int lane) {
  for (int d = lane; d < D; d += 32) {
    int p = h.price[d];
    bool elig = p > 0 && (against_asks ? p <= limit : p >= limit);
    unsigned sum = 0;
    if (elig)
      for (int s = 0; s < Q; ++s) sum += (unsigned)h.qty[d * Q + s];
    key[d] = elig ? (against_asks ? p : kPriceCap - p) : kPriceCap;
    lav[d] = (int)sum;
  }
  __syncwarp();
  Stats st = {0u, 0u, 0u, 0u, 0u, kPriceCap, 0};
  for (int d = lane; d < D; d += 32) {
    const int p = h.price[d];
    const bool elig = p > 0 && (against_asks ? p <= limit : p >= limit);
    const int k = key[d];
    unsigned prior = 0;
    for (int i = 0; i < D; ++i)
      if (key[i] < k) prior += (unsigned)lav[i];
    int tq[kMaxSlots], to[kMaxSlots];
    unsigned level_fill = 0;
    for (int s = 0; s < Q; ++s) {
      const int q = h.qty[d * Q + s];
      const int o = h.oid[d * Q + s];
      const int avail = elig ? q : 0;
      int f = (int)((unsigned)take - prior);
      f = min(max(f, 0), avail);
      prior += (unsigned)avail;
      st.filled += (unsigned)f;
      st.value += (unsigned)f * (unsigned)p;
      st.events += f > 0 ? 1u : 0u;
      if (o == kAgentOid && f > 0) {
        st.agent_qty += (unsigned)f;
        st.agent_value += (unsigned)f * (unsigned)p;
      }
      level_fill += (unsigned)f;
      const int nq = q - f;
      tq[s] = nq;
      to[s] = nq > 0 ? o : 0;
    }
    if ((int)level_fill > 0) {
      st.pmin = min(st.pmin, p);
      st.pmax = max(st.pmax, p);
    }
    const unsigned sum = store_compacted(h.qty + d * Q, h.oid + d * Q, tq, to, Q);
    h.price[d] = (int)sum > 0 ? p : 0;
  }
  st.filled = warp_sum(st.filled);
  st.value = warp_sum(st.value);
  st.events = warp_sum(st.events);
  st.agent_qty = warp_sum(st.agent_qty);
  st.agent_value = warp_sum(st.agent_value);
  st.pmin = warp_min(st.pmin);
  st.pmax = warp_max(st.pmax);
  __syncwarp();
  return st;
}

// book.py::_rest_half: rest q lots of owner o at price p in the level that
// already holds p, else the first free level, at its first free slot;
// dropped (0) when there is none.
__device__ int rest_half(Half h, int D, int Q, int p, int q, int o, int lane) {
  int found = -1, free_level = -1;
  for (int base = 0; base < D; base += 32) {
    const int d = base + lane;
    bool has = false, empty = false;
    if (d < D) {
      has = h.price[d] == p && h.price[d] > 0;
      unsigned sum = 0;
      for (int s = 0; s < Q; ++s) sum += (unsigned)h.qty[d * Q + s];
      empty = sum == 0u;
    }
    const unsigned m_has = __ballot_sync(kFull, has);
    const unsigned m_free = __ballot_sync(kFull, empty);
    if (found < 0 && m_has) found = base + __ffs(m_has) - 1;
    if (free_level < 0 && m_free) free_level = base + __ffs(m_free) - 1;
  }
  const int li = found >= 0 ? found : (free_level >= 0 ? free_level : 0);
  int si = -1;
  for (int s = 0; s < Q && si < 0; ++s)
    if (h.qty[li * Q + s] == 0) si = s;
  const bool can = q > 0 && (found >= 0 || free_level >= 0) && si >= 0;
  __syncwarp();
  if (can && lane == 0) {
    h.qty[li * Q + si] = q;
    h.oid[li * Q + si] = o;
    h.price[li] = p;
  }
  __syncwarp();
  return can ? q : 0;
}

// book.py::_cancel_half: remove every live slot owned by target (0 hits
// nothing), compact every level, zero the price of emptied levels.
__device__ int cancel_half(Half h, int D, int Q, int target, int lane) {
  unsigned removed = 0;
  for (int d = lane; d < D; d += 32) {
    int tq[kMaxSlots], to[kMaxSlots];
    for (int s = 0; s < Q; ++s) {
      int q = h.qty[d * Q + s];
      int o = h.oid[d * Q + s];
      if (o == target && q > 0 && target != 0) {
        removed += (unsigned)q;
        q = 0;
        o = 0;
      }
      tq[s] = q;
      to[s] = o;
    }
    const unsigned sum = store_compacted(h.qty + d * Q, h.oid + d * Q, tq, to, Q);
    if ((int)sum <= 0) h.price[d] = 0;
  }
  removed = warp_sum(removed);
  __syncwarp();
  return (int)removed;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lob_stream_kernel(LobArgs a, long long n_books, int D, int Q, int M) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= n_books) return;  // whole warps only: b is uniform in a warp

  // per book: both prices, both (qty, oid) slabs, the match's level keys
  // and eligible level sums
  const int per_book = 2 * D + 4 * D * Q + 2 * D;
  int* base = smem + warp * per_book;
  Half bids = {base, base + 2 * D, base + 2 * D + D * Q};
  Half asks = {base + D, base + 2 * D + 2 * D * Q, base + 2 * D + 3 * D * Q};
  int* key = base + 2 * D + 4 * D * Q;
  int* lav = key + D;

  const long long lvl0 = b * D, slot0 = b * D * Q;
  for (int i = lane; i < D; i += 32) {
    bids.price[i] = a.in[0][lvl0 + i];
    asks.price[i] = a.in[3][lvl0 + i];
  }
  for (int i = lane; i < D * Q; i += 32) {
    bids.qty[i] = a.in[1][slot0 + i];
    bids.oid[i] = a.in[2][slot0 + i];
    asks.qty[i] = a.in[4][slot0 + i];
    asks.oid[i] = a.in[5][slot0 + i];
  }
  __syncwarp();

  const long long m0 = b * M;
  int* fills = a.fills + m0 * kFillCols;
  for (int chunk = 0; chunk < M; chunk += 32) {
    const int mine = chunk + lane;
    int mk = 0, ms = 0, mp = 0, mq = 0, mo = 0;
    if (mine < M) {
      mk = a.msg[0][m0 + mine];
      ms = a.msg[1][m0 + mine];
      mp = a.msg[2][m0 + mine];
      mq = a.msg[3][m0 + mine];
      mo = a.msg[4][m0 + mine];
    }
    const int count = min(32, M - chunk);
    for (int j = 0; j < count; ++j) {
      const int kind = min(max(__shfl_sync(kFull, mk, j), 0), 3);
      const bool is_buy = __shfl_sync(kFull, ms, j) > 0;
      const int price = __shfl_sync(kFull, mp, j);
      const int qty = __shfl_sync(kFull, mq, j);
      const int oid = __shfl_sync(kFull, mo, j);
      Stats st = {0u, 0u, 0u, 0u, 0u, kPriceCap, 0};
      int rested = 0, cancelled = 0;
      if (kind == kAdd || kind == kMarket) {
        const bool add = kind == kAdd;
        if (is_buy) {
          st = match_half(asks, D, Q, qty, add ? price : kPriceCap, true, key, lav, lane);
          if (add) rested = rest_half(bids, D, Q, price, qty - (int)st.filled, oid, lane);
        } else {
          st = match_half(bids, D, Q, qty, add ? price : 0, false, key, lav, lane);
          if (add) rested = rest_half(asks, D, Q, price, qty - (int)st.filled, oid, lane);
        }
      } else if (kind == kCancel) {
        cancelled = cancel_half(is_buy ? bids : asks, D, Q, oid, lane);
      }
      const int rec[kFillCols] = {
          (int)st.filled, (int)st.value, (int)st.events, (int)st.agent_qty,
          (int)st.agent_value, st.pmin, st.pmax, rested, cancelled};
      if (lane < kFillCols) fills[(long long)(chunk + j) * kFillCols + lane] = rec[lane];
    }
  }

  __syncwarp();
  for (int i = lane; i < D; i += 32) {
    a.out[0][lvl0 + i] = bids.price[i];
    a.out[3][lvl0 + i] = asks.price[i];
  }
  for (int i = lane; i < D * Q; i += 32) {
    a.out[1][slot0 + i] = bids.qty[i];
    a.out[2][slot0 + i] = bids.oid[i];
    a.out[4][slot0 + i] = asks.qty[i];
    a.out[5][slot0 + i] = asks.oid[i];
  }
}

}  // namespace

extern "C" {

int gymfx_lob_pointer_count() { return kLobPointers; }

// ptrs: the six input book tensors, the five (B, M) message tensors, the
// six output book tensors and the (B, M, 9) fill records, all int32 and
// contiguous.  Requires 1 <= depth <= 64, 1 <= slots <= 8.
int gymfx_lob_stream(void* const* ptrs, long long n_books, int depth, int slots,
                     int n_msgs, void* stream) {
  if (depth < 1 || depth > kMaxDepth || slots < 1 || slots > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  LobArgs a;
  for (int i = 0; i < 6; ++i) a.in[i] = static_cast<const int*>(ptrs[i]);
  for (int i = 0; i < 5; ++i) a.msg[i] = static_cast<const int*>(ptrs[6 + i]);
  for (int i = 0; i < 6; ++i) a.out[i] = static_cast<int*>(ptrs[11 + i]);
  a.fills = static_cast<int*>(ptrs[17]);
  const int per_book = 2 * depth + 4 * depth * slots + 2 * depth;
  const size_t smem = sizeof(int) * (size_t)per_book * kWarpsPerBlock;
  const long long blocks = (n_books + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lob_stream_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(a, n_books, depth, slots,
                                                           n_msgs);
  return (int)cudaGetLastError();
}

}  // extern "C"
