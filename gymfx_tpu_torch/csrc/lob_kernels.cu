// Hand-written Hopper (sm_90a) kernel for the LOB venue's stream matching.
//
//   K5 lob_stream  replaces gymfx_tpu/ops/lob_match.py::fused_process_stream
//                  (pallas body _stream_kernel): a message stream matched
//                  through one fixed-capacity book per program, price-time
//                  priority, exact int32 — matching, resting, cancels and
//                  queue compaction, plus one nine-field fill record per
//                  message.
//
// What it computes is the port's plain version,
// gymfx_tpu_torch/lob/book.py::process_stream, and the Pallas kernel's
// dense dispatch, message by message: both halves matched (the side the
// message takes from with its take, the other with a take of 0), every
// level whose int32 lot sum is <= 0 loses its price, a CANCEL cancels on
// its own half, an ADD rests what it did not fill on its own half.  Sums wrap mod 2^32 as int32 sums
// do in XLA and torch; the kind is clipped to 0-3.  Where no sum wraps,
// this is gymfx_tpu/lob/book.py::process_stream, which matches only the
// half a message takes from.
//
// Invariants it relies on, which every book built from empty_book by
// these operations holds (gymfx_tpu_torch/ops/lob_match.py states them
// too):
//   - the levels that hold a nonzero price hold distinct prices, so the
//     best eligible level is unique and the best-first walk below is the
//     argsort engine's cumsum walk;
//   - queues are front-compacted and slot quantities are >= 0, so a level
//     the walk or a cancel did not touch is already compacted, and a
//     rest's slot is the count of the level's live slots;
//   - every empty slot holds oid 0;
//   - a level whose lots are 0 holds price 0 (book.py zeroes it at every
//     match; here only the levels a message empties are zeroed, see
//     process).
//
// What bounds it: a book's stream is one chain of dependent steps, and
// the bytes are few (a D = 24, Q = 4 book is 432 int32 each way, a
// 16-message stream 320 B in and 576 B of fill records out: ~35 MB for
// 8,192 books, 10.6 us at 3.35 TB/s).  What costs time is the latency of
// each message's chain of dependent instructions and warp reductions,
// and with many books the instructions each message issues.
//
// What the design does about it: one warp per book, the whole book in
// registers for the whole stream.  Lane l holds levels l and l + 32 (L
// levels a lane, L = 1 or 2, so D <= 64), each as its price, its Q <= 8
// slot quantities and oids, and its lot sum mod 2^32, kept up to date as
// lots leave and arrive.  Each half also keeps, the same in every lane,
// its exact lot total and `best`, a key no worse than its best level's.
// L and Q are template parameters, so no register array is indexed at
// run time.  A message takes one of two inlined copies of process (buy:
// asks are the opposite half; sell: bids), so no half is chosen at run
// time either.  Per message:
//   - match (match_half, walk_exact): while the half's total fits in
//     int32, a take <= 0 fills nothing and a best level that is not
//     eligible ends the match, both without a warp step (the non-crossing
//     add).  Otherwise the walk goes best level first, one round of two
//     reductions (redux.sync) a level: its lots and the next key.  The
//     level's owner fills it FIFO and drops its consumed slots with a
//     barrel shift; the walk stops once the lots ahead reach the take.
//     filled, value and the traded prices come out of the walk the same
//     in every lane; the fill events and the agent's lots from three
//     reductions after it.
//   - rest (rest_lookup, rest_place): two min reductions over (level,
//     queue full) codes find the level holding the price and the first
//     free level (lot sum 0).  An ADD's own half is not touched by its
//     match, so the lookup runs before the match, beside it; the owner
//     then writes the slot with selects.
//   - cancel (cancel_half): every lane scans its own slots for the oid;
//     only the levels hit are compacted; two reductions (the lots
//     removed, the best key left).
// While a half's exact total exceeds int32 (lots near 2^31), sums of lots
// may wrap: match_wrapped then visits every eligible level, fills each
// slot by the argsort engine's wrapped clip, and zeroes the price of
// every level whose int32 sum is <= 0, and the total is counted again
// after each change.  No flow the venue makes comes near.  Messages
// arrive 32 at a time (coalesced loads, one 16-byte shared memory read a
// message); fill records are staged in shared memory and written as one
// contiguous block of 32 x 9 ints.
//
// match_half, rest_lookup / rest_place and cancel_half act on a book in
// registers only and assume nothing about where it came from: a kernel
// that runs more than a stream (the agent's fills, stops and cancels
// around the flow) calls them as they are.
//
// The extern "C" entry point launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kPriceCap = 1 << 20;
constexpr int kAgentOid = 1 << 29;
constexpr int kMaxDepth = 64;
constexpr int kMaxSlots = 8;
constexpr int kWarpsPerBlock = 4;
constexpr int kFillCols = 9;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // above every level key and code
constexpr long long kI32Max = INT_MAX;
constexpr long long kI32Min = INT_MIN;

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

// One price level, held by one lane.
template <int Q>
struct Level {
  int price;
  unsigned sum;  // the queue's lots mod 2^32 (book.py's int32 sum)
  int qty[Q];
  int oid[Q];
};

// One half of a warp's book: lane l holds levels l, l + 32, ...; total
// (the half's exact lots) and best (a key no worse than the best live
// level's, see key_of) are the same in every lane.
template <int L, int Q>
struct Half {
  Level<Q> lv[L];
  long long total;
  unsigned best;
};

// A match's fill record fields, the same in every lane.
struct Stats {
  unsigned filled, value, events, agent_qty, agent_value;
  int pmin, pmax;
};

__device__ __forceinline__ Stats no_fill() { return {0u, 0u, 0u, 0u, 0u, kPriceCap, 0}; }

// A level's priority key on its half: lower is better (asks: the lowest
// price; bids: the highest); kNone for a level without a price.
template <bool kAsks>
__device__ __forceinline__ unsigned key_of(int p) {
  return p > 0 ? (kAsks ? (unsigned)p : (unsigned)(INT_MAX - p)) : kNone;
}

// Whether a taker with this limit may trade with the level of this key.
template <bool kAsks>
__device__ __forceinline__ bool eligible(unsigned key, int limit) {
  if (key == kNone) return false;
  const int p = kAsks ? (int)key : INT_MAX - (int)key;
  return kAsks ? p <= limit : p >= limit;
}

template <bool kAsks, int L, int Q>
__device__ __forceinline__ unsigned best_key(const Half<L, Q>& h) {
  unsigned mine = kNone;
#pragma unroll
  for (int j = 0; j < L; ++j) mine = min(mine, key_of<kAsks>(h.lv[j].price));
  return __reduce_min_sync(kFull, mine);
}

// book.py::_compact on one level: live slots (qty != 0) first, in order,
// then empty ones (qty 0, oid 0): each slot moves to its rank among the
// live slots.
template <int Q>
__device__ __forceinline__ void compact(Level<Q>& v) {
  int q[Q], o[Q];
#pragma unroll
  for (int d = 0; d < Q; ++d) q[d] = o[d] = 0;
  int rank = 0;
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const bool live = v.qty[s] != 0;
#pragma unroll
    for (int d = 0; d <= s; ++d)
      if (live && rank == d) {
        q[d] = v.qty[s];
        o[d] = v.oid[s];
      }
    rank += live ? 1 : 0;
  }
#pragma unroll
  for (int d = 0; d < Q; ++d) {
    v.qty[d] = q[d];
    v.oid[d] = o[d];
  }
}

// The half's exact lots (slot quantities are >= 0): 16-bit halves summed
// apart, so neither warp sum can wrap.
template <int L, int Q>
__device__ __forceinline__ long long count_total(const Half<L, Q>& h) {
  unsigned lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < L; ++j)
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      const unsigned x = (unsigned)h.lv[j].qty[s];
      lo += x & 0xffffu;
      hi += x >> 16;
    }
  lo = __reduce_add_sync(kFull, lo);
  hi = __reduce_add_sync(kFull, hi);
  return ((long long)hi << 16) + lo;
}

// After a match or cancel took `removed` lots (mod 2^32) from the half.
template <int L, int Q>
__device__ __forceinline__ void lots_left(Half<L, Q>& h, unsigned removed) {
  h.total = h.total <= kI32Max ? h.total - (long long)removed : count_total(h);
}

// Drop a level's first k slots (the ones a FIFO fill consumed) and shift
// the rest to the front: a barrel shifter, log2(Q) + 1 stages of selects.
template <int Q>
__device__ __forceinline__ void shift_out(Level<Q>& v, int k) {
#pragma unroll
  for (int b = 1; b <= Q; b <<= 1) {
    const bool on = (k & b) != 0;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      v.qty[s] = on ? (s + b < Q ? v.qty[s + b] : 0) : v.qty[s];
      v.oid[s] = on ? (s + b < Q ? v.oid[s + b] : 0) : v.oid[s];
    }
  }
}

// The match while no sum of lots can wrap (the half's total within
// int32) and the best level is eligible, take > 0: the best-first walk.
// Each step is one round of two reductions (the lots of the level the
// walk is at, and the next key); meanwhile the level's owner fills it
// FIFO, drops its consumed slots and, if it emptied, zeroes its price.
// `best` may name a level that has lost its price since (a cancel or a
// reset makes the truth only worse): that step finds no owner and moves
// on.  The walk stops once the lots ahead reach the take.
template <bool kAsks, int L, int Q>
__device__ __forceinline__ Stats walk_exact(Half<L, Q>& h, int take, int limit) {
  Stats st = no_fill();
  unsigned key[L];
#pragma unroll
  for (int j = 0; j < L; ++j) key[j] = key_of<kAsks>(h.lv[j].price);
  unsigned best = h.best, ahead = 0u, last = kNone;
  unsigned events = 0u, agent_qty = 0u, agent_value = 0u;  // this lane's
  do {
    const unsigned room = (unsigned)take - ahead;  // > 0: what the take still wants
    bool own[L];
    unsigned lots = 0u, mine = kNone;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      own[j] = key[j] == best;
      lots = own[j] ? h.lv[j].sum : lots;
      key[j] = own[j] ? kNone : key[j];
      mine = min(mine, key[j]);
    }
    lots = __reduce_add_sync(kFull, lots);
    const unsigned next = __reduce_min_sync(kFull, mine);
    const int p = kAsks ? (int)best : INT_MAX - (int)best;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (!own[j]) continue;
      Level<Q>& v = h.lv[j];
      unsigned want = room;
      int consumed = 0;
#pragma unroll
      for (int s = 0; s < Q; ++s) {
        const unsigned a = (unsigned)v.qty[s];
        const unsigned f = min(want, a);
        want -= f;
        events += f > 0u ? 1u : 0u;
        const bool agent = v.oid[s] == kAgentOid;
        agent_qty += agent ? f : 0u;
        agent_value += agent ? f * (unsigned)p : 0u;
        consumed += (a != 0u && f == a) ? 1 : 0;
        v.qty[s] = (int)(a - f);
      }
      v.sum -= room - want;
      if (v.sum == 0u) v.price = 0;  // book.py's reset of an emptied level
      shift_out(v, consumed);
    }
    const unsigned f = min(lots, room);
    st.value += f * (unsigned)p;
    if (f > 0u) {
      st.pmin = min(st.pmin, p);
      st.pmax = max(st.pmax, p);
    }
    ahead += lots;
    last = best;
    best = next;
  } while ((int)ahead < take && eligible<kAsks>(best, limit));
  st.events = __reduce_add_sync(kFull, events);
  st.agent_qty = __reduce_add_sync(kFull, agent_qty);
  st.agent_value = __reduce_add_sync(kFull, agent_value);
  st.filled = min((unsigned)take, ahead);
  // the level the take ended in, else the next one, is the best left
  h.best = (int)ahead > take ? last : best;
  h.total -= st.filled;
  return st;
}

// book.py::_reset_empty_levels: a level whose int32 lot sum is <= 0
// loses its price.
template <int L, int Q>
__device__ __forceinline__ void reset_empty(Half<L, Q>& h) {
#pragma unroll
  for (int j = 0; j < L; ++j)
    if ((int)h.lv[j].sum <= 0) h.lv[j].price = 0;
}

// The match where sums of lots may wrap (the half's total beyond int32,
// or take - total below INT_MIN): every eligible level is visited best
// first, each slot fills book.py's wrapped clip(take - lots ahead, 0,
// its lots), the visited levels are compacted, and the stats come from
// reductions.  No flow the venue makes comes here.
template <bool kAsks, int L, int Q>
__device__ __forceinline__ Stats match_wrapped(Half<L, Q>& h, int take, int limit) {
  Stats st = no_fill();
  unsigned key[L], before[L];
  bool visited[L];
  unsigned mine = kNone;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    key[j] = key_of<kAsks>(h.lv[j].price);
    before[j] = 0u;
    visited[j] = false;
    mine = min(mine, key[j]);
  }
  unsigned best = __reduce_min_sync(kFull, mine), ahead = 0u;
  while (eligible<kAsks>(best, limit)) {
    unsigned lots = 0u;
    mine = kNone;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (key[j] == best) {
        visited[j] = true;
        before[j] = ahead;
        key[j] = kNone;
        lots = h.lv[j].sum;
      }
      mine = min(mine, key[j]);
    }
    ahead += __reduce_add_sync(kFull, lots);
    best = __reduce_min_sync(kFull, mine);
  }
  unsigned filled = 0u, value = 0u, events = 0u, agent_qty = 0u, agent_value = 0u;
  int pmin = kPriceCap, pmax = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (!visited[j]) continue;
    Level<Q>& v = h.lv[j];
    unsigned pos = before[j], level_fill = 0u;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      const int a = v.qty[s];
      const int f = min(max((int)((unsigned)take - pos), 0), a);
      pos += (unsigned)a;
      level_fill += (unsigned)f;
      value += (unsigned)f * (unsigned)v.price;
      events += f > 0 ? 1u : 0u;
      if (v.oid[s] == kAgentOid && f > 0) {
        agent_qty += (unsigned)f;
        agent_value += (unsigned)f * (unsigned)v.price;
      }
      v.qty[s] = a - f;
      if (v.qty[s] <= 0) v.oid[s] = 0;
    }
    if ((int)level_fill > 0) {
      pmin = min(pmin, v.price);
      pmax = max(pmax, v.price);
    }
    filled += level_fill;
    compact(v);
    v.sum -= level_fill;
  }
  st.events = __reduce_add_sync(kFull, events);
  st.agent_qty = __reduce_add_sync(kFull, agent_qty);
  st.agent_value = __reduce_add_sync(kFull, agent_value);
  st.filled = __reduce_add_sync(kFull, filled);
  st.value = __reduce_add_sync(kFull, value);
  st.pmin = __reduce_min_sync(kFull, pmin);
  st.pmax = __reduce_max_sync(kFull, pmax);
  lots_left(h, st.filled);
  reset_empty(h);
  return st;
}

// book.py::_match_half: take `take` lots from one half; the taker buys
// (kAsks: eligible prices <= limit, best = lowest) or sells (eligible
// prices >= limit, best = highest).
template <bool kAsks, int L, int Q>
__device__ __forceinline__ Stats match_half(Half<L, Q>& h, int take, int limit) {
  // Within int32 no sum of lots ahead wraps: a take <= 0 fills nothing,
  // nothing fills when the best level is not eligible, and the walk may
  // stop at the take.
  if (h.total <= kI32Max && (long long)take - h.total >= kI32Min) {
    if (take <= 0 || !eligible<kAsks>(h.best, limit)) return no_fill();
    return walk_exact<kAsks>(h, take, limit);
  }
  return match_wrapped<kAsks>(h, take, limit);
}

// book.py::_cancel_half: remove every live slot owned by target (0 hits
// nothing); only the levels hit are compacted.
template <bool kAsks, int L, int Q>
__device__ __forceinline__ int cancel_half(Half<L, Q>& h, int target) {
  if (target == 0) return 0;
  unsigned removed = 0u, mine = kNone;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    Level<Q>& v = h.lv[j];
    unsigned level = 0u;
    bool hit_any = false;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      const bool hit = v.oid[s] == target && v.qty[s] > 0;
      level += hit ? (unsigned)v.qty[s] : 0u;
      v.qty[s] = hit ? 0 : v.qty[s];
      v.oid[s] = hit ? 0 : v.oid[s];
      hit_any |= hit;
    }
    if (hit_any) {
      compact(v);
      v.sum -= level;
      if ((int)v.sum <= 0) v.price = 0;
    }
    removed += level;
    mine = min(mine, key_of<kAsks>(v.price));
  }
  removed = __reduce_add_sync(kFull, removed);
  h.best = __reduce_min_sync(kFull, mine);
  lots_left(h, removed);
  return (int)removed;
}

// book.py::_rest_half, first half: the level a rest at price p goes to
// (the level holding p, else the first level whose lot sum is 0), as
// 2 x level + (its queue is full: its last slot live), or kNone.  A
// level whose int32 lot sum is <= 0 counts as holding no price, as after
// reset_empty.
template <int L, int Q>
__device__ __forceinline__ unsigned rest_lookup(const Half<L, Q>& h, int p, int lane, int depth) {
  unsigned has = kNone, free_level = kNone;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int d = lane + 32 * j;
    const Level<Q>& v = h.lv[j];
    const unsigned code = 2u * (unsigned)d + (v.qty[Q - 1] != 0 ? 1u : 0u);
    if (v.price == p && p > 0 && (int)v.sum > 0) has = min(has, code);
    if (v.sum == 0u && d < depth) free_level = min(free_level, code);
  }
  has = __reduce_min_sync(kFull, has);
  free_level = __reduce_min_sync(kFull, free_level);
  return has != kNone ? has : free_level;
}

// book.py::_rest_half, second half: rest q > 0 lots of owner o at price p
// in the level rest_lookup picked, at the slot after its live ones (the
// count of them); dropped (0) when there is no level or its queue is full.
template <bool kAsks, int L, int Q>
__device__ __forceinline__ int rest_place(Half<L, Q>& h, unsigned pick, int p, int q, int o,
                                          int lane) {
  if (pick == kNone || (pick & 1u)) return 0;
  const int level = (int)(pick >> 1);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    Level<Q>& v = h.lv[j];
    const bool here = level == lane + 32 * j;
    int n = 0;
#pragma unroll
    for (int s = 0; s < Q; ++s) n += v.qty[s] != 0 ? 1 : 0;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      const bool put = here && s == n;
      v.qty[s] = put ? q : v.qty[s];
      v.oid[s] = put ? o : v.oid[s];
    }
    v.price = here ? p : v.price;
    v.sum += here ? (unsigned)q : 0u;
  }
  h.total += q;
  h.best = min(h.best, key_of<kAsks>(p));
  return q;
}

// book.py::process_message on a warp's book for a buy (kBuy: own = bids,
// opp = asks) or a sell (own = asks, opp = bids): match opp with the take
// (own with a take of 0, which fills nothing unless own's total exceeds
// int32), zero the prices of levels left without lots, cancel on own,
// rest on own, and write the message's fill record to row.  book.py
// zeroes the price of every level whose int32 lot sum is <= 0 at every
// match; here only a wrapped match does (reset_empty), since within int32
// a level's sum is 0 exactly when it is empty, the walk and the cancel
// zero the price of a level they empty, and a half beyond int32 always
// matches wrapped.
template <bool kBuy, int L, int Q>
__device__ __forceinline__ void process(Half<L, Q>& own, Half<L, Q>& opp, int kind, int price,
                                        int qty, int oid, int lane, int depth, int* row) {
  constexpr bool kOwnAsks = !kBuy;
  const bool is_add = kind == kAdd;
  const int take = (is_add || kind == kMarket) ? qty : 0;
  const bool own_narrow = own.total <= kI32Max;
  // An ADD's rest goes to its own half, which the match leaves alone:
  // look its level up now, beside the match's reductions.
  const bool early = is_add && own_narrow;
  unsigned pick = early ? rest_lookup(own, price, lane, depth) : kNone;
  const Stats so = match_half<kBuy>(opp, take, is_add ? price : (kBuy ? kPriceCap : 0));
  const Stats sw =
      own_narrow ? no_fill() : match_half<kOwnAsks>(own, 0, is_add ? price : (kBuy ? 0 : kPriceCap));
  const int cancelled = kind == kCancel ? cancel_half<kOwnAsks>(own, oid) : 0;
  const int rest = (int)((is_add ? (unsigned)qty : 0u) - so.filled);
  int rested = 0;
  if (rest > 0) {
    if (!early) pick = rest_lookup(own, price, lane, depth);
    rested = rest_place<kOwnAsks>(own, pick, price, rest, oid, lane);
  }
  // every lane stores the same values (one store, no branch)
  row[0] = (int)(so.filled + sw.filled);
  row[1] = (int)(so.value + sw.value);
  row[2] = (int)(so.events + sw.events);
  row[3] = (int)(so.agent_qty + sw.agent_qty);
  row[4] = (int)(so.agent_value + sw.agent_value);
  row[5] = min(so.pmin, sw.pmin);
  row[6] = max(so.pmax, sw.pmax);
  row[7] = rested;
  row[8] = cancelled;
}

template <bool kAsks, int L, int Q>
__device__ __forceinline__ void load_half(Half<L, Q>& h, const int* price, const int* qty,
                                          const int* oid, long long lvl0, int lane, int depth) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int d = lane + 32 * j;
    Level<Q>& v = h.lv[j];
    const bool here = d < depth;
    v.price = here ? price[lvl0 + d] : 0;
    v.sum = 0u;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      v.qty[s] = here ? qty[(lvl0 + d) * Q + s] : 0;
      v.oid[s] = here ? oid[(lvl0 + d) * Q + s] : 0;
      v.sum += (unsigned)v.qty[s];
    }
  }
  h.total = count_total(h);
  h.best = best_key<kAsks>(h);
}

template <int L, int Q>
__device__ __forceinline__ void store_half(const Half<L, Q>& h, int* price, int* qty, int* oid,
                                           long long lvl0, int lane, int depth) {
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int d = lane + 32 * j;
    if (d >= depth) continue;
    const Level<Q>& v = h.lv[j];
    price[lvl0 + d] = v.price;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      qty[(lvl0 + d) * Q + s] = v.qty[s];
      oid[(lvl0 + d) * Q + s] = v.oid[s];
    }
  }
}

template <int L, int Q>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
lob_stream_kernel(LobArgs a, long long n_books, int depth, int n_msgs) {
  __shared__ int4 s_msg[kWarpsPerBlock][32];
  __shared__ int s_rec[kWarpsPerBlock][32 * kFillCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= n_books) return;  // whole warps only: b is uniform in a warp

  const long long lvl0 = b * depth;
  Half<L, Q> bids, asks;
  load_half<false>(bids, a.in[0], a.in[1], a.in[2], lvl0, lane, depth);
  load_half<true>(asks, a.in[3], a.in[4], a.in[5], lvl0, lane, depth);

  const long long m0 = b * n_msgs;
  int* rec = s_rec[warp];
  for (int chunk = 0; chunk < n_msgs; chunk += 32) {
    const int count = min(32, n_msgs - chunk);
    if (lane < count) {  // (kind clipped to 0-3) x 2 + buy, price, qty, oid
      const long long i = m0 + chunk + lane;
      const int kind = min(max(a.msg[0][i], 0), 3);
      s_msg[warp][lane] = make_int4(2 * kind + (a.msg[1][i] > 0 ? 1 : 0), a.msg[2][i],
                                    a.msg[3][i], a.msg[4][i]);
    }
    __syncwarp();
    for (int j = 0; j < count; ++j) {
      const int4 m = s_msg[warp][j];
      int* row = rec + j * kFillCols;
      if (m.x & 1)
        process<true>(bids, asks, m.x >> 1, m.y, m.z, m.w, lane, depth, row);
      else
        process<false>(asks, bids, m.x >> 1, m.y, m.z, m.w, lane, depth, row);
    }
    __syncwarp();
    int* out = a.fills + (m0 + chunk) * kFillCols;
    for (int i = lane; i < count * kFillCols; i += 32) out[i] = rec[i];
    __syncwarp();
  }

  store_half(bids, a.out[0], a.out[1], a.out[2], lvl0, lane, depth);
  store_half(asks, a.out[3], a.out[4], a.out[5], lvl0, lane, depth);
}

template <int L, int Q>
int launch(const LobArgs& a, long long n_books, int depth, int n_msgs, cudaStream_t stream) {
  const long long blocks = (n_books + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lob_stream_kernel<L, Q><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(a, n_books, depth,
                                                                               n_msgs);
  return (int)cudaGetLastError();
}

// every (levels a lane, slots) pair the wrapper takes
template <int L>
int launch_slots(int slots, const LobArgs& a, long long n_books, int depth, int n_msgs,
                 cudaStream_t stream) {
  switch (slots) {
    case 1: return launch<L, 1>(a, n_books, depth, n_msgs, stream);
    case 2: return launch<L, 2>(a, n_books, depth, n_msgs, stream);
    case 3: return launch<L, 3>(a, n_books, depth, n_msgs, stream);
    case 4: return launch<L, 4>(a, n_books, depth, n_msgs, stream);
    case 5: return launch<L, 5>(a, n_books, depth, n_msgs, stream);
    case 6: return launch<L, 6>(a, n_books, depth, n_msgs, stream);
    case 7: return launch<L, 7>(a, n_books, depth, n_msgs, stream);
    case 8: return launch<L, 8>(a, n_books, depth, n_msgs, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int gymfx_lob_pointer_count() { return kLobPointers; }

// ptrs: the six input book tensors, the five (B, M) message tensors, the
// six output book tensors and the (B, M, 9) fill records, all int32 and
// contiguous.  Requires 1 <= depth <= 64, 1 <= slots <= 8.
int gymfx_lob_stream(void* const* ptrs, long long n_books, int depth, int slots, int n_msgs,
                     void* stream) {
  if (depth < 1 || depth > kMaxDepth || slots < 1 || slots > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  LobArgs a;
  for (int i = 0; i < 6; ++i) a.in[i] = static_cast<const int*>(ptrs[i]);
  for (int i = 0; i < 5; ++i) a.msg[i] = static_cast<const int*>(ptrs[6 + i]);
  for (int i = 0; i < 6; ++i) a.out[i] = static_cast<int*>(ptrs[11 + i]);
  a.fills = static_cast<int*>(ptrs[17]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return depth <= 32 ? launch_slots<1>(slots, a, n_books, depth, n_msgs, s)
                     : launch_slots<2>(slots, a, n_books, depth, n_msgs, s);
}

}  // extern "C"
