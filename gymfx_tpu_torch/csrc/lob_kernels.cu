// Hand-written Hopper (sm_90a) kernels for the LOB venue's book.
//
//   K5 lob_stream  replaces gymfx_tpu/ops/lob_match.py::fused_process_stream
//                  (pallas body _stream_kernel): a message stream matched
//                  through one fixed-capacity book per program, price-time
//                  priority, exact int32 — matching, resting, cancels and
//                  queue compaction, plus one nine-field fill record per
//                  message.
//   K8 lob_bar     has no Pallas counterpart: it is the port's counterpart
//                  of the lax.scan over a bar's flow inside the reference's
//                  jitted step (gymfx_tpu/lob/venue.py:236-267).  One bar
//                  of the LOB venue on the books K5 seeded: the agent's
//                  open walk, gap stop and resting take-profit, then the
//                  bar's flow message by message with the agent's maker
//                  fills, the stop's trigger, the take-profit's cancel and
//                  the stop's walk (lob/venue.py, ops/lob_bar.py; described
//                  above lob_bar_kernel below).
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
// match_half, rest_lookup / rest_place, cancel_half and process act on a
// book in registers only and assume nothing about where it came from; K8
// calls them as they are.
//
// K8 lob_bar.  What it computes is the plain version
// gymfx_tpu_torch/ops/lob_bar.py::run_bar_plain, venue.py's book work of
// one bar, step for step: the open walk (book.py::match_market, its
// remainder priced at the open tick), the gap stop's walk, the
// take-profit's add_limit of AGENT_OID at max(tp, 1) (process of an ADD,
// which is add_limit: a cancel of oid 0 changes nothing after a match),
// then per flow message process, the trigger has_sl & !fired & rem > 0 &
// printed, book.py::cancel of AGENT_OID on the exit's half (cancel_half,
// never a CANCEL message: book.py::cancel matches nothing) and the walk of
// rem backstopped at the stop.  Where the stop does not fire, the cancel
// names oid 0 and the walk takes 0 lots, as in the plain version; both
// return without a warp step on a half within int32.  Its inputs are ints
// computed before any book work (ops/lob_bar.py BarOrders); its outputs
// the eight ints the ledger fills need (BarFills) and the final books.
// Sums, values and the remaining lots wrap mod 2^32 as torch's int32
// does (unsigned arithmetic, cast).  Where a half's lots exceed int32,
// K8 does what book.py does, as K5 does: the walks match wrapped, and
// after each cancel every level of both halves whose int32 lot sum is
// <= 0 loses its price (reset_empty; within int32 that changes nothing).
// The CPU tests hold ops/cases.lob_bar_emulated, this algorithm, to the
// plain version on such books too.
//
// What bounds K8: as K5, each book's chain of dependent steps, and no
// longer the bytes (the venue's 8,192 books of 24 x 4 and 64 messages:
// 14.2 MB of book each way, 10.5 MB of flow, 0.5 MB of orders and
// results, 11.8 us at 3.35 TB/s).  Its design is K5's: one warp per book,
// the whole book in registers from the open walk to the last message,
// the flow staged 32 messages at a time through shared memory, the
// agent's seven inputs read once per warp and its eight results written
// by lane 0.  A message's record stays in registers.  The agent's work
// takes one of two inlined copies by the exit's side, as process does by
// the message's, so no register array is indexed at run time.
//
// Where a message's time goes (gymfx_tpu_torch/profile_lob_bar.py, the
// venue's books and orders with the flow of one kind at a time): one
// warp alone runs a bar in ~47 us and six a scheduler take ~1.9x that,
// so the SM is busy issuing, and what a message issues decides the time;
// a NOOP, which changes nothing, paid 55% of the mix's cost.  So K8 skips
// what changes nothing, in branches uniform in the warp: a NOOP skips
// process where both halves are within int32 (there process matches both
// with a take of 0 and rests nothing), and fire runs only where the stop
// triggers or a half is beyond int32 (elsewhere its cancel of oid 0, its
// resets and its walk of 0 lots change nothing).  The launch bounds ask
// for 6 CTAs an SM at <1, Q <= 4> (kBarMinBlocks): 80 registers, 24 warps
// an SM; at 8 CTAs (64 registers) it spills and runs slower.  Several
// books a warp would serialise their kinds' and sides' paths.
//
// The extern "C" entry points launch on the caller's stream, do not
// synchronise, and return cudaGetLastError() (0 = launched).

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
constexpr int kNoop = 0;
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

// book.py::_record of the two halves' match stats, at most one of which
// saw a nonzero take: sums mod 2^32, the traded prices' min and max.
__device__ __forceinline__ Stats both(const Stats& a, const Stats& b) {
  return {a.filled + b.filled, a.value + b.value, a.events + b.events,
          a.agent_qty + b.agent_qty, a.agent_value + b.agent_value,
          min(a.pmin, b.pmin), max(a.pmax, b.pmax)};
}

// One message's fill record (book.py::FillRecord): the match's stats, the
// lots rested and the lots cancelled.
struct Record {
  Stats s;
  int rested, cancelled;
};

// The record as book.py's nine int32 columns.
__device__ __forceinline__ void store_record(int* row, const Record& r) {
  row[0] = (int)r.s.filled;
  row[1] = (int)r.s.value;
  row[2] = (int)r.s.events;
  row[3] = (int)r.s.agent_qty;
  row[4] = (int)r.s.agent_value;
  row[5] = r.s.pmin;
  row[6] = r.s.pmax;
  row[7] = r.rested;
  row[8] = r.cancelled;
}

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

// Whether the half's exact lots are within int32: then no sum of lots
// wraps, and every level whose lot sum is 0 has lost its price.
template <int L, int Q>
__device__ __forceinline__ bool narrow(const Half<L, Q>& h) {
  return h.total <= kI32Max;
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
// rest on own; returns the message's fill record.  book.py
// zeroes the price of every level whose int32 lot sum is <= 0 at every
// match; here only a wrapped match does (reset_empty), since within int32
// a level's sum is 0 exactly when it is empty, the walk and the cancel
// zero the price of a level they empty, and a half beyond int32 always
// matches wrapped.
template <bool kBuy, int L, int Q>
__device__ __forceinline__ Record process(Half<L, Q>& own, Half<L, Q>& opp, int kind, int price,
                                          int qty, int oid, int lane, int depth) {
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
  const Stats s = both(so, sw);
  return {s, rested, cancelled};
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
      // every lane stores the same values (one store, no branch), inside
      // each side's copy, where process leaves its record
      int* row = rec + j * kFillCols;
      if (m.x & 1)
        store_record(row, process<true>(bids, asks, m.x >> 1, m.y, m.z, m.w, lane, depth));
      else
        store_record(row, process<false>(asks, bids, m.x >> 1, m.y, m.z, m.w, lane, depth));
    }
    __syncwarp();
    int* out = a.fills + (m0 + chunk) * kFillCols;
    for (int i = lane; i < count * kFillCols; i += 32) out[i] = rec[i];
    __syncwarp();
  }

  store_half(bids, a.out[0], a.out[1], a.out[2], lvl0, lane, depth);
  store_half(asks, a.out[3], a.out[4], a.out[5], lvl0, lane, depth);
}

// ---------------------------------------------------------------------------
// K8 lob_bar: one bar of the LOB venue on a warp's book
// ---------------------------------------------------------------------------
struct BarArgs {
  const int* in[6];     // the seeded books, as LobArgs
  const int* msg[5];    // the bar's flow: kind, side, price, qty, oid, (B, M)
  const int* order[7];  // the agent's orders (kOpenLots ...), (B,)
  int* out[6];          // the final books
  int* fill[8];         // the agent's results (kOpenValue ...), (B,)
};
constexpr int kBarPointers = 32;
// CTAs an SM that K8's launch bounds ask for at one level a lane and up
// to 4 slots (the venue's <1, 4>): ptxas fits 80 registers, 24 warps an
// SM, with a 24-byte frame (90 registers and 20 warps without), 4% faster
// on an H100 (profile_lob_bar.py --min_blocks)
constexpr int kBarMinBlocks = 6;
// ops/lob_bar.py BarOrders
enum { kOpenLots, kOpenBuy, kOpenTick, kPosLots, kExitBuy, kStop, kTakeProfit };
// ops/lob_bar.py BarFills
enum { kOpenValue, kGapLots, kGapValue, kTpLots, kTpValue, kSlLots, kSlValue, kFired };

// book.py::match_market: a market order of `lots` for a buy (kBuy: the
// take walks the asks) or a sell, both halves matched as book.py matches
// them (the other with a take of 0).
template <bool kBuy, int L, int Q>
__device__ __forceinline__ Stats match_market(Half<L, Q>& bids, Half<L, Q>& asks, int lots) {
  const Stats sa = match_half<true>(asks, kBuy ? lots : 0, kPriceCap);
  const Stats sb = match_half<false>(bids, kBuy ? 0 : lots, 0);
  return both(sa, sb);
}

// venue.py::_walk_with_backstop: the market walk's value in tick-lots,
// its unfilled remainder priced at the worst level it touched, else at
// `backstop`; mod 2^32, as torch's int32.
template <bool kBuy, int L, int Q>
__device__ __forceinline__ unsigned walk(Half<L, Q>& bids, Half<L, Q>& asks, int lots,
                                         int backstop) {
  const Stats s = match_market<kBuy>(bids, asks, lots);
  const int worst = (int)s.filled > 0 ? (kBuy ? s.pmax : s.pmin) : backstop;
  return s.value + ((unsigned)lots - s.filled) * (unsigned)worst;
}

// The stop's work after a flow message (venue.py::intrabar's cancel and
// walk) for an exit that buys (kBuy: the take-profit rests on the bids)
// or sells: book.py::cancel of `target` on that half, then the exit's
// walk of `take` lots backstopped at `stop`.  Where the stop does not
// fire both are 0, as in the plain version: cancel_half and match_half
// then return without a warp step (on a half within int32).  book.py's
// cancel also zeroes the price of every level of both halves whose int32
// lot sum is <= 0: within int32 no priced level is empty, and beyond it
// reset_empty zeroes what book.py zeroes.
template <bool kBuy, int L, int Q>
__device__ __forceinline__ unsigned fire(Half<L, Q>& bids, Half<L, Q>& asks, int target,
                                         int take, int stop) {
  if (kBuy)
    cancel_half<false>(bids, target);
  else
    cancel_half<true>(asks, target);
  reset_empty(bids);
  reset_empty(asks);
  return walk<kBuy>(bids, asks, take, stop);
}

// venue.py's open_walk and intrabar on one book, their book work in the
// plain version's order: the open walk, the gap stop, the take-profit's
// rest (an ADD of AGENT_OID at max(tp, 1)), then for each flow message
// process, the agent's maker fills, the stop's trigger and fire.  The
// agent's scalars are the same in every lane; every branch on a side is
// the book's own, so none diverges inside a warp.  The two walks at the
// open share one loop, and the take-profit's rest is message 0 of the
// flow's loop, so each side's walk and process is inlined once there
// (fire holds the other walk): a third of the code, and of the build
// time, of a copy at each call site.
template <int L, int Q>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, L == 1 && Q <= 4 ? kBarMinBlocks : 1)
lob_bar_kernel(BarArgs a, long long n_books, int depth, int n_msgs) {
  __shared__ int4 s_msg[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= n_books) return;  // whole warps only: b is uniform in a warp

  const long long lvl0 = b * depth;
  Half<L, Q> bids, asks;
  load_half<false>(bids, a.in[0], a.in[1], a.in[2], lvl0, lane, depth);
  load_half<true>(asks, a.in[3], a.in[4], a.in[5], lvl0, lane, depth);
  const int open_lots = a.order[kOpenLots][b];
  const bool open_buy = a.order[kOpenBuy][b] != 0;
  const int o_t = a.order[kOpenTick][b];
  const int pos_lots = a.order[kPosLots][b];
  const bool exit_buy = a.order[kExitBuy][b] != 0;  // exiting a short buys
  const int sl = a.order[kStop][b];
  const int tp = a.order[kTakeProfit][b];

  const bool has_sl = sl > 0 && pos_lots > 0;
  const bool has_tp = tp > 0 && pos_lots > 0;
  // a bar that gaps open through the stop exits at the open walk
  const bool gap_sl = has_sl && (exit_buy ? o_t >= sl : o_t <= sl);
  const int gap_lots = gap_sl ? pos_lots : 0;
  // the pending order's market walk at the open, then the gap stop's: one
  // inlined copy of each side's walk serves both
  unsigned open_value = 0u, gap_value = 0u;
#pragma unroll 1
  for (int w = 0; w < 2; ++w) {
    const bool buy = w == 0 ? open_buy : exit_buy;
    const int lots = w == 0 ? open_lots : gap_lots;
    const unsigned v = buy ? walk<true>(bids, asks, lots, o_t) : walk<false>(bids, asks, lots, o_t);
    open_value = w == 0 ? v : open_value;
    gap_value = w == 0 ? gap_value : v;
  }

  // Message 0 is the take-profit's rest (an ADD of AGENT_OID at max(tp,
  // 1), skipped when the gap stop flattened the bar; its marketable part
  // fills at maker prices), messages 1..M the bar's flow: one inlined
  // copy of each side's process serves both.
  const int tp_rest = has_tp && !gap_sl ? pos_lots : 0;
  unsigned rem = 0u, tp_lots = 0u, tp_value = 0u;
  unsigned sl_lots = (unsigned)gap_lots, sl_value = gap_value;
  bool fired = gap_sl;
  const long long m0 = b * n_msgs - 1;  // the flow's row, one message behind
  for (int chunk = 0; chunk <= n_msgs; chunk += 32) {
    const int count = min(32, n_msgs + 1 - chunk);
    if (lane < count) {  // as lob_stream_kernel stages them
      const int i = chunk + lane;
      if (i == 0) {
        s_msg[warp][lane] = make_int4(2 * kAdd + (exit_buy ? 1 : 0), max(tp, 1), tp_rest, kAgentOid);
      } else {
        const long long k = m0 + i;
        const int kind = min(max(a.msg[0][k], 0), 3);
        s_msg[warp][lane] = make_int4(2 * kind + (a.msg[1][k] > 0 ? 1 : 0), a.msg[2][k],
                                      a.msg[3][k], a.msg[4][k]);
      }
    }
    __syncwarp();
    for (int j = 0; j < count; ++j) {
      const int4 m = s_msg[warp][j];
      // a NOOP on two halves within int32 changes nothing (process would
      // match both with a take of 0 and rest nothing)
      Record r = {no_fill(), 0, 0};
      if (m.x >> 1 != kNoop || !narrow(bids) || !narrow(asks))
        r = (m.x & 1) ? process<true>(bids, asks, m.x >> 1, m.y, m.z, m.w, lane, depth)
                      : process<false>(asks, bids, m.x >> 1, m.y, m.z, m.w, lane, depth);
      if (chunk + j == 0) {  // the take-profit's immediate fill
        rem = (unsigned)pos_lots - (unsigned)gap_lots - r.s.filled;
        tp_lots = r.s.filled;
        tp_value = r.s.value;
        continue;
      }
      // flow takers reaching the resting take-profit (maker fills)
      rem -= r.s.agent_qty;
      tp_lots += r.s.agent_qty;
      tp_value += r.s.agent_value;
      // the stop triggers on the first print at or through it
      const bool printed = exit_buy ? r.s.pmax >= sl : r.s.pmin <= sl;
      const bool trig = has_sl && !fired && (int)rem > 0 && printed;
      // where the stop does not fire, fire's cancel of oid 0, its resets
      // and its walk of 0 lots change nothing on halves within int32
      if (trig || !narrow(bids) || !narrow(asks)) {
        const int target = trig ? kAgentOid : 0;
        const int take = trig ? (int)rem : 0;
        const unsigned xvalue = exit_buy ? fire<true>(bids, asks, target, take, sl)
                                         : fire<false>(bids, asks, target, take, sl);
        if (trig) {
          sl_lots += rem;
          sl_value += xvalue;
          rem = 0u;
        }
      }
      fired = fired || trig;
    }
    __syncwarp();
  }

  if (lane == 0) {
    a.fill[kOpenValue][b] = (int)open_value;
    a.fill[kGapLots][b] = gap_lots;
    a.fill[kGapValue][b] = (int)gap_value;
    a.fill[kTpLots][b] = (int)tp_lots;
    a.fill[kTpValue][b] = (int)tp_value;
    a.fill[kSlLots][b] = (int)sl_lots;
    a.fill[kSlValue][b] = (int)sl_value;
    a.fill[kFired][b] = fired ? 1 : 0;
  }
  store_half(bids, a.out[0], a.out[1], a.out[2], lvl0, lane, depth);
  store_half(asks, a.out[3], a.out[4], a.out[5], lvl0, lane, depth);
}

template <int L, int Q>
void start(const LobArgs& a, unsigned blocks, long long n_books, int depth, int n_msgs,
           cudaStream_t stream) {
  lob_stream_kernel<L, Q><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(a, n_books, depth, n_msgs);
}

template <int L, int Q>
void start(const BarArgs& a, unsigned blocks, long long n_books, int depth, int n_msgs,
           cudaStream_t stream) {
  lob_bar_kernel<L, Q><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(a, n_books, depth, n_msgs);
}

// K5 or K8 (by the arguments' type) at every (levels a lane, slots) pair
// the wrappers take: depth 1-32 -> 1 level a lane, 33-64 -> 2
template <int L, class Args>
void start_slots(int slots, const Args& a, unsigned blocks, long long n_books, int depth,
                 int n_msgs, cudaStream_t stream) {
  switch (slots) {
    case 1: return start<L, 1>(a, blocks, n_books, depth, n_msgs, stream);
    case 2: return start<L, 2>(a, blocks, n_books, depth, n_msgs, stream);
    case 3: return start<L, 3>(a, blocks, n_books, depth, n_msgs, stream);
    case 4: return start<L, 4>(a, blocks, n_books, depth, n_msgs, stream);
    case 5: return start<L, 5>(a, blocks, n_books, depth, n_msgs, stream);
    case 6: return start<L, 6>(a, blocks, n_books, depth, n_msgs, stream);
    case 7: return start<L, 7>(a, blocks, n_books, depth, n_msgs, stream);
    default: return start<L, 8>(a, blocks, n_books, depth, n_msgs, stream);
  }
}

template <class Args>
int launch(const Args& a, long long n_books, int depth, int slots, int n_msgs, void* stream) {
  if (depth < 1 || depth > kMaxDepth || slots < 1 || slots > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_books + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (depth <= 32)
    start_slots<1>(slots, a, blocks, n_books, depth, n_msgs, s);
  else
    start_slots<2>(slots, a, blocks, n_books, depth, n_msgs, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gymfx_lob_pointer_count() { return kLobPointers; }

int gymfx_lob_bar_pointer_count() { return kBarPointers; }

// ptrs: the six input book tensors, the five (B, M) message tensors, the
// six output book tensors and the (B, M, 9) fill records, all int32 and
// contiguous.  Requires 1 <= depth <= 64, 1 <= slots <= 8.
int gymfx_lob_stream(void* const* ptrs, long long n_books, int depth, int slots, int n_msgs,
                     void* stream) {
  LobArgs a;
  for (int i = 0; i < 6; ++i) a.in[i] = static_cast<const int*>(ptrs[i]);
  for (int i = 0; i < 5; ++i) a.msg[i] = static_cast<const int*>(ptrs[6 + i]);
  for (int i = 0; i < 6; ++i) a.out[i] = static_cast<int*>(ptrs[11 + i]);
  a.fills = static_cast<int*>(ptrs[17]);
  return launch(a, n_books, depth, slots, n_msgs, stream);
}

// ptrs: the six input book tensors, the five (B, M) flow tensors, the
// seven (B,) order tensors (ops/lob_bar.py BarOrders), the six output book
// tensors and the eight (B,) result tensors (BarFills), all int32 and
// contiguous.  Requires 1 <= depth <= 64, 1 <= slots <= 8.
int gymfx_lob_bar(void* const* ptrs, long long n_books, int depth, int slots, int n_msgs,
                  void* stream) {
  BarArgs a;
  for (int i = 0; i < 6; ++i) a.in[i] = static_cast<const int*>(ptrs[i]);
  for (int i = 0; i < 5; ++i) a.msg[i] = static_cast<const int*>(ptrs[6 + i]);
  for (int i = 0; i < 7; ++i) a.order[i] = static_cast<const int*>(ptrs[11 + i]);
  for (int i = 0; i < 6; ++i) a.out[i] = static_cast<int*>(ptrs[18 + i]);
  for (int i = 0; i < 8; ++i) a.fill[i] = static_cast<int*>(ptrs[24 + i]);
  return launch(a, n_books, depth, slots, n_msgs, stream);
}

}  // extern "C"
