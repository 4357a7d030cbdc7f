"""int16 tick-delta compression for MarketData tapes.

The port's copy of ``gymfx_tpu/data/compress.py``.  The encoder is the
JAX package's numpy code, kept as it is (:156-556): each OHLC /
padded_close column becomes int16 deltas against a per-shard int32 base
with the tick grid as the divisor, the event / calendar blocks narrow to
int16 or uint8 quantities, packed bits, whole-tape constants or
periodic tables, and every codec is accepted only when its simulated
decode equals the f32 target bit for bit.  Off-grid prices and per-shard
tick spans beyond int16 raise (honor-or-reject); every other column
falls back to raw storage.  Column order and slab dedup follow
``MarketData._fields``, which is the JAX package's order, so the port
encodes a host tape into the JAX package's ``CompressedTape``.

The decode is a plain function over tensors (:func:`_decode_shard_impl`):
every unique (slab, divisor) q16 pair of one row count goes through one
call of K6 (``ops/tape_decode.decode_q16_block``: the kernel on the
card, its plain version on the CPU); ``data_compress`` "on" and
"interpret" both take that path, "off" (the oracle,
:func:`decode_shard_ref`) the plain ``decode_q16_ref``.  Divisors reach
the decode as device tensors, never as constants.

Decode arithmetic (pinned): ``f32 = (base_i32 + delta_i16->i32)->f32 /
inv_f32`` where ``inv = 1 / scale``.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gymfx_tpu_torch.data.feed import (
    MarketData,
    market_data_nbytes,
    shard_market_data,
)
from gymfx_tpu_torch.ops.tape_decode import decode_q16_block

COMPRESS_MODES = ("off", "on", "interpret")

# fields whose codec is mandatory (honor-or-reject): the int-tick grid
# IS the contract for prices
PRICE_FIELDS = ("open", "high", "low", "close", "padded_close")

# q16 divisor candidates for non-price f32 columns, tried in order: raw
# integer quantities (volume, M1 bar counts), hours-from-minutes
# (calendar hours_to_* = minutes / 60), minutes/days grids
Q16_CANDIDATE_INVS = (1.0, 60.0, 24.0, 1440.0, 10080.0)

# feature-pipeline tensors stay raw f32: their values are f64-derived
# rolling moments with no grid to quantize against
RAW_FIELDS = ("padded_features", "feat_mean", "feat_std", "feat_neutral")

_I16_SPAN = 65535  # full int16 delta range once the base is centered


class ColumnSpec(NamedTuple):
    """One stored column of a compressed tape.

    ``kind``:
      q16      int16 delta + per-shard i32 base; f32 = (base+delta)→f32/inv
      i16      int16 delta + per-shard i32 base; i32 = base + delta
      u8       uint8 delta + per-shard i32 base; i32 = base + delta
      bits     bit ``bit`` of a packed uint8 mask column; f32 = (m>>b)&1
      const    whole-tape constant ``value``
      iperiodic whole-tape lookup table gathered by the GLOBAL bar index
               modulo the table length (regular bar grids repeat weekly:
               calendar/session blocks and minute_of_week itself store
               ONE week of slots, not one value per bar)
      periodic whole-tape f32 lookup table gathered by the decoded
               ``minute_of_week`` — the fallback for weekly-periodic
               values on IRREGULAR grids (gap-y CSV replays), where the
               bar index is not congruent to the week.  Both table
               kinds copy stored bits on decode, so the round-trip is
               exact by construction and still verified at encode time.
      raw      original-dtype passthrough slab
    ``src`` indexes ``CompressedTape.slabs`` (q16/i16/bits), ``.raws``
    (raw) or ``.tables`` (periodic); identical delta slabs are
    content-deduplicated, so several columns may share one ``src`` with
    different ``inv`` (e.g. the calendar's hours-to-break and M1
    bars-to-break both decode from one stored minutes column).
    """

    field: str
    col: int          # column index inside a 2-D field; -1 for 1-D
    kind: str
    src: int = -1
    inv: float = 1.0
    bit: int = 0
    value: float = 0.0


class CompressedTape(NamedTuple):
    """Stacked per-shard slabs for one logical tape.

    ``slabs[i]`` is ``(S, rows)`` int16 (q16/i16) or uint8 (bits) with
    ``bases[i]`` the aligned ``(S,)`` int32 base sidecar; ``raws[i]`` is
    ``(S, rows[, C])`` in the original dtype.  Shard ``k``'s decode is
    bitwise-identical to ``shard_market_data(host, starts[k],
    shard_bars, window_size)`` — verified at encode time.
    """

    columns: Tuple[ColumnSpec, ...]
    slabs: Tuple[Any, ...]
    bases: Tuple[Any, ...]
    raws: Tuple[Any, ...]
    tables: Tuple[Any, ...]   # (period,) f32 minute-of-week lookups
    starts: Any               # (S,) int32 global shard starts
    shard_bars: int
    window_size: int
    n_bars: int
    decoded_shard_nbytes: int  # exact f32 bytes of ONE decoded shard

    @property
    def num_shards(self) -> int:
        return int(np.asarray(self.starts).shape[0])

    @property
    def nbytes(self) -> int:
        """Total compressed bytes (slabs + base sidecars + raw slabs +
        periodic lookup tables)."""
        total = 0
        for arr in (*self.slabs, *self.bases, *self.raws, *self.tables):
            total += int(arr.nbytes)
        return total

    @property
    def shard_nbytes(self) -> int:
        """Compressed bytes of one shard (slabs are uniformly stacked)."""
        return -(-self.nbytes // max(1, self.num_shards))

    @property
    def compression_ratio(self) -> float:
        """Decoded f32 bytes / compressed bytes over the shard set."""
        return (self.decoded_shard_nbytes * self.num_shards) / max(
            1, self.nbytes
        )

    def codec_report(self) -> Dict[str, str]:
        """{column: kind} — observability for tests and docs."""
        out = {}
        for c in self.columns:
            name = c.field if c.col < 0 else f"{c.field}:{c.col}"
            out[name] = c.kind
        return out


def validate_compress_mode(mode: Any) -> str:
    """Honor-or-reject the ``data_compress`` knob."""
    m = str(mode or "off").lower()
    if m not in COMPRESS_MODES:
        raise ValueError(
            f"data_compress must be one of {COMPRESS_MODES}, got {mode!r}"
        )
    return m


# ---------------------------------------------------------------------------
# encode


def _bitview(a: np.ndarray) -> np.ndarray:
    """Reinterpret as unsigned bits for exact (NaN-safe) comparison."""
    if a.dtype == np.float32:
        return a.view(np.uint32)
    return a


def _bit_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return bool(np.array_equal(_bitview(np.ascontiguousarray(a)),
                               _bitview(np.ascontiguousarray(b))))


def _try_q16(col: np.ndarray, inv: float):
    """Fit (S, rows) f32 -> per-shard base + int16 delta under divisor
    ``inv``; returns (bases_i32, delta_i16) when the simulated decode is
    bitwise-exact, else None."""
    t = np.rint(col.astype(np.float64) * inv)
    if not np.all(np.isfinite(t)):
        return None
    lo = t.min(axis=1)
    span = t.max(axis=1) - lo
    if span.max() > _I16_SPAN:
        return None
    base = lo + np.where(span > 32767, 32768.0, 0.0)
    if np.any(np.abs(base) > 2**31 - 1):
        return None
    base = base.astype(np.int32)
    delta = (t - base[:, None].astype(np.float64)).astype(np.int16)
    dec = (
        base[:, None] + delta.astype(np.int32)
    ).astype(np.float32) / np.float32(inv)
    if not _bit_equal(dec, col):
        return None
    return base, delta


def _try_i16(col: np.ndarray):
    """(S, rows) int32 -> per-shard base + int16 delta (exact)."""
    t = col.astype(np.int64)
    lo = t.min(axis=1)
    span = t.max(axis=1) - lo
    if span.max() > _I16_SPAN:
        return None
    base = (lo + np.where(span > 32767, 32768, 0)).astype(np.int32)
    delta = (t - base[:, None]).astype(np.int16)
    if not np.array_equal(base[:, None] + delta.astype(np.int32), t):
        return None
    return base, delta


def _try_u8(col: np.ndarray):
    """(S, rows) int32 -> per-shard base + uint8 delta (exact): half the
    int16 bytes for narrow-span int columns (scenario flags)."""
    t = col.astype(np.int64)
    lo = t.min(axis=1)
    if (t.max(axis=1) - lo).max() > 255:
        return None
    base = lo.astype(np.int32)
    delta = (t - lo[:, None]).astype(np.uint8)
    if not np.array_equal(base[:, None] + delta.astype(np.int32), t):
        return None
    return base, delta


def _is_binary(col: np.ndarray) -> bool:
    dec = (col.view(np.uint32) != 0).astype(np.float32)
    return _bit_equal(dec, col)


# one FX week of minutes — the largest period a minute-of-week lookup
# table can need; anything indexing past it is not weekly-periodic
_MINUTES_PER_WEEK = 10080


def _try_index_periodic(
    col: np.ndarray, gidx: Optional[np.ndarray], period: Optional[int]
):
    """Fit (S, rows) values as a pure function of the GLOBAL bar index
    modulo ``period`` (bars-per-week on a regular grid): one (period,)
    table in the column's own dtype replaces per-bar storage.  Returns
    the table when the gather round-trips bitwise — irregular grids
    (gap-y replays) and non-periodic columns fail the consistency check
    — else None."""
    if gidx is None or period is None or period <= 0:
        return None
    if gidx.shape != col.shape:
        return None
    # only worth it when the table is smaller than the int16/uint8 slab
    # it replaces — short tapes keep delta codecs, long tapes amortize
    # one stored week over millions of bars
    if col.dtype.itemsize * period >= 2 * col.size:
        return None
    m = gidx.reshape(-1) % period
    v = col.reshape(-1)
    table = np.zeros(period, col.dtype)
    table[m] = v  # last write wins; the verify catches inconsistency
    if not _bit_equal(table[m], v):
        return None
    return table


def _try_periodic(col: np.ndarray, minutes: Optional[np.ndarray]):
    """Fit (S, rows) f32 as a pure function of minute_of_week: one
    (period,) f32 table replaces per-bar storage for weekly-periodic
    calendar/session columns.  Returns the table when the gather
    round-trips bitwise (DST-shifted or date-specific columns fail the
    consistency check and fall through to q16), else None."""
    if minutes is None or minutes.shape != col.shape:
        return None
    m = minutes.reshape(-1)
    if m.size == 0 or m.min() < 0 or m.max() >= _MINUTES_PER_WEEK:
        return None
    # only worth it when the (period,) f32 table is smaller than the
    # (n,) int16 q16 slab it replaces — short tapes keep q16, long tapes
    # amortize one stored week over millions of bars
    if 4 * (int(m.max()) + 1) >= 2 * m.size:
        return None
    v = col.reshape(-1)
    table = np.zeros(int(m.max()) + 1, np.float32)
    table[m] = v  # last write wins; the verify catches inconsistency
    if not _bit_equal(table[m], v):
        return None
    return table


class _TableStore:
    """Content-deduplicated periodic lookup tables."""

    def __init__(self):
        self.tables: List[np.ndarray] = []
        self._index: Dict[bytes, int] = {}

    def add(self, table: np.ndarray) -> int:
        key = str(table.dtype).encode() + b"|" + table.tobytes()
        src = self._index.get(key)
        if src is None:
            src = len(self.tables)
            self._index[key] = src
            self.tables.append(np.ascontiguousarray(table))
        return src


def _first_offgrid(col: np.ndarray, inv: float) -> Tuple[int, int, float]:
    """(shard, row, value) of the first element that fails the q16
    round-trip — for the honor-or-reject message."""
    t = np.rint(col.astype(np.float64) * inv)
    dec = (t / np.float64(inv)).astype(np.float32)
    bad = _bitview(dec) != _bitview(col)
    if not bad.any():
        # round-trips elementwise, so the failure was the delta span
        return -1, -1, float("nan")
    k, r = np.argwhere(bad)[0]
    return int(k), int(r), float(col[k, r])


class _SlabStore:
    """Content-deduplicated slab registry (the hours/bars calendar pair
    and OHLC columns of flat synthetic tapes collapse to one slab)."""

    def __init__(self):
        self.slabs: List[np.ndarray] = []
        self.bases: List[np.ndarray] = []
        self._index: Dict[bytes, int] = {}

    def add(self, slab: np.ndarray, base: Optional[np.ndarray]) -> int:
        if base is None:
            base = np.zeros(slab.shape[0], np.int32)
        key = (
            str(slab.dtype).encode() + b"|" + slab.tobytes()
            + b"|" + base.tobytes()
        )
        src = self._index.get(key)
        if src is None:
            src = len(self.slabs)
            self._index[key] = src
            self.slabs.append(np.ascontiguousarray(slab))
            self.bases.append(np.ascontiguousarray(base))
        return src


def _encode_f32_column(
    field: str, col_idx: int, col: np.ndarray, store: _SlabStore,
    *, tick_inv: float, tick_size: float, what: str,
    minutes: Optional[np.ndarray] = None,
    tstore: Optional["_TableStore"] = None,
    gidx: Optional[np.ndarray] = None,
    period: Optional[int] = None,
) -> ColumnSpec:
    """Codec selection for one stacked (S, rows) f32 column."""
    first = col.flat[0]
    if _bit_equal(np.broadcast_to(first, col.shape), col):
        return ColumnSpec(field, col_idx, "const", value=float(first))
    if field in PRICE_FIELDS:
        fit = _try_q16(col, tick_inv)
        if fit is None:
            k, r, v = _first_offgrid(col, tick_inv)
            if k >= 0:
                raise ValueError(
                    f"data_compress{what}: price column {field!r} is off "
                    f"the {tick_size!r} tick grid at shard {k} row {r} "
                    f"(value {v!r}); compressed tapes require on-grid "
                    "prices (same discipline as validate_lob_venue) — "
                    "snap the data to the LOB tick grid or set "
                    "data_compress=off"
                )
            raise ValueError(
                f"data_compress{what}: price column {field!r} spans more "
                f"than {_I16_SPAN} ticks ({_I16_SPAN * tick_size:g} price "
                "units) within one shard — beyond the int16 delta range; "
                "use smaller shards (lower stream_hbm_budget_mb) or set "
                "data_compress=off"
            )
        base, delta = fit
        return ColumnSpec(field, col_idx, "q16",
                          src=store.add(delta, base), inv=tick_inv)
    if _is_binary(col):
        # packed later by the caller (one uint8 mask per 2-D field)
        return ColumnSpec(field, col_idx, "bits")
    if tstore is not None:
        # index-periodic first: its table is one week of BAR slots (the
        # weekend rows never exist), smaller than the minute-of-week
        # table and independent of the minute decode
        table = _try_index_periodic(col, gidx, period)
        if table is not None:
            return ColumnSpec(field, col_idx, "iperiodic",
                              src=tstore.add(table))
        table = _try_periodic(col, minutes)
        if table is not None:
            return ColumnSpec(field, col_idx, "periodic",
                              src=tstore.add(table))
    for inv in Q16_CANDIDATE_INVS + (tick_inv,):
        fit = _try_q16(col, inv)
        if fit is not None:
            base, delta = fit
            return ColumnSpec(field, col_idx, "q16",
                              src=store.add(delta, base), inv=inv)
    return ColumnSpec(field, col_idx, "raw")


def encode_market_data(
    host: Any,
    *,
    starts: Sequence[int],
    shard_bars: int,
    window_size: int,
    tick_size: float,
    what: str = "",
) -> CompressedTape:
    """Compress a host MarketData into per-shard slabs aligned with the
    given shard ``starts`` (the BarStreamer grid, or ``[0]`` with
    ``shard_bars = n - 1`` for a whole-tape single slab).

    Every column's decode is simulated in numpy and verified bitwise
    against ``shard_market_data(host, start, ...)`` before the codec is
    accepted; prices reject loudly on failure, everything else falls
    back to raw f32.
    """
    close = np.asarray(host.close)
    if close.dtype != np.float32:
        raise ValueError(
            f"data_compress{what} requires compute_dtype float32 "
            f"(tapes are {close.dtype}); narrow the compute dtype or "
            "set data_compress=off"
        )
    if float(tick_size) <= 0.0:
        raise ValueError(
            f"data_compress{what}: lob_tick_size must be > 0, got "
            f"{tick_size!r}"
        )
    tick_inv = float(np.float32(1.0 / float(tick_size)))
    starts = [int(s) for s in starts]
    shards = [
        shard_market_data(host, s, int(shard_bars), int(window_size))
        for s in starts
    ]
    decoded_shard_nbytes = market_data_nbytes(shards[0])

    store = _SlabStore()
    tstore = _TableStore()
    raws: List[np.ndarray] = []
    columns: List[ColumnSpec] = []

    # weekly-periodic candidates gather by minute_of_week; the minute
    # block is stacked once up front so any f32 column with matching
    # geometry can try the table codec
    minutes = np.stack(
        [np.asarray(sh.minute_of_week) for sh in shards]
    ).astype(np.int64)
    # index-periodic candidates gather by GLOBAL bar index mod the
    # bars-per-week period; the distinct minute slots count the period
    # (self-validating — a wrong guess fails the bitwise check)
    gidx = (
        np.asarray(starts, np.int64)[:, None]
        + np.arange(minutes.shape[1], dtype=np.int64)[None, :]
    )
    period = int(np.unique(minutes).size)

    for field in type(host)._fields:
        if field == "row0":
            continue
        target = np.stack([np.asarray(getattr(sh, field)) for sh in shards])
        if field in RAW_FIELDS:
            columns.append(ColumnSpec(field, -1, "raw", src=len(raws)))
            raws.append(np.ascontiguousarray(target))
            continue
        if target.dtype == np.int32:
            first = target.flat[0]
            if np.array_equal(np.broadcast_to(first, target.shape), target):
                columns.append(
                    ColumnSpec(field, -1, "const", value=float(first))
                )
                continue
            table = _try_index_periodic(target, gidx, period)
            if table is not None:
                columns.append(ColumnSpec(field, -1, "iperiodic",
                                          src=tstore.add(table)))
                continue
            fit = _try_u8(target)
            if fit is not None:
                base, delta = fit
                columns.append(ColumnSpec(field, -1, "u8",
                                          src=store.add(delta, base)))
                continue
            fit = _try_i16(target)
            if fit is not None:
                base, delta = fit
                columns.append(ColumnSpec(field, -1, "i16",
                                          src=store.add(delta, base)))
            else:
                columns.append(ColumnSpec(field, -1, "raw",
                                          src=len(raws)))
                raws.append(np.ascontiguousarray(target))
            continue
        # f32 columns: 1-D fields directly, 2-D fields per column with
        # the binary columns packed into one uint8 mask slab per field
        if target.ndim == 2:
            cols = [(-1, target)]
        else:
            cols = [(j, target[:, :, j]) for j in range(target.shape[2])]
        pending_bits: List[Tuple[int, np.ndarray]] = []
        for j, col in cols:
            spec = _encode_f32_column(
                field, j, col, store,
                tick_inv=tick_inv, tick_size=float(tick_size), what=what,
                minutes=minutes, tstore=tstore, gidx=gidx, period=period,
            )
            if spec.kind == "bits":
                pending_bits.append((j, col))
                columns.append(spec)  # placeholder; patched below
            elif spec.kind == "raw":
                columns.append(spec._replace(src=len(raws)))
                raws.append(np.ascontiguousarray(col))
            else:
                columns.append(spec)
        if pending_bits:
            if len(pending_bits) > 8:
                raise ValueError(
                    f"data_compress{what}: field {field!r} has "
                    f"{len(pending_bits)} binary columns — more than one "
                    "uint8 mask can pack"
                )
            mask = np.zeros(pending_bits[0][1].shape, np.uint8)
            for bit, (_, col) in enumerate(pending_bits):
                mask |= ((col.view(np.uint32) != 0).astype(np.uint8) << bit)
            src = store.add(mask, None)
            bit_iter = iter(range(len(pending_bits)))
            for i, spec in enumerate(columns):
                if spec.field == field and spec.kind == "bits":
                    columns[i] = spec._replace(src=src, bit=next(bit_iter))

    return CompressedTape(
        columns=tuple(columns),
        slabs=tuple(store.slabs),
        bases=tuple(store.bases),
        raws=tuple(raws),
        tables=tuple(tstore.tables),
        starts=np.asarray(starts, np.int32),
        shard_bars=int(shard_bars),
        window_size=int(window_size),
        n_bars=int(close.shape[0]),
        decoded_shard_nbytes=int(decoded_shard_nbytes),
    )


def encode_tape(host: Any, *, window_size: int, tick_size: float,
                what: str = "") -> CompressedTape:
    """Whole-tape single-slab encoding: shard 0 anchored at row 0 with
    ``shard_bars = n - 1`` decodes to the full MarketData bitwise
    (curriculum tape libraries, ops/tape_decode parity tests)."""
    n = int(np.asarray(host.close).shape[0])
    return encode_market_data(
        host, starts=(0,), shard_bars=n - 1, window_size=window_size,
        tick_size=tick_size, what=what,
    )


# ---------------------------------------------------------------------------
# decode


def decode_q16_ref(delta, base, inv):
    """The plain q16 decode (the JAX package's XLA oracle): (C, rows)
    int16 + (C,) int32 + (C,) f32 -> (C, rows) f32."""
    return (base[:, None] + delta.to(torch.int32)).to(torch.float32) / inv[:, None]


def _q16_groups(
    columns: Tuple[ColumnSpec, ...], row_counts: Sequence[int]
) -> List[List[Tuple[int, float]]]:
    """Deterministic fused-decode grouping: unique (slab, inv) q16 pairs
    bucketed by row count, sorted — shared by ``shard_arrays`` and
    ``_decode_shard_impl`` so the runtime divisor arrays line up."""
    q16_pairs = sorted({(c.src, c.inv) for c in columns if c.kind == "q16"})
    by_rows: Dict[int, List[Tuple[int, float]]] = {}
    for src, inv in q16_pairs:
        by_rows.setdefault(int(row_counts[src]), []).append((src, inv))
    return [items for _, items in sorted(by_rows.items())]


def shard_arrays(tape: CompressedTape, k: int) -> Dict[str, Any]:
    """Shard ``k``'s compressed arrays (slabs, bases and raws sliced at
    ``k``, as numpy arrays or tensors, whichever the tape holds), the
    whole-tape tables, the q16 divisors of each fused group as f32
    arrays, and the shard's global ``row0`` (an int)."""
    groups = _q16_groups(tape.columns, [int(s.shape[1]) for s in tape.slabs])
    return {
        "slabs": tuple(s[k] for s in tape.slabs),
        "bases": tuple(b[k] for b in tape.bases),
        "raws": tuple(r[k] for r in tape.raws),
        "tables": tuple(tape.tables),
        "invs": tuple(np.asarray([iv for _, iv in g], np.float32) for g in groups),
        "row0": int(np.asarray(tape.starts)[k]),
    }


def _on(x, device: torch.device):
    """A tensor on ``device`` from a numpy array or a tensor."""
    return torch.as_tensor(x).to(device)


def _decode_shard_impl(columns: Tuple[ColumnSpec, ...], shard_bars: int, window_size: int,
                       mode: str, slab: Dict[str, Any]) -> MarketData:
    """Decode one shard's tensors into a MarketData on their device.

    The q16 sources are decoded fused: all unique (slab, inv) pairs of
    one row count are stacked into one (C, rows) block (a device copy
    of the int16s, as the JAX package's ``jnp.stack``) and decoded by
    one K6 call (``mode`` "on" / "interpret"; "off" is the plain
    oracle).  ``slab["invs"]`` holds the divisors as tensors.
    """
    slabs, bases, raws = slab["slabs"], slab["bases"], slab["raws"]
    row0 = int(slab["row0"])
    R = int(shard_bars) + 1
    device = slabs[0].device if slabs else raws[0].device

    groups = _q16_groups(columns, [s.shape[0] for s in slabs])
    decoded_q16: Dict[Tuple[int, float], Any] = {}
    for gi, items in enumerate(groups):
        delta = torch.stack([slabs[s] for s, _ in items])
        base = torch.stack([bases[s] for s, _ in items])
        inv = slab["invs"][gi]
        if mode == "off":
            out = decode_q16_ref(delta, base, inv)
        else:
            out = decode_q16_block(delta, base, inv)
        for i, key in enumerate(items):
            decoded_q16[key] = out[i]

    def column_rows(field: str) -> int:
        if field in ("padded_close", "padded_features"):
            return R + int(window_size)
        if field in ("feat_mean", "feat_std", "feat_neutral"):
            return R + 1
        return R

    def decode_column(c: ColumnSpec, int_field: bool):
        if c.kind == "q16":
            return decoded_q16[(c.src, c.inv)]
        if c.kind in ("i16", "u8"):
            return bases[c.src] + slabs[c.src].to(torch.int32)
        if c.kind == "iperiodic":
            t = slab["tables"][c.src]
            idx = (row0 + torch.arange(column_rows(c.field), dtype=torch.int64,
                                       device=device)) % t.shape[0]
            return t[idx]
        if c.kind == "periodic":
            return slab["tables"][c.src][minute_idx.long()]
        if c.kind == "bits":
            return torch.bitwise_and(torch.bitwise_right_shift(slabs[c.src], c.bit), 1).to(
                torch.float32)
        if c.kind == "const":
            rows = column_rows(c.field)
            if int_field:
                return torch.full((rows,), int(np.int32(c.value)), dtype=torch.int32, device=device)
            return torch.full((rows,), float(np.float32(c.value)), dtype=torch.float32,
                              device=device)
        return raws[c.src]

    # periodic columns gather by the decoded minute_of_week: decode it
    # once up front (a gather of stored bits is exact by construction)
    minute_idx = None
    if any(c.kind == "periodic" for c in columns):
        mspec = next(c for c in columns if c.field == "minute_of_week")
        minute_idx = decode_column(mspec, True)

    by_field: Dict[str, List[ColumnSpec]] = {}
    for c in columns:
        by_field.setdefault(c.field, []).append(c)

    fields: Dict[str, Any] = {"row0": row0}
    for field, specs in by_field.items():
        int_field = field in ("minute_of_week", "scen_flags")
        if len(specs) == 1 and specs[0].col < 0:
            fields[field] = decode_column(specs[0], int_field)
        else:
            cols = [decode_column(c, int_field) for c in sorted(specs, key=lambda c: c.col)]
            fields[field] = torch.stack(cols, dim=1)
    return MarketData(**fields)


class ShardDecoder:
    """``slab_dict -> MarketData`` on ``device`` for one tape geometry
    (every shard shares it).  The whole-tape tables and each fused
    group's divisors are moved to the device once, here, so a decode
    makes no host-to-device copy of its own; slabs, bases and raws are
    taken as they come (device tensors, or host arrays copied over)."""

    def __init__(self, tape: CompressedTape, mode: str, device):
        self.columns, self.shard_bars = tape.columns, tape.shard_bars
        self.window_size = tape.window_size
        self.mode = validate_compress_mode(mode)
        self.device = torch.device(device)
        probe = shard_arrays(tape, 0)
        self.tables = tuple(_on(t, self.device) for t in probe["tables"])
        self.invs = tuple(_on(v, self.device) for v in probe["invs"])

    def __call__(self, slab: Dict[str, Any]) -> MarketData:
        dev = self.device
        slab = dict(
            slab,
            slabs=tuple(_on(s, dev) for s in slab["slabs"]),
            bases=tuple(_on(b, dev) for b in slab["bases"]),
            raws=tuple(_on(r, dev) for r in slab["raws"]),
            tables=self.tables,
            invs=self.invs,
        )
        return _decode_shard_impl(self.columns, self.shard_bars, self.window_size,
                                  self.mode, slab)


def make_shard_decoder(tape: CompressedTape, mode: str, device=None) -> ShardDecoder:
    """The decoder of one tape geometry onto ``device`` (the device the
    tape's slabs are on when ``device`` is None)."""
    if device is None:
        first = (tape.slabs or tape.raws)[0]
        device = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")
    return ShardDecoder(tape, mode, device)


def decode_shard_ref(tape: CompressedTape, k: int, device="cpu") -> MarketData:
    """The plain decode of shard ``k`` (the parity oracle: every q16
    group through :func:`decode_q16_ref`)."""
    return ShardDecoder(tape, "off", device)(shard_arrays(tape, k))


def device_tape(tape: CompressedTape, device) -> CompressedTape:
    """Every compressed slab, base, raw and table as a tensor on
    ``device``."""
    device = torch.device(device)
    return tape._replace(
        slabs=tuple(_on(s, device) for s in tape.slabs),
        bases=tuple(_on(b, device) for b in tape.bases),
        raws=tuple(_on(r, device) for r in tape.raws),
        tables=tuple(_on(t, device) for t in tape.tables),
    )
