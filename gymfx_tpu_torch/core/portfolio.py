"""The multi-pair portfolio environment, batched over books.

The port of ``gymfx_tpu/core/portfolio.py``: :class:`PortfolioData`,
:class:`PortfolioConfig`, :class:`PortfolioParams`, :class:`PortfolioState`,
:func:`load_portfolio_frames` (:140-165), :func:`build_conversion_factors`
(:167-200), :func:`reset` and :func:`step` (:204-405), the obs and info
dicts (:406-516) and :class:`PortfolioEnvironment` (:519-766).

Where the JAX package vmaps ``core.env.step`` over a book's I pairs (and
a trainer vmaps that over envs and members), the port steps every pair
of every book as one batch of rows: ``B`` books of ``I`` pairs are
``R = B * I`` rows of one EnvState, row ``b * I + i`` pair ``i`` of book
``b``, so a portfolio step launches one K2 and one K3 for all rows.  Each
row reads its own pair's bars: the I tapes lie end to end in one
MarketData, each pair's block ``stride`` rows long, and the tape's
``row0`` is a per-row tensor of bases (``-i * stride``), which
``core/obs.local_rows`` subtracts from every cursor, as it rebases a
streamed shard.  Each row reads its own params: a param on which the
pairs differ is an ``(R,)`` column, one the pairs share stays 0-d
(:meth:`PortfolioEnvironment.rows`); K2 and K3 take both forms.  Each
pair may bind its own execution cost profile (``portfolio_profiles``),
and with financing each pair's tape holds its own rollover accrual
column, which a row reads through the same bases.

The account couples the pairs as in the JAX package: per-bar quote ->
account conversion factors, the greedy margin preflight in pair order,
the equity mark (or the realized-pnl sweep), the account reward, the
stage-B penalty and bankruptcy.  Every sum over a book's pairs runs in
pair order from zero (:func:`pair_sum`), the JAX reduction's order.

Host loading: the pair CSVs through the port's own reader
(``data/feed.load_dataframe``), rows with unparseable timestamps dropped,
then joined on the timestamps all pairs share (the sorted intersection:
the JAX package's pandas inner join, row for row).  With
``feed="scengen"`` the book is generated instead (correlated pairs on one
grid, no join; K10 on the card); ``feed="curriculum"`` binds tape 0 and
``data/tapes.PortfolioCurriculumSampler`` holds the other books.  The
venue is the pair config's: with ``venue="lob"`` every row steps through
the LOB venue, as the JAX package's vmapped ``core.env.step`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gymfx_tpu_torch import resolve_device
from gymfx_tpu_torch.core import broker, rewards
from gymfx_tpu_torch.core import env as env_core
from gymfx_tpu_torch.core.broker import add_count_
from gymfx_tpu_torch.core.obs import CALENDAR_OBS_KEYS, build_obs
from gymfx_tpu_torch.core.types import (
    EXEC_DIAG_INDEX,
    TERMINATION_BANKRUPT,
    TERMINATION_EXHAUSTED,
    EnvConfig,
    EnvParams,
    EnvState,
    _parse_profile,
    initial_state,
    make_env_config,
    make_env_params,
    not_ported,
)
from gymfx_tpu_torch.data.calendar import FORCE_CLOSE_FEATURE_KEYS
from gymfx_tpu_torch.data.compress import validate_compress_mode
from gymfx_tpu_torch.data.feed import Frame, MarketData, MarketDataset, load_dataframe


class PortfolioData(NamedTuple):
    pair: MarketData   # the I tapes end to end, each pair's block ``stride`` rows
    conv: Any          # (n, I) quote -> account conversion factors
    close: Any         # (n, I) each pair's close
    force_close: Any   # (n, 4) pair 0's stage-B features (shared timestamps)
    stride: int = 0

    @property
    def n_pairs(self) -> int:
        return int(self.close.shape[1])


@dataclasses.dataclass(frozen=True)
class PortfolioConfig:
    n_pairs: int
    n_bars: int
    window_size: int
    pair_cfg: EnvConfig    # the per-pair step's config
    acct_cfg: EnvConfig    # the account's reward and penalty config
    enforce_margin_preflight: bool = False
    enforce_margin_closeout: bool = False
    margin_model: str = "leveraged"
    sweep_realized_pnl: bool = False
    dtype: Any = torch.float32


class PortfolioParams(NamedTuple):
    pair: EnvParams        # per pair (I,) leaves; bound to rows: (R,) or 0-d
    acct: EnvParams        # 0-d (account currency)


class PortfolioState(NamedTuple):
    pairs: EnvState        # R = B * I rows, book-major
    acct: EnvState         # (B,) account carry
    swept_realized: Any    # (B,) account currency
    prev_realized_q: Any   # (B, I) quote currency


# ---------------------------------------------------------------------------
# host-side data loading
# ---------------------------------------------------------------------------
def load_portfolio_frames(files: Dict[str, str], *, date_column: str = "DATE_TIME",
                          price_column: str = "CLOSE",
                          max_rows: Optional[int] = None) -> Tuple[List[str], Dict[str, Frame]]:
    """Load and time-align several pair CSVs on their shared timestamps
    (an inner join).  Returns (pair names, per-pair aligned frames)."""
    frames: Dict[str, Frame] = {}
    for pair, path in files.items():
        frame = load_dataframe({"input_data_file": path, "date_column": date_column,
                                "price_column": price_column, "max_rows": max_rows})
        if np.isnat(frame.timestamps).all() and len(frame):
            raise KeyError(date_column)
        frames[pair] = frame
    common = None
    for frame in frames.values():
        ts = np.unique(frame.timestamps)
        common = ts if common is None else np.intersect1d(common, ts)
    if common is None or len(common) < 3:
        raise ValueError("portfolio pairs share too few timestamps")
    aligned = {}
    for pair, frame in frames.items():
        first = {}
        for k, t in enumerate(frame.timestamps.tolist()):
            first.setdefault(t, k)
        rows = np.array([first[t] for t in common.tolist()], dtype=np.int64)
        aligned[pair] = Frame({k: v[rows] for k, v in frame.columns.items()},
                              frame.timestamps[rows])
    return list(files.keys()), aligned


def build_conversion_factors(pairs: Sequence[str], closes: np.ndarray,
                             account_currency: str = "USD") -> np.ndarray:
    """(n, I) float64 quote-currency -> account-currency factors; crosses
    bridge through another pair in the book that quotes or bases the
    account currency."""
    n = closes.shape[0]
    parsed = [p.replace("/", "_").split("_", 1) for p in pairs]
    conv = np.ones((n, len(pairs)))
    for i, (base, quote) in enumerate(parsed):
        if quote == account_currency:
            conv[:, i] = 1.0
        elif base == account_currency:
            conv[:, i] = 1.0 / closes[:, i]
        else:
            bridge = None
            for j, (b2, q2) in enumerate(parsed):
                if b2 == quote and q2 == account_currency:
                    bridge = closes[:, j]
                    break
                if b2 == account_currency and q2 == quote:
                    bridge = 1.0 / closes[:, j]
                    break
            if bridge is None:
                raise ValueError(
                    f"pair {pairs[i]}: no direct conversion from {quote} to "
                    f"{account_currency} and no bridging pair in the book"
                )
            conv[:, i] = bridge
    return conv


def concat_tapes(tapes: Sequence[MarketData], stride: int) -> MarketData:
    """The I pair tapes end to end: every array field's pair block padded
    with zeros to ``stride`` rows (never read: each array's own rows fit in
    it), ``row0`` 0 until :func:`bind_rows` sets the per-row bases."""
    fields = {}
    for name in MarketData._fields:
        if name == "row0":
            continue
        parts = []
        for tape in tapes:
            x = np.asarray(getattr(tape, name))
            pad = np.zeros((stride - x.shape[0], *x.shape[1:]), dtype=x.dtype)
            parts.append(np.concatenate([x, pad]))
        fields[name] = np.ascontiguousarray(np.concatenate(parts))
    return MarketData(row0=0, **fields)


def pair_sum(x):
    """Σ over the last (pair) axis, pair 0 first, from zero: the order of
    the JAX package's reduction over a book's pairs."""
    s = torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        s = s + x[..., i]
    return s


def _rows_of(x, n_pairs: int):
    """A book flag (B,) as its rows' flags (R,)."""
    return x.repeat_interleave(n_pairs)


# ---------------------------------------------------------------------------
# the step: reset / step over B books
# ---------------------------------------------------------------------------
def reset(cfg: PortfolioConfig, params: PortfolioParams, data: PortfolioData):
    """Fresh episodes of every book of ``data``'s rows (:func:`bind_rows`):
    (state, obs)."""
    n_rows = data.pair.row0.shape[0]
    books = n_rows // cfg.n_pairs
    pairs, obs_i = env_core.reset(cfg.pair_cfg, params.pair, data.pair, n_rows)
    device = pairs.pos.device
    acct = initial_state(cfg.acct_cfg, books, device)
    eq = pair_sum(data.conv[0] * pairs.equity_delta.view(books, cfg.n_pairs)).to(
        acct.equity_delta.dtype)
    acct = acct._replace(equity_delta=eq, prev_equity_delta=eq,
                         peak_equity_delta=torch.maximum(acct.peak_equity_delta, eq))
    state = PortfolioState(
        pairs=pairs, acct=acct,
        swept_realized=torch.zeros(books, dtype=cfg.dtype, device=device),
        prev_realized_q=torch.zeros((books, cfg.n_pairs), dtype=cfg.dtype, device=device),
    )
    return state, portfolio_obs(obs_i, state, data, cfg, params)


def step(cfg: PortfolioConfig, params: PortfolioParams, data: PortfolioData,
         state: PortfolioState, actions, with_info: bool = True):
    """One step of every book: ``actions`` (B, I) ints in {0=hold, 1=long,
    2=short, 3=flat}.  Returns (state, obs, reward (B,), done (B,), info);
    ``with_info=False`` returns None for the info dict (a trainer's step)."""
    n_pairs = cfg.n_pairs
    books = state.acct.t.shape[0]
    n_rows = books * n_pairs
    was_terminated = state.acct.terminated
    live = ~was_terminated
    pp = params.pair

    pairs, _r, _d, _parts = env_core.transition(
        cfg.pair_cfg, pp, data.pair, state.pairs, actions.reshape(n_rows))
    obs_i = build_obs(pairs, data.pair, cfg.pair_cfg, pp)
    if with_info:
        atr = torch.where(
            pairs.tr_len > 0,
            pairs.tr_buffer.sum(dim=1) / torch.clamp_min(pairs.tr_len, 1).to(pairs.tr_buffer.dtype),
            0.0,
        )

    t_new = pairs.t.view(books, n_pairs)[:, 0].contiguous()
    conv = data.conv[t_new.long()]                # (B, I)
    close = data.close[t_new.long()].reshape(n_rows)
    pos = pairs.pos.view(books, n_pairs)

    # ---- the account's margin preflight over newly submitted orders,
    # greedy in pair order
    if cfg.enforce_margin_preflight:
        opening = broker.opening_units(pairs.pos, pairs.pending_target)
        required_q = opening * close * pp.margin_init
        if cfg.margin_model == "leveraged":
            required_q = required_q / torch.clamp_min(pp.leverage, 1e-12)
        required = required_q.view(books, n_pairs) * conv
        realized_q = (pairs.cash_delta + pairs.pos * pairs.entry_price).view(books, n_pairs)
        if cfg.sweep_realized_pnl:
            free = (params.acct.initial_cash + state.swept_realized
                    + pair_sum(conv * (realized_q - state.prev_realized_q)))
        else:
            free = params.acct.initial_cash + pair_sum(conv * realized_q)
        want = (pairs.pending_active & (opening > 0)).view(books, n_pairs)
        granted_sum = torch.zeros_like(free)
        granted = []
        for i in range(n_pairs):
            ok = want[:, i] & (granted_sum + required[:, i] <= free)
            granted_sum = granted_sum + torch.where(ok, required[:, i], 0.0)
            granted.append(ok)
        denied = (want & ~torch.stack(granted, dim=1)).reshape(n_rows)
        pairs = pairs._replace(
            pending_active=pairs.pending_active & ~denied,
            pending_target=torch.where(denied, 0.0, pairs.pending_target),
            pending_sl=torch.where(denied, 0.0, pairs.pending_sl),
            pending_tp=torch.where(denied, 0.0, pairs.pending_tp),
            exec_diag=add_count_(pairs.exec_diag, "preflight_denied", denied),
        )

    # ---- the account's equity mark
    acct = state.acct
    n = cfg.n_bars
    advance = live & acct.started & (acct.t < n - 1)
    exhausted = live & acct.started & (acct.t >= n - 1)
    marking = advance | (live & ~acct.started)
    if cfg.sweep_realized_pnl:
        realized_q = (pairs.cash_delta + pairs.pos * pairs.entry_price).view(
            books, n_pairs).to(state.prev_realized_q.dtype)
        unrealized_q = pairs.equity_delta.view(books, n_pairs) - realized_q
        swept = state.swept_realized + pair_sum(conv * (realized_q - state.prev_realized_q)).to(
            state.swept_realized.dtype)
        swept = torch.where(marking, swept, state.swept_realized)
        prev_realized_q = torch.where(marking[:, None], realized_q, state.prev_realized_q)
        eq = (swept + pair_sum(conv * unrealized_q)).to(acct.equity_delta.dtype)
    else:
        swept = state.swept_realized
        prev_realized_q = state.prev_realized_q
        eq = pair_sum(conv * pairs.equity_delta.view(books, n_pairs)).to(acct.equity_delta.dtype)
    acct = acct._replace(
        t=t_new,
        started=acct.started | live,
        prev_equity_delta=torch.where(marking, acct.equity_delta, acct.prev_equity_delta),
        equity_delta=torch.where(marking, eq, acct.equity_delta),
        pos=pair_sum(pos.abs()).to(acct.pos.dtype),
    )
    peak = torch.where(marking, torch.maximum(acct.peak_equity_delta, acct.equity_delta),
                       acct.peak_equity_delta)
    money_down = peak - acct.equity_delta
    peak_equity = params.acct.initial_cash + peak
    acct = acct._replace(
        peak_equity_delta=peak,
        max_drawdown_money=torch.maximum(acct.max_drawdown_money, money_down),
        max_drawdown_pct=torch.maximum(
            acct.max_drawdown_pct,
            torch.where(peak_equity > 0, money_down / peak_equity * 100.0, 0.0),
        ),
    )

    # ---- the account's maintenance-margin closeout: the whole book
    # flattens at the next open
    if cfg.enforce_margin_closeout:
        maint = pair_sum(
            broker.maintenance_margin(pairs.pos, close, pp, cfg.margin_model).view(books, n_pairs)
            * conv)
        equity_now = params.acct.initial_cash + acct.equity_delta
        breach = advance & (pos != 0).any(dim=1) & (equity_now < maint)
        breach_rows = _rows_of(breach, n_pairs)
        held = breach_rows & (pairs.pos != 0)
        pairs = pairs._replace(
            pending_active=torch.where(breach_rows, pairs.pos != 0, pairs.pending_active),
            pending_target=torch.where(breach_rows, 0.0, pairs.pending_target),
            pending_sl=torch.where(breach_rows, 0.0, pairs.pending_sl),
            pending_tp=torch.where(breach_rows, 0.0, pairs.pending_tp),
            pending_forced=pairs.pending_forced | held,
            exec_diag=add_count_(pairs.exec_diag, "margin_closeouts", held),
        )

    acct, base_reward = rewards.compute_reward(acct, cfg.acct_cfg, params.acct, live)
    fc_row = torch.clamp_max(t_new.long() + 1, n - 1)
    penalty = rewards.force_close_penalty(acct, data.force_close[fc_row], cfg.acct_cfg,
                                          params.acct)
    penalty = torch.where(live, penalty, 0.0)
    reward = base_reward - penalty

    # ---- the account's termination
    equity = params.acct.initial_cash + acct.equity_delta
    broke = equity <= params.acct.min_equity
    terminated = was_terminated | exhausted | (live & broke)
    reason_now = torch.where(live & broke, TERMINATION_BANKRUPT,
                             torch.where(exhausted, TERMINATION_EXHAUSTED, 0)).to(torch.int32)
    acct = acct._replace(
        terminated=terminated,
        termination_reason=torch.where(was_terminated, acct.termination_reason, reason_now),
    )
    pairs = pairs._replace(terminated=pairs.terminated | _rows_of(terminated, n_pairs))

    new_state = PortfolioState(pairs=pairs, acct=acct, swept_realized=swept,
                               prev_realized_q=prev_realized_q)
    obs = portfolio_obs(obs_i, new_state, data, cfg, params)
    info = None
    if with_info:
        info = portfolio_info(atr.view(books, n_pairs), new_state, conv, cfg, params)
        info["reward"] = reward
        info["force_close_reward_penalty"] = penalty
    return new_state, obs, reward, terminated, info


def portfolio_obs(obs_i: Dict[str, Any], state: PortfolioState, data: PortfolioData,
                  cfg: PortfolioConfig, params: PortfolioParams) -> Dict[str, Any]:
    """The rows' obs blocks in the portfolio layout, per book: window
    blocks (B, window, I) (bars leading, pairs as channels; features
    (B, window, I * F)), per-pair scalars (B, I), account scalars (B, 1)."""
    n_pairs = cfg.n_pairs
    books = state.acct.t.shape[0]
    acct = state.acct
    pa = params.acct
    obs: Dict[str, Any] = {}
    if "features" in obs_i:
        f = obs_i["features"]
        w = f.shape[1]
        obs["features"] = f.view(books, n_pairs, w, -1).permute(0, 2, 1, 3).reshape(books, w, -1)
    if "prices" in obs_i:
        obs["prices"] = obs_i["prices"].view(books, n_pairs, -1).transpose(1, 2)
        obs["returns"] = obs_i["returns"].view(books, n_pairs, -1).transpose(1, 2)
    if "position" in obs_i:
        obs["position"] = obs_i["position"].view(books, n_pairs)
        obs["unrealized_pnl_norm"] = obs_i["unrealized_pnl_norm"].view(books, n_pairs)
    initial = torch.where(pa.initial_cash == 0, 1.0, pa.initial_cash)
    obs["equity_norm"] = (acct.equity_delta / initial).to(torch.float32)[:, None]
    # a float32 division by a tensor: the card divides by a Python scalar
    # as a multiply by its reciprocal, an ulp off the JAX package's quotient
    remaining = torch.clamp_min(cfg.n_bars - (acct.t + 1), 0).to(torch.float32)
    obs["steps_remaining_norm"] = (
        remaining / torch.full_like(remaining, float(max(1, cfg.n_bars))))[:, None]
    # timestamp blocks are the same on every pair: pair 0's copy; an
    # account-dependent calendar entry comes from the account below
    account_dependent = ("margin_available_norm", "margin_closeout_percent")
    shared_keys = set(FORCE_CLOSE_FEATURE_KEYS) | set(CALENDAR_OBS_KEYS)
    handled = {"position", "unrealized_pnl_norm", "equity_norm", "steps_remaining_norm",
               *account_dependent}
    for key, val in obs_i.items():
        if key in obs or key in handled:
            continue
        per_book = val.view(books, n_pairs, *val.shape[1:])
        obs[key] = per_book[:, 0] if key in shared_keys else per_book
    if "margin_available_norm" in obs_i:
        t = acct.t.long()
        close = data.close[t].reshape(books * n_pairs)
        maint = pair_sum(broker.maintenance_margin(state.pairs.pos, close, params.pair,
                                                   cfg.margin_model).view(books, n_pairs)
                         * data.conv[t])
        equity = pa.initial_cash + acct.equity_delta
        pct = torch.where(equity > 0, maint / torch.clamp_min(equity, 1e-30), 100.0)
        pct = torch.where((state.pairs.pos != 0).view(books, n_pairs).any(dim=1), pct, 0.0)
        obs["margin_closeout_percent"] = torch.clamp(pct, 0.0, 100.0)[:, None].to(torch.float32)
        obs["margin_available_norm"] = ((pa.initial_cash + acct.equity_delta) / initial)[
            :, None].to(torch.float32)
    return obs


def portfolio_info(atr, state: PortfolioState, conv, cfg: PortfolioConfig,
                   params: PortfolioParams) -> Dict[str, Any]:
    """The account's info dict, per book; per-pair entries (B, I)."""
    books, n_pairs = atr.shape
    pairs = state.pairs

    def per_pair(x):
        return x.view(books, n_pairs, *x.shape[1:])

    return {
        "equity": params.acct.initial_cash + state.acct.equity_delta,
        "equity_delta": state.acct.equity_delta,
        "positions": per_pair(broker.sign(pairs.pos).to(torch.int32)),
        "position_units": per_pair(pairs.pos),
        "bar_index": state.acct.t + 1,
        "trades": pair_sum(per_pair(pairs.trade_count)).to(torch.int32),
        "commission_paid": pair_sum(conv * per_pair(pairs.commission_paid)),
        "blocked_margin": pair_sum(
            per_pair(pairs.exec_diag[:, EXEC_DIAG_INDEX["preflight_denied"]])).to(torch.int32),
        "margin_closeouts": pair_sum(
            per_pair(pairs.exec_diag[:, EXEC_DIAG_INDEX["margin_closeouts"]])).to(torch.int32),
        "bracket_sl": per_pair(pairs.bracket_sl),
        "bracket_tp": per_pair(pairs.bracket_tp),
        "pending_active": per_pair(pairs.pending_active),
        "atr": atr,
        "max_drawdown_money": state.acct.max_drawdown_money,
        "max_drawdown_pct": state.acct.max_drawdown_pct,
        "trades_won": pair_sum(per_pair(pairs.trades_won)).to(torch.int32),
        "trades_lost": pair_sum(per_pair(pairs.trades_lost)).to(torch.int32),
    }


def masked_reset(done, fresh: PortfolioState, cur: PortfolioState) -> PortfolioState:
    """Where ``done`` ((B,) bool) replace each book of ``cur`` with
    ``fresh``'s: a state of as many books, or of one book, which serves
    every book."""
    n_pairs = cur.prev_realized_q.shape[1]

    def one(pred, f, c):
        return torch.where(pred.view(-1, *([1] * (c.dim() - 1))), f, c)

    rows = _rows_of(done, n_pairs)
    books = done.shape[0]
    pairs = EnvState(*(one(rows, f if f.shape[0] == c.shape[0]
                           else f.repeat(books, *([1] * (f.dim() - 1))), c)
                       for f, c in zip(fresh.pairs, cur.pairs)))
    return PortfolioState(
        pairs=pairs,
        acct=EnvState(*(one(done, f, c) for f, c in zip(fresh.acct, cur.acct))),
        swept_realized=one(done, fresh.swept_realized, cur.swept_realized),
        prev_realized_q=one(done, fresh.prev_realized_q, cur.prev_realized_q),
    )


def bind_rows(params: PortfolioParams, data: PortfolioData, books: int):
    """``params`` and ``data`` for ``books`` books of ``I`` pairs, ``R``
    rows: each pair param on which the pairs differ becomes an ``(R,)``
    column (row ``b * I + i`` holds pair ``i``'s value), one they share
    its 0-d value; the tape's ``row0`` becomes the rows' bases."""
    n_pairs = data.n_pairs
    device = data.conv.device
    pair_of_row = torch.arange(books * n_pairs, device=device) % n_pairs

    def column(x):
        if bool((x == x[0]).all()):
            return x[0].clone()
        return x[pair_of_row].contiguous()

    rows = params._replace(pair=EnvParams(*(column(x) for x in params.pair)))
    return rows, data._replace(pair=data.pair._replace(row0=-pair_of_row * data.stride))


# ---------------------------------------------------------------------------
# host-side binding
# ---------------------------------------------------------------------------
_STATIC_PROFILE_FIELDS = (
    "intrabar_collision_policy",
    "limit_fill_policy",
    "margin_model",
    "financing_enabled",
    "enforce_margin_preflight",
)


class PortfolioEnvironment:
    """Pair CSVs -> the portfolio's config, params and tapes on a device.
    ``split=("train"|"eval", frac)`` applies the chronological
    out-of-sample split after the cross-pair join."""

    def __init__(self, config: Dict[str, Any], split: Optional[Tuple[str, float]] = None,
                 device=None):
        from gymfx_tpu_torch.core.runtime import _parse_column_list

        self.device = resolve_device(device)
        self.config = dict(config)
        account = str(config.get("account_currency", "USD"))
        feed = str(config.get("feed") or "replay").lower()
        if validate_compress_mode(config.get("data_compress", "off")) != "off":
            raise ValueError(
                "data_compress applies to single-pair MarketData tapes; "
                "portfolio books (stacked pair leaves + a conversion "
                "matrix) have no compressed form — unset data_compress "
                "for the portfolio env"
            )
        self.curriculum = None
        curriculum_specs = None
        base_config = None
        if feed == "curriculum":
            from gymfx_tpu_torch.data import tapes as tapes_mod

            if split is not None:
                raise ValueError(
                    "feed=curriculum cannot be combined with eval_split "
                    "on the portfolio env (which tape would be cut?); "
                    "evaluate on a held-out book instead"
                )
            curriculum_specs = tapes_mod.parse_tape_specs(config)
            base_config = dict(config)
            # rebind this env to tape 0: the overlay strips the curriculum
            # keys, so the nested tape builds cannot recurse
            config = tapes_mod.overlay_config(config, curriculum_specs[0])
            self.config = dict(config)
            feed = str(config.get("feed") or "replay").lower()
        if feed == "scengen":
            # correlated multi-asset generation on one shared grid (K10 on
            # the card): already aligned, no timestamp join
            from gymfx_tpu_torch.scengen.feed import synthesize_portfolio_frames

            pairs, aligned, _flags = synthesize_portfolio_frames(config, device=self.device)
        else:
            files = config.get("portfolio_files")
            if not files:
                raise ValueError(
                    "portfolio env requires config['portfolio_files'] "
                    "(or feed=scengen for a generated book)"
                )
            pairs, aligned = load_portfolio_frames(
                dict(files),
                date_column=str(config.get("date_column", "DATE_TIME")),
                price_column=str(config.get("price_column", "CLOSE")),
                max_rows=config.get("max_rows"),
            )
        self.pairs = pairs
        w = int(config.get("window_size", 32))
        if split is not None:
            part, frac = split
            frac = float(frac)
            if part not in ("train", "eval"):
                raise ValueError(f"split part must be train|eval, got {part!r}")
            if not 0.0 < frac < 1.0:
                raise ValueError(f"eval_split must be in (0, 1), got {frac!r}")
            n_all = len(next(iter(aligned.values())))
            cut = n_all - int(n_all * frac)
            min_bars = w + 2
            if cut < min_bars or n_all - cut < min_bars:
                raise ValueError(
                    f"eval_split={frac} leaves too few aligned bars (train "
                    f"{cut}, eval {n_all - cut}; both need >= {min_bars})"
                )
            sl = slice(0, cut) if part == "train" else slice(cut, None)
            aligned = {p: Frame({k: v[sl] for k, v in f.columns.items()}, f.timestamps[sl])
                       for p, f in aligned.items()}
        self.timestamps = next(iter(aligned.values())).timestamps
        n = len(self.timestamps)
        if n < w + 2:
            raise ValueError("aligned portfolio data too short for the window")

        profiles = self._load_profiles(config, pairs)
        self._check_static_profile_agreement(profiles)
        feature_columns = _parse_column_list(config.get("feature_columns"), "feature_columns")
        binary = set(_parse_column_list(config.get("feature_binary_columns"),
                                        "feature_binary_columns"))
        cfg0 = make_env_config(config, n_bars=n, n_features=len(feature_columns),
                               binary_mask=tuple(c in binary for c in feature_columns),
                               profile=profiles[0])
        if self.device.type == "cuda" and cfg0.dtype != torch.float32:
            raise not_ported(
                f"compute_dtype {cfg0.dtype} on the card (the kernels are float32)", 7)
        # the legacy portfolio key 'margin_rate' doubles as margin_init and
        # the enforcement flag
        margin_rate = float(config.get("margin_rate", 0.0) or 0.0)
        enforce = bool(cfg0.enforce_margin_preflight or margin_rate > 0)
        enforce_closeout = bool(config.get("enforce_margin_closeout", enforce))
        # the pairs step with the account's gates off
        pair_cfg = dataclasses.replace(
            cfg0, enforce_margin_preflight=False, enforce_margin_closeout=False,
            reward="pnl_reward", stage_b_force_close_reward_penalty=False,
            allow_flat_action=True,
        )
        acct_cfg = dataclasses.replace(cfg0, n_features=0, include_prices=False,
                                       include_agent_state=False)
        self.cfg = PortfolioConfig(
            n_pairs=len(pairs), n_bars=n, window_size=w, pair_cfg=pair_cfg, acct_cfg=acct_cfg,
            enforce_margin_preflight=enforce, enforce_margin_closeout=enforce_closeout,
            margin_model=cfg0.margin_model,
            sweep_realized_pnl=bool(config.get("sweep_realized_pnl", False)),
            dtype=cfg0.dtype,
        )

        from gymfx_tpu_torch.core.runtime import load_financing_rates, validate_profile_latency

        financing_rate_data = load_financing_rates(config, pair_cfg.financing_enabled)
        datasets = [MarketDataset(aligned[p], config) for p in pairs]
        tapes = [ds.build_market_data(
            window_size=w, device=None, feature_columns=tuple(feature_columns),
            feature_scaling=str(config.get("feature_scaling", "rolling_zscore")),
            feature_scaling_window=int(config.get("feature_scaling_window", 256)),
            dtype=cfg0.dtype, financing_rate_data=financing_rate_data, instrument=p,
        ) for p, ds in zip(pairs, datasets)]
        stride = n + w + 1  # the longest array of a tape: the padded window sources
        closes = np.stack([aligned[p].columns["CLOSE"] for p in pairs], 1)
        conv = build_conversion_factors(pairs, closes, account)
        npd = tapes[0].close.dtype
        dev = self.device

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

        tape = concat_tapes(tapes, stride)
        self.data = PortfolioData(
            pair=MarketData(row0=0, **{k: put(v) for k, v in tape._asdict().items()
                                       if k != "row0"}),
            conv=put(conv.astype(npd)),
            close=put(np.stack([t.close for t in tapes], 1)),
            force_close=put(tapes[0].force_close),
            stride=stride,
        )

        sizes = config.get("portfolio_position_sizes")
        if sizes is None:
            sizes = [float(config.get("position_size", 1.0))] * len(pairs)
        overrides = config.get("portfolio_param_overrides") or {}
        per_pair = []
        for i, p in enumerate(pairs):
            cfg_i = dict(config, position_size=float(sizes[i]), min_equity=None)
            if margin_rate > 0 and "margin_init" not in cfg_i:
                cfg_i["margin_init"] = margin_rate
            cfg_i.update(overrides.get(p) or {})
            # a pair's ledger never terminates on its own equity: the
            # account gates bankruptcy
            per_pair.append(make_env_params(cfg_i, pair_cfg, dev, profile=profiles[i])._replace(
                min_equity=torch.tensor(-1e30, dtype=cfg0.dtype, device=dev)))
        self.params = PortfolioParams(
            pair=EnvParams(*(torch.stack(xs) for xs in zip(*per_pair))),
            acct=make_env_params(dict(config), acct_cfg, dev, profile=profiles[0]),
        )
        # honor-or-reject: latency against the shared bar interval
        bar_ms = datasets[0].bar_interval_ms()
        for prof in profiles:
            validate_profile_latency(prof, bar_ms)
        self.timeframe_hours = datasets[0].timeframe_hours
        self._rows: Dict[int, Tuple[PortfolioParams, PortfolioData]] = {}
        if curriculum_specs is not None:
            from gymfx_tpu_torch.data import tapes as tapes_mod

            self.curriculum = tapes_mod.PortfolioCurriculumSampler(
                base_config, curriculum_specs, base_env=self)

    @property
    def n_bars(self) -> int:
        return self.cfg.n_bars

    def rows(self, books: int) -> Tuple[PortfolioParams, PortfolioData]:
        """(params, data) bound to ``books`` books (:func:`bind_rows`),
        built once per count."""
        hit = self._rows.get(books)
        if hit is None:
            hit = self._rows[books] = bind_rows(self.params, self.data, books)
        return hit

    @staticmethod
    def _load_profiles(config: Dict[str, Any], pairs: List[str]):
        """Each pair's profile: its ``portfolio_profiles`` entry, else the
        shared ``execution_cost_profile`` (or None)."""
        shared = _parse_profile(config)
        per_pair_raw = config.get("portfolio_profiles") or {}
        profiles = []
        for p in pairs:
            raw = per_pair_raw.get(p)
            if raw is None:
                profiles.append(shared)
            else:
                profiles.append(_parse_profile({"execution_cost_profile": raw}))
        return profiles

    @staticmethod
    def _check_static_profile_agreement(profiles) -> None:
        """The pairs' profiles bind every pair or none, and agree on the
        fields that are static config (one config serves every row)."""
        bound = [p for p in profiles if p is not None]
        if not bound:
            return
        if len(bound) != len(profiles):
            raise ValueError(
                "portfolio_profiles must cover every pair (or bind one "
                "shared execution_cost_profile): profiles must never be "
                "silently degraded"
            )
        head = bound[0]
        for other in bound[1:]:
            for field in _STATIC_PROFILE_FIELDS:
                if getattr(other, field) != getattr(head, field):
                    raise ValueError(
                        "per-pair profiles must agree on static policy field "
                        f"{field!r} (one step config serves all pairs): "
                        f"{getattr(head, field)!r} != {getattr(other, field)!r}"
                    )

    def reset(self, books: int = 1):
        params, data = self.rows(books)
        return reset(self.cfg, params, data)

    def step(self, state: PortfolioState, actions):
        params, data = self.rows(state.acct.t.shape[0])
        return step(self.cfg, params, data, state, actions)
