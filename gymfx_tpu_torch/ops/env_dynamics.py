"""K2 and K3: the bar venue's per-step ledger dynamics.

  K2 :func:`fill_brackets` replaces ``gymfx_tpu/ops/env_dynamics.py::
     fused_fill_brackets``: advance-gated ``broker.fill_pending`` ->
     ``broker.check_brackets`` -> financing accrual ``pos * close * rate``,
     plus the ``order_denied_min_quantity`` counter.
  K3 :func:`mark_reward` replaces ``fused_mark_reward``: gated
     ``broker.mark_to_market`` -> drawdown carries -> ``rewards.
     compute_reward`` (pnl, dd or sharpe); returns the base reward.  The
     sharpe reward, which the JAX package computes on its XLA path only,
     also reads and writes its (N, W) ring buffer and the buffer's write
     slot and length (:func:`sharpe_outputs`).

Each param is a 0-d tensor (one value for every env) or an ``(N,)``
column (one value per row: a portfolio's pairs; the Pallas kernels' ``(b,
NP)`` params block, though their ``custom_vmap`` rules keep only its
first row, ROADMAP.md Queue 3); :func:`param_rows` gives the kernels'
mask of which is which.  The plain versions broadcast an ``(N,)`` param
as they do a 0-d one.

The kernels are ``fill_brackets_kernel`` (8 instantiations, by
slip_match, financing and the ohlc policy) and ``mark_reward_kernel`` in
``csrc/env_kernels.cu``: one thread per env in CTAs of 64, every load
first, reading the EnvState field tensors as structure-of-arrays
pointers and writing fresh output tensors (the input state is left as it
was, but for K2's counter column, which it advances in place); K2's 18
outputs are rows of three blocks, one per type (:func:`fill_outputs`),
K3's 7 rows of one block (:func:`mark_outputs`).  Beside each wrapper is its plain
version (:func:`fill_brackets_plain`, :func:`mark_reward_plain`): the
same chain of ``core/broker`` / ``core/rewards`` functions that
``core/env.step`` would run.  A CPU tensor runs the plain version; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import functools
import operator

import torch

from gymfx_tpu_torch.core import broker, rewards
from gymfx_tpu_torch.core.types import EXEC_DIAG_INDEX, EnvConfig, EnvParams, EnvState, not_ported
from gymfx_tpu_torch.ops import _build

# the kernels' pointer contract (csrc/env_kernels.cu FillArgs / MarkArgs)
FILL_FLOAT_FIELDS = (
    "pos", "entry_price", "cash_delta", "commission_paid",
    "last_trade_cost", "trade_pnl_sum", "trade_pnl_sumsq",
    "open_trade_commission", "pending_target", "pending_sl",
    "pending_tp", "bracket_sl", "bracket_tp",
)
FILL_BOOL_FIELDS = ("pending_active", "pending_forced")
FILL_INT_FIELDS = ("trade_count", "trades_won", "trades_lost")
FILL_PARAM_FIELDS = ("slippage", "commission", "price_tick", "size_step", "min_qty")
MARK_FLOAT_FIELDS = (
    "pos", "cash_delta", "equity_delta", "prev_equity_delta",
    "peak_equity_delta", "max_drawdown_money", "max_drawdown_pct",
    "reward_peak",
)
MARK_OUT_FIELDS = (
    "equity_delta", "prev_equity_delta", "peak_equity_delta",
    "max_drawdown_money", "max_drawdown_pct", "reward_peak",
)
MARK_PARAM_FIELDS = ("initial_cash", "reward_scale", "penalty_lambda")

_LIMIT_FILL_CODES = {"cross": 0, "touch": 1, "conservative": 2}
_REWARD_CODES = {"pnl_reward": 0, "dd_penalized_reward": 1, "sharpe_reward": 2}


def select(pred, a: EnvState, b: EnvState) -> EnvState:
    """Per env: ``a`` where ``pred`` else ``b``.  A field both states
    share is the same tensor and is passed through (selecting between two
    equal values returns that value)."""
    def one(x, y):
        if x is y:
            return x
        return torch.where(pred.view(-1, *([1] * (x.dim() - 1))), x, y)

    return EnvState(*(one(x, y) for x, y in zip(a, b)))


def fill_brackets_plain(st: EnvState, o, h, l, c, accrual, advance,
                        cfg: EnvConfig, params: EnvParams) -> EnvState:
    """Plain version of K2 (the JAX package's core/env.step steps 1, 2, 2b)."""
    st = select(advance, broker.fill_pending(st, o, params, cfg, h, l), st)
    st = select(advance, broker.check_brackets(st, o, h, l, cfg, params), st)
    if cfg.financing_enabled:
        accrued = st.pos * c * accrual
        st = st._replace(cash_delta=st.cash_delta + torch.where(advance, accrued, 0.0))
    return st


def mark_reward_plain(st: EnvState, c, mark_pred, live, cfg: EnvConfig,
                      params: EnvParams):
    """Plain version of K3 (core/env.step step 4 and the reward block).
    Returns (new_state, base_reward)."""
    st = select(mark_pred, broker.mark_to_market(st, c, params), st)
    return rewards.compute_reward(st, cfg, params, live)


def param_rows(par, names, n: int, device) -> int:
    """The kernels' ``par_rows`` mask for the params ``par``: bit k set
    where param k is an ``(n,)`` column, clear where it is 0-d (raises on
    any other shape, dtype or device)."""
    rows = 0
    for k, t in enumerate(par):
        shape = ()
        if t.dim():
            rows |= 1 << k
            shape = (n,)
        if t.dtype is not torch.float32 or t.shape != shape or t.device != device \
                or not t.is_contiguous():
            _build.require(t, names[k], torch.float32, shape, device)
    return rows


def _cuda_device(st: EnvState, cfg: EnvConfig) -> torch.device:
    device = st.pos.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if cfg.dtype != torch.float32 or st.pos.dtype != torch.float32:
        raise not_ported("the env kernels in a compute dtype other than float32", 7)
    return device


# K2's outputs: one (fields, N) block per type, handed out as row views
_FILL_OUT_GROUPS = (
    (FILL_FLOAT_FIELDS, torch.float32),
    (FILL_BOOL_FIELDS, torch.bool),
    (FILL_INT_FIELDS, torch.int32),
)
FILL_OUT_FIELDS = FILL_FLOAT_FIELDS + FILL_BOOL_FIELDS + FILL_INT_FIELDS
_FILL_BAR_NAMES = ("open", "high", "low", "close", "accrual")
_FILL_PARAM_NAMES = tuple(f"param {k}" for k in FILL_PARAM_FIELDS)
_DENIED_COLUMN = EXEC_DIAG_INDEX["order_denied_min_quantity"]
_fill_inputs = operator.attrgetter(*FILL_OUT_FIELDS)
_fill_params = operator.attrgetter(*FILL_PARAM_FIELDS)
# the kernel's FillArgs: 18 input fields, 3 output blocks, the counter
# block, advance, 5 bar columns, 5 params
FILL_POINTERS = len(FILL_OUT_FIELDS) + len(_FILL_OUT_GROUPS) + 2 + 5 + len(FILL_PARAM_FIELDS)


def fill_outputs(n: int, device):
    """K2's 18 output fields in three allocations, one (fields, n) block
    per type: returns (blocks, {field: row view}).  Each row is a
    contiguous (n,) tensor and no two overlap, so they stand in for 18
    separate tensors; nothing in the port resizes a state field in place.
    (``torch.save`` of one row saves its whole block.)"""
    blocks = tuple(torch.empty((len(names), n), dtype=dtype, device=device)
                   for names, dtype in _FILL_OUT_GROUPS)
    rows = [row for block in blocks for row in block.unbind(0)]
    return blocks, dict(zip(FILL_OUT_FIELDS, rows))


_fill_flags_cache = {}


def fill_flags(cfg: EnvConfig) -> int:
    """K2's flag word for ``cfg`` (csrc/env_kernels.cu kSlipOpen ...),
    computed once per config object."""
    hit = _fill_flags_cache.get(id(cfg))
    if hit is not None and hit[0] is cfg:
        return hit[1]
    flags = (
        (1 if cfg.slip_open else 0)
        | (2 if cfg.slip_limit else 0)
        | (4 if cfg.slip_match else 0)
        | (8 if cfg.financing_enabled else 0)
        | (_LIMIT_FILL_CODES[cfg.limit_fill_policy] << 4)
        | (64 if cfg.intrabar_collision_policy == "ohlc" else 0)
    )
    _fill_flags_cache[id(cfg)] = (cfg, flags)  # keeps cfg alive, so its id is not reused
    return flags


@functools.lru_cache(maxsize=None)
def _fill_library():
    """The env library, with K2's pointer count checked against the
    kernel source once."""
    lib = _build.load_library()
    if lib.gymfx_fill_pointer_count() != FILL_POINTERS:
        raise RuntimeError("fill_brackets: pointer layout does not match the kernel source")
    return lib


def fill_brackets(st: EnvState, o, h, l, c, accrual, advance, cfg: EnvConfig,
                  params: EnvParams) -> EnvState:
    """K2 on a CUDA state, its plain version on a CPU state.  ``accrual``
    is the bar's financing rate (None unless ``cfg.financing_enabled``).

    The kernel adds the denials to ``st.exec_diag``'s
    ``order_denied_min_quantity`` column in place, so the (N, 17) counter
    block is neither copied nor moved: pass a block you own (core/env.
    transition passes the step's own copy).  The plain version leaves it
    as it was and returns a new block.  The kernel's 18 output fields are
    rows of three blocks (:func:`fill_outputs`)."""
    device = st.pos.device
    if device.type == "cpu":
        return fill_brackets_plain(st, o, h, l, c, accrual, advance, cfg, params)
    _cuda_device(st, cfg)
    n = st.pos.shape[0]
    shape = (n,)
    inputs = _fill_inputs(st)
    _build.require_all(inputs[:13], FILL_FLOAT_FIELDS, torch.float32, shape, device)
    _build.require_all(inputs[13:15], FILL_BOOL_FIELDS, torch.bool, shape, device)
    _build.require_all(inputs[15:], FILL_INT_FIELDS, torch.int32, shape, device)
    _build.require(advance, "advance", torch.bool, shape, device)
    financing = cfg.financing_enabled
    bars = [o, h, l, c, accrual] if financing else [o, h, l, c]
    _build.require_all(bars, _FILL_BAR_NAMES, torch.float32, shape, device)
    par = _fill_params(params)
    rows = param_rows(par, _FILL_PARAM_NAMES, n, device)
    diag = st.exec_diag
    _build.require(diag, "exec_diag", torch.int32, (n, diag.shape[-1]), device)

    lib = _fill_library()
    blocks, outs = fill_outputs(n, device)
    if n:
        ptrs = fill_pointers(inputs, blocks, diag, advance, bars if financing else bars[:3], par)
        _build.check_launch(
            lib.gymfx_fill_brackets(
                ptrs, n, diag.shape[1], _DENIED_COLUMN, fill_flags(cfg), rows,
                _build.stream_handle(device),
            ),
            "fill_brackets",
        )
        fill_brackets.launches += 1
    return st._replace(**outs)


def fill_pointers(inputs, blocks, diag, advance, bars, par):
    """The kernel's FillArgs as a C array: the 18 input fields, the three
    output blocks, the counter block, advance, the bar columns (open,
    high, low, then close and accrual or null) and the 5 params."""
    return _build.pointer_array((*inputs, *blocks, diag, advance, *bars,
                                 *(None,) * (5 - len(bars)), *par))


# K3's outputs: the six carries and the reward, rows of one (7, N) block
MARK_OUTPUTS = MARK_OUT_FIELDS + ("reward",)
MARK_THREADS = 64  # csrc/env_kernels.cu kMarkThreads
_MARK_PARAM_NAMES = tuple(f"param {k}" for k in MARK_PARAM_FIELDS)
_mark_inputs = operator.attrgetter(*MARK_FLOAT_FIELDS)
_mark_params = operator.attrgetter(*MARK_PARAM_FIELDS)
# the kernel's MarkArgs: 8 input fields, the close, mark and live, the 7
# outputs, 3 params
MARK_POINTERS = len(MARK_FLOAT_FIELDS) + 3 + len(MARK_OUTPUTS) + len(MARK_PARAM_FIELDS)


# the kernel's SharpeArgs: the ring buffer, its write slot and length, the
# new buffer, the new slot and length, the annualization factor
SHARPE_POINTERS = 7


def sharpe_outputs(n: int, window: int, device):
    """The sharpe reward's outputs: a new (n, window) f32 ring buffer and
    one (2, n) int32 block whose rows are the write slot and the length."""
    buf = torch.empty((n, window), dtype=torch.float32, device=device)
    counters = torch.empty((2, n), dtype=torch.int32, device=device)
    return buf, counters.unbind(0)


def mark_outputs(n: int, device):
    """K3's 7 outputs in one allocation: returns (block, rows), the
    (7, n) f32 block and its rows in :data:`MARK_OUTPUTS` order.  Each row
    is a contiguous (n,) tensor and no two overlap, as :func:`fill_outputs`'
    rows (``torch.save`` of one row saves the whole block)."""
    block = torch.empty((len(MARK_OUTPUTS), n), dtype=torch.float32, device=device)
    return block, block.unbind(0)


@functools.lru_cache(maxsize=None)
def _mark_library():
    """The env library, with K3's pointer count and CTA size checked
    against the kernel source once."""
    lib = _build.load_library()
    if (lib.gymfx_mark_pointer_count() != MARK_POINTERS
            or lib.gymfx_sharpe_pointer_count() != SHARPE_POINTERS
            or lib.gymfx_mark_threads() != MARK_THREADS):
        raise RuntimeError("mark_reward: pointer layout or CTA size does not match the kernel source")
    return lib


def mark_pointers(inputs, c, mark_pred, live, outs, par):
    """The kernel's MarkArgs as a C array: the 8 input fields, the close,
    the two flags, the 7 outputs and the 3 params."""
    return _build.pointer_array((*inputs, c, mark_pred, live, *outs, *par))


_NO_SHARPE = (None,) * SHARPE_POINTERS


def sharpe_pointers(st: EnvState, buf, idx, length, annualization):
    """The kernel's SharpeArgs as a C array."""
    return _build.pointer_array((st.reward_buffer, st.reward_buffer_idx, st.reward_buffer_len,
                                 buf, idx, length, annualization))


def mark_reward(st: EnvState, c, mark_pred, live, cfg: EnvConfig,
                params: EnvParams):
    """K3 on a CUDA state, its plain version on a CPU state.  Returns
    (new_state, base_reward); the kernel's 7 outputs are rows of one
    block (:func:`mark_outputs`), and under the sharpe reward the ring
    buffer and its two counters are new tensors too
    (:func:`sharpe_outputs`).  ``mark_reward.sharpe_launches`` counts the
    launches of the sharpe path among ``mark_reward.launches``."""
    device = st.pos.device
    if device.type == "cpu":
        return mark_reward_plain(st, c, mark_pred, live, cfg, params)
    _cuda_device(st, cfg)
    n = st.pos.shape[0]
    shape = (n,)
    inputs = _mark_inputs(st)
    _build.require_all(inputs, MARK_FLOAT_FIELDS, torch.float32, shape, device)
    _build.require(c, "close", torch.float32, shape, device)
    _build.require_all((mark_pred, live), ("mark_pred", "live"), torch.bool, shape, device)
    par = _mark_params(params)
    rows = param_rows(par, _MARK_PARAM_NAMES, n, device)
    sharpe = cfg.reward == "sharpe_reward"
    window = cfg.sharpe_window
    if sharpe:
        _build.require(st.reward_buffer, "reward_buffer", torch.float32, (n, window), device)
        _build.require_all((st.reward_buffer_idx, st.reward_buffer_len),
                           ("reward_buffer_idx", "reward_buffer_len"), torch.int32, shape, device)
        _build.require(params.annualization_factor, "param annualization_factor",
                       torch.float32, (), device)
    lib = _mark_library()
    _, outs = mark_outputs(n, device)
    if sharpe:
        ring, (ring_idx, ring_len) = sharpe_outputs(n, window, device)
    if n:
        sharpe_ptrs = (sharpe_pointers(st, ring, ring_idx, ring_len, params.annualization_factor)
                       if sharpe else _build.pointer_array(_NO_SHARPE))
        _build.check_launch(
            lib.gymfx_mark_reward(mark_pointers(inputs, c, mark_pred, live, outs, par),
                                  sharpe_ptrs, n, _REWARD_CODES[cfg.reward], window, rows,
                                  _build.stream_handle(device)),
            "mark_reward",
        )
        mark_reward.launches += 1
        if sharpe:
            mark_reward.sharpe_launches += 1
    eq, prev, peak, dd_money, dd_pct, reward_peak, reward = outs
    st = st._replace(equity_delta=eq, prev_equity_delta=prev, peak_equity_delta=peak,
                     max_drawdown_money=dd_money, max_drawdown_pct=dd_pct,
                     reward_peak=reward_peak)
    if sharpe:
        st = st._replace(reward_buffer=ring, reward_buffer_idx=ring_idx,
                         reward_buffer_len=ring_len)
    return st, reward


fill_brackets.launches = 0
mark_reward.launches = 0
mark_reward.sharpe_launches = 0
