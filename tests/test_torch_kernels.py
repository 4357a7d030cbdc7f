"""K1-K3: the port's plain kernel versions against the JAX package.

Inputs are seeded random windows and ledgers with the awkward cases in
them: NaN, ±inf, neutral envs and a binary mask for K1; open, flat,
flipping and huge ledgers, pending orders, forced liquidations,
brackets at the open, inside and across the bar for K2; -inf reward
peaks and zero initial cash for K3.

Pins:
* against the JAX functions evaluated op by op (``jax.disable_jit``):
  BITWISE, over a covering array of the K2 static flags (the card's
  tests hold the kernels to these plain versions over the full grid).  The port, its
  plain versions and its CUDA kernels (-fmad=false) all round every
  multiply and add separately.
* K1 against ``fused_step_obs`` in Pallas interpret mode and the jitted
  XLA path: BITWISE (no multiply-add in its chain).
* K2 / K3 against the interpret-mode Pallas kernels and the jitted XLA
  path: rtol 1e-6, atol 1e-5, on ledgers of small notional.  XLA on the
  CPU contracts ``a - b * c`` into one fused multiply-add inside a
  jitted program, so those results differ from the op-by-op ones by up
  to an ulp of the product (ROADMAP.md Queue 3).

* K2 / K3 with a param row per env (a portfolio's pair rows):
  the plain versions against the JAX chains vmapped over envs and their
  param rows, op by op BITWISE and jitted within the tolerance above;
  the Pallas kernels' vmap rules keep only the first param row (pinned);
  the ``par_rows`` mask and the kernels' argument against their source.

The CUDA kernels against these plain versions: tests/test_torch_cuda.py.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.core import broker as jbroker
from gymfx_tpu.core import rewards as jrewards
from gymfx_tpu.core.env import _select as jselect
from gymfx_tpu.core.obs import scale_feature_window as jax_scale
from gymfx_tpu.core.types import EnvConfig as JaxEnvConfig
from gymfx_tpu.core.types import initial_state as jax_initial_state
from gymfx_tpu.ops import env_dynamics as jdyn
from gymfx_tpu.ops.window_zscore import fused_step_obs

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.ops import env_dynamics, window_zscore
from gymfx_tpu_torch.ops.cases import (
    FLAG_GRID,
    K1_EDGE_SHAPES,
    PAIR_PARAM_ROWS,
    PARAM_SETS,
    env_params,
    exec_diag_case,
    flag_config,
    ledger_case,
    obs_case,
    row_params,
    step_obs_emulated,
    step_obs_row_tiling,
    step_obs_tiling,
)

from test_torch_parity import assert_bitwise, to_np, x64_off

N = 64
# a covering array of the static flags: every slip-switch combination,
# every (limit-fill, collision) pair twice, financing on and off
_PAIRS = list(itertools.product(("cross", "touch", "conservative"), ("worst_case", "ohlc")))
COVERING_FLAGS = [
    (so, sl, sm, k % 2 == 1, *_PAIRS[k % len(_PAIRS)])
    for k, (so, sl, sm) in enumerate(
        list(itertools.product((True, False), (False, True), (False, True)))
        + [(True, False, True), (False, True, False), (True, True, False), (False, False, True)]
    )
]
INTERPRET_FLAGS = [FLAG_GRID[i] for i in (0, 30, 58, 95)]


# ---------------------------------------------------------------- K1
class _ObsCfg:
    def __init__(self, binary_mask, feature_clip):
        self.binary_mask = binary_mask
        self.feature_clip = feature_clip


@pytest.mark.parametrize("mask,clip", [
    ((), 10.0),
    ((False, True, False), 1.5),
    ((), 0.0),
    ((True, False, True), -2.0),
])
def test_step_obs_plain_bitwise_matches_pallas_and_xla(mask, clip):
    win, mean, std, neutral = obs_case()
    cfg = _ObsCfg(binary_mask=mask or (False,) * 3, feature_clip=clip)
    args = tuple(jnp.asarray(x) for x in (win, mean, std, neutral))
    with x64_off():
        xla = jax.vmap(lambda *a: jax_scale(*a, cfg))(*args)
        pallas = jax.vmap(
            lambda *a: fused_step_obs(*a, binary_mask=cfg.binary_mask,
                                      clip=cfg.feature_clip, interpret=True)
        )(*args)
    ours = window_zscore.step_obs(
        *(torch.from_numpy(x) for x in (win, mean, std, neutral)),
        binary_mask=cfg.binary_mask, clip=cfg.feature_clip,
    )
    assert_bitwise(xla, ours, "vs xla")
    assert_bitwise(pallas, ours, "vs pallas interpret")
    assert not torch.isnan(ours).any()


# ---------------------------------------------------------------- K2 / K3
def _flag_config(flags, reward="pnl_reward"):
    tcfg = flag_config(flags, reward)
    slip_open, slip_limit, slip_match, financing, limit_fill, collision = flags
    jcfg = JaxEnvConfig(slip_open=slip_open, slip_limit=slip_limit, slip_match=slip_match,
                        financing_enabled=financing, limit_fill_policy=limit_fill,
                        intrabar_collision_policy=collision, reward=reward,
                        window_size=tcfg.window_size)
    return jcfg, tcfg


def _params(values):
    """(JAX EnvParams, port EnvParams) holding the same f32 values."""
    jparams = jax.tree.map(lambda _: jnp.float32(0), jax_initial_params())
    jparams = jparams._replace(**{k: jnp.float32(v) for k, v in values.items()})
    return jparams, env_params(values, "cpu")


def jax_initial_params():
    from gymfx_tpu.config import DEFAULT_VALUES
    from gymfx_tpu.core.types import make_env_config, make_env_params

    cfg = make_env_config(dict(DEFAULT_VALUES), n_bars=64)
    return make_env_params(dict(DEFAULT_VALUES), cfg)._replace(user=())


def _states(jcfg, fields):
    base = jax_initial_state(jcfg)
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (N, *x.shape)), base)
    jst = jst._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    jst = jst._replace(exec_diag=jnp.asarray(exec_diag_case(N, jst.exec_diag.shape[1])))
    return jst, convert.env_state_from_numpy(jax.tree.map(np.asarray, jst), device="cpu")


def _jax_fill(jcfg, jparams, mode):
    """The JAX K2 chain: "ops" (op by op), "xla" (jitted) or "pallas"
    (fused_fill_brackets in interpret mode), vmapped over envs."""
    def xla(st, o, h, l, c, acc, adv):
        st = jselect(adv, jbroker.fill_pending(st, o, jparams, jcfg, h, l), st)
        st = jselect(adv, jbroker.check_brackets(st, o, h, l, jcfg, jparams), st)
        if jcfg.financing_enabled:
            st = st._replace(cash_delta=st.cash_delta + jnp.where(adv, st.pos * c * acc, 0.0))
        return st

    def pallas(st, o, h, l, c, acc, adv):
        return jdyn.fused_fill_brackets(
            st, o, h, l, c, acc if jcfg.financing_enabled else None, adv,
            jcfg, jparams, interpret=True,
        )
    return {"ops": jax.vmap(xla), "xla": jax.jit(jax.vmap(xla)), "pallas": jax.vmap(pallas)}[mode]


def _compare(ref, ours, label, exact):
    if exact:
        assert_bitwise(ref, ours, label)
    else:
        np.testing.assert_allclose(to_np(ours), to_np(ref), rtol=1e-6, atol=1e-5, err_msg=label)


def _run_fill(flags, pname, seed, mode, big=True):
    jcfg, tcfg = _flag_config(flags)
    jparams, tparams = _params(PARAM_SETS[pname])
    fields, _, bars, advance, _ = ledger_case(seed, big=big)
    jst, tst = _states(jcfg, fields)
    jbars = [jnp.asarray(bars[k]) for k in ("o", "h", "l", "c", "accrual")]
    with x64_off(), jax.disable_jit(mode == "ops"):
        ref = _jax_fill(jcfg, jparams, mode)(jst, *jbars, jnp.asarray(advance))
    tb = [torch.from_numpy(bars[k]) for k in ("o", "h", "l", "c", "accrual")]
    ours = env_dynamics.fill_brackets(
        tst, *tb[:4], tb[4] if tcfg.financing_enabled else None,
        torch.from_numpy(advance), tcfg, tparams,
    )
    for name in ours._fields:
        _compare(getattr(ref, name), getattr(ours, name), f"{flags} {pname}: {name}",
                 exact=mode == "ops")
    return ours, tst


@pytest.mark.parametrize("flags", COVERING_FLAGS, ids=lambda f: "-".join(map(str, f)))
def test_fill_brackets_plain_bitwise_matches_jax_ops(flags):
    i = COVERING_FLAGS.index(flags)
    ours, before = _run_fill(flags, sorted(PARAM_SETS)[i % 2], seed=i, mode="ops")
    assert int((ours.pos != before.pos).sum()) > 5  # fills and exits happen


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("flags", INTERPRET_FLAGS, ids=lambda f: "-".join(map(str, f)))
def test_fill_brackets_plain_matches_pallas_interpret_and_jit(flags, mode):
    i = INTERPRET_FLAGS.index(flags)
    _run_fill(flags, sorted(PARAM_SETS)[i % 2], seed=7 + i, mode=mode, big=False)


def _run_mark(reward, seed, mode, initial_cash=10000.0):
    jcfg, tcfg = _flag_config(FLAG_GRID[0], reward=reward)
    jparams, tparams = _params(dict(initial_cash=initial_cash, reward_scale=2.0, penalty_lambda=0.5))
    fields, mark, bars, _, rng = ledger_case(seed, big=mode == "ops")
    jst, tst = _states(jcfg, {**fields, **mark})
    mark_pred = rng.random(N) < 0.7
    live = rng.random(N) < 0.8
    args = (jnp.asarray(bars["c"]), jnp.asarray(mark_pred), jnp.asarray(live))
    with x64_off(), jax.disable_jit(mode == "ops"):
        if mode == "pallas":
            ref_st, ref_r = jax.vmap(
                lambda st, c, m, lv: jdyn.fused_mark_reward(st, c, m, lv, jcfg, jparams, interpret=True)
            )(jst, *args)
        else:
            def one(st, c, m, lv):  # "ops" and "xla"
                st = jselect(m, jbroker.mark_to_market(st, c, jparams), st)
                return jrewards.compute_reward(st, jcfg, jparams, lv)
            ref_st, ref_r = jax.jit(jax.vmap(one))(jst, *args)
    ours_st, ours_r = env_dynamics.mark_reward(
        tst, torch.from_numpy(bars["c"]), torch.from_numpy(mark_pred),
        torch.from_numpy(live), tcfg, tparams,
    )
    exact = mode == "ops"
    _compare(ref_r, ours_r, f"{reward}: base reward", exact)
    for name in env_dynamics.MARK_OUT_FIELDS:
        _compare(getattr(ref_st, name), getattr(ours_st, name), f"{reward}: {name}", exact)


@pytest.mark.parametrize("mode", ["ops", "pallas", "xla"])
@pytest.mark.parametrize("reward", ["pnl_reward", "dd_penalized_reward"])
def test_mark_reward_plain_matches_jax(reward, mode):
    for seed in range(3):
        _run_mark(reward, seed, mode)
    _run_mark(reward, 5, mode, initial_cash=0.0)


# ---------------------------------------------------------------- K1's tiling
# (csrc/env_kernels.cu step_obs_kernel; the CPU model ops/cases.step_obs_tiling)
def _k1_launches(n, w, f):
    """(grid, output offset, input offset) cases: the grid on 132 SMs at
    8 CTAs each, grids that make every CTA walk several env blocks, and
    data pointers 4, 8 and 12 bytes off 16-byte alignment."""
    eb, grid = window_zscore.step_obs_geometry(n, w, f, 132, 8)
    return [(grid, 0, 0), (3, 1, 0), (1, 0, 3), (7, 2, 2)]


@pytest.mark.parametrize("env_block", window_zscore.K1_ENV_BLOCKS)
@pytest.mark.parametrize("shape", K1_EDGE_SHAPES + ((64, 8, 3), (5, 7, 1)), ids=str)
def test_step_obs_tiling_covers_each_element_once_and_derives_its_feature(shape, env_block):
    n, w, f = shape
    threads, vectors = window_zscore.K1_THREADS, window_zscore.K1_VECTORS
    for grid, out_offset, in_offset in _k1_launches(n, w, f):
        t = step_obs_tiling(n, w, f, env_block, grid, threads, vectors, out_offset, in_offset)
        idx = t["index"]
        assert np.array_equal(np.sort(idx), np.arange(n * w * f))  # each element once
        assert np.array_equal(t["feature"], idx % f)
        assert np.array_equal(t["env"], idx // (w * f))
        assert ((0 <= t["thread"]) & (t["thread"] < threads)).all()
        assert ((0 <= t["cta"]) & (t["cta"] < grid)).all()
        vec = t["vector"] >= 0
        # a vector's four elements are neighbours (the model lists them
        # lane by lane), the first on a 16-byte boundary of the output; a
        # float4 load only where the input is on one too
        lanes = idx[vec].reshape(-1, 4)
        assert (np.diff(lanes, axis=1) == 1).all()
        assert ((out_offset + lanes[:, 0]) % 4 == 0).all()
        loads = idx[t["float4_in"]].reshape(-1, 4)
        assert ((in_offset + loads[:, 0]) % 4 == 0).all()
        assert t["float4_in"][vec].all() == ((in_offset - out_offset) % 4 == 0)
        assert (t["slot"][vec] < vectors).all()
        assert (~vec).sum() <= 6 * -(-n // env_block)  # at most 3 + 3 scalars a block
        # the staged moments: each (env, feature) once, its feature derived
        k = t["staged_index"]
        assert np.array_equal(np.sort(k), np.arange(n * f))
        assert np.array_equal(t["staged_feature"], k % f)
        assert np.array_equal(t["staged_env"], k // f)


@pytest.mark.parametrize("shape", [s for s in K1_EDGE_SHAPES if window_zscore.row_groups(*s)]
                         + [(3, 4, 5), (64, 8, 5)], ids=str)
def test_step_obs_row_tiling_covers_each_element_once_and_derives_its_feature(shape):
    n, w, f = shape
    groups = window_zscore.row_groups(n, w, f)
    assert groups == n * w // window_zscore.K1_ROW_GROUP
    for grid in (window_zscore.row_grid(groups, 132, 8), 1, 3):
        t = step_obs_row_tiling(n, w, f, grid, window_zscore.K1_ROW_THREADS,
                                window_zscore.K1_ROW_GROUP)
        idx = t["index"]
        assert np.array_equal(np.sort(idx), np.arange(n * w * f))
        assert np.array_equal(t["feature"], idx % f)
        assert np.array_equal(t["env"], idx // (w * f))
        lanes = idx.reshape(-1, 4)  # the float4s, 16-byte aligned
        assert (np.diff(lanes, axis=1) == 1).all() and (lanes[:, 0] % 4 == 0).all()
        assert (t["thread"] < window_zscore.K1_ROW_THREADS).all() and (t["cta"] < grid).all()
        # coalesced: a warp's lanes move 32 neighbouring float4s in each slot,
        # lane l the l-th of them, every float4 by a thread of the warp that
        # computes it
        vec, mover = t["vector"][::4], t["mover"][::4]
        assert (mover // 32 == t["thread"][::4] // 32).all()
        key = (t["cta"][::4] * 10 ** 6 + t["pass_"][::4] * 10 ** 3 + mover // 32) * 8 + t["slot"][::4]
        order = np.argsort(key, kind="stable")
        starts = np.r_[0, np.flatnonzero(np.diff(key[order])) + 1]
        first = np.repeat(np.minimum.reduceat(vec[order], starts), np.diff(np.r_[starts, key.size]))
        assert np.array_equal(vec[order] - first, mover[order] % 32)
    # the row path takes only F = 5 and windows of whole groups
    assert not window_zscore.row_groups(63, 9, 3) and not window_zscore.row_groups(4, 30, 5)


@pytest.mark.parametrize("mask,clip", [((), 10.0), ("odd", 1.5), ((), 0.0), ("odd", -2.0)])
@pytest.mark.parametrize("shape", K1_EDGE_SHAPES[1:] + ((64, 8, 3),), ids=str)
def test_step_obs_emulated_tiling_equals_plain(shape, mask, clip):
    n, w, f = shape
    win, mean, std, neutral = obs_case(sum(shape), n, w, f)
    mask = tuple(k % 2 == 1 for k in range(f)) if mask == "odd" else mask
    ref = window_zscore.scale_feature_window(
        *(torch.from_numpy(x) for x in (win, mean, std, neutral)), mask, clip)
    tilings = {f"env block {eb}": step_obs_tiling(n, w, f, eb, 5, window_zscore.K1_THREADS,
                                                  window_zscore.K1_VECTORS, out_offset=3,
                                                  in_offset=1)
               for eb in (1, window_zscore.env_block(w, f))}
    if window_zscore.row_groups(n, w, f):
        tilings["row groups"] = step_obs_row_tiling(n, w, f, 3, window_zscore.K1_ROW_THREADS,
                                                    window_zscore.K1_ROW_GROUP)
    for label, t in tilings.items():
        ours = step_obs_emulated(win, mean, std, neutral, mask, clip, t)
        assert_bitwise(ref, torch.from_numpy(ours), label)


@pytest.mark.parametrize("divisors", [range(1, 300), [160, 108, 27, 1280, 2 ** 20 + 7, 2 ** 30 + 1]],
                         ids=["small", "faces"])
def test_magic_division_is_exact_below_2_31(divisors):
    rng = np.random.default_rng(0)
    j = np.concatenate([np.arange(4096), rng.integers(0, 2 ** 31, 4096),
                        2 ** 31 - 1 - np.arange(64)]).astype(np.int64)
    for d in divisors:
        lo, hi, shift = window_zscore.magic(d)
        assert 0 <= lo < 2 ** 32 and hi in (0, 1)
        assert np.array_equal(window_zscore.magic_div(j, lo, hi, shift), j // d), d
        assert np.array_equal(window_zscore.magic_div(j + d, lo, hi, shift), (j + d) // d) or d > 2 ** 20


def test_step_obs_geometry_spreads_over_the_card_and_refuses_what_shared_memory_cannot_hold():
    eb, grid = window_zscore.step_obs_geometry(8192, 32, 5, 132, 8)
    assert eb in window_zscore.K1_ENV_BLOCKS and eb * 32 * 5 <= 4 * 256 * 2
    assert grid == min(-(-8192 // eb), 132 * 8)
    assert window_zscore.step_obs_geometry(1, 32, 5, 132, 8) == (eb, 1)
    assert window_zscore.step_obs_geometry(3, 1024, 10, 132, 8) == (1, 3)  # a face bigger than a pass
    with pytest.raises(ValueError, match="features"):
        window_zscore.step_obs_geometry(4, 1, 6000, 132, 8)


# ---------------------------------------------------------------- K2's launch path
def test_fill_outputs_are_contiguous_disjoint_rows_of_three_blocks():
    n = 37
    blocks, outs = env_dynamics.fill_outputs(n, "cpu")
    assert [b.dtype for b in blocks] == [torch.float32, torch.bool, torch.int32]
    assert [tuple(b.shape) for b in blocks] == [(13, n), (2, n), (3, n)]
    assert tuple(outs) == env_dynamics.FILL_OUT_FIELDS
    groups = [(env_dynamics.FILL_FLOAT_FIELDS, torch.float32), (env_dynamics.FILL_BOOL_FIELDS, torch.bool),
              (env_dynamics.FILL_INT_FIELDS, torch.int32)]
    spans = []
    for (names, dtype), block in zip(groups, blocks):
        for k, name in enumerate(names):
            t = outs[name]
            assert t.dtype == dtype and tuple(t.shape) == (n,) and t.is_contiguous()
            assert t.data_ptr() == block.data_ptr() + k * n * t.element_size()  # row k of its block
            spans.append((t.data_ptr(), t.data_ptr() + n * t.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # no two overlap
    # a write to one row leaves every other as it was
    for t in outs.values():
        t.zero_()
    outs["cash_delta"].fill_(1.0)
    outs["pending_forced"].fill_(True)
    outs["trades_won"].fill_(3)
    assert [int(t.float().sum()) for t in outs.values()] == [
        n if k in ("cash_delta", "pending_forced") else 3 * n if k == "trades_won" else 0
        for k in outs]
    blocks0, outs0 = env_dynamics.fill_outputs(0, "cpu")
    assert all(t.numel() == 0 for t in outs0.values())


# ---------------------------------------------------------------- K3's launch path
def test_mark_threads_and_pointers_match_the_kernel_source():
    import pathlib
    import re

    src = (pathlib.Path(env_dynamics.__file__).resolve().parent.parent / "csrc"
           / "env_kernels.cu").read_text()
    threads = int(re.search(r"constexpr int kMarkThreads = (\d+);", src).group(1))
    assert env_dynamics.MARK_THREADS == threads == 64
    # the flagship's 8,192 envs reach 128 of the H100's 132 SMs, one CTA each
    assert -(-8192 // threads) == 128
    counts = {"kNumMarkIn": len(env_dynamics.MARK_FLOAT_FIELDS),
              "kNumMarkOut": len(env_dynamics.MARK_OUT_FIELDS),
              "kNumMarkParams": len(env_dynamics.MARK_PARAM_FIELDS)}
    for enum, n in counts.items():
        body = re.search(r"enum \w+ \{([^}]*)\b" + enum + r"\b", src).group(1)
        assert body.count(",") == n, enum
    # MarkArgs: inputs, close, mark, live, outputs, reward, params
    assert env_dynamics.MARK_POINTERS == sum(counts.values()) + 3 + 1 == 21


def test_mark_outputs_are_contiguous_disjoint_rows_of_one_block():
    n = 37
    block, rows = env_dynamics.mark_outputs(n, "cpu")
    assert block.dtype == torch.float32 and tuple(block.shape) == (7, n)
    assert len(rows) == len(env_dynamics.MARK_OUTPUTS) == 7
    assert env_dynamics.MARK_OUTPUTS[:6] == env_dynamics.MARK_OUT_FIELDS
    for k, t in enumerate(rows):
        assert t.dtype == torch.float32 and tuple(t.shape) == (n,) and t.is_contiguous()
        assert t.data_ptr() == block.data_ptr() + k * n * 4  # row k of the block
    spans = sorted((t.data_ptr(), t.data_ptr() + 4 * n) for t in rows)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # no two overlap
    for k, t in enumerate(rows):
        t.fill_(float(k))
    assert [float(t.sum()) for t in rows] == [float(k * n) for k in range(7)]
    _, empty = env_dynamics.mark_outputs(0, "cpu")
    assert len(empty) == 7 and all(t.numel() == 0 for t in empty)


def test_fill_flags_encode_the_kernel_flag_word_once_per_config():
    for flags in FLAG_GRID:
        slip_open, slip_limit, slip_match, financing, limit_fill, collision = flags
        cfg = flag_config(flags)
        want = (slip_open | slip_limit << 1 | slip_match << 2 | financing << 3
                | ("cross", "touch", "conservative").index(limit_fill) << 4
                | (collision == "ohlc") << 6)
        assert env_dynamics.fill_flags(cfg) == want
        assert env_dynamics.fill_flags(cfg) == want  # from the cache
    assert env_dynamics.FILL_POINTERS == 33


def test_require_raises_on_what_a_raw_pointer_cannot_take():
    from gymfx_tpu_torch.ops import _build

    cpu = torch.device("cpu")
    x = torch.zeros(6, 4)
    _build.require(x, "x", torch.float32, (6, 4), cpu)
    _build.require_all([x, x + 1], ["x", "y"], torch.float32, (6, 4), cpu)
    for bad, why in [(x.double(), "float64"), (x[:, :2], r"\(6, 2\)"), (x.t(), "not contiguous"),
                     (x.reshape(24), r"\(24,\)")]:
        with pytest.raises(ValueError, match=why):
            _build.require(bad, "x", torch.float32, (6, 4), cpu)
        with pytest.raises(ValueError, match="^y must"):
            _build.require_all([x, bad], ["x", "y"], torch.float32, (6, 4), cpu)
    with pytest.raises(ValueError, match="meta"):
        _build.require(x.to("meta"), "x", torch.float32, (6, 4), cpu)


# ---------------------------------------------------------------- K2 / K3 with a param row per env
def _row_params(n):
    """(JAX EnvParams, port EnvParams): K2's and K3's params per row
    (``cases.PAIR_PARAM_ROWS``, a portfolio's three pairs, row e holding
    pair e % 3's), every other field 0; the JAX leaves all (n,), to be
    vmapped with the envs."""
    tparams = row_params(PAIR_PARAM_ROWS, n, "cpu")
    jparams = jax.tree.map(lambda _: jnp.zeros((n,), jnp.float32), jax_initial_params())
    jparams = jparams._replace(**{
        k: jnp.broadcast_to(jnp.asarray(to_np(getattr(tparams, k))), (n,)).astype(
            jnp.int32 if k in ("entry_start_mow", "force_close_mow") else jnp.float32)
        for k in jparams._fields if k != "user"})
    return jparams, tparams


def _jax_fill_rows(jcfg, mode):
    """The JAX K2 chain with params vmapped alongside the envs (the
    portfolio's vmap over pairs): "ops", "xla" or "pallas"."""
    def xla(st, o, h, l, c, acc, adv, p):
        st = jselect(adv, jbroker.fill_pending(st, o, p, jcfg, h, l), st)
        st = jselect(adv, jbroker.check_brackets(st, o, h, l, jcfg, p), st)
        if jcfg.financing_enabled:
            st = st._replace(cash_delta=st.cash_delta + jnp.where(adv, st.pos * c * acc, 0.0))
        return st

    def pallas(st, o, h, l, c, acc, adv, p):
        return jdyn.fused_fill_brackets(st, o, h, l, c, acc if jcfg.financing_enabled else None,
                                        adv, jcfg, p, interpret=True)
    return {"ops": jax.vmap(xla), "xla": jax.jit(jax.vmap(xla)), "pallas": jax.vmap(pallas)}[mode]


@pytest.mark.parametrize("mode", ["ops", "xla"])
@pytest.mark.parametrize("flags", INTERPRET_FLAGS, ids=lambda f: "-".join(map(str, f)))
def test_fill_brackets_plain_with_row_params_matches_jax(flags, mode):
    """K2's plain version with a param row per env against the JAX chain
    vmapped over envs and their param rows: op by op BITWISE, jitted
    within rtol 1e-6 / atol 1e-5 (on ledgers of small notional)."""
    jcfg, tcfg = _flag_config(flags)
    jparams, tparams = _row_params(N)
    fields, _, bars, advance, _ = ledger_case(31 + INTERPRET_FLAGS.index(flags), big=False)
    jst, tst = _states(jcfg, fields)
    jbars = [jnp.asarray(bars[k]) for k in ("o", "h", "l", "c", "accrual")]
    with x64_off(), jax.disable_jit(mode == "ops"):
        ref = _jax_fill_rows(jcfg, mode)(jst, *jbars, jnp.asarray(advance), jparams)
    tb = [torch.from_numpy(bars[k]) for k in ("o", "h", "l", "c", "accrual")]
    ours = env_dynamics.fill_brackets(tst, *tb[:4], tb[4] if tcfg.financing_enabled else None,
                                      torch.from_numpy(advance), tcfg, tparams)
    for name in ours._fields:
        _compare(getattr(ref, name), getattr(ours, name), f"{flags}: {name}", exact=mode == "ops")
    assert int((ours.pos != tst.pos).sum()) > 5
    # each row's own commission: the rows of one ledger case under row 0's
    # params alone differ
    shared = env_dynamics.fill_brackets_plain(
        tst, *tb[:4], tb[4] if tcfg.financing_enabled else None, torch.from_numpy(advance),
        tcfg, env_params(PAIR_PARAM_ROWS[0], "cpu"))
    assert not torch.equal(shared.cash_delta, ours.cash_delta)


@pytest.mark.parametrize("mode", ["ops", "xla"])
@pytest.mark.parametrize("reward", ["pnl_reward", "dd_penalized_reward"])
def test_mark_reward_plain_with_row_params_matches_jax(reward, mode):
    jcfg, tcfg = _flag_config(FLAG_GRID[0], reward=reward)
    jparams, tparams = _row_params(N)
    fields, mark, bars, _, rng = ledger_case(41, big=False)
    jst, tst = _states(jcfg, {**fields, **mark})
    mark_pred, live = rng.random(N) < 0.7, rng.random(N) < 0.8

    def one(st, c, m, lv, p):
        st = jselect(m, jbroker.mark_to_market(st, c, p), st)
        return jrewards.compute_reward(st, jcfg, p, lv)

    run = jax.vmap(one) if mode == "ops" else jax.jit(jax.vmap(one))
    with x64_off(), jax.disable_jit(mode == "ops"):
        ref_st, ref_r = run(jst, jnp.asarray(bars["c"]), jnp.asarray(mark_pred),
                            jnp.asarray(live), jparams)
    ours_st, ours_r = env_dynamics.mark_reward(tst, torch.from_numpy(bars["c"]),
                                               torch.from_numpy(mark_pred),
                                               torch.from_numpy(live), tcfg, tparams)
    _compare(ref_r, ours_r, f"{reward}: reward", mode == "ops")
    for name in env_dynamics.MARK_OUT_FIELDS:
        _compare(getattr(ref_st, name), getattr(ours_st, name), f"{reward}: {name}",
                 mode == "ops")


def test_the_pallas_vmap_rules_read_the_first_param_row():
    """The JAX package's Pallas K2 and K3 fold the vmapped envs into one
    launch but keep one params row, the first (``_rule``'s ``pp[:1]``,
    gymfx_tpu/ops/env_dynamics.py:262 and :299): under a vmap whose param
    rows differ (a portfolio's pairs with ``rollout_env_kernel`` on) every
    env computes with row 0's.  Pinned here against the port's plain
    version given row 0's params for every env (within rtol 1e-6 / atol
    1e-5, the interpreter's contractions); the port's kernels take every
    row's own, as the JAX package's XLA path, its default, does."""
    flags = INTERPRET_FLAGS[1]
    jcfg, tcfg = _flag_config(flags)
    jparams, _ = _row_params(N)
    fields, mark, bars, advance, rng = ledger_case(51, big=False)
    jst, tst = _states(jcfg, {**fields, **mark})
    jbars = [jnp.asarray(bars[k]) for k in ("o", "h", "l", "c", "accrual")]
    with x64_off():
        ref = _jax_fill_rows(jcfg, "pallas")(jst, *jbars, jnp.asarray(advance), jparams)
    first = env_params({**PAIR_PARAM_ROWS[0]}, "cpu")
    tb = [torch.from_numpy(bars[k]) for k in ("o", "h", "l", "c", "accrual")]
    ours = env_dynamics.fill_brackets(tst, *tb[:4], tb[4] if tcfg.financing_enabled else None,
                                      torch.from_numpy(advance), tcfg, first)
    for name in ours._fields:
        _compare(getattr(ref, name), getattr(ours, name), f"pallas row 0: {name}", exact=False)
    mark_pred, live = rng.random(N) < 0.7, rng.random(N) < 0.8
    with x64_off():
        ref_st, ref_r = jax.vmap(lambda st, c, m, lv, p: jdyn.fused_mark_reward(
            st, c, m, lv, jcfg, p, interpret=True))(
            jst, jnp.asarray(bars["c"]), jnp.asarray(mark_pred), jnp.asarray(live), jparams)
    ours_st, ours_r = env_dynamics.mark_reward(tst, tb[3], torch.from_numpy(mark_pred),
                                               torch.from_numpy(live), tcfg, first)
    _compare(ref_r, ours_r, "pallas row 0: reward", exact=False)


def test_param_rows_mask_and_the_kernels_argument_match_the_source():
    import pathlib
    import re

    n = 12
    rows = row_params(PAIR_PARAM_ROWS, n, "cpu")
    shared = env_params(PAIR_PARAM_ROWS[0], "cpu")
    mixed = shared._replace(commission=rows.commission, reward_scale=rows.reward_scale)
    names2 = [f"param {k}" for k in env_dynamics.FILL_PARAM_FIELDS]
    names3 = [f"param {k}" for k in env_dynamics.MARK_PARAM_FIELDS]
    cpu = torch.device("cpu")
    assert env_dynamics.param_rows(env_dynamics._fill_params(rows), names2, n, cpu) == 0b11111
    assert env_dynamics.param_rows(env_dynamics._fill_params(shared), names2, n, cpu) == 0
    assert env_dynamics.param_rows(env_dynamics._fill_params(mixed), names2, n, cpu) == 0b00010
    assert env_dynamics.param_rows(env_dynamics._mark_params(mixed), names3, n, cpu) == 0b010
    with pytest.raises(ValueError, match=r"param commission must be .* shape \(12,\)"):
        env_dynamics.param_rows(env_dynamics._fill_params(
            mixed._replace(commission=rows.commission[:5])), names2, n, cpu)
    with pytest.raises(ValueError, match="float32"):
        env_dynamics.param_rows(env_dynamics._fill_params(
            mixed._replace(slippage=rows.slippage.double())), names2, n, cpu)
    src = (pathlib.Path(env_dynamics.__file__).resolve().parent.parent / "csrc"
           / "env_kernels.cu").read_text()
    # one int mask after the flags (K2) and after the window (K3), bit k
    # for param k, each param read through param_at
    assert re.search(r"int gymfx_fill_brackets\([^)]*int flags, int par_rows, void\* stream\)",
                     src)
    assert re.search(r"int gymfx_mark_reward\([^)]*int window, int par_rows, void\* stream\)",
                     src)
    assert "(((par_rows >> k) & 1) ? e : 0)" in src
    for k in ("kSlippage", "kCommission", "kPriceTick", "kSizeStep", "kMinQty",
              "kInitialCash", "kRewardScale", "kPenaltyLambda"):
        assert f"param_at(a.par, {k}, par_rows, e)" in src, k
    assert "__ldg(a.par[" not in src.split("fill_skeleton_kernel")[0]
