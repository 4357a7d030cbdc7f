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
    PARAM_SETS,
    env_params,
    exec_diag_case,
    flag_config,
    ledger_case,
    obs_case,
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
