"""The port's threefry PRNG and LOB order flow against the JAX package.

All EXACT.  ``gymfx_tpu_torch/lob/prng.py`` gives the bits of the
installed ``jax.random`` (threefry-2x32, ``jax_threefry_partitionable``):
``PRNGKey``, ``fold_in``, ``split`` (2 and 6 ways), ``uniform`` (float32)
and ``randint`` (int32, including the full int32 range, where the
uint32 multiplier wraps).  ``bar_messages``, ``seed_messages`` and
``random_message_streams`` equal the JAX package's for all five scenario
presets, against the JAX functions run op by op (17 messages) and
jitted (64).

The JAX side runs under ``jax.enable_x64(False)``: under the suite's
global x64 ``jax.random.uniform`` draws float64 bits and
``reference_path``'s ``jnp.linspace`` is float64, while the venue runs in
float32.  ``price_to_ticks`` equals the op-by-op JAX function bitwise; the
jitted one rewrites ``price / 1e-5`` as ``price * 1e5`` and rounds to the
other tick for prices whose quotient is within an ulp of a half tick
(ROADMAP.md Queue 3), so against jit it is held on quote prices (on the
1e-5 grid), where the two agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.lob import flow as jflow
from gymfx_tpu.lob.scenarios import scenario_flow_params as jax_scenario

from gymfx_tpu_torch.lob import flow, prng
from gymfx_tpu_torch.lob.scenarios import scenario_flow_params, scenario_names

from test_torch_parity import assert_bitwise, x64_off

SEEDS = (0, 7, 12345, 2 ** 31 + 5)
STEPS = (0, 1, 499, 2 ** 20)


def _key_np(key):
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_matches_jax_random(seed):
    with x64_off():
        key = jax.random.PRNGKey(jnp.uint32(seed))
        ours = prng.PRNGKey(seed)
        np.testing.assert_array_equal(_key_np(key), ours.numpy())
        for t in STEPS:
            k, kt = jax.random.fold_in(key, jnp.uint32(t)), prng.fold_in(ours, t)
            np.testing.assert_array_equal(_key_np(k), kt.numpy())
            for num in (2, 6):
                np.testing.assert_array_equal(_key_np(jax.random.split(k, num)),
                                              prng.split(kt, num).numpy())
            assert_bitwise(jax.random.uniform(k, (37,)), prng.uniform(kt, 37), "uniform")
            for lo, hi in ((-2, 3), (0, 10), (0, 1), (5, 5), (-2 ** 31, 2 ** 31 - 1)):
                np.testing.assert_array_equal(
                    np.asarray(jax.random.randint(k, (19,), lo, hi, dtype=jnp.int32)),
                    prng.randint(kt, 19, lo, hi).numpy(), err_msg=f"randint [{lo}, {hi})")


def test_prng_batches_over_keys():
    t = np.arange(5, dtype=np.uint32)
    with x64_off():
        keys = jax.vmap(lambda x: jax.random.fold_in(jax.random.PRNGKey(jnp.uint32(3)), x))(
            jnp.asarray(t))
        ref = jax.vmap(lambda k: jax.random.uniform(k, (8,)))(keys)
    ours = prng.fold_in(prng.PRNGKey(3), torch.from_numpy(t.astype(np.int64)))
    np.testing.assert_array_equal(_key_np(keys), ours.numpy())
    assert_bitwise(ref, prng.uniform(ours, 8), "batched uniform")


def _bars(n=12, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.integers(109000, 111000, n).astype(np.int32)
    c = (o + rng.integers(-30, 30, n)).astype(np.int32)
    h = (np.maximum(o, c) + rng.integers(0, 20, n)).astype(np.int32)
    l = (np.minimum(o, c) - rng.integers(0, 20, n)).astype(np.int32)
    t = rng.integers(0, 500, n).astype(np.int32)
    return t, o, h, l, c


@pytest.mark.parametrize("jit", [False, True], ids=["op_by_op", "jit"])
@pytest.mark.parametrize("scenario", scenario_names())
def test_bar_messages_match_jax(scenario, jit):
    t, o, h, l, c = _bars()
    fp, jfp = scenario_flow_params(scenario), jax_scenario(scenario)
    assert tuple(fp) == tuple(jfp)
    n_msgs = 64 if jit else 17

    def one(tt, oo, hh, ll, cc):
        return jflow.bar_messages(jflow.bar_key(3, tt), oo, hh, ll, cc, n_msgs, jfp)

    fn = jax.vmap(one)
    with x64_off():
        if jit:
            ref = jax.jit(fn)(*map(jnp.asarray, (t, o, h, l, c)))
        else:
            with jax.disable_jit():
                ref = fn(*map(jnp.asarray, (t, o, h, l, c)))
    tt, to, th, tl, tc = map(torch.from_numpy, (t, o, h, l, c))
    ours = flow.bar_messages(flow.bar_key(3, tt), to, th, tl, tc, n_msgs, fp)
    for name, a, b in zip(ours._fields, ref, ours):
        assert_bitwise(a, b, f"{scenario} {n_msgs} {name}")
    if scenario == "lob_flash_crash":
        window = slice(fp.crash_at, fp.crash_at + fp.crash_len)
        assert (ours.kind[:, window] == 3).all() and (ours.side[:, window] == -1).all()


@pytest.mark.parametrize("scenario", scenario_names())
def test_seed_messages_and_random_streams_match_jax(scenario):
    _, o, *_ = _bars()
    fp, jfp = scenario_flow_params(scenario), jax_scenario(scenario)
    with x64_off():
        ref_seed = jax.vmap(lambda x: jflow.seed_messages(x, 8, jfp))(jnp.asarray(o))
        ref_streams = jflow.random_message_streams(jax.random.PRNGKey(17), 8, 48, jfp)
    for name, a, b in zip(ref_seed._fields, ref_seed, flow.seed_messages(torch.from_numpy(o), 8, fp)):
        assert_bitwise(a, b, f"seed {name}")
    ours = flow.random_message_streams(prng.PRNGKey(17), 8, 48, fp)
    for name, a, b in zip(ref_streams._fields, ref_streams, ours):
        assert_bitwise(a, b, f"streams {name}")


def test_price_to_ticks_matches_jax():
    rng = np.random.default_rng(1)
    tick = torch.tensor(1e-5, dtype=torch.float32)
    off_grid = (1.1 + rng.normal(0, 0.01, 2000)).astype(np.float32)
    on_grid = np.round(off_grid.astype(np.float64), 5).astype(np.float32)
    with x64_off():
        with jax.disable_jit():
            ref = jflow.price_to_ticks(jnp.asarray(off_grid), 1e-5)
        ref_jit = jax.jit(lambda p: jflow.price_to_ticks(p, 1e-5))(jnp.asarray(on_grid))
    assert_bitwise(ref, flow.price_to_ticks(torch.from_numpy(off_grid), tick), "op by op")
    assert_bitwise(ref_jit, flow.price_to_ticks(torch.from_numpy(on_grid), tick), "jit, quotes")
