"""Bar streaming (data/feed.BarStreamer) and the streamed episode against the JAX package.

* Planner: for the same host tape and budget, ``shard_bars``,
  ``starts``, ``num_shards``, ``ring_shards``, ``tape_resident`` and
  the byte report equal the JAX ``BarStreamer``'s, uncompressed and
  compressed (a ring that holds the whole tape, and one that does not),
  and a budget too small for two decoded plus two compressed shards
  raises the JAX package's ValueError.
* Shards: every shard the port's streamer hands out equals the JAX
  streamer's shard field by field, bitwise, with its global ``row0``.
* Episode: the port's streamed episode (compress off, on and interpret,
  5 to 8 shards) equals its resident episode BITWISE, every collected
  output and the final state, with the buy_hold driver (and the random
  one over the streamed compressed ring), through the end of the tape
  and past it.  Against the JAX ``rollout_streamed`` (compress off and
  on) it agrees within rtol 1e-6 / atol 1e-5 on the
  float ledger (integer outputs exact): inside jit XLA:CPU fuses
  ``a - b * c`` into one multiply-add, the port rounds each product
  (ROADMAP.md Queue 3).
* ``convert.market_data_from_numpy`` carries a JAX shard (row0 != 0)
  across; a streamed Environment refuses reset/step and a second env.
"""
import pathlib

import jax
import numpy as np
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.core import rollout as jax_rollout
from gymfx_tpu.core.runtime import Environment as JaxEnvironment
from gymfx_tpu.data.feed import BarStreamer as JaxStreamer
from gymfx_tpu.data.feed import load_market_dataset as jax_load

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core import rollout as rollout_mod
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.data.feed import BarStreamer, load_market_dataset

from test_torch_parity import assert_bitwise, to_np, x64_off

REPO = pathlib.Path(__file__).resolve().parent.parent
SAMPLE = str(REPO / "examples" / "data" / "eurusd_sample.csv")
WINDOW = 8
FEATURES = ["CLOSE", "VOLUME"]
# (mode, budget MiB) over the 500-bar sample: 5 uncompressed shards of
# 112 bars; 8 compressed shards of 64 with a 4-shard ring (not resident);
# 8 with the whole compressed tape resident
PLANS = [("off", 0.03), ("on", 0.03), ("interpret", 0.05)]


def _hosts():
    config = dict(JAX_DEFAULTS, input_data_file=SAMPLE)
    kw = dict(window_size=WINDOW, feature_columns=FEATURES)
    return (jax_load(config).build_market_data(device=False, **kw),
            load_market_dataset(config).build_market_data(device=None, **kw))


@pytest.mark.parametrize("mode,budget", PLANS + [("off", 0.05), ("on", 0.2)])
def test_planner_and_shards_match_jax(mode, budget):
    jax_host, host = _hosts()
    ref = JaxStreamer(jax_host, window_size=WINDOW, budget_mb=budget, compress=mode)
    ours = BarStreamer(host, window_size=WINDOW, budget_mb=budget, compress=mode)
    for key in ("shard_bars", "starts", "num_shards", "ring_shards", "resident_bars",
                "compression_ratio"):
        assert getattr(ours, key) == getattr(ref, key), key
    assert ours.tape_resident == getattr(ref, "tape_resident", False)
    assert ours.nbytes_report() == ref.nbytes_report()
    assert ours.serve_ranges() == ref.serve_ranges()
    assert ours.num_shards >= 3
    shards = list(ours.iter_shards())
    assert [(lo, hi) for lo, hi, _ in shards] == ours.serve_ranges()
    for k, (_, _, shard) in enumerate(shards):
        with x64_off():
            want = ref._device_shard(k)
        assert shard.row0 == int(want.row0) == ours.starts[k]
        for name in shard._fields:
            if name != "row0":
                assert_bitwise(getattr(want, name), getattr(shard, name), f"shard {k} {name}")


def test_planner_refuses_a_budget_without_room_for_the_ring():
    jax_host, host = _hosts()
    with pytest.raises(ValueError) as ref:
        JaxStreamer(jax_host, window_size=WINDOW, budget_mb=0.02, compress="on")
    with pytest.raises(ValueError) as ours:
        BarStreamer(host, window_size=WINDOW, budget_mb=0.02, compress="on")
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="streaming is not needed"):
        BarStreamer(host, window_size=WINDOW, budget_mb=0.2, compress="off")


def _config(**over):
    return dict(DEFAULT_VALUES, input_data_file=SAMPLE, window_size=WINDOW,
                feature_columns=FEATURES, **over)


@pytest.mark.parametrize("mode,budget,driver", [
    *((mode, budget, "buy_hold") for mode, budget in PLANS), ("on", 0.03, "random"),
])
def test_streamed_episode_equals_resident_episode(mode, budget, driver):
    resident = Environment(_config(), device="cpu")
    streamed = Environment(_config(stream_hbm_budget_mb=budget, data_compress=mode), device="cpu")
    assert streamed.streaming and streamed.data is None and not resident.streaming
    assert streamed.streamer.num_shards >= 3
    steps = 520  # past the end of the 500-bar tape: the frozen tail too
    make = rollout_mod.DRIVERS[driver]
    ref_state, ref = resident.rollout(make(), steps, seed=3)
    state, out = streamed.rollout(make(), steps, seed=3)
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert_bitwise(ref[key], out[key], key)
    for name in ref_state._fields:
        assert_bitwise(getattr(ref_state, name), getattr(state, name), f"state {name}")
    assert bool(out["done"][-1, 0]) and int(out["bar_index"][-1, 0]) == 500


@pytest.mark.parametrize("mode,budget", PLANS[:2])
def test_streamed_episode_matches_jax_rollout_streamed(mode, budget):
    jconfig = dict(JAX_DEFAULTS, input_data_file=SAMPLE, window_size=WINDOW,
                   feature_columns=FEATURES, stream_hbm_budget_mb=budget, data_compress=mode)
    steps = 480
    with x64_off():
        jenv = JaxEnvironment(jconfig)
        assert jenv.streaming
        _, ref = jenv.rollout(jax_rollout.DRIVERS["buy_hold"](), steps)
    env = Environment(_config(stream_hbm_budget_mb=budget, data_compress=mode), device="cpu")
    _, out = env.rollout(rollout_mod.buy_hold_driver(), steps)
    for key in ("done", "action", "position", "trade_count", "bar_index", "pending_active"):
        assert_bitwise(np.asarray(ref[key]), to_np(out[key])[:, 0], key)
    for key in ("equity_delta", "equity", "reward", "pos_units", "pending_target"):
        np.testing.assert_allclose(to_np(out[key])[:, 0], np.asarray(ref[key]),
                                   rtol=1e-6, atol=1e-5, err_msg=key)


def test_market_data_from_numpy_carries_a_shard_across():
    jax_host, _ = _hosts()
    ref = JaxStreamer(jax_host, window_size=WINDOW, budget_mb=0.03, compress="off")
    with x64_off():
        shard = ref._device_shard(2)
    ours = convert.market_data_from_numpy(jax.tree.map(np.asarray, shard), device="cpu")
    assert ours.row0 == ref.starts[2] > 0
    for name in ours._fields:
        if name != "row0":
            assert_bitwise(getattr(shard, name), getattr(ours, name), name)


def test_streamed_environment_refuses_random_access_and_batches():
    env = Environment(_config(stream_hbm_budget_mb=0.03), device="cpu")
    with pytest.raises(ValueError, match=r"reset\(\) requires the full bar history"):
        env.reset()
    with pytest.raises(ValueError, match="one env"):
        env.rollout(rollout_mod.buy_hold_driver(), 10, n_envs=2)
    # a budget the tape fits: resident, the same tensors as no budget at all
    fits = Environment(_config(stream_hbm_budget_mb=1.0), device="cpu")
    plain = Environment(_config(), device="cpu")
    assert not fits.streaming
    for name in plain.data._fields:
        if name != "row0":
            assert torch.equal(getattr(plain.data, name), getattr(fits.data, name)), name


def test_shard_reads_rebase_and_clamp_to_the_shard():
    from gymfx_tpu_torch.core import env as env_core
    from gymfx_tpu_torch.core.obs import local_rows

    env = Environment(_config(stream_hbm_budget_mb=0.03), device="cpu")
    streamer = env.streamer
    shard = streamer._device_shard(2)
    rows = shard.close.shape[0]
    cursors = torch.tensor([0, shard.row0 - 1, shard.row0, shard.row0 + 5, 10**6])
    assert local_rows(env.cfg, shard, cursors, rows).tolist() == [0, 0, 0, 5, rows - 1]
    whole = Environment(_config(), device="cpu")
    assert torch.equal(local_rows(whole.cfg, whole.data, cursors[:4], 500), cursors[:4])
    # the frozen cursor of an episode that ended in shard 0, stepped on
    # shard 2: the reads clamp, the terminated env stays as it was
    state, _ = env_core.reset(env.cfg, env.params, streamer._device_shard(0), 1)
    state = state._replace(terminated=torch.ones_like(state.terminated))
    after, _, _, done, _ = env_core.step(env.cfg, env.params, shard, state,
                                         torch.zeros(1, dtype=torch.int32))
    assert bool(done[0]) and torch.equal(after.t, state.t)
    assert torch.equal(after.equity_delta, state.equity_delta)
