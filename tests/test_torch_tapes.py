"""The curriculum over a tape library (data/tapes.py) and its PPO loop against the JAX package.

* Specs: ``parse_tape_specs`` gives the JAX package's TapeSpecs for both
  grammars (the compact string and a JSON list of dicts with per-tape
  overrides) and refuses the same malformed entries with its messages.
* Picks: for the same seed and weights, the port's picker draws the
  JAX picker's tape sequence (numpy PCG64), bit for bit.
* Library: a ``feed="curriculum"`` Environment over three example CSVs
  with ``data_compress`` on and off: each tape's MarketData (decoded
  from its compressed form, or held in f32) equals the same CSV built
  directly, bitwise, and ``nbytes_report`` equals the JAX sampler's.
* Rollout phase on tape 1: ``PPOTrainer.rollout_phase(state, tape)``
  against the JAX ``PPOTrainer._rollout_phase(state, tape)`` with the
  JAX start offsets and actions injected, as tests/test_torch_rollout.py
  does for tape 0 (8 envs, window 8, a 24-bar tape so episodes end and
  auto-reset from the tape's own random starts).  Env states, obs,
  rewards and dones BITWISE (unit positions and 4 / 8 pip brackets keep
  every product XLA may fuse exact); logp and value rtol / atol 1e-5
  (the two CPU GEMM libraries).
* ``PPOTrainer.train`` draws one pick per superstep boundary (K = 1 and
  2), trains on it and reports the JAX loop's metrics.
* Refusals: unequal bar counts (a ``scengen:`` tape's among them),
  curriculum with streaming, a bad ``data_compress``, a trainer on a
  streamed Environment, and ``train``'s telemetry, preemption and logging
  (item 10) and mesh (item 17) arguments; its checkpoints (item 10's
  part that is ported) run on a curriculum too.
"""
import pathlib

import jax
import numpy as np
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.core.runtime import Environment as JaxEnvironment
from gymfx_tpu.data import tapes as jax_tapes
from gymfx_tpu.train.ppo import PPOTrainer as JaxTrainer
from gymfx_tpu.train.ppo import ppo_config_from as jax_ppo_config_from

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.config.flagship import curriculum_config
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.data import tapes
from gymfx_tpu_torch.data.feed import load_market_dataset
from gymfx_tpu_torch.ops import cases, tape_decode
from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

from test_torch_parity import assert_bitwise, assert_state_bitwise, to_np, x64_off

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / "examples" / "data"
LIBRARY = f"file:{DATA / 'eurusd_sample.csv'}@2,file:{DATA / 'gbpusd_sample.csv'},file:{DATA / 'usdjpy_sample.csv'}@0.5"


@pytest.mark.parametrize("raw", [
    LIBRARY,
    "file:a.csv,scengen:flash_crash@3",
    '[{"file": "a.csv", "weight": 3, "window_size": 8}, {"scengen": "crash", "scengen_seed": 7}]',
    [{"file": "a.csv"}, "file:b.csv@0.25"],
])
def test_parse_tape_specs_matches_jax(raw):
    assert tapes.parse_tape_specs({"tapes": raw}) == jax_tapes.parse_tape_specs({"tapes": raw})


@pytest.mark.parametrize("raw", [
    None, "", "csv:a.csv", "file:a.csv@x", "file:a.csv@-1", "file:a.csv,file:a.csv",
    "[not json", [{"file": "a", "scengen": "b"}], [3],
])
def test_parse_tape_specs_refusals_match_jax(raw):
    with pytest.raises(ValueError) as ref:
        jax_tapes.parse_tape_specs({"tapes": raw})
    with pytest.raises(ValueError) as ours:
        tapes.parse_tape_specs({"tapes": raw})
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("seed_key,seed", [("curriculum_seed", 11), ("seed", 4), ("seed", None)])
def test_pick_sequence_matches_jax_picker(seed_key, seed):
    config = {"tapes": LIBRARY, seed_key: seed}
    ref, ours = jax_tapes._TapePickerBase(), tapes._TapePickerBase()
    ref._init_picker(config, jax_tapes.parse_tape_specs(config))
    ours._init_picker(config, tapes.parse_tape_specs(config))
    ref._tape_data = ours._tape_data = lambda i: None
    for it in range(200):
        assert ours.pick(it)[:2] == ref.pick(it)[:2]
    assert ours.picks == ref.picks
    assert {i for _, i in ours.picks} == {0, 1, 2}


def _library_config(**over):
    config = dict(DEFAULT_VALUES, feed="curriculum", tapes=LIBRARY, window_size=16,
                  feature_columns=["OPEN", "CLOSE", "VOLUME"])
    config.update(over)
    return config


@pytest.mark.parametrize("mode", ["on", "interpret", "off"])
def test_library_tapes_equal_the_direct_f32_build_and_jax_accounting(mode):
    config = _library_config(data_compress=mode)
    env = Environment(config, device="cpu")
    sampler = env.curriculum
    assert sampler.num_tapes == 3
    with x64_off():
        jenv = JaxEnvironment(dict(JAX_DEFAULTS, **{k: v for k, v in config.items()
                                                    if k not in DEFAULT_VALUES or
                                                    v != DEFAULT_VALUES[k]}))
    assert sampler.nbytes_report() == jenv.curriculum.nbytes_report()
    kw = dict(window_size=16, feature_columns=["OPEN", "CLOSE", "VOLUME"], device="cpu")
    for i, spec in enumerate(sampler.specs):
        direct = load_market_dataset(dict(DEFAULT_VALUES, input_data_file=spec.source)
                                     ).build_market_data(**kw)
        tape = sampler._tape_data(i)
        assert (sampler.tape(i) is not None) == (mode != "off" and i > 0)
        for name in direct._fields:
            if name != "row0":
                assert_bitwise(getattr(direct, name), getattr(tape, name), f"tape {i} {name}")
    if mode != "off":
        assert sampler.nbytes_report()["ratio"] > 1.0


def _tick_tapes(tmp_path, n=24, count=2):
    paths = []
    for i in range(count):
        path = tmp_path / f"tape{i}.csv"
        cases.write_bar_csv(path, cases.tick_walk_columns(n, seed=20 + i, vol_ticks=30.0),
                            cases.m1_week_grid(n))
        paths.append(path)
    return ",".join(f"file:{p}" for p in paths)


def _jax_phase(trainer, data):
    """``trainer._rollout_phase(state, data)`` jitted with the EnvParams
    as traced arguments (see tests/test_torch_rollout.py)."""
    env = trainer.env
    fixed = env.params

    def phase(js, params, tape):
        env.params = params
        try:
            return trainer._rollout_phase(js, tape)
        finally:
            env.params = fixed

    jitted = jax.jit(phase)
    return lambda js: jitted(js, fixed, data)


def test_curriculum_rollout_phase_on_tape_1_matches_jax_with_injected_draws(tmp_path):
    over = dict(
        feed="curriculum", tapes=_tick_tapes(tmp_path), data_compress="on", timeframe="M1",
        window_size=8, num_envs=8, ppo_horizon=8, policy="mlp",
        policy_kwargs={"hidden": [32, 32, 32]}, random_episode_start=True,
        feature_columns=["CLOSE", "VOLUME"], strategy_plugin="direct_fixed_sltp",
        sl_pips=4.0, tp_pips=8.0,
    )
    with x64_off():
        jenv = JaxEnvironment(dict(JAX_DEFAULTS, **over))
        trainer = JaxTrainer(jenv, jax_ppo_config_from(jenv.config))
        jtape = jenv.curriculum._tape_data(1)
    env = Environment(dict(DEFAULT_VALUES, **over), device="cpu")
    ro = PPOTrainer(env, ppo_config_from(env.config))
    tape = env.curriculum._tape_data(1)
    for name in tape._fields:
        if name != "row0":
            assert_bitwise(getattr(jtape, name), getattr(tape, name), f"tape 1 {name}")
    n = ro.pcfg.n_envs
    state = ro.init_state(0)
    dones = 0
    with x64_off():
        js = trainer.init_state(0)
        state = state._replace(params=convert.mlp_params_from_flax(
            jax.tree.map(np.asarray, js.params), device="cpu"))
        jax_phase = _jax_phase(trainer, jtape)
        for phase in range(4):
            # the phase's first draw: the random-start bank, from the carried key
            _, k0 = jax.random.split(js.rng)
            offsets = np.array(jax.random.randint(k0, (n,), 0, max(1, env.cfg.n_bars - 2)))
            js, (traj, last_value) = jax_phase(js)
            state, (ttraj, tlast) = ro.rollout_phase(
                state, tape, actions=torch.from_numpy(np.array(traj["action"])),
                start_offsets=torch.from_numpy(offsets),
            )
            for key in ("obs", "reward", "done", "action"):
                assert_bitwise(traj[key], ttraj[key], f"phase {phase} traj {key}")
            for key in ("logp", "value"):
                np.testing.assert_allclose(to_np(ttraj[key]), np.asarray(traj[key]),
                                           rtol=1e-5, atol=1e-5, err_msg=key)
            np.testing.assert_allclose(to_np(tlast), np.asarray(last_value), rtol=1e-5, atol=1e-5)
            assert_state_bitwise(js.env_states, state.env_states, f"phase {phase}")
            assert_bitwise(js.obs_vec, state.obs_vec, f"phase {phase} obs_vec")
            dones += int(np.asarray(traj["done"]).sum())
    assert dones > 0  # auto-reset ran, from tape 1's own bank


@pytest.mark.parametrize("k", [1, 2])
def test_train_draws_one_tape_per_superstep(tmp_path, k):
    config = dict(DEFAULT_VALUES, feed="curriculum", tapes=_tick_tapes(tmp_path, n=40, count=3),
                  data_compress="on", timeframe="M1", window_size=8, num_envs=4, ppo_horizon=4,
                  ppo_epochs=1, ppo_minibatches=2, policy_kwargs={"hidden": [8, 8, 8]},
                  random_episode_start=True, feature_columns=["CLOSE"], curriculum_seed=5)
    trainer = PPOTrainer(Environment(config, device="cpu"), ppo_config_from(config))
    before = tape_decode.decode_q16_block.launches
    state, metrics = trainer.train(5 * 16, seed=1, supersteps_per_dispatch=k)
    assert metrics["iterations"] == 5 and metrics["total_env_steps"] == 80
    assert metrics["env_steps_per_sec"] > 0 and np.isfinite(metrics["loss"])
    picks = trainer.curriculum.picks
    assert [it for it, _ in picks] == list(range(0, 5, k))
    ref = jax_tapes._TapePickerBase()
    ref._init_picker(config, jax_tapes.parse_tape_specs(config))
    ref._tape_data = lambda i: None
    assert [i for _, i in picks] == [ref.pick(it)[0] for it, _ in picks]
    assert tape_decode.decode_q16_block.launches == before  # CPU: the plain version


def test_curriculum_config_is_the_flagship_over_a_library():
    config = curriculum_config(LIBRARY)
    assert (config["feed"], config["data_compress"], config["random_episode_start"],
            config["lob_tick_size"], config["num_envs"]) == ("curriculum", "on", True, 1e-5, 8192)
    assert config["input_data_file"] == str(DATA / "eurusd_sample.csv")


def test_refusals(tmp_path):
    short = tmp_path / "short.csv"
    cases.write_bar_csv(short, cases.tick_walk_columns(300, 1), cases.m1_week_grid(300))
    with pytest.raises(ValueError, match="same bar count"):
        Environment(_library_config(tapes=f"{LIBRARY},file:{short}"), device="cpu")
    with pytest.raises(ValueError, match="cannot be combined with shard streaming"):
        Environment(_library_config(stream_hbm_budget_mb=0.05), device="cpu")
    # a scengen tape (item 14, ported) of the default 2,048 bars beside
    # 500-bar files; alone it is the library
    with pytest.raises(ValueError, match="same bar count"):
        Environment(_library_config(tapes=f"{LIBRARY},scengen:flash_crash"), device="cpu")
    alone = Environment(_library_config(tapes="scengen:flash_crash"), device="cpu")
    assert alone.n_bars == 2048 and alone.curriculum.num_tapes == 1
    with pytest.raises(ValueError, match="data_compress must be one of"):
        Environment(_library_config(data_compress="zstd"), device="cpu")
    streamed = dict(DEFAULT_VALUES, input_data_file=str(DATA / "eurusd_sample.csv"),
                    window_size=8, num_envs=4, stream_hbm_budget_mb=0.03)
    with pytest.raises(ValueError, match=r"PPO training \(random-access rollouts\) requires"):
        PPOTrainer(Environment(streamed, device="cpu"), ppo_config_from(streamed))
    config = _library_config(num_envs=4, ppo_horizon=2)
    trainer = PPOTrainer(Environment(config, device="cpu"), ppo_config_from(config))
    # telemetry, preempt_at and log_every run (tests/test_torch_telemetry.py,
    # test_torch_faults.py); the mesh faults wait on item 17
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        trainer.train(8, mesh_faults=("kill:1",))
    # checkpoints and the skip guard are ported: a curriculum run takes them
    _, metrics = trainer.train(8, checkpoint_dir=str(tmp_path), checkpoint_every=1,
                               max_consecutive_skips=10)
    assert metrics["last_checkpoint_step"] == 8 and (tmp_path / "8" / "state.pt").is_file()


def test_each_tape_decodes_with_its_own_codecs(tmp_path):
    # tape 1's volume is constant (codec "const"), tape 2's varies ("q16"):
    # the JAX sampler decodes every tape with the first compressed tape's
    # columns and gives tape 2 tape 1's constant volume (ROADMAP Queue 3);
    # the port keeps one decoder per tape
    n = 400
    stamps = cases.m1_week_grid(n)
    cols = [cases.tick_walk_columns(n, seed) for seed in (3, 1, 2)]
    cols[1]["VOLUME"] = np.full(n, 7.0)
    specs = []
    for i, c in enumerate(cols):
        cases.write_bar_csv(tmp_path / f"t{i}.csv", c, stamps)
        specs.append(f"file:{tmp_path / f't{i}.csv'}")
    config = dict(DEFAULT_VALUES, feed="curriculum", tapes=",".join(specs), data_compress="on",
                  window_size=8, timeframe="M1")
    sampler = Environment(config, device="cpu").curriculum
    assert [sampler.tape(i).codec_report()["volume"] for i in (1, 2)] == ["const", "q16"]
    for i in (1, 2):
        assert_bitwise(np.float32(cols[i]["VOLUME"]), sampler._tape_data(i).volume, f"tape {i}")
