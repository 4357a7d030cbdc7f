"""The port's greedy evaluation and ``driver_mode=policy`` (train/ppo.py,
train/common.py) against the JAX package's, on the CPU.

* ``evaluate`` on the same MLP params (flax params through
  ``convert.mlp_params_from_flax``; ``policy_dtype`` float32, so that no
  bf16 rounding can flip an argmax between near-equal logits): the greedy
  actions of the whole episode are equal, and the summary's floats are
  within rtol 1e-6 (the policy's logits agree to 1e-5, ROADMAP Queue 3,
  and the env steps bitwise), its integers equal.
* ``build_train_eval_envs`` cuts the tape where the JAX package cuts it
  (``train_bars``, ``eval_bars``), and the held-out env's tape is the
  JAX held-out env's.
* End to end: the JAX ``train_from_config`` trains a few iterations and
  writes an orbax checkpoint; its params, read with the JAX
  ``load_params`` and converted, are saved with the port's
  ``save_checkpoint``; then both packages' ``main`` in
  ``driver_mode=policy`` on the held-out split give the same results JSON
  (tolerances as above).
"""
import json

import jax
import numpy as np
import pytest
import torch

from gymfx_tpu.app.main import main as jax_main
from gymfx_tpu.core.rollout import rollout_chunked as jax_rollout_chunked
from gymfx_tpu.train.checkpoint import load_params as jax_load_params
from gymfx_tpu.train.checkpoint import read_metadata as jax_read_metadata
from gymfx_tpu.train.common import build_train_eval_envs as jax_build_train_eval_envs
from gymfx_tpu.train.ppo import PPOTrainer as JaxTrainer
from gymfx_tpu.train.ppo import evaluate as jax_evaluate
from gymfx_tpu.train.ppo import greedy_policy_driver as jax_greedy
from gymfx_tpu.train.ppo import ppo_config_from as jax_ppo_config_from
from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu_torch import convert
from gymfx_tpu_torch.app.main import main
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core.rollout import rollout_chunked
from gymfx_tpu_torch.train.checkpoint import save_checkpoint
from gymfx_tpu_torch.train.common import build_train_eval_envs
from gymfx_tpu_torch.train.ppo import PPOTrainer, evaluate, greedy_policy_driver, ppo_config_from

from test_torch_cli import assert_results_match
from test_torch_parity import assert_bitwise, x64_off

CSV = str(__import__("pathlib").Path(__file__).resolve().parent.parent
          / "examples" / "data" / "eurusd_sample.csv")
SMALL = dict(input_data_file=CSV, window_size=8, feature_columns=["CLOSE", "VOLUME"],
             num_envs=4, ppo_horizon=8, ppo_minibatches=2, ppo_minibatch_scheme="sample_permute",
             policy_kwargs={"hidden": [32, 32, 32]}, policy_dtype="float32", timeframe="M1")


def _configs(**over):
    jcfg, tcfg = dict(JAX_DEFAULTS, **SMALL), dict(DEFAULT_VALUES, **SMALL)
    jcfg.update(over)
    tcfg.update(over)
    return jcfg, tcfg


def _pair(split=None):
    jcfg, tcfg = _configs(eval_split=split)
    with x64_off():
        jtrain, jeval = jax_build_train_eval_envs(jcfg)
    ttrain, teval = build_train_eval_envs(tcfg, device="cpu")
    return (jtrain, jeval), (ttrain, teval), jcfg, tcfg


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 4.0)])
def test_greedy_actions_and_summary_match_jax_evaluate(seed, scale):
    (jenv, _), (tenv, _), jcfg, tcfg = _pair()
    with x64_off():
        jtr = JaxTrainer(jenv, jax_ppo_config_from(jcfg))
        # sharper logits (scale) make the greedy policy change its mind often
        jparams = jax.tree.map(lambda x: x * scale, jtr.init_state(seed).params)
        steps = jenv.cfg.n_bars - 1
        _, jout = jax_rollout_chunked(jenv.cfg, jenv.params, jenv.data, jax_greedy(jtr), steps,
                                      jax.random.PRNGKey(0),
                                      driver_carry=(jparams, jtr.policy.initial_carry(())))
        ref = json.loads(json.dumps(jax_evaluate(jtr, jparams)))
    ttr = PPOTrainer(tenv, ppo_config_from(tcfg))
    params = convert.mlp_params_from_flax(jax.tree.map(np.asarray, jparams), device="cpu")
    _, out = rollout_chunked(tenv.cfg, tenv.params, tenv.data, greedy_policy_driver(ttr), steps,
                             torch.Generator().manual_seed(0), driver_carry=(params, ()))
    actions = out["action"][:, 0]
    assert_bitwise(jout["action"], actions, "greedy actions")
    assert len(set(actions.tolist())) == 3 and (actions[1:] != actions[:-1]).sum() >= 5
    ours = json.loads(json.dumps(evaluate(ttr, params)))
    assert_results_match(ref, ours)
    assert ours["trades_total"] >= 2
    # the greedy driver is the trainer's own, so new weights reuse it
    assert greedy_policy_driver(ttr) is greedy_policy_driver(ttr)


@pytest.mark.parametrize("split", [0.25, 0.5, 0.9])
def test_the_chronological_cut_matches_jax(split):
    (jtrain, jeval), (ttrain, teval), *_ = _pair(split)
    assert (ttrain.n_bars, teval.n_bars) == (jtrain.n_bars, jeval.n_bars)
    assert ttrain.n_bars + teval.n_bars == 500
    for name in ("close", "padded_features", "feat_mean", "minute_of_week"):
        assert_bitwise(getattr(jeval.data, name), getattr(teval.data, name), f"eval {name}")
        assert_bitwise(getattr(jtrain.data, name), getattr(ttrain.data, name), f"train {name}")
    np.testing.assert_array_equal(np.asarray(jeval.dataset.timestamps, "datetime64[us]"),
                                  teval.dataset.timestamps)


def test_the_cut_refuses_what_the_jax_package_refuses():
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="leaves too few bars"):
        build_train_eval_envs(dict(tcfg, eval_split=0.99), device="cpu")
    with pytest.raises(ValueError, match="either eval_data_file or eval_split"):
        build_train_eval_envs(dict(tcfg, eval_split=0.5, eval_data_file=CSV), device="cpu")
    with pytest.raises(ValueError, match=r"must be in \(0, 1\)"):
        build_train_eval_envs(dict(tcfg, eval_split=1.5), device="cpu")
    train, held = build_train_eval_envs(dict(tcfg, eval_data_file=CSV), device="cpu")
    assert held.n_bars == train.n_bars == 500


def test_policy_mode_on_a_jax_trained_checkpoint_matches_jax(tmp_path):
    jdir, tdir = tmp_path / "jax_ckpt", tmp_path / "torch_ckpt"
    cfg_file = tmp_path / "small.json"
    cfg_file.write_text(json.dumps(dict(SMALL, eval_split=0.25)))
    common = ["--load_config", str(cfg_file), "--quiet_mode",
              "--results_file", str(tmp_path / "results.json"),
              "--save_config", str(tmp_path / "saved.json")]
    with x64_off():
        trained = jax_main(common + ["--mode", "training", "--train_total_steps", "96",
                                     "--checkpoint_dir", str(jdir)])
        flax_params, step = jax_load_params(str(jdir))
        meta = jax_read_metadata(str(jdir))
    assert trained["eval_scope"] == "held_out" and step == 96
    params = convert.mlp_params_from_flax(jax.tree.map(np.asarray, flax_params), device="cpu")
    # a params-only save: the bare tree, read back by load_params
    save_checkpoint(str(tdir), params, step=step,
                    metadata={k: meta[k] for k in ("policy", "policy_kwargs")})
    steps = ["--steps", str(trained["eval_bars"] - 1)]
    with x64_off():
        ref = json.loads(json.dumps(jax_main(common + ["--driver_mode", "policy",
                                                       "--checkpoint_dir", str(jdir)] + steps)))
    ours = json.loads(json.dumps(main(common + ["--driver_mode", "policy",
                                                "--checkpoint_dir", str(tdir)] + steps,
                                                device="cpu")))
    assert_results_match(ref, ours)
    assert ours["mode"] == "inference" and ours["checkpoint_step"] == 96
    assert ours["eval_scope"] == "held_out"
