"""Checkpoints, resume and the non-finite skip guard of the port
(train/checkpoint.py, resilience/loop.py, resilience/guards.py,
PPOTrainer.train), on the CPU at small sizes (8 envs, horizon 8, a
16-wide MLP on examples/data/eurusd_sample.csv).

* save, digest verification, newest-N pruning with a protected step, a
  torn step skipped for the newest step that verifies, a step saved twice
  (warned and skipped), and a restore against a template of another
  architecture (refused at load time);
* a saved state's bytes are within 1.1x of the sum of its leaves' bytes,
  also when leaves are row views of a larger block (K2's and K3's
  outputs on the card), whose whole block ``torch.save`` of the views
  themselves would store;
* a 4-iteration training run through the command line against 2
  iterations plus a resume of 2 (``resume_training``), one train step a
  dispatch and two: every leaf of the final train state, the generator's
  state included, ``torch.equal``;
* the skip guard: NaN params make every update non-finite, and after
  ``guard_max_consecutive_skips`` such iterations the run saves a
  diagnostic checkpoint and raises ``NonFiniteDivergenceError``.
"""
import io
import json
import shutil
import warnings

import pytest
import torch

from gymfx_tpu_torch.app.main import main
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.resilience.guards import NonFiniteDivergenceError, SkipMonitor
from gymfx_tpu_torch.train import checkpoint as ckpt
from gymfx_tpu_torch.train.ppo import PPOTrainer, TrainState, ppo_config_from

CSV = str(__import__("pathlib").Path(__file__).resolve().parent.parent
          / "examples" / "data" / "eurusd_sample.csv")
SMALL = dict(input_data_file=CSV, window_size=8, feature_columns=["CLOSE", "VOLUME"],
             num_envs=8, ppo_horizon=8, ppo_minibatches=2, policy_kwargs={"hidden": [16, 16, 16]})


def _trainer(**over):
    config = dict(DEFAULT_VALUES, **SMALL)
    config.update(over)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return PPOTrainer(Environment(config, device="cpu"), ppo_config_from(config))


def _assert_trees_equal(a, b, what):
    fa, fb = ckpt.flatten_tree(a), ckpt.flatten_tree(b)
    assert list(fa) == list(fb), what
    for key in fa:
        x, y = fa[key], fb[key]
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: {key}"


def test_save_verify_load_prune_and_torn_steps(tmp_path):
    tr = _trainer()
    state, _ = tr.train_step(tr.init_state(0))
    d = tmp_path / "ck"
    for step in (64, 128, 192, 256):
        ckpt.save_checkpoint(str(d), state, step=step, metadata={"policy": "mlp"},
                             params=state.params)
    assert ckpt.read_metadata(str(d)) == {"policy": "mlp", "state_format": "composite"}
    assert sorted(p.name for p in d.iterdir()) == [
        "128", "192", "256", "64", "digest_128.json", "digest_192.json", "digest_256.json",
        "digest_64.json", "metadata.json"]
    assert sorted(p.name for p in (d / "256").iterdir()) == ["params.pt", "state.pt"]
    step, digest = ckpt.verify_checkpoint(str(d))
    assert step == 256 and len(digest) == 64
    restored, step = ckpt.load_checkpoint(str(d), template=tr.init_state(0))
    assert step == 256 and isinstance(restored, TrainState)
    _assert_trees_equal(restored, state, "restored state")
    params, _ = ckpt.load_params(str(d), template=tr.params_template())
    _assert_trees_equal(params, state.params, "restored params")

    # saving a step that exists warns and leaves it as it was
    before = (d / "256" / "state.pt").read_bytes()
    with pytest.warns(UserWarning, match="already exists"):
        ckpt.save_checkpoint(str(d), tr.init_state(1), step=256, params=state.params)
    assert (d / "256" / "state.pt").read_bytes() == before

    # a torn newest step fails its digest and the newest good one loads
    with open(d / "256" / "state.pt", "r+b") as fh:
        fh.seek(100)
        fh.write(b"\xff\xff\xff\xff")
    assert not ckpt.verify_checkpoint_step(str(d), 256)
    with pytest.raises(ckpt.CheckpointIntegrityError):
        ckpt.verify_checkpoint(str(d), 256)
    assert ckpt.load_checkpoint(str(d), template=tr.init_state(0))[1] == 192

    # newest-2 retention with step 64 protected, sidecars with their steps
    pruned = ckpt.prune_checkpoints(str(d), keep=2, protect=(64,))
    assert [row["step"] for row in pruned] == [128] and pruned[0]["bytes"] > 0
    assert ckpt._list_steps(d) == [64, 192, 256]
    assert not (d / "digest_128.json").exists()
    # save-time retention likewise
    ckpt.save_checkpoint(str(d), state, step=320, params=state.params, keep=1, protect=(192,))
    assert ckpt._list_steps(d) == [192, 320]
    with pytest.raises(FileNotFoundError):
        ckpt.verify_checkpoint(str(d), 64)
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "empty"))


@pytest.mark.parametrize("over", [{"policy_kwargs": {"hidden": [16, 32, 16]}},
                                  {"num_envs": 16}, {"window_size": 12}])
def test_a_template_of_another_configuration_is_refused_at_load(tmp_path, over):
    tr = _trainer()
    state = tr.init_state(0)
    ckpt.save_checkpoint(str(tmp_path), state, step=8, params=state.params)
    other = _trainer(**over)
    with pytest.raises(ValueError, match="does not match the configured policy architecture"):
        ckpt.load_checkpoint(str(tmp_path), template=other.init_state(0))
    if "policy_kwargs" in over:
        with pytest.raises(ValueError, match="does not match"):
            ckpt.load_params(str(tmp_path), template=other.params_template())


def test_saved_bytes_are_the_leaves_own_even_for_row_views(tmp_path):
    tr = _trainer(num_envs=1024, ppo_horizon=2, ppo_minibatches=1)
    state, _ = tr.train_step(tr.init_state(0))
    n = tr.pcfg.n_envs
    # as K2 and K3 leave their outputs on the card: rows of a block that
    # holds more rows than the state keeps
    block = torch.arange(64 * n, dtype=torch.float32).reshape(64, n)
    rows = dict(pending_target=block[0], pending_sl=block[1], pending_tp=block[2],
                bracket_sl=block[3], bracket_tp=block[4], last_trade_cost=block[5])
    state = state._replace(env_states=state.env_states._replace(**rows))
    flat = ckpt.flatten_tree(state)
    leaf_bytes = sum(v.get_state().nbytes if isinstance(v, torch.Generator) else v.nbytes
                     for v in flat.values())
    ckpt.save_checkpoint(str(tmp_path), state, step=1, params=state.params)
    saved = (tmp_path / "1" / "state.pt").stat().st_size
    assert leaf_bytes <= saved <= 1.1 * leaf_bytes, (saved, leaf_bytes)
    # the pitfall itself: torch.save of the views stores their whole block
    raw = io.BytesIO()
    torch.save({k: v for k, v in flat.items() if isinstance(v, torch.Tensor)}, raw)
    assert len(raw.getvalue()) > 1.1 * leaf_bytes
    restored, _ = ckpt.load_checkpoint(str(tmp_path), template=tr.init_state(0))
    assert torch.equal(restored.env_states.bracket_tp, block[4])


def _train_argv(tmp_path, d, total, *extra):
    (tmp_path / "small.json").write_text(json.dumps(SMALL))
    return ["--mode", "training", "--load_config", str(tmp_path / "small.json"),
            "--train_total_steps", str(total), "--checkpoint_dir", str(d), "--checkpoint_every", "2",
            "--results_file", str(tmp_path / "results.json"),
            "--save_config", str(tmp_path / "config.json"), "--quiet_mode", *extra]


@pytest.mark.parametrize("supersteps", [1, 2])
def test_resume_continues_the_uninterrupted_run_bit_for_bit(tmp_path, supersteps):
    full, resumed = tmp_path / "full", tmp_path / "resumed"
    k = ["--supersteps_per_dispatch", str(supersteps)]
    summary = main(_train_argv(tmp_path, full, 256, *k), device="cpu")
    assert summary["train_metrics"]["iterations"] == 4
    assert summary["train_metrics"]["last_checkpoint_step"] == 256
    assert ckpt._list_steps(full) == [128, 256]
    # an interrupted run: only its step-128 checkpoint is on disk
    resumed.mkdir()
    for name in ("128", "digest_128.json", "metadata.json"):
        src = full / name
        (shutil.copytree if src.is_dir() else shutil.copy)(src, resumed / name)
    again = main(_train_argv(tmp_path, resumed, 128, "--resume_training", "true", *k),
                 device="cpu")
    assert again["train_metrics"]["iterations"] == 2
    assert ckpt._list_steps(resumed) == [128, 256]
    tr = _trainer()
    a, _ = ckpt.load_checkpoint(str(full), template=tr.init_state(0))
    b, _ = ckpt.load_checkpoint(str(resumed), template=tr.init_state(0))
    _assert_trees_equal(a, b, "uninterrupted vs resumed train state")
    fresh = tr.init_state(0).params
    assert not all(torch.equal(a.params[k], fresh[k]) for k in fresh)  # it trained
    for key in ("final_equity", "total_return", "trades_total", "sharpe_ratio_steps"):
        assert again[key] == summary[key], key
    meta = json.loads((full / "metadata.json").read_text())
    assert meta == {"policy": "mlp", "policy_kwargs": {"hidden": [16, 16, 16]},
                    "state_format": "composite"}


def test_the_skip_guard_saves_a_diagnostic_checkpoint_then_raises(tmp_path):
    tr = _trainer()
    state = tr.init_state(0)
    nan_params = {k: torch.full_like(v, float("nan")) for k, v in state.params.items()}
    steps_per_iter = tr.pcfg.n_envs * tr.pcfg.horizon
    with pytest.raises(NonFiniteDivergenceError, match="non-finite for 2 consecutive") as err:
        tr.train(6 * steps_per_iter, initial_params=nan_params, max_consecutive_skips=2,
                 checkpoint_dir=str(tmp_path), step_offset=1000)
    assert err.value.metrics["nonfinite_skips"] == err.value.metrics["guard_updates"] == 8.0
    # read one dispatch late: iteration 2's counters after iteration 3's
    # dispatch, so the diagnostic step is the end of iteration 2
    assert ckpt._list_steps(tmp_path) == [1000 + 2 * steps_per_iter]
    params, _ = ckpt.load_params(str(tmp_path), template=tr.params_template())
    assert all(torch.isnan(v).all() for v in params.values())  # the last (stale) params
    # the guard off: the same run finishes, every update skipped
    _, metrics = tr.train(2 * steps_per_iter, initial_params=nan_params, max_consecutive_skips=0)
    assert metrics["nonfinite_skips"] == 8.0
    with pytest.raises(ValueError, match="max_consecutive must be >= 1"):
        SkipMonitor(0)


@pytest.mark.parametrize("name,value,item", [("log_every", 1, 10), ("preempt_at", 1, 10),
                                             ("telemetry", object(), 10),
                                             ("mesh_faults", ({"at": 1},), 17)])
def test_train_options_not_ported_raise_naming_their_item(name, value, item):
    with pytest.raises(NotImplementedError, match=f"item {item}$"):
        _trainer().train(64, **{name: value})
