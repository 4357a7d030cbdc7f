"""Fault injection (gymfx_tpu_torch/resilience/faults.py) and the
preemption drill (resilience/loop.py) against the JAX package's
(gymfx_tpu/resilience/faults.py, loop.py).

* ``parse_fault_profile`` gives equal dicts over a table of specs, and
  raises the same errors with the same messages on malformed ones.
* ``contaminate_market_data``, ``nonfinite_report`` and
  ``apply_fault_profile_to_market_data`` (NaN/inf bars on chosen fields,
  the scengen stress overlay first) are BITWISE the JAX package's on the
  same MarketData.
* ``FlakyEngine`` and ``FlakyTransport`` consume scripted and seeded
  probabilistic plans into the same token history and raise the same
  sequence of errors; an inert profile leaves the engine unwrapped.
* The preemption drill: ``ResilientLoop`` raises ``SimulatedPreemptionError``
  at the same iteration as the JAX loop for the same ``preempt_at`` and
  superstep sizes, after the iteration's checkpoint; through the command
  line, a run preempted at iteration 2 and resumed from its checkpoint
  ends bitwise where the uninterrupted run ends (every leaf of the train
  state, the generator's included).
* A training run's mesh events raise naming item 17, the decision
  fleet's events in serving naming item 16.
"""
import shutil

import numpy as np
import pytest
import torch

from gymfx_tpu.resilience import faults as JF
from gymfx_tpu.resilience.loop import ResilientLoop as JaxLoop

from gymfx_tpu_torch.app.main import main
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.resilience import faults as TF
from gymfx_tpu_torch.resilience.loop import ResilientLoop
from gymfx_tpu_torch.serve.engine import check_serving_config
from gymfx_tpu_torch.train import checkpoint as ckpt
from gymfx_tpu_torch.train.ppo import train_from_config

from test_torch_checkpoint import SMALL, _assert_trees_equal, _train_argv, _trainer
from test_torch_parity import assert_bitwise, paired_envs, random_walk_columns, x64_off

SPECS = [
    None, "", "nan_bars=30-31;transport=http:503,http:503,ok;seed=7",
    "serve=slow:40+slow:40+exc+ok;burst=32x4;seed=0", "inf_bars=5;fields=close+open",
    "nan_bars=2;nan_bars=7-9;preempt_at=3", "transport=p0.3;serve=p0.25", "burst=8",
    "fleet=kill:1@8+stall:0@4:250,flap:2@6", "mesh=kill:3@2+kill:0@1", "scengen=flash_crash",
    " nan_bars = 4 ; ; seed = 2 ", "fields=close,high;inf_bars=0-1",
]
BAD_SPECS = [
    "nan_bars", "bogus=1", "burst=0x2", "fleet=explode:1@2", "fleet=kill:1", "fleet=stall:0@4:-5",
    "fleet=kill:1@2:30", "mesh=kill:1", "mesh=kill:x@2", "mesh=kill:-1@2", "mesh=boom:1@2",
    "scengen=no_such_preset", "preempt_at=x", "fleet=kill:-1@3",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_profile_gives_the_jax_dict(spec):
    assert TF.parse_fault_profile(spec) == JF.parse_fault_profile(spec)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_fault_profile_raises_the_jax_errors(spec):
    with pytest.raises(Exception) as ref:
        JF.parse_fault_profile(spec)
    with pytest.raises(type(ref.value)) as ours:
        TF.parse_fault_profile(spec)
    assert str(ours.value) == str(ref.value)


def _data():
    jax_env, torch_env = paired_envs(random_walk_columns(n=64, seed=4), window_size=8,
                                     feature_columns=["CLOSE", "VOLUME"])
    return jax_env.data, torch_env.data


def _assert_data_bitwise(jdata, tdata):
    for field, ours in zip(type(tdata)._fields, tdata):
        if isinstance(ours, torch.Tensor):
            assert_bitwise(np.asarray(getattr(jdata, field)), ours, field)


@pytest.mark.parametrize("bars,fields,value", [
    ([3, 4, 63], ("close",), float("nan")),
    ([0, 10], ("close", "open", "high"), float("inf")),
    ([], ("close",), float("nan")),
])
def test_contamination_is_bitwise_the_jax_packages(bars, fields, value):
    jdata, tdata = _data()
    with x64_off():
        ref = JF.contaminate_market_data(jdata, bars=bars, fields=fields, value=value)
        ours = TF.contaminate_market_data(tdata, bars=bars, fields=fields, value=value)
        _assert_data_bitwise(ref, ours)
        assert TF.nonfinite_report(ours) == JF.nonfinite_report(ref)
    assert TF.nonfinite_report(tdata) == {}
    with pytest.raises(ValueError) as jerr:
        JF.contaminate_market_data(jdata, bars=[64])
    with pytest.raises(ValueError, match="out of range") as terr:
        TF.contaminate_market_data(tdata, bars=[64])
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("spec", ["nan_bars=5-6;inf_bars=9;fields=close+low",
                                  "scengen=flash_crash;seed=3;nan_bars=20",
                                  "scengen=range_chop;seed=1"])
def test_fault_profile_on_market_data_is_bitwise_the_jax_packages(spec):
    jdata, tdata = _data()
    with x64_off():
        ref = JF.apply_fault_profile_to_market_data(jdata, JF.parse_fault_profile(spec))
        ours = TF.apply_fault_profile_to_market_data(tdata, TF.parse_fault_profile(spec))
        _assert_data_bitwise(ref, ours)
        assert TF.nonfinite_report(ours) == JF.nonfinite_report(ref)


class _Engine:
    """The inner engine both wrappers delegate to: counts dispatches."""

    recurrent = False
    buckets = (1, 8)

    def __init__(self):
        self.calls = 0
        self.on_compile = None

    def decide_batch(self, obs, carries=None):
        self.calls += 1
        return ("ok", len(obs))


def _drive(wrapper, n):
    """The outcome of ``n`` dispatches: the result or the error's type."""
    out = []
    for _ in range(n):
        try:
            out.append(wrapper.decide_batch(np.zeros((2, 3), np.float32))[0])
        except Exception as exc:  # noqa: BLE001 - the injected errors
            out.append(type(exc).__name__)
    return out


@pytest.mark.parametrize("kwargs", [
    dict(plan=["exc", "ok", "slow:5", "exc", "stall:9"]),
    dict(plan=["exc"], failure_rate=0.5, seed=3),
    dict(failure_rate=0.3, rate_tokens=("exc", "slow:1"), seed=11),
])
def test_flaky_engine_raises_the_jax_sequence(kwargs):
    slept_j, slept_t = [], []
    ref = JF.FlakyEngine(_Engine(), sleep=slept_j.append, **kwargs)
    ours = TF.FlakyEngine(_Engine(), sleep=slept_t.append, **kwargs)
    assert _drive(ours, 12) == _drive(ref, 12)
    assert ours.history == ref.history and slept_t == slept_j
    assert (ours.dispatch_calls, ours.faults_injected) == (ref.dispatch_calls,
                                                           ref.faults_injected)
    assert ours._inner.calls == ref._inner.calls
    # attribute writes land on the wrapped engine; the wrapper's own stay
    ours.on_compile = print
    assert ours._inner.on_compile is print and ours.buckets == (1, 8)
    ours.push_faults("exc")
    with pytest.raises(TF.InjectedDispatchError):
        ours.decide_batch(np.zeros((1, 3), np.float32))
    with pytest.raises(ValueError, match="unknown serve fault token"):
        TF.FlakyEngine(_Engine(), plan=["boom"]).decide_batch(np.zeros((1, 3)))


def test_flaky_engine_from_profile_wraps_only_serving_plans():
    engine = _Engine()
    assert TF.flaky_engine_from_profile(engine, TF.parse_fault_profile("nan_bars=3")) is engine
    wrapped = TF.flaky_engine_from_profile(engine, TF.parse_fault_profile("serve=exc+ok;seed=4"),
                                           sleep=lambda s: None)
    ref = JF.flaky_engine_from_profile(_Engine(), JF.parse_fault_profile("serve=exc+ok;seed=4"),
                                       sleep=lambda s: None)
    assert _drive(wrapped, 3) == _drive(ref, 3) == ["InjectedDispatchError", "ok", "ok"]


def _venue(method, url, headers, body):
    return 201, b'{"orderFillTransaction": {"id": "7"}}'


@pytest.mark.parametrize("kwargs", [
    dict(plan=["timeout", "conn", "http:503", "accept-then-503", "partial", "ok"]),
    dict(failure_rate=0.4, seed=5),
    dict(plan=["http:429"], failure_rate=0.5, rate_tokens=("conn", "partial"), seed=9,
         match=lambda method, url: method == "POST"),
])
def test_flaky_transport_raises_the_jax_sequence(kwargs):
    def drive(transport):
        out, venue = [], []

        def inner(method, url, headers, body):
            venue.append(method)
            return _venue(method, url, headers, body)

        transport._inner = inner
        for i in range(10):
            try:
                out.append(transport("POST" if i % 3 else "GET", "https://venue/x", {}, b"{}"))
            except Exception as exc:  # noqa: BLE001 - the injected errors
                out.append(type(exc).__name__)
        return out, venue, transport.history, transport.faults_injected

    assert drive(TF.FlakyTransport(_venue, **kwargs)) == drive(JF.FlakyTransport(_venue, **kwargs))
    with pytest.raises(ValueError, match="unknown fault token"):
        TF.FlakyTransport(_venue, plan=["boom"])("GET", "u", {}, None)


@pytest.mark.parametrize("preempt_at,k", [(1, 1), (3, 1), (3, 2), (4, 3), (0, 2)])
def test_preemption_fires_at_the_jax_iteration(preempt_at, k, tmp_path):
    def run(loop_cls, error_cls):
        loop = loop_cls(steps_per_iter=10, preempt_at=preempt_at, max_consecutive_skips=0)
        it = 0
        while it < 12:
            try:
                loop.after_superstep(it, k, {}, lambda: ({}, {}))
            except error_cls as exc:
                return exc.iteration, it
            it += k
        return None

    ours = run(ResilientLoop, TF.SimulatedPreemptionError)
    assert ours == run(JaxLoop, JF.SimulatedPreemptionError)
    assert ours is not None


def test_a_preempted_run_resumes_bitwise_to_the_uninterrupted_one(tmp_path):
    full, drill = tmp_path / "full", tmp_path / "drill"
    summary = main(_train_argv(tmp_path, full, 256), device="cpu")
    assert summary["train_metrics"]["iterations"] == 4
    with pytest.raises(TF.SimulatedPreemptionError) as exc:
        main(_train_argv(tmp_path, drill, 256, "--fault_profile", "preempt_at=2"), device="cpu")
    # raised after iteration 2, its checkpoint (checkpoint_every 2) written
    assert exc.value.iteration == 2 and ckpt._list_steps(drill) == [128]
    again = main(_train_argv(tmp_path, drill, 128, "--resume_training", "true"), device="cpu")
    assert again["train_metrics"]["iterations"] == 2 and ckpt._list_steps(drill) == [128, 256]
    tr = _trainer()
    a, _ = ckpt.load_checkpoint(str(full), template=tr.init_state(0))
    b, _ = ckpt.load_checkpoint(str(drill), template=tr.init_state(0))
    _assert_trees_equal(a, b, "uninterrupted vs preempted-and-resumed train state")
    for key in ("final_equity", "total_return", "trades_total"):
        assert again[key] == summary[key], key
    shutil.rmtree(full)


def test_nan_bars_in_the_training_feed_are_skipped_and_quarantined(tmp_path):
    config = dict(DEFAULT_VALUES, **SMALL)
    config.update(train_total_steps=128, fault_profile="nan_bars=0-60;fields=close",
                  guard_max_consecutive_skips=0, eval_split=0.3)
    out = train_from_config(config, device="cpu")
    metrics = out["train_metrics"]
    # the episodes' bars are NaN: updates skipped, envs quarantined
    assert metrics["nonfinite_skips"] > 0 and metrics["poisoned_env_resets"] > 0
    # the held-out evaluation's tape stays clean
    assert out["eval_scope"] == "held_out" and np.isfinite(out["final_equity"])


def test_mesh_and_fleet_events_raise_naming_their_items():
    config = dict(DEFAULT_VALUES, **SMALL)
    with pytest.raises(NotImplementedError, match="item 17$"):
        train_from_config({**config, "fault_profile": "mesh=kill:0@1"}, device="cpu")
    with pytest.raises(NotImplementedError, match="item 16$"):
        check_serving_config({"fault_profile": "fleet=kill:1@8"})
    # a fleet clause is inert in training, a mesh clause inert in serving
    TF.refuse_mesh_and_fleet(TF.parse_fault_profile("fleet=kill:1@8"))
    check_serving_config({"fault_profile": "mesh=kill:0@1;serve=exc"})
