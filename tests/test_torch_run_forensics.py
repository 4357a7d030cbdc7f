"""Run forensics: the port's run ledger and flight recorder
(gymfx_tpu_torch/telemetry/ledger.py, flight_recorder.py) against the
JAX package's (gymfx_tpu/telemetry/).

* ``config_digest`` is the JAX package's sha256 for the same config.
* The port's schema copies have the JAX package's keys (only their
  ``_comment`` differs: it states the ``rng_key`` form); the ledger and
  postmortem validators flag the same drift.
* The same short chaos run (``fault_profile`` NaN bars plus the
  preemption drill, periodic checkpoints, a ledger and a flight
  recorder) through both packages' ``train_from_config``: the same
  sequence of ledger ``kind``s and their iteration and step fields, both
  files valid; one postmortem bundle each, valid against the port's
  schema, the same frames (iterations, superstep sizes, the JAX
  package's metric keys), the manifest's ``rng_key`` the generator state
  the run died with.
* The divergence path: a run of fully skipped steps dumps a
  ``divergence`` postmortem and ledgers it, as the JAX loop does.
"""
import json
import os

import numpy as np
import pytest
import torch

from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS
from gymfx_tpu.resilience.faults import SimulatedPreemptionError as JaxPreemption
from gymfx_tpu.telemetry import ledger as jledger
from gymfx_tpu.telemetry import flight_recorder as jrecorder
from gymfx_tpu.train.ppo import train_from_config as jax_train_from_config

from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.resilience.faults import SimulatedPreemptionError
from gymfx_tpu_torch.resilience.guards import NonFiniteDivergenceError
from gymfx_tpu_torch.resilience.loop import ResilientLoop
from gymfx_tpu_torch.telemetry import (
    FlightRecorder,
    RunLedger,
    config_digest,
    validate_ledger,
    validate_postmortem,
)
from gymfx_tpu_torch.telemetry import flight_recorder as trecorder
from gymfx_tpu_torch.telemetry import ledger as tledger
from gymfx_tpu_torch.train.checkpoint import load_checkpoint
from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from, train_from_config

from test_torch_parity import x64_off

CHAOS = {
    "input_data_file": "examples/data/eurusd_sample.csv", "window_size": 8, "num_envs": 4,
    "ppo_horizon": 16, "ppo_epochs": 2, "ppo_minibatches": 2,
    "policy_kwargs": {"hidden": [16, 16]}, "train_total_steps": 192, "seed": 1,
    "fault_profile": "nan_bars=30-31;seed=7;preempt_at=2", "checkpoint_every": 1,
    "telemetry_flight_recorder_k": 4,
}


@pytest.mark.parametrize("over", [{}, {"num_envs": 8, "policy": "lstm", "nested": {"b": [1, 2]}},
                                  {"weird": object, "telemetry_ledger": "x.jsonl"}])
def test_config_digest_is_the_jax_packages(over):
    for base in (DEFAULT_VALUES, {}):
        config = {**base, **over}
        assert config_digest(config) == jledger.config_digest(config)
    assert config_digest(None) is None
    assert config_digest(DEFAULT_VALUES) == jledger.config_digest(JAX_DEFAULTS)


def test_the_schema_copies_have_the_jax_keys():
    for ours, ref in ((tledger.load_ledger_schema(), jledger.load_ledger_schema()),
                      (trecorder.load_postmortem_schema(), jrecorder.load_postmortem_schema())):
        assert ours == ref
    raw = json.loads(open(trecorder.SCHEMA_PATH).read())
    assert "rng_key" in raw["_comment"] and "torch.Generator" in raw["_comment"]
    rows = [{"seq": 1, "ts": 0.0, "kind": "run_start", "config_sha256": None,
             "schema_version": 1},
            {"seq": 1, "ts": 0.0, "kind": "bogus", "config_sha256": None, "schema_version": 1},
            {"seq": 3, "kind": "checkpoint_write", "config_sha256": None, "schema_version": 1}]
    assert tledger.validate_ledger_rows(rows) == jledger.validate_ledger_rows(rows)
    assert len(tledger.validate_ledger_rows(rows)) == 4


def _kinds(path):
    rows = tledger.read_ledger(path)
    keep = ("it_start", "k", "step", "it", "reason")
    return [(r["kind"], *(r.get(key) for key in keep)) for r in rows]


def _bundle(directory):
    names = os.listdir(directory)
    assert len(names) == 1 and "preemption" in names[0]
    path = os.path.join(directory, names[0])
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    frames = [json.loads(line) for line in open(os.path.join(path, "frames.jsonl"))]
    return path, manifest, frames


def test_a_chaos_run_ledgers_and_dumps_what_the_jax_run_does(tmp_path):
    def config(base, name):
        return {**base, **CHAOS, "checkpoint_dir": str(tmp_path / name / "ckpt"),
                "telemetry_ledger": str(tmp_path / name / "ledger.jsonl"),
                "telemetry_flight_recorder_dir": str(tmp_path / name / "pm")}

    ours = config(DEFAULT_VALUES, "port")
    with pytest.raises(SimulatedPreemptionError) as exc:
        train_from_config(ours, device="cpu")
    assert exc.value.iteration == 2
    ref = config(JAX_DEFAULTS, "jax")
    with x64_off(), pytest.raises(JaxPreemption):
        jax_train_from_config(ref)
    for path in (ours["telemetry_ledger"], ref["telemetry_ledger"]):
        assert validate_ledger(path) == [] and jledger.validate_ledger(path) == []
    assert [row[0] for row in _kinds(ours["telemetry_ledger"])] == [
        "run_start", "superstep_dispatch", "checkpoint_write", "superstep_dispatch",
        "checkpoint_write", "preemption", "postmortem_dump", "run_end"]
    strip = lambda rows: [row[:5] for row in rows]  # noqa: E731 (the dump's path differs)
    assert strip(_kinds(ours["telemetry_ledger"])) == strip(_kinds(ref["telemetry_ledger"]))
    rows = tledger.read_ledger(ours["telemetry_ledger"])
    assert {r["config_sha256"] for r in rows} == {config_digest(ours)}

    path, manifest, frames = _bundle(ours["telemetry_flight_recorder_dir"])
    jpath, jmanifest, jframes = _bundle(ref["telemetry_flight_recorder_dir"])
    assert validate_postmortem(path) == [] and validate_postmortem(jpath) == []
    assert sorted(manifest) == sorted(jmanifest)
    assert (manifest["reason"], manifest["frames"], manifest["it"]) == (
        jmanifest["reason"], jmanifest["frames"], jmanifest["it"]) == ("preemption", 2, 2)
    assert manifest["resilience"].keys() == jmanifest["resilience"].keys()
    assert [(f["it_end"], f["k"]) for f in frames] == [(f["it_end"], f["k"]) for f in jframes]
    assert frames[-1]["metrics"].keys() >= jframes[-1]["metrics"].keys()
    # the generator state the run died with: the one in the preemption's
    # checkpoint
    trainer = PPOTrainer(Environment(ours, device="cpu"), ppo_config_from(ours))
    state, step = load_checkpoint(str(tmp_path / "port" / "ckpt"), template=trainer.init_state(0))
    assert step == 2 * 4 * 16
    assert manifest["rng_key"] == state.generator.get_state().tolist()


def test_divergence_dumps_a_postmortem_and_ledgers_it(tmp_path):
    led = RunLedger(str(tmp_path / "ledger.jsonl"))
    rec = FlightRecorder(str(tmp_path / "pm"), k=4, ledger=led)
    rec.set_rng_source(lambda: torch.Generator().manual_seed(5).get_state())
    loop = ResilientLoop(steps_per_iter=1, max_consecutive_skips=2, ledger=led, recorder=rec)
    sick = {"nonfinite_skips": torch.tensor(1.0), "guard_updates": torch.tensor(1.0),
            "poisoned_env_resets": torch.tensor(0.0)}
    with pytest.raises(NonFiniteDivergenceError):
        for it in range(5):
            rec.record_frame(it + 1, 1, {"loss": [float(it)], "x": np.float32([it])})
            loop.after_superstep(it, 1, dict(sick), lambda: ({"params": {}}, {}))
    led.close()
    rows = tledger.read_ledger(led.path)
    kinds = [r["kind"] for r in rows]
    # read one dispatch late: the second sick step is read at the third's hooks
    assert kinds == ["run_start"] + ["superstep_dispatch"] * 3 + [
        "divergence", "postmortem_dump", "run_end"]
    assert validate_ledger(led.path) == []
    dump = next(r for r in rows if r["kind"] == "postmortem_dump")
    assert dump["reason"] == "divergence" and validate_postmortem(dump["path"]) == []
    manifest = json.load(open(os.path.join(dump["path"], "manifest.json")))
    assert manifest["frames"] == 3 and manifest["it"] == 2
    assert manifest["rng_key"] == torch.Generator().manual_seed(5).get_state().tolist()
