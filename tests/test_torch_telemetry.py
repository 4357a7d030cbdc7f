"""The port's telemetry (gymfx_tpu_torch/telemetry/) against the JAX
package's (gymfx_tpu/telemetry/), and the trainers' and the serving
stack's hooks into it.

* The Prometheus exposition and the registry snapshot are the JAX
  package's, byte for byte, for the same registry calls (labels with
  escapes, callback gauges, histograms, NaN and infinities).
* ``DelayedLogger`` prints the JAX package's lines, character for
  character, for the same per-iteration metrics (0-d and stacked), one
  dispatch late; ``DeviceMetricStream`` drains the same registry
  exposition, sink rows and flight-recorder frames.
* The off path: with every telemetry key unset ``telemetry_from_config``
  is None, and PPO's and IMPALA's final train states (params, moments,
  env batch, generator) are ``torch.equal`` to those of the bare loop of
  train steps; so are the states of a run with every trainer key on and
  ``log_every`` set.
* ``train_from_config`` with every trainer key on writes the sink's
  metric rows, spans and the registry snapshot; it takes the performance
  observatory's keys too.
* A ``/metrics`` scrape on loopback after a scripted burst (a
  ``FlakyEngine`` plan under a micro-batcher with instruments) has the
  JAX package's families and counts; an engine built with
  ``telemetry_http_port`` serves ``/healthz`` from the engine; the
  ``late_compiles`` gauge binds only where the engine counts captures.
* The analytic FLOP model is the JAX package's; spans enter
  ``torch.profiler.record_function`` while a profiler records.
"""
import json
import math
import time
from collections import deque
import types

import numpy as np
import pytest
import torch

from gymfx_tpu import telemetry as JT
from gymfx_tpu.resilience import faults as JF
from gymfx_tpu.serve.batcher import MicroBatcher as JaxBatcher
from gymfx_tpu.telemetry import mfu as jmfu
from gymfx_tpu.telemetry.instruments import ServeInstruments as JaxInstruments
from gymfx_tpu.telemetry.prometheus import render as jax_render

from gymfx_tpu_torch import telemetry as TT
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.resilience import faults as TF
from gymfx_tpu_torch.serve import MicroBatcher
from gymfx_tpu_torch.telemetry import mfu as tmfu
from gymfx_tpu_torch.telemetry.http import TelemetryServer, scrape
from gymfx_tpu_torch.telemetry.instruments import ServeInstruments, instruments_from_telemetry
from gymfx_tpu_torch.telemetry.prometheus import render
from gymfx_tpu_torch.train import impala as timpala
from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from, train_from_config

from test_serve_overload import FakeEngine as JaxFakeEngine
from test_torch_checkpoint import SMALL
from test_torch_serve_batcher import OBS_DIM, FakeEngine


def _fill(mod):
    """The same registry calls on ``mod``'s registry."""
    reg = mod.MetricsRegistry()
    reg.histogram("t_lat", "Latency", buckets=(0.5, 1.0)).observe(0.25)
    reg.histogram("t_lat", buckets=(0.5, 1.0)).observe(0.75)
    reg.histogram("t_lat", buckets=(0.5, 1.0)).observe(5.0)
    h = reg.histogram("t_span_seconds", "Spans\nby name", labels=("span",))
    for v in (0.0001, 0.003, 0.2, 30.0):
        h.observe(v, span="train/superstep")
    h.observe(1.5, span='odd "name"\\x')
    ctr = reg.counter("t_requests_total", "Total requests", labels=("path",))
    ctr.inc(2.0, path="/a")
    ctr.inc(path="/b")
    ctr.inc(0.1, path="/b")
    reg.gauge("t_temp", "Temperature").set(1.5)
    g = reg.gauge("t_odd", "Odd values", labels=("kind",))
    g.set(float("nan"), kind="nan")
    g.set(float("inf"), kind="pinf")
    g.set(float("-inf"), kind="ninf")
    g.set(1e16, kind="big")
    g.set(-3.0, kind="neg")
    reg.gauge("t_live", "Callback").set_function(lambda: 7.25)
    reg.gauge("t_dead", "Dead callback").set_function(lambda: 1 / 0)
    reg.gauge("t_empty", "Never set", labels=("x",))
    return reg


def test_prometheus_exposition_and_snapshot_are_the_jax_packages():
    ours, ref = _fill(TT), _fill(JT)
    assert render(ours) == jax_render(ref)
    assert json.dumps(ours.snapshot(), sort_keys=True) == json.dumps(ref.snapshot(),
                                                                      sort_keys=True)
    assert render(TT.MetricsRegistry()) == jax_render(JT.MetricsRegistry()) == ""


def _dispatches():
    """(it_start, k, metrics as numpy) of a short run: 0-d metrics at k =
    1, stacked (k,) ones at k > 1."""
    rng = np.random.default_rng(1)
    out, it = [], 0
    for k in (1, 2, 1, 3, 1):
        names = ("loss", "entropy", "nonfinite_skips", "guard_updates", "poisoned_env_resets",
                 "mean_reward", "grad_norm")
        vals = {n: rng.normal(size=(k,)).astype(np.float32) for n in names}
        vals["nonfinite_skips"] = np.float32(rng.integers(0, 3, (k,)))
        vals["poisoned_env_resets"] = np.float32(rng.integers(0, 2, (k,)))
        vals["guard_updates"] = np.full((k,), 4.0, np.float32)
        if k == 1:
            vals = {n: v[0] for n, v in vals.items()}
        out.append((it, k, vals))
        it += k
    return out


def _drive_stream(stream, dispatches, as_tensor):
    for it, k, vals in dispatches:
        stream.after_dispatch(it, k, {n: as_tensor(v) for n, v in vals.items()})
    stream.finish()


def test_delayed_logger_prints_the_jax_lines(capsys):
    import jax.numpy as jnp

    for every in (1, 2, 3):
        _drive_stream(JT.DelayedLogger("ppo", every, 9), _dispatches(), jnp.asarray)
        ref = capsys.readouterr().out
        _drive_stream(TT.DelayedLogger("ppo", every, 9), _dispatches(), torch.as_tensor)
        ours = capsys.readouterr().out
        assert ours == ref and ours.count("\n") >= 2


def test_the_device_stream_drains_what_the_jax_stream_drains(tmp_path):
    import jax.numpy as jnp

    def run(mod, as_tensor, name):
        reg = mod.MetricsRegistry()
        sink = mod.JsonlSink(str(tmp_path / f"{name}.jsonl"))
        rec = mod.FlightRecorder(str(tmp_path / name), k=3, config_sha256="x")
        stream = mod.DeviceMetricStream("ppo", iters=9, registry=reg, sink=sink,
                                        steps_per_iter=64, recorder=rec)
        held = []
        for it, k, vals in _dispatches():
            stream.after_dispatch(it, k, {n: as_tensor(v) for n, v in vals.items()})
            held.append(render(reg) if mod is TT else jax_render(reg))
        stream.finish()
        rows = [json.loads(line) for line in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
        for row in rows:
            row.pop("ts")
        return held, render(reg) if mod is TT else jax_render(reg), rows, list(rec._frames)

    ours, ref = run(TT, torch.as_tensor, "port"), run(JT, jnp.asarray, "jax")
    assert ours == ref
    # one dispatch late: nothing drained until the second dispatch
    assert "gymfx_train_iterations_total{" not in ours[0][0]
    assert 'gymfx_train_iterations_total{algo="ppo"} 1' in ours[0][1]
    assert len(ours[2]) == 5 and [f["it_end"] for f in ours[3]] == [4, 7, 8]


def test_host_copy_reads_cpu_metrics_in_sorted_order():
    copy = TT.HostCopy({"b": torch.tensor([1.0, 2.0]), "a": torch.tensor(3.0), "c": 4})
    host = copy.get()
    assert list(host) == ["a", "b", "c"]
    assert host["a"].tolist() == [3.0] and host["b"].tolist() == [1.0, 2.0] and host["c"] == [4]


def test_telemetry_from_config_is_none_with_every_key_unset_and_builds_each_piece(tmp_path):
    assert TT.telemetry_from_config(dict(DEFAULT_VALUES)) is None
    assert TT.telemetry_from_config({"telemetry_http_port": -1}) is None
    t = TT.telemetry_from_config({"telemetry_jsonl": str(tmp_path / "t.jsonl"),
                                  "telemetry_spans": True, "telemetry_http_port": 0,
                                  "telemetry_ledger": str(tmp_path / "l.jsonl"),
                                  "telemetry_flight_recorder_dir": str(tmp_path / "pm")})
    try:
        assert t.sink is not None and t.tracer.enabled and t.ledger is TT.get_active_ledger()
        assert t.recorder.config_sha256 == t.ledger.config_sha256
        server = t.start_http()
        assert server is t.start_http() and server.port > 0
    finally:
        t.close()
    assert TT.get_active_ledger() is None


@pytest.mark.parametrize("key,value", [("telemetry_compile_watch", True),
                                       ("telemetry_profile_dir", "prof"),
                                       ("telemetry_profile_supersteps", "1,2"),
                                       ("telemetry_profile_every", 2)])
def test_the_performance_observatory_keys_raise_naming_item_30(key, value, tmp_path):
    """The observatory's keys no longer raise (item 30 is ported,
    tests/test_torch_observatory.py): the compile watch and the profile
    dir each build their part of the bundle, the cadence keys alone build
    nothing (the dir is the master switch, as in the JAX package), and a
    training run takes each."""
    if key == "telemetry_profile_dir":
        value = str(tmp_path / value)
    t = TT.telemetry_from_config({key: value})
    try:
        if key == "telemetry_compile_watch":
            assert t.compile_watch is not None and t.profiler is None
        elif key == "telemetry_profile_dir":
            assert t.profiler is not None and t.profiler.supersteps == (1,)
        else:
            assert t is None
    finally:
        if t is not None:
            t.close()
    out = train_from_config({**DEFAULT_VALUES, **SMALL, "train_total_steps": 128, key: value},
                            device="cpu")
    assert out["train_metrics"]["iterations"] == 2


def _leaves(state):
    from gymfx_tpu_torch.resilience.guards import tree_leaves

    out = []
    for leaf in tree_leaves(tuple(state)):
        out.append(leaf.get_state() if isinstance(leaf, torch.Generator) else leaf)
    return out


def _all_keys(tmp_path):
    return {"telemetry_enabled": True, "telemetry_jsonl": str(tmp_path / "t.jsonl"),
            "telemetry_spans": True, "telemetry_http_port": 0,
            "telemetry_ledger": str(tmp_path / "ledger.jsonl"),
            "telemetry_flight_recorder_dir": str(tmp_path / "pm")}


@pytest.mark.parametrize("algo", ["ppo", "impala"])
def test_the_off_path_is_the_bare_loop_and_so_is_the_on_path(algo, tmp_path, capsys):
    config = {**DEFAULT_VALUES, **SMALL}
    if algo == "impala":
        config.update(policy="lstm", policy_kwargs={"hidden": 8}, impala_unroll=8)
        make = lambda: timpala.ImpalaTrainer(Environment(config, device="cpu"),  # noqa: E731
                                             timpala.impala_config_from(config))
    else:
        make = lambda: PPOTrainer(Environment(config, device="cpu"),  # noqa: E731
                                  ppo_config_from(config))
    tr = make()
    state = tr.init_state(3)
    for _ in range(3):
        state, _ = tr.train_step(state)
    total = 3 * SMALL["num_envs"] * 8
    off, _ = make().train(total, seed=3)
    telemetry = TT.telemetry_from_config({**config, **_all_keys(tmp_path)})
    try:
        on, metrics = make().train(total, seed=3, log_every=1, telemetry=telemetry)
    finally:
        telemetry.close()
    for a, b, c in zip(_leaves(state), _leaves(off), _leaves(on)):
        assert torch.equal(a, b) and torch.equal(a, c)
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(" {")[0] for line in lines] == [f"[{algo}] iter {i}/3" for i in (1, 2, 3)]
    # the drained metrics are the returned ones
    drained = [json.loads(r) for r in (tmp_path / "t.jsonl").read_text().splitlines()]
    last = [r for r in drained if r["kind"] == "train_metrics"][-1]
    assert {k: last[k] for k in metrics if k in last} == {
        k: metrics[k] for k in metrics if k in last} and last["iter"] == 3


def test_train_from_config_with_every_trainer_key(tmp_path):
    config = {**DEFAULT_VALUES, **SMALL, **_all_keys(tmp_path), "train_total_steps": 128}
    out = train_from_config(config, device="cpu")
    rows = [json.loads(r) for r in (tmp_path / "t.jsonl").read_text().splitlines()]
    kinds = [r["kind"] for r in rows]
    assert kinds.count("train_metrics") == 2 and kinds.count("span") == 2
    assert kinds[-1] == "metrics_snapshot"
    snap = rows[-1]["registry"]
    assert snap["gymfx_train_iterations_total"]["samples"][0]["value"] == 2.0
    assert snap["gymfx_train_env_steps_total"]["samples"][0]["value"] == 128.0
    assert "gymfx_resilience_skip_monitor_consecutive" in snap
    assert "gymfx_span_seconds" in snap
    gauge = {s["labels"]["metric"]: s["value"] for s in snap["gymfx_train_metric"]["samples"]}
    assert gauge["loss"] == pytest.approx(out["train_metrics"]["loss"], rel=1e-6)
    assert TT.get_active_ledger() is None


def _burst(batcher_cls, engine, instruments, rows):
    mb = batcher_cls(engine, max_batch_wait_ms=0.0, instruments=instruments)
    outcomes = []
    try:
        for row in rows:
            try:
                mb.submit(row).result(timeout=30)
                outcomes.append("served")
            except Exception as exc:  # noqa: BLE001 - the injected failures
                outcomes.append(type(exc).__name__)
        deadline = time.perf_counter() + 5.0  # the completion hooks
        while (instruments.requests.value(batcher="flaky", outcome="served")
               < outcomes.count("served")) and time.perf_counter() < deadline:
            time.sleep(0.001)
        health = mb.health()
    finally:
        mb.close()
    return outcomes, health


def _families_and_counts(text):
    """The exposition's families and its sample lines, without the
    latency-valued ones (their values are times)."""
    families = [line.split()[2] for line in text.splitlines() if line.startswith("# TYPE")]
    timed = ("_seconds", "gymfx_serve_slo_p99")
    samples = [line for line in text.splitlines()
               if not line.startswith("#") and not any(t in line.split("{")[0] for t in timed)]
    return families, samples


def test_a_metrics_scrape_after_a_scripted_burst_is_the_jax_packages():
    plan = ["exc", "ok", "exc", "ok", "ok", "exc"]
    rows = [np.random.default_rng(20 + i).standard_normal(OBS_DIM).astype(np.float32)
            for i in range(6)]
    ref_reg = JT.MetricsRegistry()
    ref_instr = JaxInstruments(ref_reg, slo=JT.SLOWindow(60.0), name="flaky")
    ref = _burst(JaxBatcher, JF.FlakyEngine(JaxFakeEngine(), plan=plan, sleep=lambda s: None),
                 ref_instr, rows)
    reg = TT.MetricsRegistry()
    instr = ServeInstruments(reg, slo=TT.SLOWindow(60.0), name="flaky")
    ours = _burst(MicroBatcher, TF.FlakyEngine(FakeEngine(), plan=plan, sleep=lambda s: None),
                  instr, rows)
    assert ours[0] == ref[0] == ["InjectedDispatchError", "served"] * 2 + [
        "served", "InjectedDispatchError"]
    assert ours[1]["slo"]["requests"] == ref[1]["slo"]["requests"] == 6
    with TelemetryServer(reg, health_fn=lambda: ours[1], port=0) as server:
        assert server.url.startswith("http://127.0.0.1:")
        text = scrape(server.url + "/metrics")
        health = json.loads(scrape(server.url + "/healthz"))
    assert _families_and_counts(text) == _families_and_counts(jax_render(ref_reg))
    assert 'gymfx_serve_requests_total{batcher="flaky",outcome="failed"} 3' in text
    assert 'gymfx_serve_dispatches_total{batcher="flaky"} 3' in text
    assert health["dispatch_failures"] == 3


def test_late_compiles_gauge_binds_only_where_the_engine_counts_captures():
    class _Batcher:
        def __init__(self, engine):
            self._pending, self._inflight = deque(), 0
            self.max_queue, self.breaker, self.engine = None, None, engine

    reg = TT.MetricsRegistry()
    engine = types.SimpleNamespace(late_compiles=0)
    ServeInstruments(reg, name="warm").bind_batcher(_Batcher(engine))
    gauge = reg.gauge("gymfx_serve_late_compiles_total", labels=("batcher",))
    assert gauge.value(batcher="warm") == 0.0
    engine.late_compiles = 3
    assert 'gymfx_serve_late_compiles_total{batcher="warm"} 3' in render(reg)
    reg2 = TT.MetricsRegistry()
    ServeInstruments(reg2, name="fake").bind_batcher(_Batcher(types.SimpleNamespace()))
    assert "gymfx_serve_late_compiles_total" not in reg2.snapshot()
    assert instruments_from_telemetry(None) is None


def test_an_engine_built_with_telemetry_serves_healthz_from_the_engine():
    from test_torch_serve_engine import _serve_config

    from gymfx_tpu_torch.serve import batcher_from_config, engine_from_config

    config = {**_serve_config(serve_buckets=[1, 4]), "telemetry_http_port": 0,
              "telemetry_enabled": True}
    bundle = engine_from_config(config, device="cpu")
    try:
        server = bundle.telemetry.server
        health = json.loads(scrape(server.url + "/healthz"))
        assert health["status"] == "ok" and health["late_compiles"] == 0
        assert health["buckets"] == [1, 4] and health["slots"]["enabled"] is False
        instr = instruments_from_telemetry(bundle.telemetry)
        mb = batcher_from_config(bundle.engine, config, instruments=instr)
        with mb:
            mb.submit(bundle.encode(bundle.reset_obs)[0]).result(timeout=60)
        text = scrape(server.url + "/metrics")
        assert 'gymfx_serve_late_compiles_total{batcher="serve"} 0' in text
        assert 'gymfx_serve_requests_total{batcher="serve",outcome="served"} 1' in text
    finally:
        bundle.telemetry.close()
    assert engine_from_config(_serve_config(serve_buckets=[1]), device="cpu").telemetry is None


def test_the_flop_model_is_the_jax_packages():
    shapes = {"w1": (4, 8), "b1": (8,), "w2": (8, 2), "s": ()}
    ours = {k: torch.zeros(s) for k, s in shapes.items()}
    ref = {k: np.zeros(s) for k, s in shapes.items()}
    assert tmfu.param_flops_per_sample(ours, tokens=3) == jmfu.param_flops_per_sample(ref,
                                                                                      tokens=3)
    kw = dict(num_envs=2, horizon=3, update_epochs=2, tokens=4, window=4, d_model=8, n_layers=2)
    assert tmfu.analytic_train_step_flops(ours, **kw) == jmfu.analytic_train_step_flops(ref, **kw)
    report = tmfu.mfu_report(1e9, 0.01, "cpu")
    assert report == {"analytic_flops_per_step": 1e9, "hw_flops_peak": None,
                      "mfu_analytic": None, "device_memory_bytes": None}
    assert tmfu.device_memory_watermarks("cpu") is None
    assert math.isclose(jmfu.attention_flops_per_sample(4, 8, 2),
                        tmfu.attention_flops_per_sample(4, 8, 2))


def test_spans_enter_record_function_while_a_profiler_records():
    tracer = TT.Tracer(registry=TT.MetricsRegistry())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("train/superstep", it=0):
            torch.ones(4).sum()
    assert "train/superstep" in {e.key for e in prof.key_averages()}
    with tracer.span("outside"):
        pass
    assert [r["span"] for r in tracer.records] == ["train/superstep", "outside"]
    assert TT.null_tracer().span("x") is TT.null_tracer().span("y")
