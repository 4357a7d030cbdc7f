"""The performance observatory on ``torch.profiler`` (gymfx_tpu_torch/
telemetry/trace_parse.py, profiler.py, attribution.py, compile_watch.py,
profile_report.py) against the JAX package's (tests/
test_profile_observatory.py), on the CPU.

* The parser on committed golden traces in ``torch.profiler``'s Chrome
  layout (tests/data/golden_torch_profile.trace.json: a CUDA capture's
  lanes, a graph replay launched from the "rollout" range whose kernels
  run beside a kernel launched from "update" on another stream, a
  kernel launched outside both; golden_torch_profile_cpu.trace.json: a
  CPU capture whose ops nest): the lane split, the busy union and the
  window, each kernel in the phase of the range that launched it (by its
  correlation, not by its time), a range's scope beating the sidecar's,
  CPU ops by the range they run in with self times, and malformed traces
  never raising.
* ``_parse_supersteps`` and ``ProfilerSession.due`` equal the JAX
  functions on the same inputs; the ResilientLoop's capture handshake; a
  real (CPU) capture's bundle, manifest, scope map, ledger row and
  counter; no raise on a bad dir.
* The report on a synthetic bundle (validates; phases, overlap share,
  reconciliation, measured MFU from the analytic FLOPs), ``k`` dividing
  per step, a broken bundle; ``compare_profile_reports`` equal to the JAX
  function on the same pairs of reports; the report CLI.
* The keys: unset (or the cadence alone) leave ``telemetry_from_config``
  None; the dir builds a profiler; the ledger schema knows the kinds; the
  compile watch against the JAX one for the same compiles, a forced
  recapture of a known key counted, a CPU "graph" captures nothing.
* A tiny PPO run through ``train_from_config`` writes a bundle whose
  report validates, and a run with the profiler on ends ``torch.equal``
  to one with it off.
"""
import copy
import json
import shutil
from pathlib import Path

import pytest
import torch

from gymfx_tpu.telemetry import attribution as JA
from gymfx_tpu.telemetry import profiler as JP
from gymfx_tpu.telemetry.compile_watch import CompileWatch as JaxCompileWatch
from gymfx_tpu.telemetry.ledger import RunLedger as JaxLedger
from gymfx_tpu.telemetry.ledger import load_ledger_schema as jax_ledger_schema
from gymfx_tpu.telemetry.registry import MetricsRegistry as JaxRegistry

from gymfx_tpu_torch import telemetry as TT
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.core import graphs
from gymfx_tpu_torch.profile_report import main as report_main
from gymfx_tpu_torch.resilience.loop import ResilientLoop
from gymfx_tpu_torch.telemetry import compile_watch as CW
from gymfx_tpu_torch.telemetry.attribution import (
    build_profile_report,
    compare_profile_reports,
    validate_profile_report,
)
from gymfx_tpu_torch.telemetry.ledger import read_ledger
from gymfx_tpu_torch.telemetry.profiler import ProfilerSession, _parse_supersteps, find_captures
from gymfx_tpu_torch.telemetry.spans import profiler_range
from gymfx_tpu_torch.telemetry.trace_parse import group_by_scope, parse_trace
from gymfx_tpu_torch.train.ppo import train_from_config

from test_torch_checkpoint import SMALL, _trainer

DATA = Path(__file__).parent / "data"
GOLDEN = DATA / "golden_torch_profile.trace.json"
GOLDEN_CPU = DATA / "golden_torch_profile_cpu.trace.json"
ELEMENTWISE = "void at::native::elementwise_kernel"


# ---- the parser on the golden traces ----------------------------------------
def test_golden_trace_lane_split_and_aggregation():
    s = parse_trace(str(GOLDEN))
    assert s["ok"] and s["error"] is None and s["work"] == "device"
    assert s["device_lanes"] == ["GPU 0/stream 7", "GPU 0/stream 8"]
    assert s["host_lanes"] == ["python/thread 100 (python)"]
    assert s["events"] == 16  # every complete event; flows and metadata are not
    # busy: the union of the two streams' kernels; the window from the
    # first kernel's start to the last's end
    assert s["device_total_us"] == pytest.approx(260.0)
    assert s["device_busy_us"] == pytest.approx(190.0)
    assert s["window_us"] == pytest.approx(730.0)
    assert s["ops"]["step_obs_rows_kernel"]["total_us"] == pytest.approx(50.0)
    assert s["ops"][ELEMENTWISE]["count"] == 2
    assert "rollout" not in s["ops"]  # the GPU lane's annotation is not work
    # host side: the ranges, the runtime calls, the op, the python frame
    assert s["host_ops"]["cudaLaunchKernel"]["count"] == 2
    assert {"rollout", "update", "train/superstep", "aten::add", "train_step"} <= set(s["host_ops"])


def test_golden_trace_scopes_kernels_by_the_launch_not_the_time():
    s = parse_trace(str(GOLDEN))
    ops = s["ops"]
    assert ops["step_obs_rows_kernel"]["scope"] == "rollout"
    # runs beside the rollout graph's kernels, launched from "update"
    assert ops["attn_fwd_tc<32, 4, 1>"]["scope"] == "update"
    assert ops["Memcpy DtoD (Device -> Device)"]["scope"] == "update"
    # launched inside the rollout range once, outside both once
    assert ops[ELEMENTWISE]["scope"] is None
    assert {k: v["total_us"] for k, v in ops[ELEMENTWISE]["by_scope"].items()} == {
        "rollout": 20.0, None: 30.0}
    assert s["phases"]["rollout"] == {"records": 3, "op_us": 120.0, "busy_us": 120.0,
                                      "span_us": 120.0}
    assert s["phases"]["update"] == {"records": 2, "op_us": 110.0, "busy_us": 110.0,
                                     "span_us": 160.0}
    assert [(e["launch"], e["scope"], e["records"]) for e in s["launches"]] == [
        ("cudaGraphLaunch", "rollout", 3), ("cudaLaunchKernel", "update", 1),
        ("cudaMemcpyAsync", "update", 1)]
    assert group_by_scope(s) == {"rollout": 120.0, "update": 110.0, "unattributed": 30.0}


def test_a_ranges_scope_beats_the_sidecar_map():
    s = parse_trace(str(GOLDEN))
    # the sidecar names the elementwise kernel "update": the launch in the
    # rollout range keeps "rollout", the unscoped one takes the sidecar's
    g = group_by_scope(s, {ELEMENTWISE: "update", "step_obs_rows_kernel": "update"})
    assert g == {"rollout": 120.0, "update": 140.0, "unattributed": 0.0}
    # an op path in the sidecar reduces to its phase component
    g = group_by_scope(s, {ELEMENTWISE: "train_step/rollout/elementwise"})
    assert g == {"rollout": 150.0, "update": 110.0, "unattributed": 0.0}


def test_cpu_trace_scopes_its_ops_by_the_range_they_run_in():
    s = parse_trace(str(GOLDEN_CPU))
    assert s["ok"] and s["work"] == "cpu_op"
    # self times: linear 50 - addmm 30; addmm 30 - copy_ 5
    assert {k: v["total_us"] for k, v in s["ops"].items()} == {
        "aten::linear": 20.0, "aten::addmm": 25.0, "aten::copy_": 5.0, "aten::tanh": 10.0,
        "aten::mul": 20.0, "aten::zeros": 10.0}
    assert s["device_busy_us"] == pytest.approx(90.0) and s["window_us"] == pytest.approx(300.0)
    assert group_by_scope(s) == {"rollout": 60.0, "update": 20.0, "unattributed": 10.0}


def test_malformed_traces_never_raise(tmp_path):
    s = parse_trace(str(tmp_path))
    assert not s["ok"] and "no trace files" in s["error"]
    bad = tmp_path / "x.trace.json.gz"
    bad.write_bytes(b"\x1f\x8b\x08\x00garbage")
    s = parse_trace(str(bad))
    assert not s["ok"] and s["events"] == 0
    import gzip

    bad.write_bytes(gzip.compress(b"not json at all"))
    assert not parse_trace(str(bad))["ok"]
    ok_empty = tmp_path / "y.trace.json"
    ok_empty.write_text(json.dumps({"something": 1}))
    s = parse_trace(str(ok_empty))
    assert s["ok"] and s["events"] == 0 and s["device_busy_us"] == 0.0
    odd = tmp_path / "z.trace.json"
    odd.write_text(json.dumps({"traceEvents": [{"ph": "X", "cat": "kernel", "ts": "x"}, 7]}))
    assert parse_trace(str(odd))["ok"]


# ---- the cadence and the loop's handshake -----------------------------------
@pytest.mark.parametrize("raw", [None, "", False, True, 3, "1", "8, 1,3", [5, 2], (4,)])
def test_parse_supersteps_equals_jax(raw):
    assert _parse_supersteps(raw) == JP._parse_supersteps(raw)


@pytest.mark.parametrize("supersteps,every", [("2,7", 0), ("", 4), (None, 0), ("1", 3),
                                              ([0, 5], 2)])
def test_due_cadence_equals_jax(tmp_path, supersteps, every):
    ours = ProfilerSession(str(tmp_path), supersteps=supersteps, every=every)
    theirs = JP.ProfilerSession(str(tmp_path), supersteps=supersteps, every=every)
    assert ours.supersteps == theirs.supersteps and ours.every == theirs.every
    for it in range(12):
        for k in (1, 2, 3, 4):
            assert ours.due(it, k) == theirs.due(it, k), (it, k)
    assert ours.due("x") == theirs.due("x") is False


def test_resilient_loop_capture_handshake(tmp_path):
    """begin_superstep opens the window at the due superstep,
    after_superstep closes it; without a profiler both are no-ops."""
    calls = []

    class FakeProfiler(ProfilerSession):
        def start_capture(self, it_start, k=1, **kw):
            due = self.due(it_start, k)
            calls.append(("start", it_start, k, due))
            self._active = {"it": it_start} if due else None
            return due

        def finish_capture(self):
            calls.append(("finish",))
            self._active = None
            return "bundle"

    loop = ResilientLoop(steps_per_iter=4, max_consecutive_skips=0,
                         profiler=FakeProfiler(str(tmp_path), supersteps="1"))
    state_fn = lambda: ({}, None)  # noqa: E731
    for it in range(3):
        assert loop.begin_superstep(it, 1) == (it == 1)
        loop.after_superstep(it, 1, {}, state_fn)
    assert calls == [("start", 0, 1, False), ("start", 1, 1, True), ("finish",),
                     ("start", 2, 1, False)]
    bare = ResilientLoop(steps_per_iter=4, max_consecutive_skips=0)
    assert bare.begin_superstep(0, 1) is False
    bare.after_superstep(0, 1, {}, state_fn)


def test_profiler_session_real_capture_writes_a_bundle(tmp_path):
    registry = TT.MetricsRegistry()
    ledger = TT.RunLedger(str(tmp_path / "ledger.jsonl"))
    session = ProfilerSession(str(tmp_path / "prof"), supersteps="0", config_sha256="abc",
                              registry=registry, ledger=ledger)
    session.set_workload_source(lambda it, k: {"algo": "unit", "analytic_flops_per_step": 10.0})
    assert session.start_capture(0, 1) and session.capturing
    x = torch.ones((16, 16))
    with profiler_range("rollout"):
        y = torch.tanh(x @ x)
    with profiler_range("update"):
        (y * 2).sum()
    bundle = session.finish_capture()
    assert bundle is not None and not session.capturing
    assert session.captures == 1 and session.capture_errors == 0
    assert find_captures(str(tmp_path / "prof")) == [bundle]
    manifest = json.loads((Path(bundle) / "manifest.json").read_text())
    assert manifest["config_sha256"] == "abc" and (manifest["it_start"], manifest["k"]) == (0, 1)
    assert manifest["algo"] == "unit" and manifest["analytic_flops_per_step"] == 10.0
    assert (manifest["platform"], manifest["device_kind"], manifest["comparable"]) == (
        "cpu", "cpu", False)
    assert manifest["xla_flops_per_step"] is None and manifest["fingerprints"] == {}
    scope_map = json.loads((Path(bundle) / "scope_map.json").read_text())
    assert scope_map["aten::tanh"] == "rollout" and scope_map["aten::sum"] == "update"
    rows = [r for r in read_ledger(str(tmp_path / "ledger.jsonl")) if r["kind"] == "profile_capture"]
    assert len(rows) == 1 and rows[0]["path"] == bundle and rows[0]["it_start"] == 0
    ledger.close()
    from gymfx_tpu_torch.telemetry import prometheus

    text = prometheus.render(registry)
    assert "gymfx_profile_captures_total 1" in text
    assert "gymfx_profile_last_capture_age_seconds" in text


def test_profiler_never_raises_on_a_bad_dir():
    session = ProfilerSession("/dev/null/not/a/dir", supersteps="0")
    assert session.start_capture(0, 1) is False
    assert session.capture_errors == 1
    assert session.finish_capture() is None


# ---- the report ---------------------------------------------------------------
def _bundle(tmp_path, *, k=1, trace=GOLDEN):
    bundle = tmp_path / "capture_001_it1"
    bundle.mkdir(parents=True, exist_ok=True)
    shutil.copy(trace, bundle / "capture.trace.json")
    manifest = {
        "schema_version": 1, "config_sha256": "deadbeef", "it_start": 1, "k": k,
        "it_end": 1 + k, "label": "unit", "platform": "gpu", "device_kind": "NVIDIA H100",
        "comparable": True, "hw_flops_peak": 989e12, "fingerprints": {"PPOTrainer.rollout|()": "aa"},
        "scope_map_file": "scope_map.json", "xla_flops_per_step": None,
        "analytic_flops_per_step": 1e9,
        # the golden trace's truth: rollout 120 us, update 110 us
        "phase_split": {"rollout_ms": 0.12, "update_ms": 0.11, "iters": 2,
                        "source": "measure_phase_split"},
    }
    (bundle / "manifest.json").write_text(json.dumps(manifest))
    (bundle / "scope_map.json").write_text(json.dumps({}))
    return bundle


def test_build_profile_report_attribution_and_mfu(tmp_path):
    report = build_profile_report(str(_bundle(tmp_path)))
    assert validate_profile_report(report) == []
    t = report["trace"]
    assert t["ok"] and t["device_busy_ms"] == pytest.approx(0.19)
    assert t["window_ms"] == pytest.approx(0.73)
    assert t["dispatch_gap_ms"] == pytest.approx(0.54)
    assert t["fusion_coverage"] is None
    p = report["phases"]
    assert (p["rollout_ms"], p["update_ms"], p["unattributed_ms"]) == pytest.approx((0.12, 0.11,
                                                                                     0.03))
    assert p["rollout_frac"] == pytest.approx(120 / 230, abs=1e-4)
    assert p["attributed_frac"] == pytest.approx(230 / 260, abs=1e-4)
    # the two streams ran at once: the phases sum to more than the union
    assert p["phase_sum_ms"] == pytest.approx(0.26) and p["busy_ms"] == pytest.approx(0.19)
    assert p["overlap_share"] == pytest.approx(1 - 190 / 260, abs=1e-4)
    assert p["detail"]["update"]["span_ms"] == pytest.approx(0.16)
    assert [e["records"] for e in p["detail"]["rollout"]["launches"]] == [3]
    r = report["reconciliation"]
    assert r["rollout_frac_abs_err"] == pytest.approx(0.0, abs=1e-4) and r["within_tolerance"]
    m = report["mfu_measured"]
    assert m["device_ms_per_step"] == pytest.approx(0.19) and m["flops_source"] == "analytic"
    assert m["achieved_flops_per_sec"] == pytest.approx(1e9 / 0.00019, rel=1e-3)
    assert m["mfu"] == pytest.approx(1e9 / 0.00019 / 989e12, rel=1e-3)
    rows = {(row["name"], row["scope"]): row["count"] for row in t["top_kernels"]}
    assert rows[(ELEMENTWISE, "rollout")] == 1 and rows[(ELEMENTWISE, None)] == 1
    assert rows[("attn_fwd_tc<32, 4, 1>", "update")] == 1


def test_build_profile_report_k_divides_per_step(tmp_path):
    report = build_profile_report(str(_bundle(tmp_path, k=2)))
    assert report["mfu_measured"]["device_ms_per_step"] == pytest.approx(0.095)
    rows = {(r["name"], r["scope"]): r for r in report["trace"]["top_kernels"]}
    assert rows[("attn_fwd_tc<32, 4, 1>", "update")]["total_ms_per_step"] == pytest.approx(0.05)


def test_build_profile_report_on_a_broken_bundle_never_raises(tmp_path):
    report = build_profile_report(str(tmp_path / "nothing_here"))
    assert validate_profile_report(report) == []
    assert report["trace"]["ok"] is False
    assert report["phases"]["rollout_frac"] is None
    assert report["reconciliation"]["within_tolerance"] is None
    assert report["mfu_measured"]["device_ms_per_step"] is None


def _jax_reports(tmp_path):
    """The JAX package's report of its own golden bundle (tests/
    test_profile_observatory.py's), and a copy with one kernel 1.5x."""
    from test_profile_observatory import _synthetic_bundle

    base = JA.build_profile_report(str(_synthetic_bundle(tmp_path)))
    slow = copy.deepcopy(base)
    for row in slow["trace"]["top_kernels"]:
        if row["name"] == "update_gemm_fusion":
            row["total_ms_per_step"] *= 1.5
    return base, slow


@pytest.mark.parametrize("pair,kw", [("same", {}), ("slow", {"threshold": 0.25}),
                                     ("slow", {"threshold": 0.25, "min_ms": 10.0}),
                                     ("fast", {"threshold": 0.25}), ("slow", {"threshold": 0.6})])
def test_compare_profile_reports_equals_the_jax_gate(tmp_path, pair, kw):
    base, slow = _jax_reports(tmp_path)
    a, b = {"same": (base, base), "slow": (base, slow), "fast": (slow, base)}[pair]
    ours = compare_profile_reports(a, b, **kw)
    assert ours == JA.compare_profile_reports(a, b, **kw)
    assert ours["ok"] == (pair != "slow" or kw.get("min_ms", 0) > 1 or kw["threshold"] > 0.5)


def test_compare_sums_a_kernels_rows_over_the_phases(tmp_path):
    base = build_profile_report(str(_bundle(tmp_path)))
    slow = copy.deepcopy(base)
    for row in slow["trace"]["top_kernels"]:
        if row["name"] == ELEMENTWISE and row["scope"] is None:
            row["total_ms_per_step"] *= 3  # 0.02 + 0.03 -> 0.02 + 0.09
    verdict = compare_profile_reports(base, slow, min_ms=0.01)
    assert not verdict["ok"] and [r["name"] for r in verdict["regressions"]] == [ELEMENTWISE]
    assert verdict["regressions"][0]["ratio"] == pytest.approx(0.11 / 0.05, abs=1e-3)
    assert verdict["comparable"]


def test_profile_report_cli_report_and_compare(tmp_path, capsys):
    bundle = _bundle(tmp_path)
    assert report_main(["report", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "Profile report" in out and "overlap share" in out and "attn_fwd_tc" in out
    report_path = bundle / "profile_report.json"
    assert validate_profile_report(json.loads(report_path.read_text())) == []
    assert report_main(["compare", str(report_path), str(report_path)]) == 0
    report = json.loads(report_path.read_text())
    for row in report["trace"]["top_kernels"]:
        row["total_ms_per_step"] = (row["total_ms_per_step"] or 0) * 2
    slow_path = tmp_path / "slow.json"
    slow_path.write_text(json.dumps(report))
    assert report_main(["compare", str(report_path), str(slow_path), "--min-ms", "0.001"]) == 1
    assert report_main(["report", str(tmp_path / "empty")]) == 2


# ---- the keys, the ledger, the compile watch ----------------------------------
def test_profile_keys_unset_keep_telemetry_none():
    assert TT.telemetry_from_config(dict(DEFAULT_VALUES)) is None
    # the cadence keys alone build nothing: the dir is the master switch
    cfg = dict(DEFAULT_VALUES, telemetry_profile_supersteps="1,2", telemetry_profile_every=4)
    assert TT.telemetry_from_config(cfg) is None


def test_profile_dir_constructs_the_profiler(tmp_path):
    t = TT.telemetry_from_config({"telemetry_profile_dir": str(tmp_path / "prof"),
                                  "telemetry_profile_supersteps": "0,2",
                                  "telemetry_profile_every": 8,
                                  "telemetry_compile_watch": True})
    try:
        assert t.profiler.supersteps == (0, 2) and t.profiler.every == 8
        assert t.profiler.config_sha256 and t.profiler.compile_watch is t.compile_watch
        assert CW.active() is t.compile_watch
    finally:
        t.close()
    assert CW.active() is None


def test_the_ledger_schema_knows_the_observatory_kinds():
    from gymfx_tpu_torch.telemetry.ledger import EVENT_KINDS, load_ledger_schema

    ours, theirs = load_ledger_schema()["kinds"], jax_ledger_schema()["kinds"]
    for kind in ("profile_capture", "compile_begin", "compile_end", "recompile"):
        assert kind in EVENT_KINDS
        assert ours[kind] == theirs[kind]
    assert ours["profile_capture"]["required"] == ["path", "it_start", "k"]


def _body(x):
    return x


def test_compile_watch_counts_captures_and_a_forced_recapture_as_jax(tmp_path):
    calls = [("PPOTrainer.rollout", ((8, 4), "f32")), ("PPOTrainer.update", ((8, 4), "f32")),
             ("PPOTrainer.rollout", ((8, 4), "f32")),   # a recapture of a known key
             ("PPOTrainer.rollout", ((16, 4), "f32"))]  # a new shape: a new key
    ledger = TT.RunLedger(str(tmp_path / "ours.jsonl"))
    watch = CW.CompileWatch(TT.MetricsRegistry(), ledger=ledger).install()
    jledger = JaxLedger(str(tmp_path / "theirs.jsonl"))
    jwatch = JaxCompileWatch(JaxRegistry(), ledger=jledger)
    try:
        for name, sig in calls:
            watch.record_capture(name, _body, sig, 0.25)
            key, fp = CW.capture_identity(name, _body, sig)
            jwatch.record_compile(name, key=key, hlo_sha256=fp, duration_s=0.25)
        watch.record_build("env", cached=True)
        # a "graph" on the CPU captures nothing and reports nothing
        graphs.PhaseGraph(lambda x: {"y": x["x"] + 1}, {"x": torch.zeros(2)}, name="cpu")
    finally:
        watch.uninstall()
        ledger.close()
        jledger.close()
    assert CW.active() is None
    assert watch.captures == 4 and watch.recompile_count == 1
    assert watch.fingerprints() == jwatch.fingerprints() and watch.fingerprint_count == 3
    kinds = [r["kind"] for r in read_ledger(str(tmp_path / "ours.jsonl"))]
    assert kinds == [r["kind"] for r in read_ledger(str(tmp_path / "theirs.jsonl"))]
    assert kinds.count("recompile") == 1 and kinds.count("compile_end") == 3
    assert TT.validate_ledger(str(tmp_path / "ours.jsonl")) == []
    from gymfx_tpu_torch.telemetry import prometheus

    text = prometheus.render(watch.registry)
    assert 'gymfx_compile_recompiles_total{watch="default"} 1' in text
    assert 'gymfx_compile_events_total{event="cuda_graph_capture"} 4' in text
    assert 'gymfx_compile_events_total{event="nvcc_cache_hit"} 1' in text


# ---- through a training run ---------------------------------------------------
def test_a_tiny_ppo_run_writes_a_bundle_whose_report_validates(tmp_path):
    cfg = dict(DEFAULT_VALUES, **SMALL, train_total_steps=3 * 64, seed=1,
               telemetry_profile_dir=str(tmp_path / "prof"), telemetry_compile_watch=True,
               telemetry_ledger=str(tmp_path / "ledger.jsonl"))
    train_from_config(cfg, device="cpu")
    caps = find_captures(str(tmp_path / "prof"))
    assert len(caps) == 1 and caps[0].endswith("it1")
    report = build_profile_report(caps[0])
    assert validate_profile_report(report) == []
    assert report["trace"]["ok"] and report["trace"]["events"] > 0
    assert report["trace"]["work"] == "cpu_op"
    assert report["phases"]["attributed_frac"] > 0.5
    assert report["phases"]["rollout_ms"] > 0 and report["phases"]["update_ms"] > 0
    assert report["mfu_measured"]["device_ms_per_step"] > 0
    assert report["mfu_measured"]["flops_per_step"] > 0
    manifest = json.loads((Path(caps[0]) / "manifest.json").read_text())
    assert manifest["algo"] == "ppo" and manifest["phase_split"]["rollout_ms"] > 0
    kinds = [r["kind"] for r in read_ledger(str(tmp_path / "ledger.jsonl"))]
    assert kinds.count("profile_capture") == 1 and "recompile" not in kinds


def test_a_profiled_run_ends_where_an_unprofiled_one_does(tmp_path):
    trainer = _trainer()
    plain, _ = trainer.train(3 * 64, seed=4)
    telemetry = TT.telemetry_from_config({"telemetry_profile_dir": str(tmp_path / "prof")})
    try:
        profiled, _ = trainer.train(3 * 64, seed=4, telemetry=telemetry)
    finally:
        telemetry.close()
    assert telemetry.profiler.captures == 1
    fields = lambda s: tuple(x for x in s if not isinstance(x, torch.Generator))  # noqa: E731
    from gymfx_tpu_torch.resilience.guards import tree_leaves

    for a, b in zip(tree_leaves(fields(plain)), tree_leaves(fields(profiled))):
        assert torch.equal(a, b)
    assert torch.equal(plain.generator.get_state(), profiled.generator.get_state())


def test_the_measuring_helpers_time_and_leave_the_live_state_alone():
    """bench_util's helpers on the CPU: each returns seconds and a state;
    the phase split works on a clone and gives the live tensors their
    values back, and draws from a copy of the generator."""
    from gymfx_tpu_torch import bench_util

    trainer = _trainer()
    state = trainer.init_state(2)
    before = [x.clone() for x in (state.params["logits.weight"], state.obs_vec)]
    gen_state = state.generator.get_state()
    rollout_s, update_s, after, flops = bench_util.measure_phase_split(trainer, state, 2)
    assert rollout_s > 0 and update_s > 0 and flops is None
    assert torch.equal(state.params["logits.weight"], before[0])
    assert torch.equal(state.obs_vec, before[1])
    assert torch.equal(state.generator.get_state(), gen_state)
    assert not torch.equal(after.params["logits.weight"], before[0])
    seconds, flops, state2, step = bench_util.measure_train_step(trainer, state, 2)
    assert seconds > 0 and flops is None and step == trainer.train_step
    seconds, _, _, _ = bench_util.measure_train_many(trainer, state2, 1, 2)
    assert seconds > 0
    record = bench_util.stamp_comparability({})
    assert record == {"platform": "cpu", "device_kind": "cpu", "comparable": False}
    assert bench_util.mfu(1e9, 2, 1.0, "cpu") is None
