"""The port's serving engine (gymfx_tpu_torch/serve/engine.py) against the
JAX package's (gymfx_tpu/serve/engine.py), on the CPU.

* The same weights (flax init, carried across by
  ``convert.policy_params_from_flax``) in both engines, ``exact`` mode,
  ladder (1, 4, 8): every row of every bucket (padded fills included)
  within the ROADMAP Queue 3 pins for policy outputs — 1e-5 in f32,
  4e-3 in bf16 (flax rounds each bf16 product before its bias, torch once
  after it) — for mlp, lstm (f32 and bf16, from non-zero carries, the
  carry too: 1e-5, bf16 2^-6 x max|carry|), transformer and
  transformer_ring at a small width.  Actions agree wherever the JAX
  logits' top two are further apart than the tolerance.
* The port's own ``exact`` rows are ``torch.equal`` to its single-row
  forward (the policy on a (1, ...) batch): the contract the card holds.
* No capture after boot, the ladder's overflow chunked, the input
  validation of tests/test_serve_engine.py, ``resolve_batch_mode``'s CPU
  answer, ``matmul`` rows across buckets, ``swap_weights`` accepted,
  rejected (names, shape, dtype: nothing copied) and probe-failed (an
  exception, a late capture: the old weights restored), and
  ``engine_from_config`` on eurusd_sample.csv: the reset-obs template
  and its encoding bitwise the JAX package's, decisions on converted
  weights within 1e-5, a checkpoint's weights, a fresh seeded boot, and
  the fleet and telemetry keys refused.
"""
import copy
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.serve.engine import InferenceEngine as JaxEngine
from gymfx_tpu.serve.engine import engine_from_config as jax_engine_from_config
from gymfx_tpu.train.policies import make_trainer_policy as jax_make_policy

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.serve import (
    InferenceEngine,
    WeightSwapError,
    engine_from_config,
    resolve_batch_mode,
)
from gymfx_tpu_torch.train import checkpoint as ckpt
from gymfx_tpu_torch.train.policies import make_trainer_policy

from test_torch_parity import assert_bitwise, to_np, x64_off

OBS_DIM = 12
WINDOW = 6
TOKEN_DIM = 3
BUCKETS = (1, 4, 8)
CSV = str(pathlib.Path(__file__).resolve().parent.parent / "examples" / "data"
          / "eurusd_sample.csv")
KWARGS = {
    "mlp": {"hidden": [16, 16]},
    "lstm": {"hidden": 16},
    "transformer": {"d_model": 16, "n_heads": 2},
    "transformer_ring": {"d_model": 16, "n_heads": 2, "n_layers": 2},
}
HEAD_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
CASES = [("mlp", "float32"), ("lstm", "float32"), ("lstm", "bfloat16"),
         ("transformer", "float32"), ("transformer_ring", "float32")]


def _token(name):
    return name in ("transformer", "transformer_ring")


def _build(name, dtype="float32", buckets=BUCKETS, batch_mode="exact", jax_engine=True,
           seed=0):
    """(JAX engine or None, port engine, the flax params, the port's
    policy module for references, numpy rng)."""
    shape = (WINDOW, TOKEN_DIM) if _token(name) else (OBS_DIM,)
    rng = np.random.default_rng(sum(map(ord, name)) + seed)
    example = rng.standard_normal(shape).astype(np.float32)
    with x64_off():
        jpol = jax_make_policy(name, continuous=False, dtype=getattr(jnp, dtype),
                               kwargs=dict(KWARGS[name]), window=WINDOW)
        carry0 = jpol.initial_carry(())
        key = jax.random.PRNGKey(seed)
        if jax.tree.leaves(carry0):
            jparams = jpol.init(key, jnp.asarray(example), carry0)
        else:
            jparams = jpol.init(key, jnp.asarray(example))
        jeng = (JaxEngine(jpol, jparams, example, buckets=buckets, batch_mode=batch_mode)
                if jax_engine else None)
    params = convert.policy_params_from_flax(
        name, jax.tree.map(lambda x: np.asarray(x, np.float32), jparams), device="cpu")
    tpol = make_trainer_policy(name, shape[-1], continuous=False, dtype=getattr(torch, dtype),
                               kwargs=dict(KWARGS[name]), window=WINDOW)
    eng = InferenceEngine(tpol, params, example, buckets=buckets, batch_mode=batch_mode,
                          device="cpu")
    ref = copy.deepcopy(tpol)
    ref.load_state_dict(params)
    return jeng, eng, jparams, ref, rng


def _rows(rng, eng, n):
    return rng.standard_normal((n, *eng.obs_shape)).astype(np.float32)


def _carries(rng, eng, n):
    if not eng.recurrent:
        return None, None
    vals = [rng.standard_normal((n, *c.shape)).astype(np.float32) for c in eng.initial_carry()]
    dtype = eng.initial_carry()[0].dtype
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with x64_off():
        jc = tuple(jnp.asarray(v).astype(jdt) for v in vals)
    return jc, tuple(torch.from_numpy(v).to(dtype) for v in vals)


def _single_row(ref, eng, x, carry):
    """The port's single-row forward (M = 1): the policy module itself on
    fresh (aligned) copies of the row, as the engine gives each row (the
    CPU's BLAS may take another path for a row at another alignment)."""
    with torch.no_grad():
        x = torch.as_tensor(x)[None].clone()
        if eng.recurrent:
            logits, value, c2 = ref(x, tuple(c[None].clone() for c in carry))
            c2 = tuple(c[0] for c in c2)
        else:
            logits, value = ref(x)
            c2 = ()
    return torch.argmax(logits[0]).to(torch.int32), value[0], logits[0], c2


def _assert_exact_rows(eng, ref, obs, tcarries, out, label):
    for i in range(obs.shape[0]):
        carry = tuple(c[i] for c in tcarries) if eng.recurrent else ()
        a, v, lo, c2 = _single_row(ref, eng, obs[i], carry)
        assert torch.equal(out.action[i], a), (label, i)
        assert torch.equal(out.value[i], v), (label, i)
        assert torch.equal(out.actor_out[i], lo), (label, i)
        for got, want in zip(out.carry, c2):
            assert torch.equal(got[i], want), (label, i)


def _assert_close_to_jax(jout, tout, dtype, label):
    tol = HEAD_TOL[dtype]
    np.testing.assert_allclose(to_np(tout.actor_out), np.asarray(jout.actor_out), rtol=tol,
                               atol=tol, err_msg=f"{label} logits")
    np.testing.assert_allclose(to_np(tout.value), np.asarray(jout.value), rtol=tol, atol=tol,
                               err_msg=f"{label} value")
    logits = np.sort(np.asarray(jout.actor_out, np.float64), axis=-1)
    clear = logits[:, -1] - logits[:, -2] > 2 * tol
    assert clear.any(), label
    np.testing.assert_array_equal(to_np(tout.action)[clear], np.asarray(jout.action)[clear],
                                  err_msg=f"{label} actions")
    for ours, theirs in zip(tout.carry or (), jax.tree.leaves(jout.carry)):
        theirs = np.asarray(theirs).astype(np.float32)
        ctol = 1e-5 if dtype == "float32" else 2.0 ** -6 * float(np.abs(theirs).max())
        np.testing.assert_allclose(to_np(ours), theirs, rtol=0, atol=ctol,
                                   err_msg=f"{label} carry")


@pytest.mark.parametrize("name,dtype", CASES)
def test_exact_rows_match_the_jax_engine_and_the_single_row_forward(name, dtype):
    jeng, eng, _jp, ref, rng = _build(name, dtype)
    assert eng.batch_mode == "exact" and eng.executable_count == len(BUCKETS)
    assert eng.obs_shape == jeng.obs_shape and eng.recurrent == jeng.recurrent
    for n in (1, 3, 4, 8):  # every bucket, padded fills included
        obs = _rows(rng, eng, n)
        jc, tc = _carries(rng, eng, n)
        out = eng.decide_batch(obs, tc)
        assert out.action.shape == (n,) and out.action.dtype == torch.int32
        _assert_exact_rows(eng, ref, obs, tc, out, f"{name} {dtype} n={n}")
        with x64_off():
            jout = jeng.decide_batch(obs, jc)
        _assert_close_to_jax(jout, out, dtype, f"{name} {dtype} n={n}")
    assert eng.late_compiles == 0 and jeng.late_compiles == 0


def test_warm_engine_never_captures_after_boot():
    _j, eng, _jp, _ref, rng = _build("mlp", jax_engine=False)
    assert eng.executable_count == len(BUCKETS)
    seen = []
    eng.on_compile = lambda *a: seen.append(a)
    for n in (1, 2, 4, 5, 8):
        eng.decide_batch(_rows(rng, eng, n))
    d = eng.decide(_rows(rng, eng, 1)[0])
    assert d.action.shape == () and d.carry == ()
    assert eng.late_compiles == 0 and eng.executable_count == len(BUCKETS) and not seen


def test_a_cold_bucket_is_captured_late_and_counted():
    _j, eng, _jp, ref, rng = _build("mlp", jax_engine=False)
    cold = InferenceEngine(eng.policy, eng.params, np.zeros(OBS_DIM, np.float32),
                           buckets=(1, 4), batch_mode="exact", warmup=False, device="cpu")
    seen = []
    cold.on_compile = lambda bucket, seconds, late: seen.append((bucket, late))
    obs = _rows(rng, eng, 3)
    out = cold.decide_batch(obs)
    _assert_exact_rows(cold, ref, obs, None, out, "cold")
    assert cold.late_compiles == 1 and cold.executable_count == 1 and seen == [(4, True)]


def test_ladder_overflow_chunks_without_capturing():
    jeng, eng, _jp, ref, rng = _build("mlp", buckets=(1, 4))
    obs = _rows(rng, eng, 11)  # > largest bucket: 4 + 4 + 3 (padded)
    out = eng.decide_batch(obs)
    assert out.action.shape == (11,)
    _assert_exact_rows(eng, ref, obs, None, out, "chunked")
    with x64_off():
        _assert_close_to_jax(jeng.decide_batch(obs), out, "float32", "chunked")
    assert eng.late_compiles == 0


def test_ladder_overflow_chunks_the_recurrent_carry():
    _j, eng, _jp, ref, rng = _build("lstm", buckets=(1, 4), jax_engine=False)
    obs = _rows(rng, eng, 9)
    _jc, tc = _carries(rng, eng, 9)
    out = eng.decide_batch(obs, tc)
    assert all(c.shape == (9, 16) for c in out.carry)
    _assert_exact_rows(eng, ref, obs, tc, out, "chunked lstm")


def test_matmul_mode_rows_stable_across_buckets():
    _j, eng, _jp, ref, rng = _build("mlp", batch_mode="matmul", jax_engine=False)
    assert eng.batch_mode == "matmul"
    row = _rows(rng, eng, 1)[0]
    alone = eng.decide_batch(row[None])
    for n in (3, 8):
        together = eng.decide_batch(np.concatenate([row[None], _rows(rng, eng, n - 1)]))
        np.testing.assert_allclose(to_np(together.actor_out[0]), to_np(alone.actor_out[0]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(to_np(together.value[0]), to_np(alone.value[0]),
                                   rtol=1e-6, atol=1e-7)
    _a, v, lo, _c = _single_row(ref, eng, row, ())
    np.testing.assert_allclose(to_np(alone.actor_out[0]), to_np(lo), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(alone.value[0]), to_np(v), rtol=1e-5, atol=1e-6)


def test_input_validation():
    _j, eng, _jp, _ref, rng = _build("mlp", buckets=(1, 4), jax_engine=False)
    with pytest.raises(ValueError, match="batch size"):
        eng.bucket_for(0)
    with pytest.raises(ValueError, match="does not match"):
        eng.decide_batch(np.zeros((2, OBS_DIM + 1), np.float32))
    _j2, eng2, _jp2, _ref2, rng2 = _build("lstm", buckets=(1,), jax_engine=False)
    with pytest.raises(ValueError, match="carries"):
        eng2.decide_batch(_rows(rng2, eng2, 2))
    with pytest.raises(ValueError, match="bucket ladder"):
        InferenceEngine(eng.policy, eng.params, np.zeros(OBS_DIM, np.float32), buckets=(),
                        device="cpu")
    with pytest.raises(ValueError, match="neutral_obs"):
        InferenceEngine(eng.policy, eng.params, np.zeros(OBS_DIM, np.float32),
                        neutral_obs=np.zeros(3, np.float32), device="cpu")
    with pytest.raises(ValueError, match="not the policy's"):
        InferenceEngine(eng.policy, {}, np.zeros(OBS_DIM, np.float32), device="cpu")
    with pytest.raises(ValueError, match="never chunks"):
        eng.dispatch_async(_rows(rng, eng, 5))


def test_resolve_batch_mode():
    with pytest.raises(ValueError, match="batch_mode"):
        resolve_batch_mode("fast", "cpu")
    assert resolve_batch_mode("exact", "cpu") == "exact"
    assert resolve_batch_mode("matmul", "cpu") == "matmul"
    # on the CPU auto picks the bit-exact mode, as the JAX package does off a TPU
    assert resolve_batch_mode("auto", "cpu") == "exact"
    assert resolve_batch_mode("auto", "cuda") == "matmul"


def _perturbed(params, seed=1, scale=0.05):
    gen = torch.Generator().manual_seed(seed)
    return {k: v + scale * torch.randn(v.shape, generator=gen) for k, v in params.items()}


def test_swap_weights_accepted_changes_decisions_from_the_next_dispatch():
    _j, eng, _jp, ref, rng = _build("mlp", jax_engine=False)
    obs = _rows(rng, eng, 5)
    before = eng.decide_batch(obs)
    new = _perturbed(eng.params)
    assert eng.swap_weights(new) == 1 and eng.swap_count == 1
    after = eng.decide_batch(obs)
    assert not torch.equal(after.actor_out, before.actor_out)
    ref.load_state_dict(new)
    _assert_exact_rows(eng, ref, obs, None, after, "swapped")
    assert eng.late_compiles == 0 and all(torch.equal(eng.params[k], new[k]) for k in new)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_swap_weights_rejected_copies_nothing(fault):
    _j, eng, _jp, _ref, rng = _build("mlp", jax_engine=False)
    obs = _rows(rng, eng, 3)
    before = eng.decide_batch(obs)
    old = {k: v.clone() for k, v in eng.params.items()}
    bad = _perturbed(eng.params)
    name = sorted(bad)[0]
    if fault == "missing":
        del bad[name]
    elif fault == "extra":
        bad["extra.weight"] = torch.zeros(2)
    elif fault == "shape":
        bad[name] = bad[name][..., :-1]
    else:
        bad[name] = bad[name].double()
    with pytest.raises(WeightSwapError):
        eng.swap_weights(bad)
    assert all(torch.equal(eng.params[k], old[k]) for k in old)
    assert eng.generation == 0
    assert torch.equal(eng.decide_batch(obs).actor_out, before.actor_out)


@pytest.mark.parametrize("fault", ["exception", "late_capture"])
def test_swap_weights_probe_failure_restores_the_old_weights(fault, monkeypatch):
    _j, eng, _jp, _ref, rng = _build("mlp", jax_engine=False)
    obs = _rows(rng, eng, 3)
    before = eng.decide_batch(obs)
    old = {k: v.clone() for k, v in eng.params.items()}
    real = eng._dispatch

    def faulty(host, bucket):
        if fault == "exception":
            raise RuntimeError("injected probe fault")
        eng.late_compiles += 1
        return real(host, bucket)

    monkeypatch.setattr(eng, "_dispatch", faulty)
    with pytest.raises(WeightSwapError, match="probe" if fault == "exception" else "late"):
        eng.swap_weights(_perturbed(eng.params))
    monkeypatch.setattr(eng, "_dispatch", real)
    assert all(torch.equal(eng.params[k], old[k]) for k in old) and eng.generation == 0
    assert torch.equal(eng.decide_batch(obs).actor_out, before.actor_out)


def test_dispatch_async_resolves_each_in_flight_dispatch_to_its_own_rows():
    _j, eng, _jp, ref, rng = _build("lstm", buckets=(1, 4), jax_engine=False)
    batches = [(_rows(rng, eng, 3), _carries(rng, eng, 3)[1]) for _ in range(3)]
    # three dispatches at one bucket before any resolve: the third
    # rewrites the first's staging buffer
    handles = [eng.dispatch_async(obs, tc) for obs, tc in batches]
    for (obs, tc), h in zip(batches, handles):
        d = h.resolve()
        assert h.resolve() is d and h.n == 3
        _assert_exact_rows(eng, ref, obs, tc, d, "in flight")


def _serve_config(**over):
    config = dict(DEFAULT_VALUES)
    config.update(input_data_file=CSV, window_size=8, serve_buckets=[1, 4], seed=3)
    config.update(over)
    return config


@pytest.mark.parametrize("name", ["mlp", "transformer_ring"])
def test_engine_from_config_matches_the_jax_boot(name):
    from gymfx_tpu.config import DEFAULT_VALUES as JAX_DEFAULTS

    over = {"policy": name, "policy_kwargs": dict(KWARGS[name])}
    jconfig = dict(JAX_DEFAULTS)
    jconfig.update(_serve_config(**over))
    with x64_off():
        jb = jax_engine_from_config(jconfig)
        jvec = np.asarray(jb.encode(jb.reset_obs))
    params = convert.policy_params_from_flax(
        name, jax.tree.map(lambda x: np.asarray(x, np.float32), jb.engine.params), device="cpu")
    tb = engine_from_config(_serve_config(**over), params=params, device="cpu")
    assert tb.policy_name == name and tb.engine.batch_mode == "exact"
    assert set(tb.reset_obs) == set(jb.reset_obs)
    for k in jb.reset_obs:
        assert_bitwise(tb.reset_obs[k][0], np.asarray(jb.reset_obs[k]), f"reset obs {k}")
    tvec = tb.encode(tb.reset_obs)[0]
    assert_bitwise(tvec, jvec, "encoded reset obs")
    assert tb.engine.obs_shape == jb.engine.obs_shape
    rng = np.random.default_rng(4)
    obs = jvec[None] + 0.01 * rng.standard_normal((4, *jvec.shape)).astype(np.float32)
    with x64_off():
        jout = jb.engine.decide_batch(obs)
    _assert_close_to_jax(jout, tb.engine.decide_batch(obs), "float32", f"{name} boot")
    assert tb.engine.late_compiles == 0 and tb.engine.executable_count == 2


def test_engine_from_config_loads_a_checkpoint_and_boots_fresh_from_a_seed(tmp_path):
    fresh = engine_from_config(_serve_config(policy="lstm", policy_kwargs={"hidden": 8},
                                             serve_session_slots=4), device="cpu")
    again = engine_from_config(_serve_config(policy="lstm", policy_kwargs={"hidden": 8}),
                               device="cpu")
    assert fresh.engine.slot_cache is not None and again.engine.slot_cache is None
    assert all(torch.equal(fresh.engine.params[k], again.engine.params[k])
               for k in fresh.engine.params)  # the same seed, the same weights
    weights = _perturbed(fresh.engine.params)
    ckpt.save_checkpoint(str(tmp_path), weights, step=5,
                         metadata={"policy": "lstm", "policy_kwargs": {"hidden": 8}})
    loaded = engine_from_config(_serve_config(checkpoint_dir=str(tmp_path), policy=None),
                                device="cpu")
    assert loaded.policy_name == "lstm"
    assert all(torch.equal(loaded.engine.params[k], weights[k]) for k in weights)


def test_engine_from_config_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 16"):
        engine_from_config(_serve_config(serve_fleet_replicas=2), device="cpu")
    # the serving telemetry runs (tests/test_torch_telemetry.py), and so
    # does the compile watch: it records the boot ladder's buckets and binds
    # the engine's capture hook
    bundle = engine_from_config(_serve_config(telemetry_compile_watch=True), device="cpu")
    try:
        watch = bundle.telemetry.compile_watch
        assert watch is not None and bundle.engine.on_compile is not None
        assert sorted(watch.fingerprints()) == ["serve_forward|bucket=1",
                                                "serve_forward|bucket=4"]
        assert watch.recompile_count == 0
    finally:
        bundle.telemetry.close()
    # continuous serving (item 11) is ported: tests/test_torch_serve_continuous.py
    bundle = engine_from_config(_serve_config(action_space_mode="continuous"), device="cpu")
    assert bundle.engine.continuous and bundle.engine.continuous_threshold == np.float32(0.33)


@pytest.mark.parametrize("name", ["mlp", "lstm", "transformer", "transformer_ring",
                                  "transformer_ulysses"])
def test_policy_params_from_flax_is_the_family_converter(name):
    family = "transformer_ring" if name == "transformer_ulysses" else name
    with x64_off():
        pol = jax_make_policy(family, continuous=False, dtype=jnp.float32,
                              kwargs=dict(KWARGS[family]), window=WINDOW)
        x = jnp.zeros((WINDOW, TOKEN_DIM) if _token(family) else (OBS_DIM,))
        carry0 = pol.initial_carry(())
        tree = (pol.init(jax.random.PRNGKey(2), x, carry0) if jax.tree.leaves(carry0)
                else pol.init(jax.random.PRNGKey(2), x))
    tree = jax.tree.map(np.asarray, tree)
    direct = {"mlp": convert.mlp_params_from_flax, "lstm": convert.lstm_params_from_flax,
              "transformer": convert.transformer_params_from_flax,
              "transformer_ring": convert.ring_transformer_params_from_flax}[family]
    got, want = convert.policy_params_from_flax(name, tree, device="cpu"), direct(tree, device="cpu")
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError, match="no converter"):
        convert.policy_params_from_flax("mlp_continuous", tree, device="cpu")
