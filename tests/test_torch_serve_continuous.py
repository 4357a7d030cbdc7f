"""Continuous serving (gymfx_tpu_torch/serve/engine.py with a Gaussian
twin) against the JAX package's engine, on the CPU.

* The same weights (flax init of the twin, carried across by
  ``convert.policy_params_from_flax``) in both engines, ``exact`` mode,
  ladder (1, 4, 8), threshold 0.2: ``actor_out`` is the mean and the
  value within the policy-output pins of ROADMAP Queue 3 (1e-5 in f32,
  4e-3 in bf16); the actions equal the JAX engine's wherever the JAX mean
  is further than that tolerance from either threshold; every action is
  the env's coercion of the port's own mean exactly (1 at ``mu >= thr``,
  2 at ``mu <= -thr``, else 0, core/env.py); each ``exact`` row is
  ``torch.equal`` to the twin's single-row forward.  MLP (f32), the LSTM
  twin (f32 and bf16, carries within 1e-5 / bf16 2^-6 x max|carry|) and
  the ring twin (f32).
* ``matmul`` rows and the LSTM twin's slot path give the same coercion.
* ``engine_from_config`` with ``action_space_mode=continuous`` takes the
  config's threshold, rounded to float32 as the env's parameter is.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.serve.engine import InferenceEngine as JaxEngine
from gymfx_tpu.train.policies import make_trainer_policy as jax_make_policy

from gymfx_tpu_torch import convert
from gymfx_tpu_torch.config import DEFAULT_VALUES
from gymfx_tpu_torch.serve import InferenceEngine, engine_from_config
from gymfx_tpu_torch.train.policies import make_trainer_policy

from test_torch_parity import to_np, x64_off

OBS_DIM, WINDOW, TOKEN_DIM, THR = 12, 6, 3, 0.2
BUCKETS = (1, 4, 8)
KWARGS = {"mlp": {"hidden": [16, 16]}, "lstm": {"hidden": 16},
          "transformer_ring": {"d_model": 16, "n_heads": 2, "n_layers": 1}}
TOL = {"float32": 1e-5, "bfloat16": 4e-3}
CSV = str(__import__("pathlib").Path(__file__).resolve().parent.parent / "examples" / "data"
          / "eurusd_sample.csv")


def _coerce(mu, thr=THR):
    thr = np.float32(thr)
    return np.where(mu >= thr, 1, np.where(mu <= -thr, 2, 0)).astype(np.int32)


def _build(name, dtype="float32", batch_mode="exact"):
    shape = (WINDOW, TOKEN_DIM) if name == "transformer_ring" else (OBS_DIM,)
    rng = np.random.default_rng(sum(map(ord, name)))
    example = rng.standard_normal(shape).astype(np.float32)
    with x64_off():
        jpol = jax_make_policy(name, continuous=True, dtype=getattr(jnp, dtype),
                               kwargs=dict(KWARGS[name]), window=WINDOW)
        carry0 = jpol.initial_carry(())
        key = jax.random.PRNGKey(5)
        jparams = (jpol.init(key, jnp.asarray(example), carry0) if jax.tree.leaves(carry0)
                   else jpol.init(key, jnp.asarray(example)))
        jeng = JaxEngine(jpol, jparams, example, buckets=BUCKETS, batch_mode=batch_mode,
                         continuous=True, continuous_threshold=THR)
    params = convert.policy_params_from_flax(
        f"{name}_continuous", jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
        device="cpu")
    tpol = make_trainer_policy(name, shape[-1], continuous=True, dtype=getattr(torch, dtype),
                               kwargs=dict(KWARGS[name]), window=WINDOW)
    eng = InferenceEngine(tpol, params, example, buckets=BUCKETS, batch_mode=batch_mode,
                          continuous=True, continuous_threshold=THR, device="cpu")
    ref = copy.deepcopy(tpol)
    ref.load_state_dict(params)
    return jeng, eng, ref, rng


def _carries(rng, eng, n):
    if not eng.recurrent:
        return None, None
    vals = [rng.standard_normal((n, *c.shape)).astype(np.float32) for c in eng.initial_carry()]
    dtype = eng.initial_carry()[0].dtype
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with x64_off():
        jc = tuple(jnp.asarray(v).astype(jdt) for v in vals)
    return jc, tuple(torch.from_numpy(v).to(dtype) for v in vals)


@pytest.mark.parametrize("name,dtype", [("mlp", "float32"), ("lstm", "float32"),
                                        ("lstm", "bfloat16"), ("transformer_ring", "float32")])
def test_continuous_engine_matches_the_jax_engine_and_the_env_coercion(name, dtype):
    jeng, eng, ref, rng = _build(name, dtype)
    tol, kinds = TOL[dtype], set()
    for n in (1, 3, 4, 8):
        obs = rng.standard_normal((n, *eng.obs_shape)).astype(np.float32)
        jc, tc = _carries(rng, eng, n)
        out = eng.decide_batch(obs, tc)
        with x64_off():
            jout = jeng.decide_batch(obs, jc)
        mu = to_np(out.actor_out)
        assert out.actor_out.shape == (n,) and out.actor_out.dtype == torch.float32
        assert out.action.dtype == torch.int32
        np.testing.assert_array_equal(to_np(out.action), _coerce(mu))
        np.testing.assert_allclose(mu, np.asarray(jout.actor_out), rtol=tol, atol=tol)
        np.testing.assert_allclose(to_np(out.value), np.asarray(jout.value), rtol=tol, atol=tol)
        jmu = np.asarray(jout.actor_out, np.float64)
        clear = np.abs(np.abs(jmu) - THR) > 2 * tol
        np.testing.assert_array_equal(to_np(out.action)[clear], np.asarray(jout.action)[clear])
        kinds |= set(to_np(out.action).tolist())
        for ours, theirs in zip(out.carry or (), jax.tree.leaves(jout.carry)):
            theirs = np.asarray(theirs).astype(np.float32)
            ctol = 1e-5 if dtype == "float32" else 2.0 ** -6 * float(np.abs(theirs).max())
            np.testing.assert_allclose(to_np(ours), theirs, rtol=0, atol=ctol)
        for i in range(n):  # the exact rows: the single-row forward, bit for bit
            with torch.no_grad():
                x = torch.as_tensor(obs[i])[None].clone()
                if eng.recurrent:
                    (m, _), v, _ = ref(x, tuple(c[i][None].clone() for c in tc))
                else:
                    (m, _), v = ref(x)
            assert torch.equal(out.actor_out[i], m[0]) and torch.equal(out.value[i], v[0])
    assert kinds == {0, 1, 2}, kinds


def test_matmul_rows_and_slots_coerce_their_mean():
    _j, eng, _ref, rng = _build("mlp", batch_mode="matmul")
    out = eng.decide_batch(rng.standard_normal((8, OBS_DIM)).astype(np.float32))
    np.testing.assert_array_equal(to_np(out.action), _coerce(to_np(out.actor_out)))
    _j, lstm, _ref, rng = _build("lstm")
    assert lstm.enable_slots(4) is not None
    obs = rng.standard_normal((3, OBS_DIM)).astype(np.float32)
    first = lstm.decide_batch_slots(obs, ["a", "b", "c"])
    again = lstm.decide_batch_slots(obs, ["a", "b", "c"])
    for out in (first, again):
        assert out.carry is None
        np.testing.assert_array_equal(to_np(out.action), _coerce(to_np(out.actor_out)))
    assert not torch.equal(first.actor_out, again.actor_out)  # the carry moved on


def test_engine_from_config_takes_the_threshold():
    config = dict(DEFAULT_VALUES, input_data_file=CSV, window_size=8, serve_buckets=[1, 4],
                  action_space_mode="continuous", continuous_action_threshold=0.1,
                  policy_kwargs={"hidden": [8, 8]})
    bundle = engine_from_config(config, device="cpu")
    eng = bundle.engine
    assert eng.continuous and eng.continuous_threshold == float(np.float32(0.1))
    d = eng.decide(bundle.encode(bundle.reset_obs)[0])
    assert d.actor_out.shape == () and int(d.action) == int(_coerce(to_np(d.actor_out), 0.1))
