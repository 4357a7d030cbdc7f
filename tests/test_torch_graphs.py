"""The train step's static-buffer bodies (core/graphs.py, train/ppo.py) on
the CPU.

On a CUDA device ``PPOTrainer`` captures each phase once as a CUDA graph
over static buffers and replays it; on the CPU nothing is captured, but
the same entry points run (``_rollout_phase_graphed``, ``_update_phase_graphed``,
``_train_many_graphed``): inputs copied into static buffers, the body run,
its outputs copied into the first call's.  Here, at small sizes (a few
envs, horizon 4-8, narrow policies; the flagship MLP, transformer_ring
with K4's plain version, the curriculum with random starts and a
compressed tape, and the LOB venue with 8 flow messages a bar):

* the bodies the graphs capture never sync the host: a
  ``TorchFunctionMode`` refuses ``item``, ``tolist``, ``bool``, ``int``,
  ``float``, ``__index__``, ``cpu``, ``numpy``, ``nonzero``,
  ``masked_select``, ``unique``, one-argument ``where``, a bool-mask index
  and ``torch.tensor`` / ``as_tensor`` / ``from_numpy`` (a tensor built
  from host data, a host-to-device copy on the card);
* the static-buffer entry points equal the eager phases bitwise (the same ops
  on the same values), train_many included;
* new inputs copied into the same buffers give what separate eager calls
  give, and a returned phase is not overwritten by the next call;
* a pick copied into the staging tape gives the pick's own phase;
* through the static buffers, the rollout still matches the JAX
  package's with its draws injected (as tests/test_torch_rollout.py
  holds the eager phase).

The card's side (graphed == eager with torch.equal, re-capture, hooks,
capture errors) is in tests/test_torch_cuda.py.
"""
import warnings

import jax
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from gymfx_tpu_torch.config import flagship
from gymfx_tpu_torch.core import graphs
from gymfx_tpu_torch.core.runtime import Environment
from gymfx_tpu_torch.ops import cases
from gymfx_tpu_torch.resilience import guards
from gymfx_tpu_torch.train.optim import ClipAdam, clip_by_global_norm
from gymfx_tpu_torch.train.ppo import PPOTrainer, TrainState, ppo_config_from

from test_torch_parity import assert_bitwise, assert_state_bitwise, to_np, x64_off
from test_torch_rollout import _jax_phase
from test_torch_rollout import _pair as _rollout_pair

CSV = str(__import__("pathlib").Path(__file__).resolve().parent.parent
          / "examples" / "data" / "eurusd_sample.csv")
KINDS = ["mlp", "transformer_ring", "curriculum", "lob"]


class NoHostSync(TorchFunctionMode):
    """Raises on every torch call that waits for the device or copies
    host data to it."""

    SYNCS = {
        torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__bool__, torch.Tensor.__int__,
        torch.Tensor.__float__, torch.Tensor.__index__, torch.Tensor.cpu, torch.Tensor.numpy,
        torch.Tensor.nonzero, torch.nonzero, torch.Tensor.masked_select, torch.masked_select,
        torch.Tensor.unique, torch.unique, torch.tensor, torch.as_tensor, torch.from_numpy,
    }

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.SYNCS:
            raise AssertionError(f"host sync in a captured body: {func.__name__}")
        if func is torch.where and len(args) + len(kwargs) == 1:
            raise AssertionError("host sync in a captured body: one-argument torch.where")
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__):
            index = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in index):
                raise AssertionError("host sync in a captured body: a bool-mask index")
        return func(*args, **kwargs)


def _tapes(tmp_path, count=3, n=200):
    paths = []
    for i in range(count):
        path = tmp_path / f"tape{i}.csv"
        cases.write_bar_csv(path, cases.tick_walk_columns(n, seed=40 + i, vol_ticks=30.0),
                            cases.m1_week_grid(n))
        paths.append(f"file:{path}")
    return ",".join(paths)


def _trainer(kind, tmp_path):
    small = dict(num_envs=8, ppo_horizon=6, ppo_minibatches=2, window_size=8,
                 policy_kwargs={"hidden": [16, 16, 16]})
    if kind == "mlp":
        config = flagship.flagship_config(CSV, **small)
    elif kind == "transformer_ring":
        config = flagship.long_context_config(
            CSV, num_envs=4, ppo_horizon=4, ppo_minibatches=2, window_size=16,
            policy_kwargs={"d_model": 16, "n_heads": 2, "n_layers": 2})
    elif kind == "lob":
        config = flagship.lob_config(CSV, lob_messages_per_bar=8, **small)
    else:
        config = flagship.curriculum_config(_tapes(tmp_path), timeframe="M1", **small)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return PPOTrainer(Environment(config, device="cpu"), ppo_config_from(config))


def _data(trainer, i=1):
    return None if trainer.curriculum is None else trainer.curriculum._tape_data(i)


def _copy(state):
    gen = torch.Generator()
    gen.set_state(state.generator.get_state())
    return TrainState(*graphs.clone_tree(tuple(state[:4])), gen)


def _assert_equal(a, b, what):
    la, lb = guards.tree_leaves(a), guards.tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert_bitwise(x, y, f"{what}: leaf {i}")


def _assert_states_equal(a, b, what):
    _assert_equal(tuple(a[:4]), tuple(b[:4]), what)
    assert torch.equal(a.generator.get_state(), b.generator.get_state()), f"{what}: generator"


@pytest.mark.parametrize("kind", KINDS)
def test_captured_bodies_never_sync_the_host(kind, tmp_path):
    trainer = _trainer(kind, tmp_path)
    data, pcfg = _data(trainer), trainer.pcfg
    state = trainer.init_state(0)
    trainer._train_many_graphed(_copy(state), data, 1)
    g = torch.Generator().manual_seed(1)
    hooks = dict(actions=torch.randint(0, 3, (pcfg.horizon, pcfg.n_envs), generator=g),
                 permutations=torch.stack([torch.randperm(pcfg.n_envs, generator=g)
                                           for _ in range(pcfg.epochs)]))
    if kind == "curriculum":
        hooks["start_offsets"] = torch.randint(0, trainer.env.cfg.n_bars - 2, (pcfg.n_envs,),
                                               generator=g)
    inter, rollout_out = trainer._rollout_phase_graphed(
        _copy(state), data, actions=hooks["actions"], start_offsets=hooks.get("start_offsets"))
    trainer._update_phase_graphed(inter, rollout_out, data, permutations=hooks["permutations"])
    assert sorted(k for k, *_ in trainer._graphs) == ["rollout", "rollout", "update", "update"]
    for graph in trainer._graphs.values():
        with NoHostSync():
            graph.body(graph.inputs)
    with pytest.raises(AssertionError, match="host sync"), NoHostSync():
        state.obs_vec.sum().item()


@pytest.mark.parametrize("kind", KINDS)
def test_static_buffer_phases_equal_the_eager_phases(kind, tmp_path):
    trainer = _trainer(kind, tmp_path)
    data = _data(trainer)
    s0 = trainer.init_state(3)
    a, rollout_a = trainer._rollout_phase_graphed(_copy(s0), data)
    b, rollout_b = trainer.rollout_phase(_copy(s0), data)
    _assert_equal(rollout_a, rollout_b, "rollout trajectory")
    _assert_states_equal(a, b, "rollout state")
    ua, ma = trainer._update_phase_graphed(a, rollout_a, data)
    ub, mb = trainer.update_phase(b, rollout_b, data)
    _assert_states_equal(ua, ub, "update state")
    _assert_equal(ma, mb, "update metrics")
    many, stacked = trainer._train_many_graphed(_copy(ub), data, 3)
    ref, ref_stacked = trainer.train_many_with_data(_copy(ub), data, 3)
    _assert_states_equal(many, ref, "train_many state")
    assert list(stacked) == list(ref_stacked)
    _assert_equal(stacked, ref_stacked, "train_many metrics")
    assert all(v.shape == (3,) for v in stacked.values())
    # one static signature a phase: every later call reused the first's buffers
    assert sorted(k for k, *_ in trainer._graphs) == ["rollout", "update"]
    with pytest.raises(ValueError, match="k >= 1"):
        trainer._train_many_graphed(many, data, 0)


def test_new_inputs_in_the_same_buffers_and_returned_phases_keep_their_values(tmp_path):
    trainer = _trainer("mlp", tmp_path)
    s1, s2 = trainer.init_state(1), trainer.init_state(2)
    first = trainer._rollout_phase_graphed(_copy(s1))
    kept = graphs.clone_tree((tuple(first[0][:4]), first[1]))
    second = trainer._rollout_phase_graphed(_copy(s2))
    graph = next(iter(trainer._graphs.values()))
    assert graph.inputs["obs_vec"] is not s2.obs_vec
    _assert_equal((tuple(first[0][:4]), first[1]), kept, "the first phase after the second")
    _assert_equal(first[1], trainer.rollout_phase(_copy(s1))[1], "first vs eager")
    _assert_equal(second[1], trainer.rollout_phase(_copy(s2))[1], "second vs eager")
    # the update likewise, its metrics too
    u1, m1 = trainer._update_phase_graphed(_copy(first[0]), first[1])
    kept = graphs.clone_tree((tuple(u1[:4]), m1))
    u2, m2 = trainer._update_phase_graphed(_copy(second[0]), second[1])
    _assert_equal((tuple(u1[:4]), m1), kept, "the first update after the second")
    ref, ref_metrics = trainer.update_phase(_copy(second[0]), second[1])
    _assert_states_equal(u2, ref, "second update vs eager")
    _assert_equal(m2, ref_metrics, "second update metrics vs eager")
    # the train step donates: its state is the update graph's static outputs
    donated, _ = trainer._train_many_graphed(_copy(s1), None, 1)
    update = [g for (kind, *_), g in trainer._graphs.items() if kind == "update"][0]
    assert donated.params is update.outputs["params"]


def test_a_pick_copied_into_the_staging_tape_gives_the_picks_phase(tmp_path):
    trainer = _trainer("curriculum", tmp_path)
    s0 = trainer.init_state(5)
    staged = []
    for i in (1, 2, 0, 2):
        pick = _data(trainer, i)
        ours, metrics = trainer._train_many_graphed(_copy(s0), pick, 1)
        ref, ref_metrics = trainer.train_many_with_data(_copy(s0), pick, 1)
        _assert_states_equal(ours, ref, f"tape {i}")
        _assert_equal(metrics, ref_metrics, f"tape {i} metrics")
        staged.append(trainer._staging)
        for name in pick._fields:
            a, b = getattr(trainer._staging, name), getattr(pick, name)
            assert (a is not b) if isinstance(b, torch.Tensor) else a == b
            if isinstance(b, torch.Tensor):
                assert_bitwise(a, b, f"staged tape {i} {name}")
    assert all(s is staged[0] for s in staged)
    assert len(trainer._graphs) == 2


def test_static_buffer_rollout_matches_jax_with_injected_draws():
    trainer, ro = _rollout_pair()
    n = trainer.pcfg.n_envs
    state = ro.init_state(0)
    dones = 0
    with x64_off():
        from gymfx_tpu_torch import convert

        js = trainer.init_state(0)
        state = state._replace(params=convert.mlp_params_from_flax(
            jax.tree.map(np.asarray, js.params), device="cpu"))
        jax_phase = _jax_phase(trainer)
        for phase in range(4):
            _, k0 = jax.random.split(js.rng)
            offsets = np.array(jax.random.randint(k0, (n,), 0, max(1, trainer.env.cfg.n_bars - 2)))
            js, (traj, last_value) = jax_phase(js)
            state, (ttraj, tlast) = ro._rollout_phase_graphed(
                state, actions=torch.from_numpy(np.array(traj["action"])),
                start_offsets=torch.from_numpy(offsets))
            for key in ("obs", "reward", "done", "action"):
                assert_bitwise(traj[key], ttraj[key], f"phase {phase} traj {key}")
            for key in ("logp", "value"):
                np.testing.assert_allclose(to_np(ttraj[key]), np.asarray(traj[key]),
                                           rtol=1e-5, atol=1e-5, err_msg=key)
            np.testing.assert_allclose(to_np(tlast), np.asarray(last_value), rtol=1e-5, atol=1e-5)
            assert_state_bitwise(js.env_states, state.env_states, f"phase {phase}")
            assert_bitwise(js.obs_vec, state.obs_vec, f"phase {phase} obs_vec")
            dones += int(np.asarray(traj["done"]).sum())
    assert dones > 0
    assert len(ro._graphs) == 1


# ---- core/graphs.py and the capture-safety repairs ---------------------------
def test_copy_tree_skips_a_leaf_that_is_its_own_source_and_casts_by_group():
    dst = {"a": torch.zeros(3), "b": (torch.zeros(2, dtype=torch.int32), torch.zeros(1))}
    same = dst["b"][1]
    graphs.copy_tree(dst, {"a": torch.arange(3.0), "b": (torch.tensor([4.0, 5.0]), same)})
    assert torch.equal(dst["a"], torch.arange(3.0))
    assert dst["b"][0].dtype == torch.int32 and dst["b"][0].tolist() == [4, 5]
    assert graphs.signature(dst) == (((3,), torch.float32, "cpu"), ((2,), torch.int32, "cpu"),
                                     ((1,), torch.float32, "cpu"))


def test_phase_graph_on_the_cpu_reuses_its_first_outputs():
    calls = []

    def body(x):
        calls.append(1)
        return {"y": x["a"] * 2, "same": x["a"]}

    buffers = {"a": torch.zeros(2)}
    graph = graphs.PhaseGraph(body, buffers)
    assert graph.graph is None and graph.capture_s == 0.0 and not calls
    out = graph({"a": torch.ones(2)})
    y = out["y"]
    assert graph({"a": torch.full((2,), 3.0)})["y"] is y
    assert y.tolist() == [6.0, 6.0] and out["same"] is buffers["a"]
    assert graph()["y"].tolist() == [6.0, 6.0] and len(calls) == 3


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_clip_adam_update_builds_no_tensor_from_host_data(mu_dtype):
    opt = ClipAdam(1e-2, 0.5, mu_dtype)
    params = {"w": torch.linspace(-1, 1, 6).reshape(2, 3)}
    state = opt.init(params)
    grads = {"w": torch.linspace(0.3, -0.7, 6).reshape(2, 3)}
    with NoHostSync():
        _, new, _ = opt.update(grads, state)
    clipped, _ = clip_by_global_norm(grads, 0.5)
    mu = (1 - 0.9) * clipped["w"] + state.mu["w"] * torch.tensor(0.9, dtype=mu_dtype)
    assert_bitwise(new.mu["w"], mu.to(mu_dtype), "mu")


def test_tree_all_finite_of_a_tree_without_floats_is_on_the_trees_device():
    tree = {"i": torch.zeros(3, dtype=torch.int32, device="meta")}
    assert guards.tree_all_finite(tree).device.type == "meta"
    assert guards.tree_all_finite({}).device.type == "cpu"
    assert bool(guards.tree_all_finite({"i": torch.zeros(3, dtype=torch.int32)}))
