"""The port's session slots (gymfx_tpu_torch/serve/slots.py and the
engine's slot path) against the JAX package's, on the CPU.

* ``SlotCache.assign``: one script of calls (new sessions, hits,
  sessionless rows, seeds, LRU evictions, drops, a full cache) through
  the port's and the JAX ``SlotCache`` gives the same gather and scatter
  rows, the same seeds and the same counters, call by call; duplicate
  sessions and too many sessions raise in both.
* Slot decisions equal host-carry threading bitwise (the port's own, in
  ``exact`` mode at every bucket, several steps deep, and in ``matmul``
  mode at one bucket), and the JAX engine's slot decisions within 1e-5
  (the same flax weights, ROADMAP Queue 3's f32 pin).
* The mirror holds each session's carry after its resolved dispatch;
  seed carries resume a host session; an evicted session restarts from
  the initial carry; dispatches in flight resolve to their own rows;
  the slot state is written in place (the graphs' static inputs), by
  ``reset`` and ``adopt`` too; stateless engines have no slots.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymfx_tpu.serve.engine import InferenceEngine as JaxEngine
from gymfx_tpu.serve.slots import SlotCache as JaxSlotCache

from gymfx_tpu_torch.serve import InferenceEngine, SlotCache, serve_config_from

from test_torch_parity import to_np, x64_off
from test_torch_serve_engine import KWARGS, OBS_DIM, _build, _rows

HIDDEN = KWARGS["lstm"]["hidden"]


def _carry0():
    return (np.zeros(4, np.float32), np.ones(4, np.float32))


def _caches(n_slots, mirror=True):
    with x64_off():
        jc = JaxSlotCache(n_slots, _carry0(), mirror=mirror)
    return jc, SlotCache(n_slots, _carry0(), mirror=mirror, device="cpu")


# bucket, sessions, seeds (a row index gets a seed carry) and what to drop first
ASSIGN_SCRIPT = [
    (4, ["a", "b", None], {}),
    (4, ["b", "c", "d"], {2: 1}),
    (2, ["e"], {0: 2}),            # full: evicts the least recent ("a")
    (4, [None, "a", "c", "f"], {1: 3}),
    (1, ["b"], {}),
    (8, ["g", "h", None, "e", "d"], {0: 4, 3: 5}),
    (2, ["a", None], {}),
]


def test_assign_script_matches_the_jax_slot_cache():
    jc, tc = _caches(4)
    for step, (bucket, sessions, seeds) in enumerate(ASSIGN_SCRIPT):
        if step == 4:
            assert jc.drop("c") and tc.drop("c")
            assert not jc.drop("zz") and not tc.drop("zz")
        carries = [None] * len(sessions)
        for row, value in seeds.items():
            carries[row] = (np.full(4, value, np.float32), np.full(4, -value, np.float32))
        with x64_off():
            jg, js, jseeds = jc.assign(bucket, sessions, carries)
        tg, ts, tseeds = tc.assign(bucket, sessions, carries)
        assert tg.dtype == ts.dtype == torch.int64 and tg.shape == (bucket,)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg), err_msg=f"gather {step}")
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=f"scatter {step}")
        assert [s for s, _ in tseeds] == [s for s, _ in jseeds], step
        assert all(a is b for (_, a), (_, b) in zip(tseeds, jseeds))
        assert tc.stats() == jc.stats(), step
        assert tc.sessions() == jc.sessions(), step
        assert {s: tc.slot_of(s) for s in "abcdefgh"} == {s: jc.slot_of(s) for s in "abcdefgh"}
    assert tc.evictions > 0 and tc.seeded > 0


def test_assign_refuses_duplicates_and_too_many_sessions():
    jc, tc = _caches(2)
    for cache in (jc, tc):
        with pytest.raises(ValueError, match="duplicate"):
            cache.assign(4, ["a", "a"])
        with pytest.raises(ValueError, match="exceed"):
            cache.assign(4, ["a", "b", "c"])
        with pytest.raises(ValueError, match="do not fit"):
            cache.assign(1, ["a", "b"])


def test_slot_cache_rejects_empty_carry_and_zero_slots_and_adopts_in_place():
    with pytest.raises(ValueError):
        SlotCache(0, _carry0(), device="cpu")
    with pytest.raises(ValueError):
        SlotCache(2, (), device="cpu")
    with pytest.raises(ValueError):
        SlotCache(2, _carry0(), device="cpu").adopt(SlotCache(3, _carry0(), device="cpu"))
    a, b = SlotCache(2, _carry0(), device="cpu"), SlotCache(2, _carry0(), device="cpu")
    ptrs = [s.data_ptr() for s in a.state]
    b.assign(2, ["x", "y"])
    b.state[0][0].fill_(7.0)
    b.update_mirror(["x", None], (torch.ones(2, 4), torch.zeros(2, 4)))
    a.adopt(b)
    assert [s.data_ptr() for s in a.state] == ptrs  # copied in, not rebound
    assert float(a.state[0][0, 0]) == 7.0 and a.sessions() == ["x", "y"]
    assert a.mirror_carry("x") is not None and a.adoptions == 1
    assert b.sessions() == [] and float(b.state[0][0, 0]) == 0.0
    a.reset()
    assert [s.data_ptr() for s in a.state] == ptrs and a.sessions() == []
    assert torch.equal(a.state[1], torch.ones(4, 4)) and torch.equal(a.state[0], torch.zeros(4, 4))


def _assert_rows_equal(slot_d, host_d, msg):
    assert slot_d.carry is None, msg
    for field in ("action", "value", "actor_out"):
        assert torch.equal(getattr(slot_d, field), getattr(host_d, field)), (msg, field)


@pytest.mark.parametrize("batch_mode", ["exact", "matmul"])
def test_slot_decisions_equal_host_carry_threading(batch_mode):
    _j, eng, _jp, _ref, rng = _build("lstm", batch_mode=batch_mode, jax_engine=False)
    cache = eng.enable_slots(8)
    assert cache is not None and eng.enable_slots(8) is cache
    with pytest.raises(ValueError, match="already enabled"):
        eng.enable_slots(4)
    widths = (1, 3, 4, 8) if batch_mode == "exact" else (3,)
    for n in widths:
        sessions = [f"w{n}-{i}" for i in range(n)]
        host_carry = eng.initial_carry_batch(n)
        for step in range(3):
            obs = _rows(rng, eng, n)
            host_d = eng.decide_batch(obs, host_carry)
            host_carry = host_d.carry
            _assert_rows_equal(eng.decide_batch_slots(obs, sessions), host_d,
                               f"n={n} step={step}")
            for i, s in enumerate(sessions):
                mirror = cache.mirror_carry(s)
                slot = cache.slot_of(s)
                for m, h, st in zip(mirror, host_carry, cache.state):
                    assert torch.equal(m, h[i]) and torch.equal(m, st[slot]), (n, step, s)
    assert eng.late_compiles == 0 and eng.mirror_fetch_bytes > 0


def test_slot_decisions_match_the_jax_engine():
    jeng, eng, _jp, _ref, rng = _build("lstm")
    eng.enable_slots(4)
    with x64_off():
        jeng.enable_slots(4)
    sessions = ["p", "q", "r"]
    for step in range(3):
        obs = _rows(rng, eng, 3)
        got = eng.decide_batch_slots(obs, sessions)
        with x64_off():
            want = jeng.decide_batch_slots(obs, sessions)
        np.testing.assert_allclose(to_np(got.actor_out), np.asarray(want.actor_out), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(to_np(got.value), np.asarray(want.value), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {step}")
        for s in sessions:
            for ours, theirs in zip(eng.slot_cache.mirror_carry(s),
                                    jeng.slot_cache.mirror_carry(s)):
                np.testing.assert_allclose(to_np(ours), np.asarray(theirs), rtol=1e-5, atol=1e-5)


def test_seed_carries_resume_a_host_session_bitwise():
    _j, eng, _jp, _ref, rng = _build("lstm", jax_engine=False)
    eng.enable_slots(4)
    n = 3
    host_carry = eng.initial_carry_batch(n)
    for _ in range(2):
        host_carry = eng.decide_batch(_rows(rng, eng, n), host_carry).carry
    seeds = [tuple(c[i] for c in host_carry) for i in range(n)]
    obs = _rows(rng, eng, n)
    host_d = eng.decide_batch(obs, host_carry)
    slot_d = eng.decide_batch_slots(obs, ["h0", "h1", "h2"], seed_carries=seeds)
    assert eng.slot_cache.seeded == n and eng.seed_upload_bytes == n * 2 * HIDDEN * 4
    _assert_rows_equal(slot_d, host_d, "seeded resume")


def test_evicted_session_restarts_from_initial_never_stale():
    _j, eng, _jp, _ref, rng = _build("lstm", buckets=(1, 2), jax_engine=False)
    eng.enable_slots(2)
    cache = eng.slot_cache
    eng.decide_batch_slots(_rows(rng, eng, 1), ["a"])
    eng.decide_batch_slots(_rows(rng, eng, 1), ["a"])
    eng.decide_batch_slots(_rows(rng, eng, 1), ["b"])
    eng.decide_batch_slots(_rows(rng, eng, 1), ["c"])
    assert cache.evictions == 1 and "a" not in cache.sessions()
    assert cache.mirror_carry("a") is None
    fresh = _rows(rng, eng, 1)
    host_d = eng.decide_batch(fresh, eng.initial_carry_batch(1))
    _assert_rows_equal(eng.decide_batch_slots(fresh, ["a"]), host_d, "evicted restart")


def test_slot_dispatches_in_flight_resolve_to_their_own_rows():
    _j, eng, _jp, _ref, rng = _build("lstm", jax_engine=False)
    eng.enable_slots(16)
    batches = [(_rows(rng, eng, 3), [f"s{k}-{i}" for i in range(3)]) for k in range(3)]
    handles = [eng.dispatch_async(obs, sessions=s) for obs, s in batches]
    for (obs, _s), h in reversed(list(zip(batches, handles))):
        _assert_rows_equal(h.resolve(), eng.decide_batch(obs, eng.initial_carry_batch(3)),
                           "in flight")
        assert h.resolve() is h.resolve()
    stats = eng.slot_stats()
    assert stats["enabled"] and stats["slot_dispatches"] == 3 and stats["slot_decisions"] == 9
    with pytest.raises(ValueError, match="sessions for"):
        eng.dispatch_async(_rows(rng, eng, 2), sessions=["x"])


def test_batch_wider_than_capacity_or_duplicated_raises_at_engine():
    _j, eng, _jp, _ref, _rng = _build("lstm", jax_engine=False)
    eng.enable_slots(2)
    with pytest.raises(ValueError):
        eng.decide_batch_slots(np.zeros((4, OBS_DIM), np.float32), ["a", "b", "c", "d"])
    with pytest.raises(ValueError):
        eng.decide_batch_slots(np.zeros((2, OBS_DIM), np.float32), ["a", "a"])


def test_knob_unset_leaves_the_host_path_as_it_was():
    _j, plain, _jp, _ref, rng = _build("lstm", jax_engine=False)
    _j2, slotted, _jp2, _ref2, _rng2 = _build("lstm", jax_engine=False)
    slotted.enable_slots(8)
    assert plain.slot_cache is None and plain.slot_stats() == {
        "enabled": False, "slot_dispatches": 0, "slot_decisions": 0,
        "mirror_fetch_bytes": 0, "seed_upload_bytes": 0}
    carries = plain.initial_carry_batch(3)
    for step in range(2):
        obs = _rows(rng, plain, 3)
        a, b = plain.decide_batch(obs, carries), slotted.decide_batch(obs, carries)
        assert torch.equal(a.actor_out, b.actor_out) and all(
            torch.equal(x, y) for x, y in zip(a.carry, b.carry)), step
        carries = a.carry
    _j3, mlp, _jp3, _ref3, _rng3 = _build("mlp", jax_engine=False)
    assert mlp.enable_slots(8) is None and mlp.slot_cache is None


def test_serve_config_parses_slot_knobs():
    scfg = serve_config_from({})
    assert scfg.session_slots == 0 and scfg.slot_mirror is True and scfg.staging is True
    scfg = serve_config_from({"serve_session_slots": 16, "serve_slot_mirror": False,
                              "serve_staging": False})
    assert scfg.session_slots == 16 and scfg.slot_mirror is False and scfg.staging is False
    with pytest.raises(ValueError):
        serve_config_from({"serve_session_slots": -1})


def test_mirror_off_fetches_no_carry():
    _j, eng, _jp, _ref, rng = _build("lstm", jax_engine=False)
    eng.enable_slots(4, mirror=False)
    eng.decide_batch_slots(_rows(rng, eng, 2), ["m0", "m1"])
    assert eng.mirror_fetch_bytes == 0 and eng.slot_cache.mirror_carry("m0") is None
