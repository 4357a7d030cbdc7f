"""K9 (ops/lob_flow.py): one bar's order-flow messages for every env.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to
its plain version there).  Here, on the CPU:

* ``ops/cases.bar_flow_emulated``, K9's algorithm (csrc/flow_kernels.cu
  ``bar_flow_kernel``) in numpy uint32 and float32 (its key derivation
  and sharing across a warp's lanes, its lane-to-message map and its
  float path), equals the plain version ``bar_flow_plain`` with
  ``torch.equal`` for every scenario of ``lob/scenarios.py`` (the flash
  crash's window among them), at 17, 64 and 70 messages (not multiples
  of a warp), at 13 envs (not a multiple of the CTA's 4) and on bar rows
  held as int32 (negative ones among them) and as int64 at 2^31 and
  above, whose low 32 bits key the flow; and on flows of one message
  kind alone (every lane a cancel, or none).  The plain version equals
  ``jax.random``'s bits (tests/test_torch_lob_flow.py).
* The kernel's constants (``flow_constants``): randint's fold with
  ``prng.randint_constants`` in uint32 wraps equals
  ``prng.bits_to_randint``, and the argument layout the wrapper checks
  equals the source's.
* ``bar_flow`` on CPU tensors is the plain version and launches nothing.
"""
import re

import numpy as np
import pytest
import torch

from gymfx_tpu_torch.lob import prng
from gymfx_tpu_torch.lob.flow import _f32
from gymfx_tpu_torch.lob.scenarios import scenario_flow_params, scenario_names
from gymfx_tpu_torch.ops import _build, cases, lob_flow

N_ENVS = 13


def _bars(rows: str, seed=0):
    return cases.lob_flow_bars(N_ENVS, rows, seed)


@pytest.mark.parametrize("rows", ["int32", "int64"])
@pytest.mark.parametrize("n_msgs", [17, 64, 70])
@pytest.mark.parametrize("scenario", scenario_names())
def test_bar_flow_emulated_equals_plain(scenario, n_msgs, rows):
    fp = scenario_flow_params(scenario)
    bars = _bars(rows, seed=n_msgs)
    ref = lob_flow.bar_flow_plain(11, *bars, n_msgs, fp)
    ours = cases.bar_flow_emulated(11, *bars, n_msgs, fp)
    for name, a, b in zip(ref._fields, ours, ref):
        assert torch.equal(a, b), f"{scenario} {n_msgs} {rows} {name}"
    kinds = torch.bincount(ref.kind.flatten(), minlength=4)
    if scenario == "lob_flash_crash":
        window = slice(fp.crash_at, fp.crash_at + fp.crash_len)
        assert (ref.kind[:, window] == 3).all() and (ref.side[:, window] == -1).all()
        assert (ref.qty[:, window] == fp.crash_qty).all()
    # every kind the scenario draws occurs, cancels naming earlier oids
    assert bool((kinds[1:] > 0).all()) and bool((kinds[0] > 0) == (fp.p_noop > 0))
    cancels = ref.kind == 2
    idx = torch.arange(n_msgs).expand_as(ref.oid)
    assert bool((ref.oid[cancels] <= idx[cancels]).all())


@pytest.mark.parametrize("kind", list(cases.FLOW_ONE_KIND))
def test_bar_flow_emulated_equals_plain_on_one_kind(kind):
    """One kind alone: every lane of every warp draws a cancel's target,
    or none does."""
    fp = scenario_flow_params("lob_volatile")._replace(**cases.FLOW_ONE_KIND[kind])
    bars = _bars("int64", seed=5)
    ref = lob_flow.bar_flow_plain(3, *bars, 70, fp)
    ours = cases.bar_flow_emulated(3, *bars, 70, fp)
    for name, a, b in zip(ref._fields, ours, ref):
        assert torch.equal(a, b), f"{kind} {name}"
    assert bool((ref.kind == list(cases.FLOW_ONE_KIND).index(kind)).all())


def test_bar_flow_emulated_shares_the_keys_across_lanes():
    """Envs whose low 32 bits of the bar row agree draw the same flow;
    a bar row one apart draws another."""
    fp = scenario_flow_params("lob_volatile")
    t, o, h, lo, c = _bars("int64")
    t = torch.tensor([5, 5 + 2 ** 32, 6] + [7] * (N_ENVS - 3), dtype=torch.int64)
    o, h, lo, c = (x[:1].expand(N_ENVS).contiguous() for x in (o, h, lo, c))
    ours = cases.bar_flow_emulated(0, t, o, h, lo, c, 40, fp)
    assert all(torch.equal(x[0], x[1]) for x in ours)
    assert not torch.equal(ours.kind[0], ours.kind[2])


@pytest.mark.parametrize("lo,hi", [(-2, 3), (0, 1), (0, 10), (5, 5), (-(2 ** 31), 2 ** 31 - 1)])
def test_randint_constants_fold_as_prng_randint(lo, hi):
    """The kernel's fold (uint32 wraps) with the host's constants."""
    span, mult = prng.randint_constants(lo, hi)
    rng = np.random.default_rng(3)
    higher, lower = (torch.from_numpy(rng.integers(0, 2 ** 32, 257, dtype=np.int64))
                     for _ in range(2))
    offset = (((higher % span) * mult) & 0xFFFFFFFF) + lower % span
    value = (lo + (offset & 0xFFFFFFFF) % span) & 0xFFFFFFFF
    value = torch.where(value >= 2 ** 31, value - 2 ** 32, value).to(torch.int32)
    assert torch.equal(value, prng.bits_to_randint(higher, lower, lo, hi))


def test_flow_constants_and_argument_layout_match_the_kernel_source():
    fp = scenario_flow_params("lob_thin")
    words = np.array(lob_flow.flow_constants(fp, 2 ** 32 + 9), np.int32)
    assert words[0] == 9
    thresholds = words[1:4].view(np.float32)
    assert thresholds.tolist() == [_f32(fp.p_noop), _f32(fp.p_noop + fp.p_add),
                                   _f32(fp.p_noop + fp.p_add + fp.p_cancel)]
    src = _build.SOURCES["flow"].read_text()
    assert int(re.search(r"kFlowConsts = (\d+);", src).group(1)) == len(words)
    assert int(re.search(r"kFlowPointers = (\d+);", src).group(1)) == 10
    assert _build.FLAGS["flow"].count("-fmad=false") == 1
    assert not any("fast_math" in f for f in _build.FLAGS["flow"])
    assert "flow" in _build.KERNEL_LIBRARIES


def test_bar_flow_on_cpu_is_the_plain_version():
    fp = scenario_flow_params("lob_calm")
    bars = _bars("int32")
    before = lob_flow.bar_flow.launches
    ours = lob_flow.bar_flow(4, *bars, 24, fp)
    assert lob_flow.bar_flow.launches == before
    for a, b in zip(ours, lob_flow.bar_flow_plain(4, *bars, 24, fp)):
        assert torch.equal(a, b) and a.dtype == torch.int32 and a.shape == (N_ENVS, 24)
