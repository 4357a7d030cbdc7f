"""K8 (ops/lob_bar.py): one bar of the LOB venue on the books K5 seeded.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to
its plain version there).  Here, on the CPU:

* ``ops/cases.lob_bar_emulated``, K8's algorithm (csrc/lob_kernels.cu
  ``lob_bar_kernel``) on K5's model of a warp's book, equals the plain
  version ``run_bar_plain`` with ``torch.equal`` on the final books and
  every result, on seeded books and the venue's ``lob_volatile`` bar flow
  (and ``lob_thin``'s, a third of it NOOPs, which the kernel skips) at
  depths 8, 24 and 48 (1 and 2 levels a lane) and 1, 4 and 8 slots;
  the agent's orders (``cases.LOB_BAR_PATHS``) cover open walks on both
  sides, a forced liquidation, a sub-lot denial, gap stops both ways,
  resting take-profits and stops left to the flow, a take-profit filled
  in part and then pulled by the stop, a stop that fires on the last
  message, and no brackets; each path must occur.
* The same on books whose lot totals exceed int32 (lots up to 2^31 - 1:
  level sums and walks wrap): the two do not part there either.
* ``run_bar`` on CPU tensors is the plain version and launches nothing.

The plain version is the venue's book work as it was (its JAX reference
is the venue's scan, held by tests/test_torch_lob_venue.py).
"""
import numpy as np
import pytest
import torch

from gymfx_tpu_torch.lob.book import BookState
from gymfx_tpu_torch.ops import cases, lob_bar
from gymfx_tpu_torch.ops.lob_bar import BarFills


def _assert_equal(ours, ref):
    names = (*BookState._fields, *BarFills._fields)
    for name, a, b in zip(names, (*ours[0], *ours[1]), (*ref[0], *ref[1])):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("slots", [1, 4, 8])
@pytest.mark.parametrize("depth", [8, 24, 48])
def test_lob_bar_emulated_equals_plain_on_venue_bars(depth, slots):
    book, flow, orders, paths = cases.lob_bar_case(66, depth=depth, slots=slots, n_msgs=64,
                                                   seed=depth + slots)
    ref = lob_bar.run_bar_plain(book, flow, orders)
    _assert_equal(cases.lob_bar_emulated(book, flow, orders), ref)
    occurred = cases.lob_bar_paths(book, flow, orders, ref[1], paths)
    assert sorted(occurred) == sorted(cases.LOB_BAR_PATHS)
    assert all(occurred.values()), occurred


@pytest.mark.parametrize("slots", [1, 4, 8])
@pytest.mark.parametrize("depth", [8, 24, 48])
def test_lob_bar_emulated_equals_plain_on_noop_flow(depth, slots):
    """lob_thin's bars: a third of the flow is NOOPs, which the kernel
    skips where both halves are within int32."""
    book, flow, orders, _ = cases.lob_bar_case(66, depth=depth, slots=slots, n_msgs=64,
                                               seed=depth + slots, scenario="lob_thin")
    assert float((flow.kind == 0).float().mean()) > 0.25
    ref = lob_bar.run_bar_plain(book, flow, orders)
    _assert_equal(cases.lob_bar_emulated(book, flow, orders), ref)


@pytest.mark.parametrize("depth,slots", [(4, 3), (2, 2), (6, 2), (33, 1), (40, 8)])
def test_lob_bar_emulated_equals_plain_where_int32_sums_wrap(depth, slots):
    book, flow, orders = cases.lob_bar_wrap_case(64, 40, depth, slots, seed=depth)
    half_lots = torch.stack([book.bid_qty.sum(dim=(1, 2)), book.ask_qty.sum(dim=(1, 2))])
    assert int(half_lots.max()) > 2 ** 31 - 1
    ref = lob_bar.run_bar_plain(book, flow, orders)
    assert int(ref[1].fired.sum()) > 0 and int((ref[1].tp_lots != 0).sum()) > 0
    _assert_equal(cases.lob_bar_emulated(book, flow, orders), ref)


def test_run_bar_on_cpu_is_the_plain_version():
    book, flow, orders, paths = cases.lob_bar_case(22, n_msgs=16)
    before = lob_bar.run_bar.launches
    _assert_equal(lob_bar.run_bar(book, flow, orders), lob_bar.run_bar_plain(book, flow, orders))
    assert lob_bar.run_bar.launches == before
    assert all(x.dtype == torch.int32 and x.shape == (22,) for x in orders)
    assert np.isin(cases.LOB_BAR_PATHS, paths).all()
