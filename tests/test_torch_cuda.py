"""The port's CUDA kernels K1-K7 against their plain versions, on the card.

Each case launches a kernel and its plain PyTorch version on the same
CUDA tensors.  K1-K3 must give ``torch.equal`` results (they are built
with -fmad=false and IEEE division, so the f32 results are the same
bits).  K4 (attention forward and backward) sums in another order than
its plain version (an online softmax, f32 FMAs): float32 within
1e-4 x max|plain|, bfloat16 within 2^-6 x max|plain| (the two round an
f32 value to bf16 once each, so they differ by at most one bf16 ulp of
an element, 2^-7 of the largest; twice that for margin).  The bf16
route (tensor cores) is also held to the emulation of its rounding points
in ops/cases.py within 2^-7 x max|emulation| (only the order of the f32
sums differs, so the two round nearly the same value to bf16: at most one
ulp of the largest element), and two backward calls must give the same
bits.  K3 also at N = 1, 63 and 8,193 with both rewards and mark_pred and
live all true, all false and mixed.  K5 (LOB stream
matching) is int32: books and fill records ``torch.equal``; so is K8
(one bar of the LOB venue): final books and results, at every template,
on the venue's bars and where lot sums wrap int32; and K9 (a bar's flow
messages: threefry words and a float32 path, -fmad=false) for every
scenario at the venue's shape and at odd ones, and replayed from a CUDA
graph.  K6 (q16
tape decode) and K7 (batched scaled windows) ``torch.equal`` (-fmad=false,
IEEE division; K7 NaN for NaN, over random, the export's and clamped
steps, F 1-7, W 8-64 and a feature view 4 bytes off alignment, and at
a batch where every CTA walks several tiles), also through a compressed tape's shard decode and a
streamed episode on the card (pinned copies on a side stream), which
must equal the CPU's.
Every test needs an NVIDIA GPU and skips without one.  This file imports
no JAX, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from gymfx_tpu_torch.core.types import EnvConfig, initial_state
from gymfx_tpu_torch.lob.book import empty_book
from gymfx_tpu_torch.lob.scenarios import scenario_flow_params
from gymfx_tpu_torch.ops import (
    cases,
    env_dynamics,
    fused_attention,
    lob_bar,
    lob_flow,
    lob_match,
    tape_decode,
    window_zscore,
)
from gymfx_tpu_torch.ops.cases import (
    FLAG_GRID,
    K1_EDGE_SHAPES,
    K2_EDGE_FLAGS,
    K2_EDGE_SIZES,
    MARK_PARAMS,
    PARAM_SETS,
    REWARDS,
    env_params,
    flag_config,
    ledger_case,
    ledger_state,
    obs_case,
)

N = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# K1 at the test's own (64, 8, 3), its edge shapes (cases.K1_EDGE_SHAPES),
# windows whose data pointer is 4 or 8 bytes off 16-byte alignment (a
# slice of a larger buffer) and F = 5 rows that fill no whole row group:
# both of the kernel's paths (ops/window_zscore.py)
K1_CASES = [((N, 8, 3), 0)] + [(shape, 0) for shape in K1_EDGE_SHAPES] + [
    ((63, 9, 3), 1), ((8192, 32, 5), 1), ((64, 8, 3), 2), ((63, 30, 5), 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset", K1_CASES, ids=str)
@pytest.mark.parametrize("mask,clip", [((), 10.0), ((False, True, False), 1.5), ((), 0.0)])
def test_cuda_step_obs_equals_plain(cuda_device, mask, clip, shape, offset):
    n, w, f = shape
    mask = tuple(mask[k % len(mask)] for k in range(f)) if mask else ()
    win, mean, std, neutral = (torch.from_numpy(x).to(cuda_device) for x in obs_case(0, n, w, f))
    if offset:
        buf = torch.empty(win.numel() + 4, device=cuda_device)
        win = buf[offset:offset + win.numel()].view(n, w, f).copy_(win)
        assert win.data_ptr() % 16 == 4 * offset
    before = window_zscore.step_obs.launches
    ours = window_zscore.step_obs(win, mean, std, neutral, binary_mask=mask, clip=clip)
    ref = window_zscore.scale_feature_window(win, mean, std, neutral, mask, clip)
    assert window_zscore.step_obs.launches == before + 1
    assert torch.equal(ours, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", FLAG_GRID, ids=lambda f: "-".join(map(str, f)))
def test_cuda_fill_brackets_and_mark_reward_equal_plain(cuda_device, flags):
    i = FLAG_GRID.index(flags)
    cfg = flag_config(flags, REWARDS[i % 2])
    params = env_params({**PARAM_SETS[sorted(PARAM_SETS)[i % 2]], **MARK_PARAMS}, cuda_device)
    fields, mark, bars, advance, rng = ledger_case(i, n=N)
    st = ledger_state(cfg, {**fields, **mark}, cuda_device)
    o, h, l, c, acc = (torch.from_numpy(bars[k]).to(cuda_device)
                       for k in ("o", "h", "l", "c", "accrual"))
    acc = acc if cfg.financing_enabled else None
    adv = torch.from_numpy(advance).to(cuda_device)
    ref = env_dynamics.fill_brackets_plain(st, o, h, l, c, acc, adv, cfg, params)
    # the kernel advances its counter block in place: give it its own
    ours = env_dynamics.fill_brackets(st._replace(exec_diag=st.exec_diag.clone()),
                                      o, h, l, c, acc, adv, cfg, params)
    for name in ref._fields:
        assert torch.equal(getattr(ours, name), getattr(ref, name)), name
    mark_pred = torch.from_numpy(rng.random(N) < 0.7).to(cuda_device)
    live = torch.from_numpy(rng.random(N) < 0.8).to(cuda_device)
    ours_st, ours_r = env_dynamics.mark_reward(st, c, mark_pred, live, cfg, params)
    ref_st, ref_r = env_dynamics.mark_reward_plain(st, c, mark_pred, live, cfg, params)
    assert torch.equal(ours_r, ref_r)
    for name in env_dynamics.MARK_OUT_FIELDS:
        assert torch.equal(getattr(ours_st, name), getattr(ref_st, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("flags", K2_EDGE_FLAGS, ids=lambda f: "-".join(map(str, f)))
@pytest.mark.parametrize("n", K2_EDGE_SIZES)
def test_cuda_fill_brackets_equals_plain_at_edge_sizes(cuda_device, n, flags):
    cfg = flag_config(flags)
    params = env_params(PARAM_SETS["quantized"], cuda_device)
    fields, mark, bars, advance, _ = ledger_case(n, n=n)
    st = ledger_state(cfg, {**fields, **mark}, cuda_device)
    o, h, l, c, acc = (torch.from_numpy(bars[k]).to(cuda_device)
                       for k in ("o", "h", "l", "c", "accrual"))
    acc = acc if cfg.financing_enabled else None
    adv = torch.from_numpy(advance).to(cuda_device)
    ref = env_dynamics.fill_brackets_plain(st, o, h, l, c, acc, adv, cfg, params)
    before = env_dynamics.fill_brackets.launches
    ours = env_dynamics.fill_brackets(st._replace(exec_diag=st.exec_diag.clone()),
                                      o, h, l, c, acc, adv, cfg, params)
    assert env_dynamics.fill_brackets.launches == before + 1
    for name in ref._fields:
        assert torch.equal(getattr(ours, name), getattr(ref, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("mark_kind,live_kind", cases.K3_FLAG_PATTERNS, ids="-".join)
@pytest.mark.parametrize("reward", REWARDS)
@pytest.mark.parametrize("n", K2_EDGE_SIZES)
def test_cuda_mark_reward_equals_plain_at_edge_sizes(cuda_device, n, reward, mark_kind, live_kind):
    cfg = flag_config(FLAG_GRID[0], reward)
    params = env_params({**PARAM_SETS["plain"], **MARK_PARAMS}, cuda_device)
    fields, mark, bars, _, rng = ledger_case(n + 1, n=n)
    st = ledger_state(cfg, {**fields, **mark}, cuda_device)
    c = torch.from_numpy(bars["c"]).to(cuda_device)
    mark_pred, live = (torch.from_numpy(cases.flag_pattern(kind, n, rng)).to(cuda_device)
                       for kind in (mark_kind, live_kind))
    before = env_dynamics.mark_reward.launches
    ours_st, ours_r = env_dynamics.mark_reward(st, c, mark_pred, live, cfg, params)
    assert env_dynamics.mark_reward.launches == before + 1
    ref_st, ref_r = env_dynamics.mark_reward_plain(st, c, mark_pred, live, cfg, params)
    assert torch.equal(ours_r, ref_r)
    for name in env_dynamics.MARK_OUT_FIELDS:
        assert torch.equal(getattr(ours_st, name), getattr(ref_st, name)), name


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_cannot_take(cuda_device):
    win, mean, std, neutral = (torch.from_numpy(x).to(cuda_device) for x in obs_case(n=N))
    with pytest.raises(ValueError, match="win"):
        window_zscore.step_obs(win.double(), mean, std, neutral)
    with pytest.raises(ValueError, match="contiguous"):
        window_zscore.step_obs(win.transpose(1, 2).contiguous().transpose(1, 2), mean, std, neutral)
    cfg64 = EnvConfig(dtype=torch.float64, window_size=8)
    st = initial_state(cfg64, N, cuda_device)
    z = torch.zeros(N, dtype=torch.float64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        env_dynamics.fill_brackets(st, z, z, z, z, None, z > 0, cfg64,
                                   env_params({}, cuda_device))


def _attention_tol(ref):
    scale = 2.0 ** -6 if ref.dtype == torch.bfloat16 else 1e-4
    return scale * float(ref.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal", [
    ((64, 256, 4, 32), torch.bfloat16, False),
    ((3, 200, 4, 32), torch.float32, True),
    ((2, 1024, 2, 64), torch.bfloat16, True),
    ((2, 77, 3, 128), torch.float32, False),
    ((5, 50, 2, 16), torch.bfloat16, True),
])
def test_cuda_attention_forward_and_backward_within_tolerance_of_plain(cuda_device, shape, dtype, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, g = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype) for _ in range(4))
    before = (fused_attention.attention_forward.launches, fused_attention.attention_backward.launches)
    out = fused_attention.attention_forward(q, k, v, causal)
    ref = fused_attention.attention_forward_plain(q, k, v, causal)
    assert out.dtype == dtype and out.shape == shape
    assert float((out.float() - ref.float()).abs().max()) <= _attention_tol(ref)
    grads = fused_attention.attention_backward(q, k, v, g, causal)
    for ours, plain in zip(grads, fused_attention.attention_backward_plain(q, k, v, g, causal)):
        assert ours.dtype == dtype
        assert float((ours.float() - plain.float()).abs().max()) <= _attention_tol(plain)
    assert (fused_attention.attention_forward.launches,
            fused_attention.attention_backward.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_attention_reads_strided_inputs_and_rejects_what_it_cannot_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    base = torch.randn((4, 3, 64, 16), generator=gen, device=cuda_device)
    q = base.transpose(1, 2)  # (B, S, H, D) view with the head axis outermost
    assert not q.is_contiguous()
    out = fused_attention.fused_window_attention(q, q, q)
    ref = fused_attention.attention_forward_plain(q, q, q)
    assert float((out - ref).abs().max()) <= _attention_tol(ref)
    with pytest.raises(NotImplementedError):
        fused_attention.attention_forward(q.double(), q.double(), q.double())
    wide = torch.zeros((1, 8, 1, 129), device=cuda_device)
    with pytest.raises(NotImplementedError):
        fused_attention.attention_forward(wide, wide, wide)


def _bits(x):
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", cases.ATTENTION_BF16_CASES,
                         ids=lambda x: "x".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_cuda_bf16_attention_within_tolerance_of_plain_and_emulation(cuda_device, shape, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v, g = (torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
                  for _ in range(4))
    out = fused_attention.attention_forward(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and out.shape == shape
    ref = fused_attention.attention_forward_plain(q, k, v, causal)
    assert float((out.float() - ref.float()).abs().max()) <= _attention_tol(ref)
    emu = cases.attention_forward_emulated(q, k, v, causal)
    assert float((out.float() - emu.float()).abs().max()) <= 2.0 ** -7 * float(emu.float().abs().max())
    grads = fused_attention.attention_backward(q, k, v, g, causal)
    plain = fused_attention.attention_backward_plain(q, k, v, g, causal)
    emulated = cases.attention_backward_emulated(q, k, v, g, causal)
    for name, ours, p, e in zip("qkv", grads, plain, emulated):
        assert ours.dtype == torch.bfloat16 and ours.shape == shape
        assert float((ours.float() - p.float()).abs().max()) <= _attention_tol(p), f"d{name}"
        assert (float((ours.float() - e.float()).abs().max())
                <= 2.0 ** -7 * float(e.float().abs().max())), f"d{name} vs emulation"


@pytest.mark.cuda
def test_cuda_bf16_attention_reads_transposed_and_strided_views(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    base = torch.randn((4, 3, 96, 32), generator=gen, device=cuda_device).to(torch.bfloat16)
    heads_outer = base.transpose(1, 2)  # (B, S, H, D), read in place
    dims_outer = base.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)  # last stride != 1
    # a head dim the wrapper pads, on (B, H, D, S) storage (d stride S):
    # the padded copy must reach the kernels with a unit d stride
    padded_dims_outer = base[..., :24].permute(0, 1, 3, 2).contiguous().permute(0, 3, 1, 2)
    for x in (heads_outer, dims_outer, padded_dims_outer):
        assert not x.is_contiguous()
        g = torch.randn(x.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
        out = fused_attention.fused_window_attention(x, x, x, causal=True)
        ref = fused_attention.attention_forward_plain(x, x, x, True)
        emu = cases.attention_forward_emulated(x, x, x, True)
        assert float((out.float() - ref.float()).abs().max()) <= _attention_tol(ref)
        assert float((out.float() - emu.float()).abs().max()) <= 2.0 ** -7 * float(emu.float().abs().max())
        for ours, plain in zip(fused_attention.attention_backward(x, x, x, g, True),
                               fused_attention.attention_backward_plain(x, x, x, g, True)):
            assert float((ours.float() - plain.float()).abs().max()) <= _attention_tol(plain)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((64, 256, 4, 32), False), ((3, 77, 2, 24), True)])
def test_cuda_bf16_attention_backward_is_deterministic(cuda_device, shape, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, g = (torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
                  for _ in range(4))
    first = fused_attention.attention_backward(q, k, v, g, causal)
    second = fused_attention.attention_backward(q, k, v, g, causal)
    for a, b in zip(first, second):
        assert torch.equal(_bits(a), _bits(b))


def _lob_equal(msgs, depth, slots, device):
    msgs = type(msgs)(*(x.to(device) for x in msgs))
    book = empty_book(msgs.kind.shape[0], depth, slots, device)
    before = lob_match.process_stream.launches
    ours = lob_match.process_stream(book, msgs)
    ref = lob_match.process_stream_plain(book, msgs)
    assert lob_match.process_stream.launches == before + 1
    for a, b in zip((*ours[0], *ours[1]), (*ref[0], *ref[1])):
        assert torch.equal(a, b)
    return ours


@pytest.mark.cuda
@pytest.mark.parametrize("depth,slots", [(8, 4), (16, 4), (24, 4), (48, 4), (64, 8), (33, 1)])
@pytest.mark.parametrize("scenario", cases.LOB_SCENARIOS)
def test_cuda_lob_stream_equals_plain_on_flow(cuda_device, scenario, depth, slots):
    _lob_equal(cases.lob_flow_streams(scenario, n_books=37, n_msgs=96), depth, slots, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(cases.LOB_STREAMS))
def test_cuda_lob_stream_equals_plain_on_hand_built_streams(cuda_device, name):
    msgs, depth, slots = cases.lob_stream(name)
    ours = _lob_equal(msgs, depth, slots, cuda_device)
    if name == "agent_maker":
        assert int(ours[1].agent_qty.sum()) == 4


@pytest.mark.cuda
def test_cuda_lob_stream_equals_plain_on_seed_streams(cuda_device):
    _lob_equal(cases.lob_seed_streams(n_books=1000), 24, 4, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 16, 24, 48])
def test_cuda_lob_stream_equals_plain_at_bench_lob_shape(cuda_device, depth):
    # bench.py --lob: 1,024 books x 256 lob_calm messages
    ours = _lob_equal(cases.lob_flow_streams("lob_calm", n_books=1024, n_msgs=256), depth, 4,
                      cuda_device)
    assert int(ours[1].fill_events.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("slots", range(1, 9))
@pytest.mark.parametrize("levels_per_lane", [1, 2])
def test_cuda_lob_stream_launches_every_instantiation(cuda_device, levels_per_lane, slots):
    # one (levels a lane, slots) template each: depth 1-32 -> 1, 33-64 -> 2
    depth = 29 if levels_per_lane == 1 else 61
    _lob_equal(cases.lob_flow_streams("lob_volatile", n_books=5, n_msgs=70), depth, slots,
               cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,slots", [(4, 3), (2, 2), (33, 1), (40, 8)])
def test_cuda_lob_stream_equals_plain_where_int32_sums_wrap(cuda_device, depth, slots):
    _lob_equal(cases.lob_wrap_streams(64, 80, seed=depth), depth, slots, cuda_device)


@pytest.mark.cuda
def test_cuda_lob_stream_rejects_what_it_cannot_take(cuda_device):
    msgs = cases.lob_flow_streams("lob_calm", n_books=2, n_msgs=8, device=cuda_device)
    with pytest.raises(NotImplementedError, match="depth"):
        lob_match.process_stream(empty_book(2, 65, 4, cuda_device), msgs)
    with pytest.raises(NotImplementedError, match="slots"):
        lob_match.process_stream(empty_book(2, 8, 9, cuda_device), msgs)
    with pytest.raises(ValueError, match="msgs.kind"):
        lob_match.process_stream(empty_book(2, 8, 4, cuda_device),
                                 msgs._replace(kind=msgs.kind.to(torch.int64)))


def _bar_equal(case, device):
    book, flow, orders = (type(x)(*(t.to(device) for t in x)) for x in case[:3])
    before = lob_bar.run_bar.launches
    ours = lob_bar.run_bar(book, flow, orders)
    ref = lob_bar.run_bar_plain(book, flow, orders)
    assert lob_bar.run_bar.launches == before + 1
    for a, b in zip((*ours[0], *ours[1]), (*ref[0], *ref[1])):
        assert torch.equal(a, b)
    return ours


@pytest.mark.cuda
@pytest.mark.parametrize("slots", range(1, 9))
@pytest.mark.parametrize("levels_per_lane", [1, 2])
def test_cuda_lob_bar_equals_plain_at_every_instantiation(cuda_device, levels_per_lane, slots):
    # K8: one (levels a lane, slots) template each, every path of
    # cases.LOB_BAR_PATHS on lob_volatile bars
    depth = 29 if levels_per_lane == 1 else 61
    _bar_equal(cases.lob_bar_case(44, depth=depth, slots=slots, n_msgs=70, seed=slots),
               cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("scenario", cases.LOB_SCENARIOS)
@pytest.mark.parametrize("depth", [8, 24, 48])
def test_cuda_lob_bar_equals_plain_on_venue_bars(cuda_device, depth, scenario):
    ours = _bar_equal(cases.lob_bar_case(300, depth=depth, slots=4, n_msgs=64, seed=depth,
                                         scenario=scenario), cuda_device)
    assert int(ours[1].fired.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("depth,slots", [(4, 3), (2, 2), (6, 2), (33, 1), (40, 8)])
def test_cuda_lob_bar_equals_plain_where_int32_sums_wrap(cuda_device, depth, slots):
    _bar_equal(cases.lob_bar_wrap_case(64, 40, depth, slots, seed=depth), cuda_device)


@pytest.mark.cuda
def test_cuda_lob_bar_rejects_what_it_cannot_take(cuda_device):
    book, flow, orders, _ = cases.lob_bar_case(4, depth=8, slots=4, n_msgs=8, device=cuda_device)
    for depth, slots, match in ((65, 4, "depth"), (8, 9, "slots")):
        with pytest.raises(NotImplementedError, match=match):
            lob_bar.run_bar(empty_book(4, depth, slots, cuda_device), flow, orders)
    with pytest.raises(ValueError, match="flow.qty"):
        lob_bar.run_bar(book, flow._replace(qty=flow.qty.to(torch.int64)), orders)
    with pytest.raises(ValueError, match="orders.stop"):
        lob_bar.run_bar(book, flow, orders._replace(stop=orders.stop[:3]))


def _flow_equal(n, n_msgs, scenario, rows, device, seed=0):
    bars = cases.lob_flow_bars(n, rows, seed=seed, device=device)
    fp = scenario_flow_params(scenario)
    before = lob_flow.bar_flow.launches
    ours = lob_flow.bar_flow(5, *bars, n_msgs, fp)
    ref = lob_flow.bar_flow_plain(5, *bars, n_msgs, fp)
    assert lob_flow.bar_flow.launches == before + 1
    for name, a, b in zip(ref._fields, ours, ref):
        assert torch.equal(a, b), name
    return ours


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_msgs,rows", [(8192, 64, "int32"), (8192, 64, "int64"),
                                           (13, 17, "int64"), (37, 70, "int32"), (1, 1, "int32"),
                                           (4099, 33, "int64")])
@pytest.mark.parametrize("scenario", cases.LOB_SCENARIOS)
def test_cuda_bar_flow_equals_plain(cuda_device, scenario, n, n_msgs, rows):
    ours = _flow_equal(n, n_msgs, scenario, rows, cuda_device, seed=n_msgs)
    if scenario == "lob_flash_crash" and n_msgs == 64:
        assert bool((ours.kind[:, 24:32] == 3).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(cases.FLOW_ONE_KIND))
def test_cuda_bar_flow_equals_plain_on_one_kind(cuda_device, kind):
    fp = scenario_flow_params("lob_volatile")._replace(**cases.FLOW_ONE_KIND[kind])
    bars = cases.lob_flow_bars(4099, "int64", seed=2, device=cuda_device)
    ours = lob_flow.bar_flow(5, *bars, 70, fp)
    for name, a, b in zip(ours._fields, ours, lob_flow.bar_flow_plain(5, *bars, 70, fp)):
        assert torch.equal(a, b), f"{kind} {name}"
    assert bool((ours.kind == list(cases.FLOW_ONE_KIND).index(kind)).all())


@pytest.mark.cuda
def test_cuda_bar_flow_replays_from_a_cuda_graph(cuda_device):
    fp = scenario_flow_params("lob_volatile")
    bars = [x.clone() for x in cases.lob_flow_bars(512, "int32", seed=1, device=cuda_device)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        lob_flow.bar_flow(9, *bars, 64, fp)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = lob_flow.bar_flow.launches
    with torch.cuda.graph(graph):
        out = lob_flow.bar_flow(9, *bars, 64, fp)
    assert lob_flow.bar_flow.launches == before + 1
    for step in range(3):  # new bars in the captured inputs each replay
        for x, y in zip(bars, cases.lob_flow_bars(512, "int32", seed=10 + step,
                                                 device=cuda_device)):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, lob_flow.bar_flow_plain(9, *bars, 64, fp)):
            assert torch.equal(a, b)
    assert lob_flow.bar_flow.launches == before + 1


@pytest.mark.cuda
def test_cuda_bar_flow_rejects_what_it_cannot_take(cuda_device):
    t, o, h, l, c = cases.lob_flow_bars(8, "int32", device=cuda_device)
    fp = scenario_flow_params("lob_calm")
    with pytest.raises(ValueError, match="h_t"):
        lob_flow.bar_flow(0, t, o, h.to(torch.int64), l, c, 8, fp)
    with pytest.raises(ValueError, match="t_global"):
        lob_flow.bar_flow(0, t[:4], o, h, l, c, 8, fp)
    with pytest.raises(ValueError, match="c_t"):
        lob_flow.bar_flow(0, t, o, h, l, torch.stack([c, c], 1)[:, 0], 8, fp)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1003, 1024, 257, 1, 262176])
def test_cuda_q16_decode_equals_plain(cuda_device, rows):
    delta, base, inv = (torch.from_numpy(x).to(cuda_device)
                        for x in cases.q16_case(seed=rows, rows=rows))
    before = tape_decode.decode_q16_block.launches
    ours = tape_decode.decode_q16_block(delta, base, inv)
    assert tape_decode.decode_q16_block.launches == before + 1
    assert torch.equal(ours, tape_decode.decode_q16_plain(delta, base, inv))
    # a block starting 2 bytes past an aligned address takes the scalar path
    flat = torch.empty(delta.numel() + 1, dtype=torch.int16, device=cuda_device)
    odd = flat[1:].view(delta.shape)
    odd.copy_(delta)
    assert odd.is_contiguous() and odd.data_ptr() % 16 != 0
    assert torch.equal(tape_decode.decode_q16_block(odd, base, inv),
                       tape_decode.decode_q16_plain(odd, base, inv))


# K7: the seeded cases, then F 1, 3, 5, 7 at W 8, 32, 64 (ops/cases.py)
K7_CASES = [(0, 8, 3), (1, 32, 5), (2, 16, 1)] + [
    (10 + i, w, f) for i, (w, f) in enumerate((w, f) for w in (8, 32, 64) for f in (1, 3, 5, 7))]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "4_bytes_off"])
@pytest.mark.parametrize("steps", cases.K7_STEP_PATTERNS)
@pytest.mark.parametrize("clip", [10.0, 0.0, 1.5])
@pytest.mark.parametrize("seed,window,f", K7_CASES)
def test_cuda_scaled_windows_equals_plain(cuda_device, seed, window, f, clip, steps, offset):
    # steps: random in [0, n]; the export's 1..n (300 steps: a ragged last
    # tile); clamped below 0 and above n.  offset: padded_features a view
    # 4 bytes past a 16-byte boundary
    args = [torch.from_numpy(x).to(cuda_device)
            for x in cases.scaled_windows_case(seed, window=window, f=f, steps=steps)]
    if offset:
        buf = torch.empty(args[0].numel() + 4, device=cuda_device)
        args[0] = buf[offset:offset + args[0].numel()].view(args[0].shape).copy_(args[0])
        assert args[0].data_ptr() % 16 == 4 * offset
    before = window_zscore.batched_scaled_windows.launches
    ours = window_zscore.batched_scaled_windows(*args, window=window, clip=clip)
    assert window_zscore.batched_scaled_windows.launches == before + 1
    ref = window_zscore.reference_scaled_windows(*args, window=window, clip=clip)
    assert torch.equal(ours.isnan(), ref.isnan())
    assert torch.equal(torch.nan_to_num(ours), torch.nan_to_num(ref))


# K7 at a batch whose tiles outnumber twice the CTAs of the persistent
# grid, so that every CTA walks at least two tiles through both buffers
K7_MANY_TILES = 600_000


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "4_bytes_off"])
@pytest.mark.parametrize("steps", ["export", "turns"])
@pytest.mark.parametrize("f", [3, 5])
def test_cuda_scaled_windows_equals_plain_when_each_cta_walks_several_tiles(cuda_device, f, steps,
                                                                            offset):
    # steps: the export's 1..n (every tile staged, the last one ragged), or
    # turns alternating staged tiles and tiles of scattered and clamped
    # steps (cases.scaled_windows_turn_steps); offset: the span's lead
    # changes from tile to tile
    n = K7_MANY_TILES
    args = [torch.from_numpy(x).to(cuda_device)
            for x in cases.scaled_windows_case(f, n=n, window=32, f=f, steps="export")]
    geometry = window_zscore._scaled_windows_plan(n, 32, f, args[0].shape[0], args[1].shape[0],
                                                  10.0, cuda_device)
    grid, tile, tiles = geometry[0], geometry[1], geometry[2]
    assert tiles >= 2 * grid and n % tile
    if steps == "turns":
        args[4] = torch.from_numpy(cases.scaled_windows_turn_steps(n, tile, grid, seed=f)).to(
            cuda_device)
    if offset:
        buf = torch.empty(args[0].numel() + 4, device=cuda_device)
        args[0] = buf[offset:offset + args[0].numel()].view(args[0].shape).copy_(args[0])
    ours = window_zscore.batched_scaled_windows(*args, window=32, clip=10.0)
    ref = window_zscore.reference_scaled_windows(*args, window=32, clip=10.0)
    assert torch.equal(ours.isnan(), ref.isnan())
    assert torch.equal(torch.nan_to_num(ours), torch.nan_to_num(ref))


@pytest.mark.cuda
def test_cuda_data_wrappers_reject_what_the_kernels_cannot_take(cuda_device):
    delta, base, inv = (torch.from_numpy(x).to(cuda_device) for x in cases.q16_case(rows=64))
    with pytest.raises(ValueError, match="delta"):
        tape_decode.decode_q16_block(delta.to(torch.int32), base, inv)
    with pytest.raises(ValueError, match="inv"):
        tape_decode.decode_q16_block(delta, base, inv.double())
    args = [torch.from_numpy(x).to(cuda_device) for x in cases.scaled_windows_case()]
    with pytest.raises(ValueError, match="steps"):
        window_zscore.batched_scaled_windows(*args[:4], args[4].long(), window=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        window_zscore.batched_scaled_windows(*args, window=12)


def _tick_csv(tmp_path, n):
    path = tmp_path / "tape.csv"
    cases.write_bar_csv(path, cases.tick_walk_columns(n, seed=7), cases.m1_week_grid(n))
    return str(path)


@pytest.mark.cuda
def test_cuda_compressed_tape_decodes_to_the_f32_build(cuda_device, tmp_path):
    from gymfx_tpu_torch.config import DEFAULT_VALUES
    from gymfx_tpu_torch.data import compress
    from gymfx_tpu_torch.data.feed import load_market_dataset

    config = dict(DEFAULT_VALUES, input_data_file=_tick_csv(tmp_path, 3 * 7200), timeframe="M1")
    kw = dict(window_size=32, feature_columns=["OPEN", "HIGH", "LOW", "CLOSE", "VOLUME"])
    dataset = load_market_dataset(config)
    host = dataset.build_market_data(device=None, **kw)
    tape = compress.device_tape(compress.encode_tape(host, window_size=32, tick_size=1e-5),
                                cuda_device)
    groups = len(compress._q16_groups(tape.columns, [s.shape[1] for s in tape.slabs]))
    before = tape_decode.decode_q16_block.launches
    decoded = compress.make_shard_decoder(tape, "on")(compress.shard_arrays(tape, 0))
    assert tape_decode.decode_q16_block.launches == before + groups
    direct = dataset.build_market_data(device=cuda_device, **kw)
    for name in direct._fields:
        if name != "row0":
            assert torch.equal(getattr(direct, name), getattr(decoded, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("mode,budget", [("off", 0.1), ("on", 0.2), ("on", 0.4)])
def test_cuda_streamed_episode_equals_resident_and_cpu(cuda_device, tmp_path, mode, budget):
    from gymfx_tpu_torch.config import DEFAULT_VALUES
    from gymfx_tpu_torch.core.rollout import buy_hold_driver
    from gymfx_tpu_torch.core.runtime import Environment

    config = dict(DEFAULT_VALUES, input_data_file=_tick_csv(tmp_path, 4000), timeframe="M1",
                  window_size=32, feature_columns=["CLOSE", "VOLUME"])
    streamed_config = dict(config, stream_hbm_budget_mb=budget, data_compress=mode)
    env = Environment(streamed_config)
    # 373-bar shards; 68-bar compressed shards streamed from pinned
    # memory (the ring holds 51 of 59); 170-bar shards, tape resident
    assert env.streaming and env.streamer.num_shards >= 11
    assert env.streamer.tape_resident == (budget == 0.4)
    steps = 1200
    _, out = env.rollout(buy_hold_driver(), steps)
    _, ref = Environment(config).rollout(buy_hold_driver(), steps)
    _, cpu = Environment(streamed_config, device="cpu").rollout(buy_hold_driver(), steps)
    for key in ref:
        assert torch.equal(out[key], ref[key]), key
        assert torch.equal(out[key].cpu(), cpu[key]), key


# ---- the train step's CUDA graphs (train/ppo.py, core/graphs.py) ------------
# Graphed phases against the same phases op by op (_rollout_phase_eager,
# _update_phase_eager) from one state and generator state: torch.equal on
# every output and on the generator's state after (the same kernels in the
# same order draw the same numbers).
REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
GRAPH_KINDS = ["mlp", "transformer_ring", "curriculum", "lob"]


def _graph_trainer(kind, tmp_path, **over):
    from gymfx_tpu_torch.config import flagship
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.train.ppo import PPOTrainer, ppo_config_from

    csv = str(REPO / "examples" / "data" / "eurusd_sample.csv")
    small = dict(num_envs=64, ppo_horizon=8, policy_kwargs={"hidden": [32, 32, 32]})
    if kind == "mlp":
        config = flagship.flagship_config(csv, **small)
    elif kind == "transformer_ring":
        config = flagship.long_context_config(
            csv, num_envs=16, ppo_horizon=8, window_size=32,
            policy_kwargs={"d_model": 32, "n_heads": 2, "n_layers": 2})
    elif kind == "lob":
        config = flagship.lob_config(csv, lob_messages_per_bar=16, **small)
    else:
        paths = []
        for i in range(2):
            path = tmp_path / f"tape{i}.csv"
            cases.write_bar_csv(path, cases.tick_walk_columns(600, seed=30 + i),
                                cases.m1_week_grid(600))
            paths.append(f"file:{path}")
        config = flagship.curriculum_config(",".join(paths), timeframe="M1", **small)
    config.update(over)
    return PPOTrainer(Environment(config), ppo_config_from(config))


def _tape(trainer):
    return None if trainer.curriculum is None else trainer.curriculum._tape_data(1)


def _copy(state):
    from gymfx_tpu_torch.core import graphs

    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return type(state)(*graphs.clone_tree(tuple(state[:4])), gen)


def _assert_equal(a, b, what):
    from gymfx_tpu_torch.resilience.guards import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{what}: leaf {i}"


def _assert_states_equal(a, b, what):
    _assert_equal(tuple(a[:4]), tuple(b[:4]), what)
    assert torch.equal(a.generator.get_state(), b.generator.get_state()), f"{what}: generator"


def _eager_step(trainer, state, data):
    return trainer._update_phase_eager(*trainer._rollout_phase_eager(state, data), data)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_cuda_graphed_phases_and_train_many_equal_eager(cuda_device, tmp_path, kind):
    trainer = _graph_trainer(kind, tmp_path)
    data = _tape(trainer)
    s0 = trainer.init_state(3)
    a, (ta, la) = trainer.rollout_phase(_copy(s0), data)
    b, (tb, lb) = trainer._rollout_phase_eager(_copy(s0), data)
    assert [k for k, *_ in trainer._graphs] == ["rollout"]
    _assert_equal((ta, la), (tb, lb), "rollout trajectory")
    _assert_states_equal(a, b, "rollout state")
    ua, ma = trainer.update_phase(a, (ta, la), data)
    ub, mb = trainer._update_phase_eager(b, (tb, lb), data)
    _assert_states_equal(ua, ub, "update state")
    _assert_equal(ma, mb, "update metrics")
    assert float(ma["nonfinite_skips"]) == 0.0
    many, stacked = trainer.train_many_with_data(_copy(ub), data, 3)
    ref, history = _copy(ub), []
    for _ in range(3):
        ref, metrics = _eager_step(trainer, ref, data)
        history.append(metrics)
    _assert_states_equal(many, ref, "train_many state")
    _assert_equal(stacked, {k: torch.stack([m[k] for m in history]) for k in stacked},
                  "train_many metrics")
    assert all(g.graph is not None for g in trainer._graphs.values())


@pytest.mark.cuda
def test_cuda_returned_phases_outlive_the_next_replay(cuda_device, tmp_path):
    trainer = _graph_trainer("mlp", tmp_path)
    first, (traj, last) = trainer.rollout_phase(trainer.init_state(1))
    kept = _copy(first), {k: v.clone() for k, v in traj.items()}, last.clone()
    trainer.rollout_phase(trainer.init_state(2))
    _assert_equal((first[:4], traj, last), (kept[0][:4], kept[1], kept[2]), "first phase")


@pytest.mark.cuda
def test_cuda_graphs_recapture_when_the_shape_or_the_config_changes(cuda_device, tmp_path):
    trainer = _graph_trainer("mlp", tmp_path)
    s0 = trainer.init_state(0)
    trainer.train_step(_copy(s0))
    trainer.train_step(_copy(s0))
    assert len(trainer._graphs) == 2  # captured once, replayed
    for pcfg in (trainer.pcfg._replace(clip_eps=0.1, ent_coef=0.05),
                 trainer.pcfg._replace(n_envs=32, horizon=4)):
        trainer.pcfg = pcfg
        s = trainer.init_state(0)
        ours, metrics = trainer.train_step(_copy(s))
        ref, ref_metrics = _eager_step(trainer, _copy(s), None)
        _assert_states_equal(ours, ref, f"after {pcfg}")
        _assert_equal(metrics, ref_metrics, f"metrics after {pcfg}")
        assert tuple(ours.obs_vec.shape)[0] == pcfg.n_envs
    assert len(trainer._graphs) == 6


@pytest.mark.cuda
def test_cuda_graphs_replay_for_a_state_with_another_generator(cuda_device, tmp_path):
    trainer = _graph_trainer("curriculum", tmp_path)
    data = _tape(trainer)
    states = [trainer.init_state(seed) for seed in (1, 2, 1)]
    for i, s in enumerate(states):
        ours, metrics = trainer.train_step(_copy(s), data)
        ours = _copy(ours)
        ref, ref_metrics = _eager_step(trainer, _copy(s), data)
        _assert_states_equal(ours, ref, f"state {i}")
        _assert_equal(metrics, ref_metrics, f"metrics {i}")
    assert len(trainer._graphs) == 2


@pytest.mark.cuda
def test_cuda_graphs_take_the_test_hooks(cuda_device, tmp_path):
    trainer = _graph_trainer("curriculum", tmp_path)
    data, pcfg = _tape(trainer), trainer.pcfg
    g = torch.Generator().manual_seed(5)
    actions = torch.randint(0, 3, (pcfg.horizon, pcfg.n_envs), generator=g, dtype=torch.int32)
    offsets = torch.randint(0, trainer.env.cfg.n_bars - 2, (pcfg.n_envs,), generator=g)
    perms = torch.stack([torch.randperm(pcfg.n_envs, generator=g) for _ in range(pcfg.epochs)])
    s0 = trainer.init_state(4)
    hooks = dict(actions=actions, start_offsets=offsets)
    a, ra = trainer.rollout_phase(_copy(s0), data, **hooks)
    b, rb = trainer._rollout_phase_eager(_copy(s0), data, **hooks)
    _assert_equal(ra, rb, "hooked rollout")
    _assert_states_equal(a, b, "hooked rollout state")
    assert torch.equal(ra[0]["action"].cpu(), actions)
    ua, ma = trainer.update_phase(a, ra, data, permutations=perms)
    ub, mb = trainer._update_phase_eager(b, rb, data, permutations=perms)
    _assert_states_equal(ua, ub, "hooked update state")
    _assert_equal(ma, mb, "hooked update metrics")
    assert sorted(k for k, *_ in trainer._graphs) == ["rollout", "update"]


@pytest.mark.cuda
def test_cuda_capture_error_raises_without_an_eager_retry(cuda_device, tmp_path):
    from gymfx_tpu_torch.core import graphs

    with pytest.raises(RuntimeError):
        graphs.PhaseGraph(lambda x: {"y": x["a"] * x["a"].sum().item()},
                          {"a": torch.ones(4, device=cuda_device)})
    trainer = _graph_trainer("mlp", tmp_path)
    encode, calls = trainer._encode, []

    def syncing(obs):
        calls.append(1)
        out = encode(obs)
        out.sum().item()  # a host sync: legal eagerly, refused under capture
        return out

    trainer._encode = syncing
    with pytest.raises(RuntimeError):
        trainer.train_step(trainer.init_state(0))
    # the warm-ups' steps and the capture's first, then nothing: no retry
    assert len(calls) == graphs.WARMUP * trainer.pcfg.horizon + 1
    assert not trainer._graphs
    assert float(torch.ones(2, device=cuda_device).sum()) == 2.0
