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
bits.  The f32 window kernels (S <= 64, ops/cases.ATTENTION_F32_WINDOW_CASES:
the ring twin's (4096, 32, 4, 32) and (256, 32, 4, 32), ragged windows,
every instantiated head dim, causal and not, strided views read in place
and copied) within 1e-4 x max|plain|, within F32_EMULATION_TOL x
max|emulation| of the emulation of their sums in order (only expf's last
ulps differ), and their backward bitwise over two calls; so is the
streamed f32 kernels' backward.  K3 also at N = 1, 63 and 8,193 with both rewards and mark_pred and
live all true, all false and mixed, and its sharpe path at N = 1, 63,
4,096 and 8,193 with rings of 2 and 64 slots, stepped on its own outputs
across a ring wrap.  The train step's graphs (PPO on every configuration,
with the LSTM and on the sharpe reward; IMPALA's two phases) equal the
eager phases.  K5 (LOB stream
matching) is int32: books and fill records ``torch.equal``; so is K8
(one bar of the LOB venue): final books and results, at every template,
on the venue's bars and where lot sums wrap int32; and K9 (a bar's flow
messages: threefry words and a float32 path, -fmad=false) for every
scenario at the venue's shape and at odd ones, and replayed from a CUDA
graph, and its flag route (each env's parameter set by its bar's drought
and crash bits) at the venue's shape and odd ones; K10 (the scenario
generator's scan: float32 with -fmad=false and the math library's
``expf``, as torch.exp on the card) ``torch.equal`` on its eight outputs
for every preset at odd shapes and at bench.py --scengen's 65,536 x 4
for two, at 1 to 256 assets, and through ``generate`` and
``feed=scengen``, which match the CPU's flags and prices.  K6 (q16
tape decode) and K7 (batched scaled windows) ``torch.equal`` (-fmad=false,
IEEE division; K7 NaN for NaN, over random, the export's and clamped
steps, F 1-7, W 8-64 and a feature view 4 bytes off alignment, and at
a batch where every CTA walks several tiles), also through a compressed tape's shard decode and a
streamed episode on the card (pinned copies on a side stream), which
must equal the CPU's.
The trainers' one-dispatch-late reads (the guard watchdog and the
telemetry's metric drain) return while the next superstep still runs on
the stream, with the values of an immediate read.
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
@pytest.mark.parametrize("mark_kind,live_kind", cases.K3_FLAG_PATTERNS, ids="-".join)
@pytest.mark.parametrize("window", cases.SHARPE_WINDOWS)
@pytest.mark.parametrize("n", cases.SHARPE_SIZES)
def test_cuda_mark_reward_sharpe_equals_plain_across_a_ring_wrap(cuda_device, n, window,
                                                                 mark_kind, live_kind):
    """K3's sharpe path, stepped W + 3 times on its own outputs (the ring
    wraps), against the plain version at every step: torch.equal."""
    cfg, params, st, close, rng = cases.sharpe_case(n, window, n + window, cuda_device)
    closes = torch.from_numpy(cases.sharpe_closes(close, window + 3, rng)).to(cuda_device)
    wrapped = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    nonzero = torch.zeros(n, dtype=torch.bool, device=cuda_device)
    for step in range(window + 3):
        mark_pred, live = (torch.from_numpy(cases.flag_pattern(kind, n, rng)).to(cuda_device)
                           for kind in (mark_kind, live_kind))
        before = (env_dynamics.mark_reward.launches, env_dynamics.mark_reward.sharpe_launches)
        ring_in = st.reward_buffer.clone()
        ours_st, ours_r = env_dynamics.mark_reward(st, closes[step], mark_pred, live, cfg, params)
        assert (env_dynamics.mark_reward.launches, env_dynamics.mark_reward.sharpe_launches) \
            == (before[0] + 1, before[1] + 1)
        ref_st, ref_r = env_dynamics.mark_reward_plain(st, closes[step], mark_pred, live, cfg,
                                                       params)
        assert torch.equal(ours_r, ref_r), f"step {step}: reward"
        for name in env_dynamics.MARK_OUT_FIELDS + ("reward_buffer", "reward_buffer_idx",
                                                     "reward_buffer_len"):
            assert torch.equal(getattr(ours_st, name), getattr(ref_st, name)), f"step {step}: {name}"
        assert torch.equal(st.reward_buffer, ring_in)  # the input ring is left as it was
        wrapped |= live & (st.reward_buffer_idx == window - 1)
        nonzero |= ours_r != 0
        st = ours_st
    if live_kind == "all" or (live_kind == "mixed" and n > 1):
        # W + 3 live steps pass every slot; a lone env live half the
        # steps may not reach slot W - 1
        assert bool(wrapped.any())
    if live_kind != "none" and mark_kind == "all":  # unmarked equity gives equal returns
        assert bool(nonzero.any())


@pytest.mark.cuda
def test_cuda_mark_reward_sharpe_rejects_a_ring_it_cannot_take(cuda_device):
    cfg, params, st, close, _ = cases.sharpe_case(63, 64, 0, cuda_device)
    c = torch.from_numpy(close).to(cuda_device)
    flags = torch.ones(63, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="reward_buffer"):
        env_dynamics.mark_reward(st._replace(reward_buffer=st.reward_buffer[:, :32]), c, flags,
                                 flags, cfg, params)
    with pytest.raises(ValueError, match="reward_buffer_idx"):
        env_dynamics.mark_reward(st._replace(reward_buffer_idx=st.reward_buffer_idx.long()), c,
                                 flags, flags, cfg, params)


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
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32)


# the f32 window kernels against the emulation of their sums in order
# (ops/cases.py): the card's expf and torch's exp differ in their last
# ulps, which move an output by a few ulps of the largest element
F32_EMULATION_TOL = 2.0 ** -19


def _window_ids(x):
    return "x".join(map(str, x)) if isinstance(x, tuple) else str(x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", cases.ATTENTION_F32_WINDOW_CASES, ids=_window_ids)
def test_cuda_f32_window_attention_within_tolerance_of_plain(cuda_device, shape, causal):
    assert fused_attention.f32_kernels(shape) == "window"
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v, g = (torch.randn(shape, generator=gen, device=cuda_device) for _ in range(4))
    before = (fused_attention.attention_forward.launches, fused_attention.attention_backward.launches)
    out = fused_attention.attention_forward(q, k, v, causal)
    ref = fused_attention.attention_forward_plain(q, k, v, causal)
    assert out.dtype == torch.float32 and out.shape == shape
    assert float((out - ref).abs().max()) <= _attention_tol(ref)
    grads = fused_attention.attention_backward(q, k, v, g, causal)
    for name, ours, plain in zip("qkv", grads, fused_attention.attention_backward_plain(q, k, v, g, causal)):
        assert ours.dtype == torch.float32 and ours.shape == shape
        assert float((ours - plain).abs().max()) <= _attention_tol(plain), f"d{name}"
    again = fused_attention.attention_backward(q, k, v, g, causal)
    for a, b in zip(grads, again):
        assert torch.equal(_bits(a), _bits(b))
    assert (fused_attention.attention_forward.launches,
            fused_attention.attention_backward.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", cases.ATTENTION_F32_WINDOW_CASES, ids=_window_ids)
def test_cuda_f32_window_attention_within_tolerance_of_emulation(cuda_device, shape, causal):
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v, g = (torch.randn(shape, generator=gen, device=cuda_device) for _ in range(4))
    out = fused_attention.attention_forward(q, k, v, causal)
    emu = cases.attention_f32_window_forward_emulated(q, k, v, causal)
    assert float((out - emu).abs().max()) <= F32_EMULATION_TOL * float(emu.abs().max())
    emulated = cases.attention_f32_window_backward_emulated(q, k, v, g, causal)
    for name, ours, e in zip("qkv", fused_attention.attention_backward(q, k, v, g, causal), emulated):
        assert float((ours - e).abs().max()) <= F32_EMULATION_TOL * max(float(e.abs().max()), 1e-30), f"d{name}"


def _f32_views(x):
    """(B, S, H, D) views of ``x``'s values laid out otherwise in memory:
    the first two the window kernels read in place, the others the
    wrapper copies."""
    b, s, h, d = x.shape
    wide = torch.zeros((b, s, h, d + 4), device=x.device)
    wide[..., :d] = x
    flat = torch.zeros(x.numel() + 1, device=x.device)
    flat[1:] = x.reshape(-1)
    return {
        "heads_outer": x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3),
        "rows_in_wider": wide[..., :d],
        "d_outermost": x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2),
        "pointer_off_16": flat[1:].view(x.shape),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["heads_outer", "rows_in_wider", "d_outermost", "pointer_off_16"])
@pytest.mark.parametrize("d", [32, 24])
def test_cuda_f32_window_attention_reads_strided_views(cuda_device, layout, d):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn((5, 33, 3, d), generator=gen, device=cuda_device)
    y = _f32_views(x)[layout]
    assert torch.equal(y, x) and not y.is_contiguous() or layout == "pointer_off_16"
    (z,), _ = fused_attention.prepare_f32_window(y)
    assert (z is y) == (d == 32 and layout in ("heads_outer", "rows_in_wider"))
    g = torch.randn(x.shape, generator=gen, device=cuda_device)
    out = fused_attention.fused_window_attention(y, y, y, causal=True)
    ref = fused_attention.attention_forward_plain(x, x, x, True)
    assert float((out - ref).abs().max()) <= _attention_tol(ref)
    for ours, plain in zip(fused_attention.attention_backward(y, y, y, g, True),
                           fused_attention.attention_backward_plain(x, x, x, g, True)):
        assert float((ours - plain).abs().max()) <= _attention_tol(plain)


@pytest.mark.cuda
def test_cuda_f32_streamed_attention_backward_is_deterministic(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v, g = (torch.randn((3, 77, 2, 32), generator=gen, device=cuda_device) for _ in range(4))
    assert fused_attention.f32_kernels(q.shape) == "streamed"
    first = fused_attention.attention_backward(q, k, v, g, True)
    second = fused_attention.attention_backward(q, k, v, g, True)
    for a, b in zip(first, second):
        assert torch.equal(_bits(a), _bits(b))


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


def _flag_bars(n, device, seed=0):
    """Bar flags over all five FLAG bits, so every env kind occurs."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, 32, (n,), generator=gen, dtype=torch.int32).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_msgs,rows", [(8192, 64, "int32"), (13, 17, "int64"),
                                           (4099, 33, "int32")])
@pytest.mark.parametrize("scenario", cases.LOB_SCENARIOS)
def test_cuda_bar_flow_flag_route_equals_plain(cuda_device, scenario, n, n_msgs, rows):
    bars = cases.lob_flow_bars(n, rows, seed=n_msgs, device=cuda_device)
    fp = scenario_flow_params(scenario)
    flags = _flag_bars(n, cuda_device, seed=n)
    before = (lob_flow.bar_flow.launches, lob_flow.bar_flow.flag_launches)
    ours = lob_flow.bar_flow(5, *bars, n_msgs, fp, flags)
    ref = lob_flow.bar_flow_plain(5, *bars, n_msgs, fp, flags)
    assert (lob_flow.bar_flow.launches, lob_flow.bar_flow.flag_launches) == (before[0] + 1,
                                                                             before[1] + 1)
    for name, a, b in zip(ref._fields, ours, ref):
        assert torch.equal(a, b), name
    if n == 8192:
        crash = ((flags >> 2) & 1).bool()
        lo = n_msgs // 3
        assert bool((ours.kind[crash, lo:lo + n_msgs // 8] == 3).all())
        with pytest.raises(ValueError, match="flags"):
            lob_flow.bar_flow(5, *bars, n_msgs, fp, flags.to(torch.int64))


def _scan_case(preset, n, a, device, weekend=True, seed=0):
    import numpy as np

    from gymfx_tpu_torch.lob import prng
    from gymfx_tpu_torch.scengen import engine, feed
    from gymfx_tpu_torch.scengen.params import scenario_params

    monday = feed.fx_timestamp_grid(n, 1.0)[1] if weekend else np.zeros(n, bool)
    shocks = engine.draw_shocks(prng.PRNGKey(seed, device), n, a)
    return engine.scan_inputs(shocks, scenario_params(preset), monday)


# every preset at odd shapes, 1 to 256 assets; bench.py --scengen's 65,536
# x 4 for two (the plain version's host loop takes ~0.3 s a case there)
SCAN_CASES = [(preset, n, a) for preset in (
    "regime_mix", "flash_crash", "liquidity_drought", "multi_asset_stress", "trend_calm",
    "range_chop", "gap_open", "multi_asset_calm") for n, a in ((2, 1), (4096, 1), (4096, 33),
                                                            (1000, 256), (3, 7))] + [
    ("regime_mix", 65536, 4), ("multi_asset_stress", 65536, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("preset,n,a", SCAN_CASES)
def test_cuda_scengen_scan_equals_plain(cuda_device, preset, n, a):
    from gymfx_tpu_torch.ops import scengen_scan as k10

    args = _scan_case(preset, n, a, cuda_device, seed=a)
    before = k10.scengen_scan.launches
    ours = k10.scengen_scan(*args)
    ref = k10.paths_plain(*args)
    assert k10.scengen_scan.launches == before + 1
    for name, x, y in zip(("open", "high", "low", "close", "spread", "slip", "flags", "regime"),
                          ours, ref):
        assert x.device.type == "cuda" and torch.equal(x, y), name


@pytest.mark.cuda
def test_cuda_generate_and_the_feed_generate_on_the_card(cuda_device):
    from gymfx_tpu_torch.config import DEFAULT_VALUES
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.lob import prng
    from gymfx_tpu_torch.ops import scengen_scan as k10
    from gymfx_tpu_torch.scengen import engine, feed
    from gymfx_tpu_torch.scengen.params import scenario_params

    p = scenario_params("multi_asset_stress")
    before = k10.scengen_scan.launches
    paths = engine.generate(p, prng.PRNGKey(0, cuda_device), 512, 3)
    assert paths.close.device.type == "cuda" and k10.scengen_scan.launches == before + 1
    cpu = engine.paths_from_shocks(engine.draw_shocks(prng.PRNGKey(0), 512, 3), p,
                                   torch.zeros(512, dtype=torch.bool))
    assert torch.equal(paths.flags.cpu(), cpu.flags) and torch.equal(paths.regime.cpu(), cpu.regime)
    torch.testing.assert_close(paths.close.cpu(), cpu.close, rtol=2e-6, atol=0)
    config = dict(DEFAULT_VALUES, feed="scengen", scengen_bars=300, window_size=8)
    env = Environment(config)
    assert env.device.type == "cuda" and k10.scengen_scan.launches == before + 2
    assert env.data.scen_flags.device.type == "cuda" and env.n_bars == 300
    flags = feed.synthesize_frame(config, device="cpu")[1]
    assert (env.data.scen_flags.cpu().numpy() == flags).all()


@pytest.mark.cuda
def test_cuda_scengen_scan_rejects_what_it_cannot_take(cuda_device):
    from gymfx_tpu_torch.ops import scengen_scan as k10

    args = list(_scan_case("regime_mix", 64, 2, cuda_device))
    with pytest.raises(ValueError, match="monday"):
        k10.scengen_scan(*args[:4], args[4].bool(), *args[5:])
    with pytest.raises(ValueError, match="eps"):  # not contiguous
        k10.scengen_scan(*args[:5], args[5].t().contiguous().t(), *args[6:])
    with pytest.raises(ValueError, match="at most 256"):
        k10.scengen_scan(*_scan_case("regime_mix", 8, 257, cuda_device))


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
GRAPH_KINDS = ["mlp", "transformer_ring", "curriculum", "lob", "ppo_lstm", "sharpe"]


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
    elif kind == "ppo_lstm":
        config = flagship.impala_lstm_config(csv, trainer="ppo", num_envs=64, ppo_horizon=8,
                                             policy_kwargs={"hidden": 32})
    elif kind == "sharpe":
        config = flagship.baseline_sharpe_config(csv, **small)
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
    """A train state (PPO's or IMPALA's) with every tensor cloned and a
    generator of its own at the same state."""
    from gymfx_tpu_torch.core import graphs

    def one(x):
        if isinstance(x, torch.Generator):
            gen = torch.Generator(device=x.device)
            gen.set_state(x.get_state())
            return gen
        return graphs.clone_tree(x)

    return type(state)(*(one(x) for x in state))


def _assert_equal(a, b, what):
    from gymfx_tpu_torch.resilience.guards import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{what}: leaf {i}"


def _assert_states_equal(a, b, what):
    fields = lambda s: tuple(x for x in s if not isinstance(x, torch.Generator))  # noqa: E731
    _assert_equal(fields(a), fields(b), what)
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
def test_cuda_impala_graphed_phases_and_train_many_equal_eager(cuda_device):
    """IMPALA's rollout and update phases from their graphs against the
    same phases op by op, then train_many (k = 3, a sync among them)
    against three eager steps: torch.equal, the generator included."""
    from gymfx_tpu_torch.config import flagship
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.train.impala import ImpalaTrainer, impala_config_from

    csv = str(REPO / "examples" / "data" / "eurusd_sample.csv")
    config = flagship.impala_lstm_config(csv, num_envs=64, impala_unroll=8, impala_sync_every=2,
                                         policy_kwargs={"hidden": 32})
    trainer = ImpalaTrainer(Environment(config), impala_config_from(config))
    s0 = trainer.init_state(3)
    a, ra = trainer.rollout_phase(_copy(s0))
    b, rb = trainer._rollout_phase_eager(_copy(s0))
    _assert_equal(ra, rb, "rollout segment and start carry")
    _assert_states_equal(a, b, "rollout state")
    ua, ma = trainer.update_phase(a, ra)
    ub, mb = trainer._update_phase_eager(b, rb)
    _assert_states_equal(ua, ub, "update state")
    _assert_equal(ma, mb, "update metrics")
    assert float(ma["nonfinite_skips"]) == 0.0
    many, stacked = trainer.train_many(_copy(ub), 3)
    ref, history = _copy(ub), []
    for _ in range(3):
        ref, metrics = trainer._update_phase_eager(*trainer._rollout_phase_eager(ref))
        history.append(metrics)
    _assert_states_equal(many, ref, "train_many state")
    _assert_equal(stacked, {k: torch.stack([m[k] for m in history]) for k in stacked},
                  "train_many metrics")
    assert sorted(k for k, *_ in trainer._graphs) == ["rollout", "update"]
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


# ---- the episode drivers' CUDA graphs (core/rollout.py) ---------------------
# Each episode replayed from its chunk graphs against the same episode with
# every chunk op by op (eager=True), on the card: torch.equal on every
# output and on the final state, for every driver, at chunk remainders,
# on the LOB venue, and streamed through the staging shard.
EPISODE_DRIVERS = ["buy_hold", "flat", "random", "replay", "greedy"]


def _episode_driver(name, env):
    from gymfx_tpu_torch.core import rollout as R
    from gymfx_tpu_torch.train.ppo import PPOTrainer, greedy_policy_driver, ppo_config_from

    if name == "greedy":
        trainer = PPOTrainer(env, ppo_config_from(dict(env.config, num_envs=4)))
        return greedy_policy_driver(trainer), (trainer.init_state(0).params, ())
    if name == "replay":
        actions = torch.randint(0, 3, (150,), generator=torch.Generator().manual_seed(5))
        return R.replay_driver(actions.numpy(), env.device), None
    return R.DRIVERS[name](), None


def _assert_episodes_equal(a, b, what):
    (sa, oa), (sb, ob) = a, b
    assert list(oa) == list(ob), what
    for key in oa:
        assert torch.equal(oa[key], ob[key]), f"{what}: {key}"
    for field in sa._fields:
        assert torch.equal(getattr(sa, field), getattr(sb, field)), f"{what}: state {field}"


@pytest.mark.cuda
@pytest.mark.parametrize("steps,n_envs", [(130, 1), (65, 8192)])
@pytest.mark.parametrize("driver", EPISODE_DRIVERS)
def test_cuda_graphed_episode_equals_eager(cuda_device, tmp_path, driver, steps, n_envs):
    from gymfx_tpu_torch.config import flagship
    from gymfx_tpu_torch.core import rollout as R
    from gymfx_tpu_torch.core.runtime import Environment

    config = flagship.flagship_config(_tick_csv(tmp_path, 2000), timeframe="M1",
                                      policy_dtype="float32")
    env = Environment(config)
    drive, carry = _episode_driver(driver, env)
    runs = []
    for eager in (False, True):
        gen = torch.Generator(device=cuda_device).manual_seed(3)
        runs.append(R.rollout_chunked(env.cfg, env.params, env.data, drive, steps, gen,
                                      driver_carry=carry, n_envs=n_envs, eager=eager,
                                      cache=env.episode_graphs))
    _assert_episodes_equal(runs[0], runs[1], f"{driver} {steps} x {n_envs}")
    assert sorted({key[0] for key in env.episode_graphs.graphs}) == sorted({64, steps % 64})
    # a second graphed episode replays the same graphs and gives the same
    again = R.rollout_chunked(env.cfg, env.params, env.data, drive, steps,
                              torch.Generator(device=cuda_device).manual_seed(3),
                              driver_carry=carry, n_envs=n_envs, cache=env.episode_graphs)
    _assert_episodes_equal(again, runs[0], f"{driver} replayed again")


@pytest.mark.cuda
def test_cuda_graphed_lob_and_streamed_episodes_equal_eager(cuda_device, tmp_path):
    from gymfx_tpu_torch.config import DEFAULT_VALUES, flagship
    from gymfx_tpu_torch.core.rollout import buy_hold_driver
    from gymfx_tpu_torch.core.runtime import Environment

    path = _tick_csv(tmp_path, 4000)
    lob = Environment(flagship.lob_config(path, timeframe="M1"))
    _assert_episodes_equal(lob.rollout(buy_hold_driver(), 70),
                           lob.rollout(buy_hold_driver(), 70, eager=True), "LOB episode")
    config = dict(DEFAULT_VALUES, input_data_file=path, timeframe="M1", window_size=32,
                  feature_columns=["CLOSE", "VOLUME"], stream_hbm_budget_mb=0.2,
                  data_compress="on")
    env = Environment(config)
    graphed = env.rollout(buy_hold_driver(), 1200)
    _assert_episodes_equal(graphed, env.rollout(buy_hold_driver(), 1200, eager=True),
                           "streamed episode")
    assert env.episode_graphs.staging.row0.device.type == "cuda"


# ---------------------------------------------------------------- the portfolio
@pytest.mark.cuda
@pytest.mark.parametrize("n", [63, 768])
@pytest.mark.parametrize("flags", FLAG_GRID, ids=lambda f: "-".join(map(str, f)))
def test_cuda_fill_brackets_and_mark_reward_with_row_params_equal_plain(cuda_device, flags, n):
    """K2 and K3 with a param row per env (cases.PAIR_PARAM_ROWS: three
    distinct rows, a portfolio's pairs), and with some params per row and
    the rest shared, equal their plain versions."""
    i = FLAG_GRID.index(flags)
    cfg = flag_config(flags, REWARDS[i % 2])
    rows = cases.row_params(cases.PAIR_PARAM_ROWS, n, cuda_device)
    mixed = env_params(cases.PAIR_PARAM_ROWS[0], cuda_device)._replace(
        commission=rows.commission, initial_cash=rows.initial_cash)
    fields, mark, bars, advance, rng = ledger_case(200 + i, n=n)
    st = ledger_state(cfg, {**fields, **mark}, cuda_device)
    o, h, l, c, acc = (torch.from_numpy(bars[k]).to(cuda_device)
                       for k in ("o", "h", "l", "c", "accrual"))
    acc = acc if cfg.financing_enabled else None
    adv = torch.from_numpy(advance).to(cuda_device)
    mark_pred = torch.from_numpy(rng.random(n) < 0.7).to(cuda_device)
    live = torch.from_numpy(rng.random(n) < 0.8).to(cuda_device)
    for params in (rows, mixed):
        ref = env_dynamics.fill_brackets_plain(st, o, h, l, c, acc, adv, cfg, params)
        ours = env_dynamics.fill_brackets(st._replace(exec_diag=st.exec_diag.clone()),
                                          o, h, l, c, acc, adv, cfg, params)
        for name in ref._fields:
            assert torch.equal(getattr(ours, name), getattr(ref, name)), name
        ours_st, ours_r = env_dynamics.mark_reward(st, c, mark_pred, live, cfg, params)
        ref_st, ref_r = env_dynamics.mark_reward_plain(st, c, mark_pred, live, cfg, params)
        assert torch.equal(ours_r, ref_r)
        for name in env_dynamics.MARK_OUT_FIELDS:
            assert torch.equal(getattr(ours_st, name), getattr(ref_st, name)), name


PORTFOLIO = {"portfolio_files": {"EUR_USD": "examples/data/eurusd_sample.csv",
                                 "GBP_USD": "examples/data/gbpusd_sample.csv",
                                 "USD_JPY": "examples/data/usdjpy_sample.csv"},
             "window_size": 8, "max_rows": 40, "margin_rate": 0.02, "leverage": 20.0,
             "portfolio_param_overrides": {"GBP_USD": {"commission": 1e-4}}}


def _portfolio_env(device, **over):
    from gymfx_tpu_torch.config import DEFAULT_VALUES
    from gymfx_tpu_torch.core.portfolio import PortfolioEnvironment

    return PortfolioEnvironment({**DEFAULT_VALUES, **PORTFOLIO, **over}, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("features", [False, True])
def test_cuda_portfolio_step_launches_one_k2_and_one_k3_for_every_row(cuda_device, features):
    """A portfolio step of 5 books x 3 pairs: one K2 and one K3 launch for
    all 15 rows, with the pairs' own commission (and with OHLCV feature
    columns one K1 launch over the rows' windows); every output equal to
    the CPU's plain step (the kernels equal their plain versions)."""
    import numpy as np

    from gymfx_tpu_torch.resilience.guards import tree_leaves

    over = {"feature_columns": ["OPEN", "HIGH", "LOW", "CLOSE", "VOLUME"]} if features else {}
    envs = {d: _portfolio_env(d, **over) for d in ("cpu", cuda_device)}
    states = {d: envs[d].reset(5)[0] for d in envs}
    rng = np.random.default_rng(0)
    kernels = (env_dynamics.fill_brackets, env_dynamics.mark_reward, window_zscore.step_obs)
    for _ in range(12):
        actions = torch.from_numpy(rng.integers(0, 4, (5, 3)))
        before = [k.launches for k in kernels]
        out = {d: envs[d].step(states[d], actions.to(d)) for d in envs}
        assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, int(features)]
        cpu, card = out["cpu"], out[cuda_device]
        for a, b in zip(tree_leaves(cpu), tree_leaves(card)):
            assert torch.equal(a, b.cpu())
        states = {d: out[d][0] for d in envs}
    assert envs[cuda_device].rows(5)[0].pair.commission.shape == (15,)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["transformer", "transformer_ring"])
def test_cuda_pbt_steps_graphed_equal_eager_with_an_exploit(cuda_device, policy):
    """Two population steps with an exploit/explore between them, graphed
    (two captures, none after) against eager: every leaf torch.equal."""
    import numpy as np

    from gymfx_tpu_torch.config import DEFAULT_VALUES
    from gymfx_tpu_torch.core import graphs
    from gymfx_tpu_torch.resilience.guards import tree_leaves
    from gymfx_tpu_torch.train.pbt import _pbt_config_from, make_portfolio_pbt

    config = {**DEFAULT_VALUES, **PORTFOLIO, "num_envs": 8, "ppo_horizon": 8,
              "pbt_population": 4, "policy": policy}
    pbt = make_portfolio_pbt(dict(config), _pbt_config_from(config), _portfolio_env(cuda_device))
    state0, _ = pbt.init_population(0)

    def copy(s):
        gen = torch.Generator(device=cuda_device)
        gen.set_state(s.generator.get_state())
        return s._replace(**{k: graphs.clone_tree(getattr(s, k)) for k in s._fields
                             if k != "generator"}, generator=gen)

    def run(eager):
        s = copy(state0)
        s, m = pbt.trainer.train_step(s, eager=eager)
        s, fitness, replaced = pbt._exploit_explore(
            s, m["mean_reward"].cpu().numpy().astype(np.float64), np.random.default_rng(1))
        s, m2 = pbt.trainer.train_step(s, eager=eager)
        return s, m2, replaced

    ga, gm, grep = run(False)
    assert pbt.trainer.captures() == 2
    ea, em, erep = run(True)
    assert grep == erep
    for a, b in zip(tree_leaves((ga[:4], gm)), tree_leaves((ea[:4], em))):
        assert torch.equal(a, b)
    assert torch.equal(ga.generator.get_state(), ea.generator.get_state())
    assert pbt.trainer.captures() == 2


# ------------------------------------------- financing, profiles and the GA
def _real_rate_accrual(n, seed):
    """Each row's accrual at one bar of a generated M1 week: the pair of
    row e is e % 3 (EUR_USD, GBP_USD, USD_JPY, a portfolio's rows), its
    bar drawn so that about half the rows sit on a 22:00 UTC rollover
    bar, with the smoke rate table's daily differentials
    (data/financing.py)."""
    import numpy as np

    from gymfx_tpu_torch.data import financing

    rows = financing.read_rate_table("examples/data/fx_rollover_rates_smoke.csv")
    stamps = cases.m1_week_grid(2 ** 15)
    columns = [financing.precompute_rollover_accrual(stamps, rows, *financing.split_pair(p))
               for p in ("EUR_USD", "GBP_USD", "USD_JPY")]
    rollover = np.flatnonzero(columns[0])
    rng = np.random.default_rng(seed)
    bars = np.where(rng.random(n) < 0.5, rng.choice(rollover, n), rng.integers(0, len(stamps), n))
    acc = np.array([columns[e % 3][b] for e, b in enumerate(bars)], np.float32)
    assert np.count_nonzero(acc) > n // 4
    return torch.from_numpy(acc)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [63, 8192])
@pytest.mark.parametrize("flags", [f for f in FLAG_GRID if f[3]], ids=lambda f: "-".join(map(str, f)))
def test_cuda_fill_brackets_financed_at_real_rates_equals_plain(cuda_device, flags, n):
    """K2's financing instantiations at the rate table's real daily
    differentials, a pair's own accrual per row, with per-row params that
    put venue quantization on (a tick grid, a size step, a minimum
    quantity) and the shared quantized params: torch.equal to plain."""
    i = FLAG_GRID.index(flags)
    cfg = flag_config(flags, REWARDS[i % 2])
    acc = _real_rate_accrual(n, i).to(cuda_device)
    fields, mark, bars, advance, _ = ledger_case(300 + i, n=n)
    st = ledger_state(cfg, {**fields, **mark}, cuda_device)
    o, h, l, c = (torch.from_numpy(bars[k]).to(cuda_device) for k in ("o", "h", "l", "c"))
    adv = torch.from_numpy(advance).to(cuda_device)
    for params in (cases.row_params(cases.PAIR_PARAM_ROWS, n, cuda_device),
                   env_params({**PARAM_SETS["quantized"], **MARK_PARAMS}, cuda_device)):
        ref = env_dynamics.fill_brackets_plain(st, o, h, l, c, acc, adv, cfg, params)
        before = env_dynamics.fill_brackets.launches
        ours = env_dynamics.fill_brackets(st._replace(exec_diag=st.exec_diag.clone()),
                                          o, h, l, c, acc, adv, cfg, params)
        assert env_dynamics.fill_brackets.launches == before + 1
        for name in ref._fields:
            assert torch.equal(getattr(ours, name), getattr(ref, name)), name
        moved = (ref.cash_delta != env_dynamics.fill_brackets_plain(
            st, o, h, l, c, torch.zeros_like(acc), adv, cfg, params).cash_delta)
        assert bool(moved.any())  # the accrual reached the cash


@pytest.mark.cuda
def test_cuda_ga_fitness_through_graphs_equals_eager(cuda_device):
    """Two generations of a population of 64 over
    examples/configs/optimize_atr.json's bars (one batched episode of
    500 steps), tuning k_sl and commission (a per-row column of K2's
    params, so the candidates score apart), replayed from the chunk
    graphs equal the same generations op by op; the first is replayed
    twice, the second's values are copied into the same buffers."""
    import json

    import numpy as np

    from gymfx_tpu_torch.config import DEFAULT_VALUES
    from gymfx_tpu_torch.core.runtime import Environment
    from gymfx_tpu_torch.train import optimize

    with open("examples/configs/optimize_atr.json", encoding="utf-8") as fh:
        config = {**DEFAULT_VALUES, **json.load(fh), "atr_period": 14,
                  "optimize_params": {"k_sl": [1.0, 4.0], "commission": [0.0, 0.0002]}}
    env = Environment(config, device=cuda_device)
    schema = optimize.hparam_schema(config)
    graphed = optimize.Optimizer(env, schema, population=64, episode_steps=500)
    eager = optimize.Optimizer(env, schema, population=64, episode_steps=500, eager=True)
    firsts = []
    for gen in range(2):
        pop = np.random.default_rng(gen).uniform([1.0, 0.0], [4.0, 2e-4], size=(64, 2))
        first = [x.clone() for x in graphed._fitness(pop, 3)]
        again = [x.clone() for x in graphed._fitness(pop, 3)]
        want = eager._fitness(pop, 3)
        assert sorted(k[0] for k in env.episode_graphs.graphs) == [52, 64]
        for a, b, c in zip(first, again, want):
            assert torch.equal(a, c) and torch.equal(b, c)
        assert len(set(first[0].tolist())) > 1
        firsts.append(first[0])
    assert not torch.equal(*firsts)


# ---- the serving engine (serve/engine.py, slots.py, batcher.py) ----------------
SERVE_KWARGS = {"mlp": {"hidden": [32, 32]}, "lstm": {"hidden": 32},
                "transformer_ring": {"d_model": 32, "n_heads": 2, "n_layers": 2}}


def _serve_engine(device, name, dtype=torch.float32, buckets=(1, 4, 8), batch_mode="exact"):
    """A small engine on the card with weights from a seeded generator,
    its policy module loaded with them (the single-row reference) and
    a host generator for rows."""
    import copy

    from gymfx_tpu_torch.serve import InferenceEngine
    from gymfx_tpu_torch.train.policies import make_trainer_policy
    from gymfx_tpu_torch.train.ppo import init_policy_weights

    shape = (8, 5) if name == "transformer_ring" else (20,)
    pol = make_trainer_policy(name, shape[-1], continuous=False, dtype=dtype,
                              kwargs=dict(SERVE_KWARGS[name]), window=shape[0]).to(device)
    init_policy_weights(pol, torch.Generator(device=device).manual_seed(3))
    params = {k: v.detach().clone() for k, v in pol.named_parameters()}
    eng = InferenceEngine(pol, params, torch.zeros(shape), buckets=buckets,
                          batch_mode=batch_mode, device=device)
    ref = copy.deepcopy(pol)
    return eng, ref, torch.Generator().manual_seed(4)


def _serve_single_row(ref, eng, x, carry):
    with torch.no_grad():
        x = x.to(eng.device)[None]
        if eng.recurrent:
            logits, value, c2 = ref(x, tuple(c.to(eng.device)[None] for c in carry))
        else:
            (logits, value), c2 = ref(x), ()
    return (torch.argmax(logits[0]).to(torch.int32).cpu(), value[0].cpu(), logits[0].cpu(),
            tuple(c[0].cpu() for c in c2))


def _serve_rows(eng, gen, n):
    return torch.randn((n, *eng.obs_shape), generator=gen)


def _serve_carries(eng, gen, n):
    if not eng.recurrent:
        return None
    return tuple(torch.randn((n, *c.shape), generator=gen).to(c.dtype)
                 for c in eng.initial_carry())


def _assert_serve_rows_exact(ref, eng, obs, carries, out):
    for i in range(obs.shape[0]):
        carry = tuple(c[i] for c in carries) if eng.recurrent else ()
        a, v, lo, c2 = _serve_single_row(ref, eng, obs[i], carry)
        assert torch.equal(out.action[i], a) and torch.equal(out.value[i], v), i
        assert torch.equal(out.actor_out[i], lo), i
        assert all(torch.equal(x[i], y) for x, y in zip(out.carry, c2)), i


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("mlp", torch.float32), ("lstm", torch.bfloat16),
                                        ("transformer_ring", torch.float32)], ids=str)
def test_cuda_serve_exact_rows_equal_the_single_row_forward(cuda_device, name, dtype):
    """Exact mode on the card: every row of every bucket (padded fills,
    the chunking above the ladder, the LSTM's non-zero carries and its
    carry) torch.equal to the policy on that row alone; no late capture;
    K4's forward counted at the ring ladder's capture."""
    from gymfx_tpu_torch.core.graphs import WARMUP

    before = fused_attention.attention_forward.launches
    eng, ref, gen = _serve_engine(cuda_device, name, dtype)
    assert eng.executable_count == 3 and all(eng.capture_s[b] > 0 for b in (1, 4, 8))
    if name == "transformer_ring":
        # exact: one forward a row, each through both layers
        assert fused_attention.attention_forward.launches - before == (WARMUP + 1) * 2 * 13
    for n in (1, 3, 4, 8, 19):
        obs, carries = _serve_rows(eng, gen, n), _serve_carries(eng, gen, n)
        _assert_serve_rows_exact(ref, eng, obs, carries, eng.decide_batch(obs, carries))
    assert eng.late_compiles == 0


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True])
def test_cuda_serve_batcher_answers_equal_decide_batch(cuda_device, pipeline):
    import threading

    from gymfx_tpu_torch.serve import MicroBatcher

    eng, _ref, gen = _serve_engine(cuda_device, "mlp")
    obs = _serve_rows(eng, gen, 32)
    want = eng.decide_batch(obs)
    answers = {}
    with MicroBatcher(eng, max_batch_wait_ms=2.0, pipeline=pipeline) as mb:
        def client(c):
            for j in range(10):
                i = (c * 10 + j) % 32
                answers[(c, j)] = (i, mb.submit(obs[i]).result(timeout=60))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert len(answers) == 80
    for i, d in answers.values():
        assert torch.equal(d.actor_out, want.actor_out[i]) and torch.equal(d.value, want.value[i])


@pytest.mark.cuda
@pytest.mark.parametrize("batch_mode", ["exact", "matmul"])
def test_cuda_serve_slots_equal_host_carry_threading(cuda_device, batch_mode):
    """Slot decisions torch.equal to host-carry threading over 6 steps,
    the mirror equal to the host carry and to the device rows after each
    resolve, slot dispatches in flight resolving to their own rows."""
    eng, _ref, gen = _serve_engine(cuda_device, "lstm", torch.bfloat16, batch_mode=batch_mode)
    cache = eng.enable_slots(16)
    sessions = [f"s{i}" for i in range(6)]
    hc = eng.initial_carry_batch(6)
    for step in range(6):
        obs = _serve_rows(eng, gen, 6)
        h = eng.decide_batch(obs, hc)
        s = eng.decide_batch_slots(obs, sessions)
        hc = h.carry
        assert s.carry is None and torch.equal(s.actor_out, h.actor_out), step
        assert torch.equal(s.value, h.value) and torch.equal(s.action, h.action), step
        for i, sess in enumerate(sessions):
            slot = cache.slot_of(sess)
            for m, x, st in zip(cache.mirror_carry(sess), hc, cache.state):
                assert torch.equal(m, x[i]) and torch.equal(m, st[slot].cpu()), (step, sess)
    a, b = _serve_rows(eng, gen, 3), _serve_rows(eng, gen, 3)
    ha = eng.dispatch_async(a, sessions=["a0", "a1", "a2"])
    hb = eng.dispatch_async(b, sessions=["b0", "b1", "b2"])
    for got, rows in ((hb.resolve(), b), (ha.resolve(), a)):
        want = eng.decide_batch(rows, eng.initial_carry_batch(3))
        assert torch.equal(got.actor_out, want.actor_out)
    assert eng.late_compiles == 0


@pytest.mark.cuda
def test_cuda_serve_async_staging_keeps_each_dispatch_its_rows(cuda_device):
    """Three host dispatches in flight at one bucket before any resolve
    (the third rewrites the first's pinned staging buffer, after waiting
    on the copy that read it): each resolves to its own rows."""
    eng, ref, gen = _serve_engine(cuda_device, "lstm")
    batches = [(_serve_rows(eng, gen, 3), _serve_carries(eng, gen, 3)) for _ in range(3)]
    handles = [eng.dispatch_async(obs, carries) for obs, carries in batches]
    for (obs, carries), h in zip(batches, handles):
        _assert_serve_rows_exact(ref, eng, obs, carries, h.resolve())


@pytest.mark.cuda
def test_cuda_serve_swap_weights(cuda_device):
    from gymfx_tpu_torch.serve import WeightSwapError

    eng, ref, gen = _serve_engine(cuda_device, "mlp")
    obs = _serve_rows(eng, gen, 5)
    before = eng.decide_batch(obs)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    new = {k: v + 0.05 * torch.randn(v.shape, generator=g, device=cuda_device)
           for k, v in eng.params.items()}
    assert eng.swap_weights(new) == 1
    after = eng.decide_batch(obs)
    assert not torch.equal(after.actor_out, before.actor_out)
    ref.load_state_dict(new)
    _assert_serve_rows_exact(ref, eng, obs, None, after)
    bad = dict(new)
    key = sorted(bad)[0]
    bad[key] = bad[key][..., :-1]
    with pytest.raises(WeightSwapError):
        eng.swap_weights(bad)
    assert torch.equal(eng.decide_batch(obs).actor_out, after.actor_out)
    assert eng.generation == 1 and eng.late_compiles == 0


def _guard_superstep(device, i, sleep_cycles=0):
    """A superstep's stacked metrics (new tensors), computed after a
    ``torch.cuda._sleep`` of ``sleep_cycles`` when given."""
    if sleep_cycles:
        torch.cuda._sleep(sleep_cycles)
    x = torch.arange(4, device=device, dtype=torch.float32) + i
    return {"nonfinite_skips": x[:1] * 0 + 1, "guard_updates": x[:1] * 0 + 4,
            "poisoned_env_resets": x[:1] * 0 + 2, "loss": x[1:2] * 0.5}


@pytest.mark.cuda
@pytest.mark.parametrize("reader", ["watchdog", "stream", "host_copy"])
def test_cuda_late_read_waits_for_its_superstep_alone(cuda_device, reader):
    """The one-dispatch-late reads (resilience/loop.py's guard watchdog,
    telemetry/device_stream.py's drain) return while superstep s + 1 (a
    ~0.5 s ``torch.cuda._sleep`` on the same stream) still runs: their
    pinned copy of s's metrics waits on its own event.  The values are
    those of an immediate read; a plain read of s's tensor then waits
    for s + 1."""
    import time

    from gymfx_tpu_torch.resilience.loop import ResilientLoop
    from gymfx_tpu_torch.telemetry import DeviceMetricStream, HostCopy, MetricsRegistry

    state_fn = lambda: ({}, {})  # noqa: E731
    torch.cuda.synchronize()
    first = _guard_superstep(cuda_device, 1)
    immediate = {k: v.cpu() for k, v in first.items()}
    registry = MetricsRegistry()
    loop = ResilientLoop(steps_per_iter=1, max_consecutive_skips=3)
    stream = DeviceMetricStream("ppo", iters=2, registry=registry)
    copy = None
    if reader == "watchdog":
        loop.after_superstep(0, 1, first, state_fn)
    elif reader == "stream":
        stream.after_dispatch(0, 1, first)
    else:
        copy = HostCopy(first)
    second = _guard_superstep(cuda_device, 2, sleep_cycles=int(1e9))
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    if reader == "watchdog":
        loop.after_superstep(1, 1, second, state_fn)
        got = {"nonfinite_skips": loop.monitor.total_skips,
               "poisoned_env_resets": loop.monitor.total_poisoned_env_resets}
        want = {k: int(immediate[k]) for k in got}
    elif reader == "stream":
        stream.after_dispatch(1, 1, second)
        got = registry.gauge("gymfx_train_metric", labels=("algo", "metric")).value(
            algo="ppo", metric="loss")
        want = float(immediate["loss"])
    else:
        got = {k: torch.from_numpy(v) for k, v in copy.get().items()}
        want = {k: v.reshape(-1) for k, v in immediate.items()}
    read_s = time.perf_counter() - t0
    assert not done.query(), f"the late read waited for the next superstep ({read_s:.3f} s)"
    if reader == "host_copy":
        assert all(torch.equal(got[k], want[k]) for k in want)
    else:
        assert got == want
    first["loss"].cpu()  # a plain read: the stream drains up to here
    assert done.query()
    loop.finish(state_fn)
    stream.finish()
