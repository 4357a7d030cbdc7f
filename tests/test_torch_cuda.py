"""The port's CUDA kernels K1-K5 against their plain versions, on the card.

Each case launches a kernel and its plain PyTorch version on the same
CUDA tensors.  K1-K3 must give ``torch.equal`` results (they are built
with -fmad=false and IEEE division, so the f32 results are the same
bits).  K4 (attention forward and backward) sums in another order than
its plain version (an online softmax, f32 FMAs): float32 within
1e-4 x max|plain|, bfloat16 within 2^-6 x max|plain| (the two round an
f32 value to bf16 once each, so they differ by at most one bf16 ulp of
an element, 2^-7 of the largest; twice that for margin).  K5 (LOB stream
matching) is int32: books and fill records ``torch.equal``.
Every test needs an NVIDIA GPU and skips without one.  This file imports
no JAX, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from gymfx_tpu_torch.core.types import EnvConfig, initial_state
from gymfx_tpu_torch.lob.book import empty_book
from gymfx_tpu_torch.ops import cases, env_dynamics, fused_attention, lob_match, window_zscore
from gymfx_tpu_torch.ops.cases import (
    FLAG_GRID,
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


@pytest.mark.cuda
@pytest.mark.parametrize("mask,clip", [((), 10.0), ((False, True, False), 1.5), ((), 0.0)])
def test_cuda_step_obs_equals_plain(cuda_device, mask, clip):
    win, mean, std, neutral = (torch.from_numpy(x).to(cuda_device) for x in obs_case(n=N))
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
def test_cuda_lob_stream_rejects_what_it_cannot_take(cuda_device):
    msgs = cases.lob_flow_streams("lob_calm", n_books=2, n_msgs=8, device=cuda_device)
    with pytest.raises(NotImplementedError, match="depth"):
        lob_match.process_stream(empty_book(2, 65, 4, cuda_device), msgs)
    with pytest.raises(NotImplementedError, match="slots"):
        lob_match.process_stream(empty_book(2, 8, 9, cuda_device), msgs)
    with pytest.raises(ValueError, match="msgs.kind"):
        lob_match.process_stream(empty_book(2, 8, 4, cuda_device),
                                 msgs._replace(kind=msgs.kind.to(torch.int64)))
