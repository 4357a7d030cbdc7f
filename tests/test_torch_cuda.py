"""The port's CUDA kernels K1-K3 against their plain versions, on the card.

Each case launches a kernel and its plain PyTorch version on the same
CUDA tensors and requires ``torch.equal`` (the kernels are built with
-fmad=false and IEEE division, so the f32 results are the same bits).
Every test needs an NVIDIA GPU and skips without one.  This file imports
no JAX, so it also runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest
import torch

from gymfx_tpu_torch.core.types import EnvConfig, initial_state
from gymfx_tpu_torch.ops import env_dynamics, window_zscore
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
