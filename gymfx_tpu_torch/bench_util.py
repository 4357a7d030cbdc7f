"""Measuring helpers: the port of ``gymfx_tpu/bench_util.py``'s
``measure_train_step`` (:70), ``measure_train_many`` (:88),
``measure_phase_split`` (:110), ``stamp_comparability`` (:157) and
``mfu`` (:277), the parts the profiler's workload payload needs (the
benchmark's rows and ``emit_bench_record`` come with ROADMAP item 19).

On a CUDA device each helper times with CUDA events around the graph
replays (one ``synchronize`` at the end of a timed loop), on the CPU with
the host clock.  No XLA cost model exists here: the FLOPs each helper
returns are None, and :func:`mfu` takes the analytic count
(``telemetry/mfu.analytic_train_step_flops``).

A trainer's state on the card is donated: after a train step its tensors
ARE the update graph's static outputs, and every replay overwrites them
(``train/ppo.py`` ``train_step``).  So :func:`measure_phase_split`, which
the profiler runs in the middle of a training run, works from a clone of
the live state and copies the clone back into the live tensors when it
is done, and it draws from a copy of the state's generator: the run goes
on bitwise where it would have gone.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Optional

import torch

from gymfx_tpu_torch.core import graphs
from gymfx_tpu_torch.telemetry.mfu import hw_flops_peak


class _Clock:
    """Seconds between marks: CUDA events on a CUDA device (read after one
    synchronize), the host clock elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self):
        """The intervals between consecutive marks."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def _device(state) -> torch.device:
    return state.generator.device


def _generator_copy(generator: torch.Generator) -> torch.Generator:
    copy = torch.Generator(device=generator.device)
    copy.set_state(generator.get_state())
    return copy


def measure_train_step(trainer: Any, state: Any, iters: int):
    """One warm-up train step (on the card: its graphs captured), then
    ``iters`` timed ones.  Returns ``(seconds, None, final_state,
    trainer.train_step)``."""
    state, _ = trainer.train_step(state)
    clock = _Clock(_device(state))
    clock.mark()
    for _ in range(int(iters)):
        state, _ = trainer.train_step(state)
    clock.mark()
    return clock.seconds()[0], None, state, trainer.train_step


def measure_train_many(trainer: Any, state: Any, dispatches: int, k: int):
    """:func:`measure_train_step` for ``dispatches`` calls of
    ``train_many(state, k)``; divide the seconds by ``dispatches * k`` for
    a train step's time.  Returns ``(seconds, None, final_state, step)``."""

    def step(s):
        return trainer.train_many(s, int(k))

    state, _ = step(state)
    clock = _Clock(_device(state))
    clock.mark()
    for _ in range(int(dispatches)):
        state, _ = step(state)
    clock.mark()
    return clock.seconds()[0], None, state, step


def measure_phase_split(trainer: Any, state: Any, iters: int, data=None):
    """The rollout and update phases of ``iters`` train steps timed apart
    (``rollout_phase`` then ``update_phase``, each its graph's replay and
    the clone of its outputs on the card), after one untimed step, from a
    clone of ``state`` drawing from a copy of its generator; the live
    tensors get the clone's values back at the end, so a run measured in
    its middle goes on bitwise.  ``data`` is the tape of a curriculum's
    superstep.  Returns ``(rollout_seconds, update_seconds, final state
    of the measurement, None)``, or None for a trainer without phases."""
    if not (hasattr(trainer, "rollout_phase") and hasattr(trainer, "update_phase")):
        return None
    live = [x for x in state if not isinstance(x, torch.Generator)]
    saved = graphs.clone_tree(live)
    extra = () if data is None else (data,)
    s = state._replace(generator=_generator_copy(state.generator))
    # the cyclic collector held off while timing: a pause of the host
    # between two events would count as the card's time
    gc.collect()
    gc.disable()
    try:
        inter, rollout_out = trainer.rollout_phase(s, *extra)
        s, _ = trainer.update_phase(inter, rollout_out, *extra)
        clock = _Clock(_device(state))
        clock.mark()
        for _ in range(int(iters)):
            inter, rollout_out = trainer.rollout_phase(s, *extra)
            clock.mark()
            s, _ = trainer.update_phase(inter, rollout_out, *extra)
            clock.mark()
        spans = clock.seconds()
    finally:
        gc.enable()
        graphs.copy_tree(live, saved)
    return sum(spans[0::2]), sum(spans[1::2]), s, None


def stamp_comparability(record: dict, device: Any = None) -> dict:
    """Stamp ``platform`` ("gpu" or "cpu"), ``device_kind`` (the card's
    name) and ``comparable`` (False on the CPU unless the caller decided)."""
    try:
        dev = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
        if dev.type == "cuda":
            platform, kind = "gpu", torch.cuda.get_device_name(dev)
        else:
            platform, kind = dev.type, dev.type
    except Exception:
        platform = kind = "unknown"
    record.setdefault("platform", platform)
    record.setdefault("device_kind", kind)
    record.setdefault("comparable", record["platform"] not in ("cpu", "unknown"))
    return record


def mfu(flops_per_iter: Optional[float], iters: int, seconds: float,
        device: Any) -> Optional[float]:
    """Achieved over peak FLOPs, or None when either is unknown (the peak
    is ``telemetry/mfu.hw_flops_peak``'s: None off the H100)."""
    peak = hw_flops_peak(device)
    if not (flops_per_iter and peak and seconds > 0):
        return None
    return (flops_per_iter * iters / seconds) / peak
