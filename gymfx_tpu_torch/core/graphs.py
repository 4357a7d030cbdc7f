"""The train step's phases as CUDA graphs: the port's ``jax.jit(...,
donate_argnums=0)`` (``gymfx_tpu/train/ppo.py:227``).

A :class:`PhaseGraph` holds a body function, its static input buffers
and its static outputs.  Its owner builds one for each static signature
(the cache key: shapes, dtypes, the config, the tape's identity, the
hooks in use; :func:`signature` gives the tensor part) and keeps it.
Each call copies the caller's inputs into the static input buffers with
``copy_`` (an input that already is the buffer is not copied), runs the
body's work, and hands back the static outputs, which the next call
overwrites.

On a CUDA device the body runs :data:`WARMUP` times on a side stream
(PyTorch's warm-up recipe: every cached launch plan, cuBLAS workspace and
shared-memory opt-in is settled there, never for the first time under
capture), then once under ``torch.cuda.graph`` into the graph's private
memory pool, with Python's cyclic garbage collector run first and held
off during the capture (it would destroy an unreachable graph mid-
capture, which invalidates the capture), with the owner's ``torch.Generator`` registered with the
graph, so that every replay draws from that generator's state at replay
time and advances it as the eager body would.  A capture error raises;
nothing retries eagerly.  On the CPU nothing is captured: each call runs
the body and copies what it returns into the first call's outputs, so the
CPU tests see the same static-buffer semantics.

This module imports on a machine without CUDA; it touches the card only
when a graph is built there.
"""
from __future__ import annotations

import gc
import time
from collections import defaultdict
from typing import Any, Callable, Optional

import torch

from gymfx_tpu_torch.resilience.guards import tree_leaves, tree_map

WARMUP = 3


def _tensor_leaves(tree: Any):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def signature(tree: Any) -> tuple:
    """The static part of a tree of tensors: each leaf's shape, dtype and
    device (a dict's keys sorted), and every non-tensor leaf as it is."""
    return tuple((tuple(x.shape), x.dtype, x.device.type) if isinstance(x, torch.Tensor) else x
                 for x in tree_leaves(tree))


def clone_tree(tree: Any) -> Any:
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def copy_tree(dst: Any, src: Any) -> None:
    """``dst`` leaf by leaf from ``src`` (trees of one structure), one
    ``torch._foreach_copy_`` a group of like dtypes and devices; a leaf
    that is its own source is skipped."""
    groups = defaultdict(lambda: ([], []))
    for d, s in zip(_tensor_leaves(dst), _tensor_leaves(src)):
        if d is not s:
            group = groups[(d.dtype, d.device, s.dtype, s.device)]
            group[0].append(d)
            group[1].append(s)
    for dsts, srcs in groups.values():
        torch._foreach_copy_(dsts, srcs)


class PhaseGraph:
    """``body(inputs) -> outputs`` over the static buffers ``inputs`` (a
    tree the owner made: its own copies, or tensors it shares with another
    graph), captured at construction on a CUDA device with ``generator``
    registered.  ``capture_s`` is the seconds of the warm-up and the
    capture (0 on the CPU).  ``capture_error_mode`` is
    ``torch.cuda.graph``'s: ``"thread_local"`` lets other threads use the
    card while this one captures (the serving engine captures beside a
    batcher thread that replays and synchronizes)."""

    def __init__(self, body: Callable[[Any], Any], inputs: Any,
                 generator: Optional[torch.Generator] = None,
                 capture_error_mode: str = "global"):
        self.body, self.inputs = body, inputs
        self.outputs = None
        self.graph = None
        self.capture_s = 0.0
        self.capture_error_mode = capture_error_mode
        if _tensor_leaves(inputs)[0].device.type == "cuda":
            t0 = time.perf_counter()
            self._capture(generator)
            self.capture_s = time.perf_counter() - t0

    def _capture(self, generator) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.body(self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        # a CUDA graph that dies in a reference cycle is destroyed by the
        # cyclic collector, and destroying one while a stream captures
        # invalidates the capture (torch.cuda.graph no longer collects
        # first): collect before, and keep the collector off during it
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode=self.capture_error_mode):
                self.outputs = self.body(self.inputs)
        finally:
            gc.enable()
        torch.cuda.synchronize()
        self.graph = graph

    def __call__(self, inputs: Any = None) -> Any:
        """Copy ``inputs`` (a tree shaped as the static inputs; None keeps
        them as they are) into the static buffers, run, and return the
        static outputs."""
        if inputs is not None:
            copy_tree(self.inputs, inputs)
        if self.graph is not None:
            self.graph.replay()
        elif self.outputs is None:
            self.outputs = self.body(self.inputs)
        else:
            copy_tree(self.outputs, self.body(self.inputs))
        return self.outputs
