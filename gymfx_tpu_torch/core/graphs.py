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

import ctypes
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


# CUgraphNodeType values of the nodes a replay's trace records
_TRACED_NODE_TYPES = (0, 1, 2)  # kernel, memcpy, memset


def capturing_graph_nodes(stream) -> Optional[int]:
    """The kernel, memcpy and memset nodes of the graph ``stream`` is
    capturing, through the driver API (``cuStreamGetCaptureInfo_v2``,
    ``cuGraphGetNodes``, ``cuGraphNodeGetType``): a profiler trace of one
    replay holds a record for each, so a trace that holds fewer lost some.
    None where the driver cannot say."""
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
        status, capture_id = ctypes.c_int(), ctypes.c_uint64()
        graph, deps, n_deps = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t()
        if cuda.cuStreamGetCaptureInfo_v2(
                ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status),
                ctypes.byref(capture_id), ctypes.byref(graph), ctypes.byref(deps),
                ctypes.byref(n_deps)) != 0 or not graph.value:
            return None
        count = ctypes.c_size_t(0)
        if cuda.cuGraphGetNodes(graph, None, ctypes.byref(count)) != 0:
            return None
        nodes = (ctypes.c_void_p * count.value)()
        if cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(count)) != 0:
            return None
        kind, traced = ctypes.c_int(), 0
        for node in nodes:
            if cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
                return None
            traced += kind.value in _TRACED_NODE_TYPES
        return traced
    except (OSError, AttributeError):
        return None


class PhaseGraph:
    """``body(inputs) -> outputs`` over the static buffers ``inputs`` (a
    tree the owner made: its own copies, or tensors it shares with another
    graph), captured at construction on a CUDA device with ``generator``
    registered.  ``capture_s`` is the seconds of the warm-up and the
    capture (0 on the CPU).  ``capture_error_mode`` is
    ``torch.cuda.graph``'s: ``"thread_local"`` lets other threads use the
    card while this one captures (the serving engine captures beside a
    batcher thread that replays and synchronizes).  A graph with a
    ``name`` reports its capture to the active compile watch
    (``telemetry/compile_watch.py``) as ``(name, signature of inputs)``."""

    def __init__(self, body: Callable[[Any], Any], inputs: Any,
                 generator: Optional[torch.Generator] = None,
                 capture_error_mode: str = "global", name: Optional[str] = None):
        self.body, self.inputs = body, inputs
        self.outputs = None
        self.graph = None
        # the captured graph's kernel, memcpy and memset nodes: the records
        # a profiler trace of one replay holds (None where not captured)
        self.nodes = None
        self.capture_s = 0.0
        self.capture_error_mode = capture_error_mode
        if _tensor_leaves(inputs)[0].device.type == "cuda":
            t0 = time.perf_counter()
            self._capture(generator)
            self.capture_s = time.perf_counter() - t0
            if name is not None:
                from gymfx_tpu_torch.telemetry import compile_watch

                watch = compile_watch.active()
                if watch is not None:
                    watch.record_capture(name, body, signature(inputs), self.capture_s)

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
                self.nodes = capturing_graph_nodes(torch.cuda.current_stream())
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
