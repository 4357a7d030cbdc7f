"""K5: a message stream matched through one fixed-capacity book per env.

Replaces ``gymfx_tpu/ops/lob_match.py::fused_process_stream`` (pallas
body ``_stream_kernel``).  The kernel is ``lob_stream_kernel`` in
``csrc/lob_kernels.cu``: one warp per book, the whole book in registers
for the whole stream (lane l holds levels l and l + 32 with their queues
and kept lot sums), a best-first walk of warp reductions per match, exact
int32 (see the source for its design).  It is instantiated for 1 or 2
levels a lane and 1-8 slots.  Its plain version is
``lob/book.py::process_stream``, the argsort engine looped over
messages; ``ops/cases.lob_stream_emulated`` models the kernel's
algorithm on the CPU.  Like the Pallas kernel, the plain version matches
both halves of the book for every message (the half it does not take
from with a take of 0); where lots near 2^31 wrap int32 sums, that take
of 0 can fill, so there the kernel and the plain version equal the
Pallas kernel and not the JAX package's argsort engine.

The kernel equals the plain version on books that hold what every book
built from ``empty_book`` by these operations holds, and relies on it:

- the levels with a nonzero price hold distinct prices;
- queues are front-compacted, with slot quantities >= 0;
- every empty slot holds oid 0;
- a level whose lots are 0 holds price 0.

:func:`process_stream` dispatches by device: a CPU book runs the plain
version; a CUDA book launches the kernel or raises.  The kernel takes
depths up to 64 levels and queues up to 8 slots (``NotImplementedError``
beyond).  It returns the final books and the (B, M) fill records; the
kernel writes every record, as the Pallas kernel does, though the venue
reads only the books.
"""
from __future__ import annotations

from typing import Tuple

import torch

from gymfx_tpu_torch.lob import book as book_mod
from gymfx_tpu_torch.lob.book import BookState, FillRecord, Messages
from gymfx_tpu_torch.ops import _build

FILL_COLS = len(FillRecord._fields)
MAX_DEPTH, MAX_SLOTS = 64, 8


def process_stream_plain(book: BookState, msgs: Messages) -> Tuple[BookState, FillRecord]:
    """Plain version of K5: ``book.process_stream``."""
    return book_mod.process_stream(book, msgs)


def process_stream(book: BookState, msgs: Messages) -> Tuple[BookState, FillRecord]:
    """(B, D) / (B, D, Q) books and (B, M) message streams -> (final
    books, (B, M) fill records): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    device = book.bid_qty.device
    if device.type == "cpu":
        return process_stream_plain(book, msgs)
    if device.type != "cuda":
        raise ValueError(f"process_stream: unsupported device {device}")
    b, d, q = book.bid_qty.shape
    m = msgs.kind.shape[-1]
    if not (1 <= d <= MAX_DEPTH and 1 <= q <= MAX_SLOTS):
        raise NotImplementedError(
            f"process_stream: the K5 kernel takes depth 1-{MAX_DEPTH} and queue slots "
            f"1-{MAX_SLOTS}, got depth {d} and {q} slots"
        )
    i32 = torch.int32
    for name, t in zip(BookState._fields, book):
        shape = (b, d) if name.endswith("price") else (b, d, q)
        _build.require(t, f"process_stream: book.{name}", i32, shape, device)
    for name, t in zip(Messages._fields, msgs):
        _build.require(t, f"process_stream: msgs.{name}", i32, (b, m), device)
    out = BookState(*(torch.empty_like(t) for t in book))
    fills = torch.empty((b, m, FILL_COLS), dtype=i32, device=device)
    if b:
        lib = _build.load_library("lob")
        ptrs = _build.pointer_array([*book, *msgs, *out, fills])
        if len(ptrs) != lib.gymfx_lob_pointer_count():
            raise RuntimeError("process_stream: pointer layout does not match the kernel source")
        _build.check_launch(
            lib.gymfx_lob_stream(ptrs, b, d, q, m, torch.cuda.current_stream(device).cuda_stream),
            "process_stream",
        )
        process_stream.launches += 1
    return out, FillRecord(*fills.unbind(-1))


process_stream.launches = 0
