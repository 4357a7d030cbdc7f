"""Device-resident session carry: the serving slot cache, the port of
``gymfx_tpu/serve/slots.py`` (:46-280).

The host-carry serving path (engine.decide_batch) uploads every
session's recurrent carry from the host on every dispatch and fetches
the updated carry back — two full carry transfers per decision.  With
``serve_session_slots`` set, carry never leaves the device: it lives in
pre-allocated ``[slots + 2, ...]`` device tensors owned by this cache,
and each dispatch passes only a gather/scatter index vector.  The
engine's fused gather→policy→scatter CUDA graph (captured per ladder
bucket, ``InferenceEngine.enable_slots``) reads the rows with
``index_select`` and writes them in place with ``index_copy_``.

Row layout of every state leaf (leading dimension ``slots + 2``)::

    0 .. slots-1   session slots, LRU-allocated by this cache
    slots          INITIAL — pristine initial carry; gather source for
                   fresh/sessionless rows, NEVER a scatter target
    slots+1        SCRATCH — scatter sink for pad rows and sessionless
                   rows, NEVER a gather source (duplicate scatters into
                   it are harmless because nothing reads it)

Because INITIAL is never written and SCRATCH never read, a dispatch is
bitwise equivalent to the host-carry path row by row in ``exact`` batch
mode: the gathered carry rows feed the identical per-row program.

The state tensors are the graphs' static inputs, so they are allocated
once and never replaced: :meth:`SlotCache.reset` and
:meth:`SlotCache.adopt` write into them with ``copy_`` where the JAX
package rebinds its functional state arrays.

The **host mirror** is the failover contract: when enabled, every
resolved dispatch also fetches the fresh carry rows (copied to pinned
host memory on the engine's stream with the decision outputs, so it
costs no extra device sync) and records them per session.  The mirror
is at most ONE unresolved dispatch stale.  Evicting a session drops its
mirror entry too: an evicted session restarts from the initial carry
everywhere, never from a stale row.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gymfx_tpu_torch import resolve_device
from gymfx_tpu_torch.resilience.guards import tree_leaves, tree_map


class SlotCache:
    """Fixed-capacity LRU slot allocator + device state + host mirror.

    The cache owns the device state tree and the session→slot table;
    the engine owns the fused executables and calls :meth:`assign`
    under its dispatch lock (which serializes all slot dispatches, so
    the table can never race a dispatch).  The mirror has its own lock
    because :meth:`update_mirror` runs at resolve time, possibly while
    the next dispatch is being assigned.
    """

    def __init__(self, n_slots: int, carry0: Any, *, mirror: bool = True,
                 device=None):
        if int(n_slots) < 1:
            raise ValueError(f"serve_session_slots must be >= 1, got {n_slots}")
        self.slots = int(n_slots)
        self.initial_row = self.slots
        self.scratch_row = self.slots + 1
        self._carry0 = tree_map(lambda x: torch.as_tensor(x).detach().cpu(), carry0)
        if not tree_leaves(self._carry0):
            raise ValueError(
                "SlotCache needs a recurrent carry (stateless policies "
                "have nothing to cache)"
            )
        self.device = resolve_device(device)
        self.mirror_enabled = bool(mirror)
        self.lock = threading.RLock()
        self.state = tree_map(
            lambda x: torch.empty((self.slots + 2, *x.shape), dtype=x.dtype, device=self.device),
            self._carry0,
        )
        self._fill_initial()
        self._table: "OrderedDict[str, int]" = OrderedDict()  # session -> slot
        self._free: List[int] = list(range(self.slots))
        self._mirror: Dict[str, Any] = {}
        self.evictions = 0      # LRU slot evictions (session restarts)
        self.seeded = 0         # slots seeded from a host carry (failover)
        self.assigned = 0       # sessions newly given a slot
        self.hits = 0           # rows served from a live slot
        self.adoptions = 0      # blue/green handoffs received

    def _fill_initial(self) -> None:
        """Every row of the state to the initial carry, in place (the
        tensors are the engine graphs' static inputs)."""
        for s, c in zip(tree_leaves(self.state), tree_leaves(self._carry0)):
            s.copy_(c.to(s.device).expand_as(s))

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        with self.lock:
            return len(self._table)

    def sessions(self) -> List[str]:
        with self.lock:
            return list(self._table)

    def slot_of(self, session: str) -> Optional[int]:
        with self.lock:
            return self._table.get(str(session))

    def mirror_carry(self, session: str) -> Any:
        """Last mirrored carry for ``session`` (None if never mirrored
        or evicted since) — at most one unresolved dispatch stale."""
        with self.lock:
            return self._mirror.get(str(session))

    def mirror_snapshot(self) -> List[Tuple[str, Any]]:
        """The failover handoff: every resident session's mirrored
        carry.  The fleet records these into the SessionStateStore so a
        surviving replica seeds its slots from them."""
        with self.lock:
            return list(self._mirror.items())

    def stats(self) -> Dict[str, int]:
        with self.lock:
            return {
                "slots": self.slots,
                "resident": len(self._table),
                "evictions": self.evictions,
                "seeded": self.seeded,
                "assigned": self.assigned,
                "hits": self.hits,
                "adoptions": self.adoptions,
                "mirrored": len(self._mirror),
            }

    # ------------------------------------------------------------------
    def assign(
        self,
        bucket: int,
        sessions: Sequence[Optional[str]],
        seed_carries: Optional[Sequence[Any]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, List[Tuple[int, Any]]]:
        """Map one dispatch's rows to slot indices.

        Returns ``(gather_idx, scatter_idx, seeds)`` — int64 host vectors of
        length ``bucket`` (pad rows gather INITIAL, scatter SCRATCH) and
        the ``(slot, host_carry)`` uploads the engine must apply to
        ``state`` BEFORE dispatching.  Rules:

        * a session already in the table gathers and scatters its slot
          (any provided seed carry is ignored — the slot is
          authoritative);
        * a new session is allocated a slot (LRU eviction when full;
          the evicted session — never one from this batch — restarts
          from initial carry on its next decision, and its mirror entry
          is dropped), gathering from the seed upload when one is given
          (the failover re-pin path) else from INITIAL;
        * sessionless rows gather INITIAL and scatter SCRATCH.

        Sessions must be unique within a dispatch and at most ``slots``
        distinct (the micro-batcher defers surplus rows to the next
        micro-batch; direct callers get a ValueError).
        """
        n = len(sessions)
        if n > int(bucket):
            raise ValueError(f"{n} rows do not fit bucket {bucket}")
        gather = np.full(int(bucket), self.initial_row, np.int64)
        scatter = np.full(int(bucket), self.scratch_row, np.int64)
        seeds: List[Tuple[int, Any]] = []
        with self.lock:
            live = [s for s in sessions if s is not None]
            batch_sessions = set(live)
            if len(batch_sessions) != len(live):
                raise ValueError(
                    "duplicate session in one slot dispatch — a session's "
                    "decisions are serial by contract (the micro-batcher "
                    "defers duplicates to the next micro-batch)"
                )
            if len(batch_sessions) > self.slots:
                raise ValueError(
                    f"{len(batch_sessions)} distinct sessions exceed the "
                    f"{self.slots} configured serve_session_slots"
                )
            for i, sess in enumerate(sessions):
                if sess is None:
                    continue
                slot = self._table.get(sess)
                if slot is None:
                    slot = self._allocate(batch_sessions)
                    self._table[sess] = slot
                    self.assigned += 1
                    seed = None if seed_carries is None else seed_carries[i]
                    if seed is not None:
                        seeds.append((slot, seed))
                        self.seeded += 1
                        gather[i] = slot  # reads the seeded carry
                    # else: gather stays INITIAL (fresh session)
                else:
                    self._table.move_to_end(sess)
                    self.hits += 1
                    gather[i] = slot
                scatter[i] = slot
        return torch.from_numpy(gather), torch.from_numpy(scatter), seeds

    def _allocate(self, batch_sessions: set) -> int:
        if self._free:
            return self._free.pop()
        victim = next(
            (s for s in self._table if s not in batch_sessions), None
        )
        if victim is None:  # unreachable given the distinct<=slots gate
            raise ValueError("no evictable slot (all held by this batch)")
        slot = self._table.pop(victim)
        self._mirror.pop(victim, None)
        self.evictions += 1
        return slot

    def update_mirror(
        self, sessions: Sequence[Optional[str]], carry_rows: Any
    ) -> None:
        """Record the fetched post-decision carry rows per session.
        Sessions evicted since the dispatch was issued are skipped —
        their restart-from-initial semantics must not be shadowed by a
        late mirror write."""
        if not self.mirror_enabled:
            return
        with self.lock:
            for i, sess in enumerate(sessions):
                if sess is None or sess not in self._table:
                    continue
                self._mirror[sess] = tree_map(lambda x, i=i: x[i], carry_rows)

    def drop(self, session: str) -> bool:
        """Release a session's slot (and mirror entry) back to the free
        list — its next decision restarts from initial carry."""
        with self.lock:
            slot = self._table.pop(str(session), None)
            if slot is None:
                return False
            self._free.append(slot)
            self._mirror.pop(str(session), None)
            return True

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Drop every session and re-initialize the device state to the
        initial carry (fresh boot semantics)."""
        with self.lock:
            self._fill_initial()
            self._table = OrderedDict()
            self._free = list(range(self.slots))
            self._mirror = {}

    def adopt(self, other: "SlotCache") -> None:
        """Blue/green handoff: take over ``other``'s device state,
        session table and mirror wholesale (the newly-active engine
        keeps serving every resident session's carry bitwise), leaving
        ``other`` reset.  Both caches must be the same capacity and
        carry structure (same policy family).  Call only while the
        batcher worker is parked: no dispatch may be in flight on either
        engine.  The state is copied into this cache's tensors (the
        graphs' static inputs), not rebound."""
        if other is self:
            return
        if other.slots != self.slots:
            raise ValueError(
                f"slot capacity mismatch: {self.slots} vs {other.slots}"
            )
        with self.lock:
            with other.lock:
                for s, o in zip(tree_leaves(self.state), tree_leaves(other.state)):
                    s.copy_(o)
                self._table = other._table
                self._free = other._free
                self._mirror = other._mirror
                self.adoptions += 1
                other._fill_initial()
                other._table = OrderedDict()
                other._free = list(range(other.slots))
                other._mirror = {}
