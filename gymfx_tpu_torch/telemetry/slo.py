"""Rolling-window SLO accounting for the serving path (the port of
``gymfx_tpu/telemetry/slo.py``).

The bench/overload counters are run totals; operators page on RECENT
behavior.  :class:`SLOWindow` keeps per-request outcomes for the last
``window_s`` seconds and derives the serving SLO trio on demand —
``shed_rate``, ``deadline_miss_rate`` and served-latency ``p99`` —
which :func:`SLOWindow.register_gauges` exposes as callback gauges so a
``/metrics`` scrape always reads the live window.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Optional, Tuple

# the request outcomes the serving instruments report
OUTCOMES = ("served", "shed", "deadline_miss", "breaker_open", "failed")


class SLOWindow:
    def __init__(self, window_s: float = 60.0, *,
                 clock: Callable[[], float] = time.monotonic,
                 max_events: int = 100_000):
        if float(window_s) <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._clock = clock
        # (t, outcome, latency_s_or_None)
        self._events: Deque[Tuple[float, str, Optional[float]]] = deque(
            maxlen=int(max_events)
        )
        self._lock = threading.Lock()

    def observe(self, outcome: str, latency_s: Optional[float] = None) -> None:
        if outcome not in OUTCOMES:
            raise ValueError(
                f"outcome must be one of {OUTCOMES}, got {outcome!r}"
            )
        with self._lock:
            self._events.append((self._clock(), outcome, latency_s))

    def _prune_locked(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def rates(self) -> Dict[str, Any]:
        """Point-in-time SLO view over the trailing window."""
        now = self._clock()
        with self._lock:
            self._prune_locked(now)
            events = list(self._events)
        total = len(events)
        counts = {o: 0 for o in OUTCOMES}
        lat = []
        for _t, outcome, latency in events:
            counts[outcome] += 1
            if outcome == "served" and latency is not None:
                lat.append(latency)
        out: Dict[str, Any] = {
            "window_s": self.window_s,
            "requests": total,
            "shed_rate": counts["shed"] / total if total else 0.0,
            "deadline_miss_rate": (
                counts["deadline_miss"] / total if total else 0.0
            ),
            "p99_s": _percentile(lat, 99.0),
            "p50_s": _percentile(lat, 50.0),
        }
        out.update({f"{o}_count": c for o, c in counts.items()})
        return out

    def register_gauges(self, registry: Any,
                        prefix: str = "gymfx_serve_slo") -> None:
        specs = (
            ("shed_rate", "Requests shed over the trailing window",
             lambda r: r["shed_rate"]),
            ("deadline_miss_rate",
             "Requests past deadline over the trailing window",
             lambda r: r["deadline_miss_rate"]),
            ("p99_seconds",
             "p99 served-request latency over the trailing window",
             lambda r: r["p99_s"]),
            ("requests", "Requests observed in the trailing window",
             lambda r: float(r["requests"])),
            ("window_seconds", "Trailing window length",
             lambda r: r["window_s"]),
        )
        for suffix, help_text, pick in specs:
            g = registry.gauge(f"{prefix}_{suffix}", help_text)
            g.set_function(lambda p=pick: float(p(self.rates()) or 0.0))


def _percentile(values, q: float) -> float:
    """Nearest-rank percentile without numpy (telemetry stays
    import-light); 0.0 on an empty sample."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(0, min(len(ordered) - 1, int(round(q / 100.0 * len(ordered) + 0.5)) - 1))
    return float(ordered[rank])
