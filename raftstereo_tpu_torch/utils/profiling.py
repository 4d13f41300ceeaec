"""``LatencyHistogram``: a fixed-bucket latency histogram with percentile
summaries, the port's own copy of the JAX package's
(``raftstereo_tpu/utils/profiling.py``), which the evaluator fills."""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Optional, Sequence, Tuple


def _log_spaced_bounds(lo: float, hi: float,
                       per_decade: int) -> Tuple[float, ...]:
    """Ascending bucket upper bounds, ``per_decade`` per factor of 10."""
    n = int(math.ceil(math.log10(hi / lo) * per_decade)) + 1
    return tuple(lo * 10 ** (i / per_decade) for i in range(n))


class LatencyHistogram:
    """Fixed-bucket histogram with percentile summaries, O(1) per
    observation.  Default buckets are log-spaced (5 per decade) from
    100 us to 60 s.  Percentiles interpolate linearly inside the
    containing bucket (clamped to the observed min/max).  Thread-safe."""

    def __init__(self, bounds: Optional[Sequence[float]] = None,
                 lo: float = 1e-4, hi: float = 60.0, per_decade: int = 5):
        self.bounds: Tuple[float, ...] = (
            tuple(sorted(bounds)) if bounds is not None
            else _log_spaced_bounds(lo, hi, per_decade))
        self._lock = threading.Lock()
        # One count per bound plus the +Inf overflow bucket.
        self._counts = [0] * (len(self.bounds) + 1)  # guarded_by: _lock
        self._count = 0  # guarded_by: _lock
        self._sum = 0.0  # guarded_by: _lock
        self._min = math.inf  # guarded_by: _lock
        self._max = -math.inf  # guarded_by: _lock

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def _snapshot(self):
        with self._lock:
            return (list(self._counts), self._count, self._sum,
                    self._min, self._max)

    def _percentile_from(self, counts, n, vmin, vmax, q: float) -> float:
        if not n:
            return float("nan")
        rank = q / 100.0 * n
        cum = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            if cum + c >= rank:
                lower = self.bounds[i - 1] if i > 0 else vmin
                upper = self.bounds[i] if i < len(self.bounds) else vmax
                v = lower + (rank - cum) / c * (upper - lower)
                return min(max(v, vmin), vmax)
            cum += c
        return vmax

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (q in [0, 100]); NaN when empty."""
        counts, n, _, vmin, vmax = self._snapshot()
        return self._percentile_from(counts, n, vmin, vmax, q)

    def summary(self) -> Dict[str, float]:
        counts, n, total, vmin, vmax = self._snapshot()
        if not n:
            return {"count": 0}
        return {"count": n, "total": total, "mean": total / n,
                "min": vmin, "max": vmax,
                **{f"p{q}": self._percentile_from(counts, n, vmin, vmax, q)
                   for q in (50, 90, 99)}}
