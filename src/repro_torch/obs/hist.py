"""Fixed-bucket log-scale latency histograms (DESIGN.md §13); the port's
own copy of ``repro.obs.hist``.

``LatencyHistogram`` yields p50/p95/p99 without retaining samples: counts
land in geometrically-spaced buckets, so memory is O(buckets) forever and
a reported percentile is correct to within one bucket's width (ratio
``2^(1/buckets_per_decade 3.32...)`` — ~15% relative at the default 16
per decade, which is plenty to tell a 2ms cache hit from a 200ms cold
execute).

Everything is host-side stdlib and internally locked: the serving thread
observes query/ingest latencies while the cleaner thread observes
increment latencies, and ``ServiceMetrics.snapshot`` reads percentiles
concurrently (DESIGN.md §9's metrics contract).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List


class LatencyHistogram:
    """Log-scale bucket histogram over seconds.

    Buckets span ``[lo, hi)`` with ``buckets_per_decade`` geometric
    buckets per power of ten, plus an underflow and an overflow bucket;
    ``count``/``total``/``max`` are tracked exactly, so means are not
    quantized — only percentiles are (to one bucket).
    """

    def __init__(self, lo: float = 1e-6, hi: float = 100.0,
                 buckets_per_decade: int = 16):
        if not (0.0 < lo < hi):
            raise ValueError("need 0 < lo < hi")
        if buckets_per_decade < 1:
            raise ValueError("buckets_per_decade must be >= 1")
        self.lo = lo
        self.hi = hi
        self._log_lo = math.log10(lo)
        self._scale = buckets_per_decade
        n = int(math.ceil((math.log10(hi) - self._log_lo) * buckets_per_decade))
        # counts[0] is underflow (< lo), counts[n + 1] overflow (>= hi)
        self._counts: List[int] = [0] * (n + 2)
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._lock = threading.Lock()

    def _bucket(self, seconds: float) -> int:
        if seconds < self.lo:
            return 0
        if seconds >= self.hi:
            return len(self._counts) - 1
        return 1 + int((math.log10(seconds) - self._log_lo) * self._scale)

    def _edge(self, bucket: int) -> float:
        """Upper edge of a bucket — what percentiles report, so the
        estimate never understates the true order statistic."""
        if bucket <= 0:
            return self.lo
        if bucket >= len(self._counts) - 1:
            return self.max if self.max > 0 else self.hi
        return 10.0 ** (self._log_lo + bucket / self._scale)

    def observe(self, seconds: float) -> None:
        """Record one latency sample (thread-safe)."""
        with self._lock:
            self._counts[self._bucket(seconds)] += 1
            self.count += 1
            self.total += seconds
            if seconds > self.max:
                self.max = seconds

    def percentile(self, q: float) -> float:
        """The smallest bucket upper edge covering the ``q``-th percentile
        (q in [0, 100]); 0.0 before any sample."""
        if not 0.0 <= q <= 100.0:
            raise ValueError("percentile must be in [0, 100]")
        with self._lock:
            if self.count == 0:
                return 0.0
            # the rank of the order statistic numpy's 'lower' method picks
            rank = int(q / 100.0 * (self.count - 1)) + 1
            seen = 0
            for bucket, c in enumerate(self._counts):
                seen += c
                if seen >= rank:
                    return self._edge(bucket)
            return self._edge(len(self._counts) - 1)  # pragma: no cover

    @property
    def mean(self) -> float:
        """Exact sample mean (not bucket-quantized)."""
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "LatencyHistogram") -> None:
        """Fold another histogram's counts in (bucket layouts must match —
        the per-host aggregation path for a sharded service)."""
        if (other.lo, other.hi, other._scale) != (self.lo, self.hi, self._scale):
            raise ValueError("cannot merge histograms with different buckets")
        with other._lock:
            counts = list(other._counts)
            count, total, mx = other.count, other.total, other.max
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self.count += count
            self.total += total
            self.max = max(self.max, mx)

    def snapshot(self) -> Dict[str, float]:
        """JSON-serializable summary: count, mean, p50/p95/p99, max."""
        return {
            "count": self.count,
            "mean_s": self.mean,
            "p50_s": self.percentile(50),
            "p95_s": self.percentile(95),
            "p99_s": self.percentile(99),
            "max_s": self.max,
        }
