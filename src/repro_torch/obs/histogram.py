"""Fixed-bucket log-scale latency histograms with exact merge algebra.

PyTorch package twin of ``repro.obs.histogram``, with the same buckets,
so a ``to_dict`` of either package loads with the other's ``from_dict``
and reads the same quantiles (``tests/test_torch_obs.py``).

The serve loop needs live p50/p95/p99/p99.9 for several traffic classes
(cached vs. uncached gR-Txs, gRW commits, CP drains) without storing raw
samples. A log-scale fixed-bucket histogram gives bounded relative error:
with ``buckets_per_decade = 16`` every bucket spans a ratio of
``10**(1/16) ~ 1.155``, so any quantile read off the histogram is within
~15% (one bucket) of the true sample quantile — far below the
run-to-run noise of wall-clock on shared hardware.

Merging is exact: two histograms with the same bucket spec merge by
adding counts, so ``merge(h1, h2)`` holds *exactly* the histogram that
would have been built from the concatenated sample streams. That makes
per-owner / per-batch histograms composable into run totals with no
approximation beyond the shared bucketing.

Quantiles use the weighted inverted-CDF rule (smallest bucket whose
cumulative count reaches ``q * total``) and report the bucket's
geometric midpoint, keeping the estimate within half a bucket of any
sample in that bucket.
"""

from __future__ import annotations

import math

import numpy as np

# Default range covers sub-microsecond device dispatch up to 100 s
# stalls; values outside clamp into the edge buckets.
DEFAULT_LO = 1e-7
DEFAULT_HI = 1e2
DEFAULT_BUCKETS_PER_DECADE = 16

REPORT_QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99),
                    ("p999", 0.999))


class LatencyHistogram:
    """Streaming latency histogram over log-spaced buckets (seconds)."""

    __slots__ = ("lo", "hi", "buckets_per_decade", "n_buckets", "counts",
                 "sum_seconds", "_log_lo", "_inv_log_width")

    def __init__(self, lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                 buckets_per_decade: int = DEFAULT_BUCKETS_PER_DECADE):
        if not (0.0 < lo < hi):
            raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
        if buckets_per_decade < 1:
            raise ValueError("buckets_per_decade must be >= 1")
        self.lo = float(lo)
        self.hi = float(hi)
        self.buckets_per_decade = int(buckets_per_decade)
        decades = math.log10(self.hi / self.lo)
        self.n_buckets = max(1, int(math.ceil(decades * buckets_per_decade)))
        self.counts = np.zeros(self.n_buckets, dtype=np.int64)
        self.sum_seconds = 0.0
        self._log_lo = math.log10(self.lo)
        self._inv_log_width = float(self.buckets_per_decade)

    # -- bucket spec ------------------------------------------------------

    @property
    def spec(self) -> tuple[float, float, int]:
        return (self.lo, self.hi, self.buckets_per_decade)

    @property
    def resolution(self) -> float:
        """Width of one bucket as a ratio (adjacent bucket edges)."""
        return 10.0 ** (1.0 / self.buckets_per_decade)

    def _index(self, seconds: float) -> int:
        if seconds <= self.lo:
            return 0
        i = int((math.log10(seconds) - self._log_lo) * self._inv_log_width)
        return min(i, self.n_buckets - 1)

    # -- recording --------------------------------------------------------

    def record(self, seconds: float, weight: int = 1) -> None:
        if weight <= 0:
            return
        self.counts[self._index(float(seconds))] += weight
        self.sum_seconds += float(seconds) * weight

    def record_many(self, seconds, weights=None) -> None:
        a = np.asarray(seconds, dtype=np.float64).reshape(-1)
        if a.size == 0:
            return
        w = (np.ones(a.size, dtype=np.int64) if weights is None
             else np.asarray(weights, dtype=np.int64).reshape(-1))
        clipped = np.clip(a, self.lo, None)
        idx = ((np.log10(clipped) - self._log_lo) * self._inv_log_width)
        idx = np.clip(idx.astype(np.int64), 0, self.n_buckets - 1)
        np.add.at(self.counts, idx, w)
        self.sum_seconds += float(np.dot(a, w))

    # -- merge algebra ----------------------------------------------------

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Exact merge: counts add. Requires identical bucket specs."""
        if self.spec != other.spec:
            raise ValueError(
                f"cannot merge histograms with different bucket specs: "
                f"{self.spec} vs {other.spec}")
        out = LatencyHistogram(self.lo, self.hi, self.buckets_per_decade)
        out.counts = self.counts + other.counts
        out.sum_seconds = self.sum_seconds + other.sum_seconds
        return out

    def merge_in(self, other: "LatencyHistogram") -> "LatencyHistogram":
        if self.spec != other.spec:
            raise ValueError(
                f"cannot merge histograms with different bucket specs: "
                f"{self.spec} vs {other.spec}")
        self.counts += other.counts
        self.sum_seconds += other.sum_seconds
        return self

    # -- reading ----------------------------------------------------------

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    @property
    def mean(self) -> float:
        n = self.count
        return self.sum_seconds / n if n else float("nan")

    def _bucket_mid(self, i: int) -> float:
        # geometric midpoint of bucket i: lo * res^(i + 0.5)
        return self.lo * 10.0 ** ((i + 0.5) / self.buckets_per_decade)

    def quantile(self, q: float) -> float:
        """Inverted-CDF quantile (seconds); NaN when empty."""
        total = self.count
        if total == 0:
            return float("nan")
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"quantile out of range: {q}")
        target = q * total
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, max(target, 1), side="left"))
        return self._bucket_mid(min(i, self.n_buckets - 1))

    def percentiles(self) -> dict:
        """The report shape: p50/p95/p99/p999 (+ count, mean)."""
        out = {name: self.quantile(q) for name, q in REPORT_QUANTILES}
        out["count"] = self.count
        out["mean"] = self.mean if self.count else None
        return out

    # -- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "lo": self.lo,
            "hi": self.hi,
            "buckets_per_decade": self.buckets_per_decade,
            "counts": self.counts.tolist(),
            "sum_seconds": self.sum_seconds,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyHistogram":
        h = cls(d["lo"], d["hi"], d["buckets_per_decade"])
        counts = np.asarray(d["counts"], dtype=np.int64)
        if counts.shape != h.counts.shape:
            raise ValueError("counts length does not match bucket spec")
        h.counts = counts
        h.sum_seconds = float(d["sum_seconds"])
        return h
