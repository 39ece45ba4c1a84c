"""Fixed-bucket log2 latency histogram.

The port's copy of jylis_tpu/obs/hist.py (:1-109), unchanged in
behaviour. 64 power-of-two nanosecond buckets: bucket 0 holds exact
zeros, bucket i (1..63) holds durations in [2^(i-1), 2^i) ns, with
everything past ~2^62 ns clamped into the last bucket. `record` is one
float->int conversion, one `int.bit_length`, and one list increment --
no allocation, no branching on the data.

Quantile queries walk the 64 buckets and report the matched bucket's
UPPER bound, so the reported value is within one bucket (a factor of
two) above the true sample.

Thread model: `record` fires from the event loop AND from worker
threads (threaded drains). The increments are plain GIL-interleaved
operations; a lost update under contention skews a count by one, the
price of keeping the hot path lock-free.
"""

from __future__ import annotations

N_BUCKETS = 64


class Histogram:
    __slots__ = ("buckets", "count", "total", "max")

    def __init__(self):
        self.buckets = [0] * N_BUCKETS
        self.count = 0
        self.total = 0.0  # seconds, for Prometheus summary _sum
        self.max = 0.0  # seconds

    def record(self, seconds: float) -> None:
        ns = int(seconds * 1e9)
        if ns < 0:  # clock hiccup: bucket as zero rather than crash
            ns = 0
        i = ns.bit_length()
        if i > N_BUCKETS - 1:
            i = N_BUCKETS - 1
        self.buckets[i] += 1
        self.count += 1
        self.total += seconds
        if seconds > self.max:
            self.max = seconds

    def percentile(self, q: float) -> float:
        """The q-quantile (0 < q <= 1) in SECONDS: the upper bound of
        the bucket holding the ceil(q * count)-th sample, 0.0 when
        empty."""
        return percentile_of(self.buckets, self.count, q)

    def snapshot(self) -> dict:
        """One consistent-enough view for the reporting surfaces:
        {count, sum_s, max_s, p50_s, p90_s, p99_s}."""
        return {
            "count": self.count,
            "sum_s": self.total,
            "max_s": self.max,
            "p50_s": self.percentile(0.50),
            "p90_s": self.percentile(0.90),
            "p99_s": self.percentile(0.99),
        }

    def mark(self) -> tuple:
        """A cheap point-in-time copy for windowed (delta-since-mark)
        quantiles: (buckets copy, count, total)."""
        return (list(self.buckets), self.count, self.total)

    def snapshot_since(self, marked: tuple) -> dict:
        """snapshot() over only the samples recorded AFTER ``marked``
        (a prior mark() of this histogram). Since-boot buckets are
        monotone, so the bucket-wise difference IS the window's
        histogram. No max_s: the since-boot max can't be windowed."""
        mbuckets, mcount, mtotal = marked
        buckets = [a - b for a, b in zip(self.buckets, mbuckets)]
        count = self.count - mcount
        return {
            "count": count,
            "sum_s": self.total - mtotal,
            "p50_s": percentile_of(buckets, count, 0.50),
            "p90_s": percentile_of(buckets, count, 0.90),
            "p99_s": percentile_of(buckets, count, 0.99),
        }


def percentile_of(buckets: list, count: int, q: float) -> float:
    """The quantile walk over an arbitrary bucket vector (shared by the
    live histogram and windowed bucket differences)."""
    if count <= 0:
        return 0.0
    target = q * count
    cum = 0
    for i, c in enumerate(buckets):
        cum += c
        if cum >= target:
            return 0.0 if i == 0 else float(1 << i) * 1e-9
    return float(1 << (N_BUCKETS - 1)) * 1e-9  # racing counts: clamp


def bucket_upper_seconds(i: int) -> float:
    """Bucket i's inclusive upper bound in seconds — the Prometheus
    ``le`` label for the cumulative `_bucket` exposition (bucket 0 is
    the exact-zero bucket; its bound is 0)."""
    return 0.0 if i == 0 else ((1 << i) - 1) * 1e-9
