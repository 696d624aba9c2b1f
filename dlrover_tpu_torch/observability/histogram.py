"""Mergeable log-bucketed latency histograms (HDR-histogram style).

The serving tier needs fleet-level percentiles at millions-of-users
scale, and percentiles do not average: p99 of a fleet is NOT the mean
of per-replica p99s. The only way to get an exact fleet percentile
without shipping every raw sample is to ship *mergeable* histograms —
fixed bucket boundaries, counts per bucket — and merge by adding
counts. That is what this module provides:

- **Fixed log2 geometry.** Bucket boundaries depend only on the
  histogram's ``(min_value, sub_bits)`` geometry, never on the data, so
  the bucket index of a value is a pure function of the value. Merging
  two histograms of the same geometry and histogramming the
  concatenated raw samples therefore yield *identical* bucket counts —
  the exactness property the fleet rollup relies on (pinned in
  ``tests/test_histogram.py``).
- **Bounded relative error.** Each octave (power of two) is split into
  ``2**sub_bits`` linear sub-buckets, bounding the relative quantile
  error at ``2**-(sub_bits+1)`` (~1.6 % at the default ``sub_bits=5``)
  across the full range — no truncation window, no per-call sort, O(1)
  record.
- **Lossless wire format.** ``to_dict``/``from_dict`` (and the
  ``to_json``/``from_json`` string wrappers) round-trip the sparse
  counts exactly, with string bucket keys so the envelope survives JSON.

Pure host-side Python, no jax import — safe from any thread and any
process tier (engine loop, router, master, offline healthcheck).

The port's copy of ``dlrover_tpu/observability/histogram.py``
(``LatencyHistogram``, ``merge_histograms``, ``histogram_delta``):
same geometry and wire format, so histograms from both packages merge.
"""

import json
import math
from typing import Dict, Iterable, Optional

__all__ = ["LatencyHistogram", "merge_histograms", "histogram_delta"]


class LatencyHistogram:
    """Fixed-geometry log2-bucketed histogram with exact merge.

    ``min_value`` is the resolution floor (values at or below it share
    bucket 0); with the default 1e-3 the unit is "milliseconds with
    microsecond floor". ``sub_bits`` sets sub-buckets per octave.
    """

    __slots__ = ("min_value", "sub_bits", "_sub", "counts", "n",
                 "total", "vmin", "vmax")

    def __init__(self, *, min_value: float = 1e-3, sub_bits: int = 5):
        if min_value <= 0.0:
            raise ValueError(f"min_value must be > 0, got {min_value}")
        if not (0 <= sub_bits <= 12):
            raise ValueError(f"sub_bits must be in [0, 12], got {sub_bits}")
        self.min_value = float(min_value)
        self.sub_bits = int(sub_bits)
        self._sub = 1 << self.sub_bits
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # ---- geometry --------------------------------------------------------

    def bucket_index(self, value: float) -> int:
        """Deterministic bucket of ``value`` — a pure function of the
        value and the geometry (this is what makes merge exact)."""
        x = value / self.min_value
        if not (x > 1.0):        # <= min_value, zero, negative, NaN
            return 0
        m, e = math.frexp(x)     # x = m * 2**e, m in [0.5, 1)
        sub = int((m - 0.5) * 2.0 * self._sub)
        if sub >= self._sub:     # fp round-up at the octave edge
            sub = self._sub - 1
        return 1 + (e - 1) * self._sub + sub

    def bucket_mid(self, idx: int) -> float:
        """Representative (midpoint) value of bucket ``idx``."""
        if idx <= 0:
            return self.min_value
        k = idx - 1
        e = k // self._sub + 1
        s = k % self._sub
        m_lo = 0.5 + s / (2.0 * self._sub)
        m_hi = 0.5 + (s + 1) / (2.0 * self._sub)
        return self.min_value * math.ldexp((m_lo + m_hi) / 2.0, e)

    # ---- recording -------------------------------------------------------

    def record(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        idx = self.bucket_index(v)
        self.counts[idx] = self.counts.get(idx, 0) + 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def clear(self) -> None:
        self.counts.clear()
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # ---- queries ---------------------------------------------------------

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (``q`` in [0, 100]) from bucket
        counts, clamped to the observed [min, max] so the bucket
        midpoint never reports a value outside what was recorded."""
        if self.n == 0:
            return 0.0
        rank = max(1, min(self.n, math.ceil(q / 100.0 * self.n)))
        cum = 0
        for idx in sorted(self.counts):
            cum += self.counts[idx]
            if cum >= rank:
                mid = self.bucket_mid(idx)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax  # unreachable: counts sum to n

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def summary(self) -> dict:
        """The scheduler's historical ``latency_ms()`` shape."""
        return {
            "p50": self.percentile(50.0),
            "p99": self.percentile(99.0),
            "n": self.n,
        }

    # ---- merge -----------------------------------------------------------

    def geometry(self) -> tuple:
        return (self.min_value, self.sub_bits)

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into self by adding bucket counts. Exact:
        equivalent to having recorded the union of both sample sets.
        Raises on geometry mismatch — silently merging histograms with
        different bucket boundaries would fabricate percentiles."""
        if other.geometry() != self.geometry():
            raise ValueError(
                f"histogram geometry mismatch: {other.geometry()} vs "
                f"{self.geometry()}"
            )
        for idx, c in other.counts.items():
            self.counts[idx] = self.counts.get(idx, 0) + c
        self.n += other.n
        self.total += other.total
        if other.n:
            self.vmin = min(self.vmin, other.vmin)
            self.vmax = max(self.vmax, other.vmax)
        return self

    def copy(self) -> "LatencyHistogram":
        h = LatencyHistogram(min_value=self.min_value, sub_bits=self.sub_bits)
        h.counts = dict(self.counts)
        h.n = self.n
        h.total = self.total
        h.vmin = self.vmin
        h.vmax = self.vmax
        return h

    # ---- wire format -----------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "v": 1,
            "min_value": self.min_value,
            "sub_bits": self.sub_bits,
            "n": self.n,
            "total": self.total,
            # inf min/max (empty hist) are not JSON — encode as None
            "min": self.vmin if self.n else None,
            "max": self.vmax if self.n else None,
            "counts": {str(k): v for k, v in sorted(self.counts.items())},
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "LatencyHistogram":
        h = cls(min_value=doc["min_value"], sub_bits=doc["sub_bits"])
        h.counts = {int(k): int(v) for k, v in doc.get("counts", {}).items()}
        h.n = int(doc.get("n", 0))
        h.total = float(doc.get("total", 0.0))
        h.vmin = float(doc["min"]) if doc.get("min") is not None else math.inf
        h.vmax = (
            float(doc["max"]) if doc.get("max") is not None else -math.inf
        )
        return h

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, line: str) -> "LatencyHistogram":
        return cls.from_dict(json.loads(line))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        s = self.summary()
        return (
            f"LatencyHistogram(n={self.n}, p50={s['p50']:.3g}, "
            f"p99={s['p99']:.3g})"
        )


def merge_histograms(
    hists: Iterable[LatencyHistogram],
) -> Optional[LatencyHistogram]:
    """Merge an iterable of same-geometry histograms into a fresh one
    (inputs untouched). Returns None for an empty iterable."""
    out: Optional[LatencyHistogram] = None
    for h in hists:
        if out is None:
            out = h.copy()
        else:
            out.merge(h)
    return out


def histogram_delta(
    cur: LatencyHistogram, prev: Optional[LatencyHistogram]
) -> LatencyHistogram:
    """The WINDOW between two snapshots of one lifetime histogram:
    ``cur``'s bucket counts minus ``prev``'s. Scheduler histograms only
    reset on ``reset_latencies``, so a controller that judges this
    window's p99 (the serving autoscaler's hysteresis-clear check)
    subtracts its previous snapshot rather than letting minutes of
    healthy history mask a fresh breach, or a cleared one.

    Counts of the window equal counts of the raw samples recorded
    between the snapshots. The window's vmin/vmax are not recoverable,
    so ``cur``'s lifetime extremes clamp its percentiles. ``prev`` of
    None (the first window) returns a copy of ``cur``. Raises on a
    geometry mismatch, as ``merge`` does."""
    if prev is None:
        return cur.copy()
    if prev.geometry() != cur.geometry():
        raise ValueError(
            f"histogram geometry mismatch: {prev.geometry()} vs "
            f"{cur.geometry()}"
        )
    out = LatencyHistogram(min_value=cur.min_value, sub_bits=cur.sub_bits)
    for idx, c in cur.counts.items():
        d = c - prev.counts.get(idx, 0)
        if d > 0:
            out.counts[idx] = d
    out.n = max(0, cur.n - prev.n)
    out.total = max(0.0, cur.total - prev.total)
    out.vmin = cur.vmin
    out.vmax = cur.vmax
    return out
