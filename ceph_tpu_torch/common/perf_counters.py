"""Named performance counters per daemon.

Reference parity: PerfCounters (common/perf_counters.h:68) — u64 counters
(inc/set), averages (avgcount/sum via tinc), and time counters; dumped over
the admin socket as `perf dump`.  Redesigned lock-light: plain dict of slots
guarded by one mutex (python ints are big enough that we need no sharding).

Latency histograms (common/perf_histogram.h role): log2-bucketed time
histograms with p50/p99/p999 extraction and cross-group merging, for
`perf histogram dump` on the admin socket.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

TYPE_U64 = "u64"
TYPE_AVG = "avg"
TYPE_TIME = "time"
TYPE_HIST = "hist"


class PerfHistogram:
    """Log2-bucketed latency histogram.

    Bucket i counts samples in [2^i, 2^(i+1)) microseconds (bucket 0
    also absorbs sub-microsecond samples; the last bucket is open-ended
    at ~2.4 hours).  Quantiles interpolate linearly inside the owning
    bucket, so p50/p99/p999 carry at most a 2x bucket-granularity error
    — plenty for attributing milliseconds across write-path stages.
    Merging is bucket-wise addition, which is what lets per-PG and
    per-daemon histograms aggregate without losing the tail.
    """

    N_BUCKETS = 44          # 1us .. 2^43us ≈ 2.4h
    __slots__ = ("buckets", "count", "sum")

    def __init__(self):
        self.buckets: List[int] = [0] * self.N_BUCKETS
        self.count = 0
        self.sum = 0.0

    @staticmethod
    def _bucket_of(seconds: float) -> int:
        us = int(seconds * 1e6)
        if us < 1:
            return 0
        return min(us.bit_length() - 1, PerfHistogram.N_BUCKETS - 1)

    def add(self, seconds: float) -> None:
        self.buckets[self._bucket_of(seconds)] += 1
        self.count += 1
        self.sum += seconds

    def merge(self, other: "PerfHistogram") -> "PerfHistogram":
        for i, c in enumerate(other.buckets):
            self.buckets[i] += c
        self.count += other.count
        self.sum += other.sum
        return self

    def quantile(self, q: float) -> float:
        """q-th quantile in SECONDS (linear interpolation in-bucket)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.buckets):
            if cum + c >= rank and c:
                lo = 0.0 if i == 0 else float(1 << i)
                hi = float(1 << (i + 1))
                frac = (rank - cum) / c
                return (lo + (hi - lo) * frac) / 1e6
            cum += c
        return float(1 << self.N_BUCKETS) / 1e6

    def dump(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum_s": round(self.sum, 6),
            "avg_ms": round(self.sum / self.count * 1e3, 4)
            if self.count else 0.0,
            "p50_ms": round(self.quantile(0.50) * 1e3, 4),
            "p99_ms": round(self.quantile(0.99) * 1e3, 4),
            "p999_ms": round(self.quantile(0.999) * 1e3, 4),
        }

    def dump_full(self) -> Dict[str, object]:
        """Quantiles plus the raw bucket vector (what a remote consumer
        needs to merge dumps across processes).  Unlike the rounded
        display form, ``sum_s`` is the FULL-precision float here — it
        round-trips exactly through JSON, so a reconstructed histogram
        is bit-for-bit the original (buckets, count, sum, quantiles)."""
        d: Dict[str, object] = self.dump()
        d["buckets"] = list(self.buckets)
        d["sum_s"] = self.sum
        return d

    @classmethod
    def from_dump(cls, d: Dict[str, object]) -> "PerfHistogram":
        h = cls()
        bk = d.get("buckets") or []
        for i, c in enumerate(bk[:cls.N_BUCKETS]):
            h.buckets[i] = int(c)
        h.count = int(d.get("count", sum(h.buckets)))
        h.sum = float(d.get("sum_s", 0.0))
        return h


class PerfCounters:
    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._types: Dict[str, str] = {}
        self._vals: Dict[str, float] = {}
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._hists: Dict[str, PerfHistogram] = {}

    def add_u64(self, key: str) -> None:
        self._types[key] = TYPE_U64
        self._vals[key] = 0

    def add_avg(self, key: str) -> None:
        self._types[key] = TYPE_AVG
        self._sums[key] = 0.0
        self._counts[key] = 0

    def add_time(self, key: str) -> None:
        self._types[key] = TYPE_TIME
        self._sums[key] = 0.0
        self._counts[key] = 0

    def add_hist(self, key: str) -> None:
        self._types[key] = TYPE_HIST
        self._hists[key] = PerfHistogram()

    def inc(self, key: str, by: int = 1) -> None:
        with self._lock:
            self._vals[key] = self._vals.get(key, 0) + by

    def set(self, key: str, v: float) -> None:
        with self._lock:
            self._vals[key] = v

    def set_max(self, key: str, v: float) -> None:
        """High-water-mark gauge: keep the larger of stored/new — for
        groups shared by many samplers (e.g. every PG of an OSD feeds
        one osd_op_window group), where a plain set() would let a
        shallow sampler clobber a deeper one's mark."""
        with self._lock:
            if v > self._vals.get(key, 0):
                self._vals[key] = v

    def tinc(self, key: str, seconds: float) -> None:
        with self._lock:
            self._sums[key] = self._sums.get(key, 0.0) + seconds
            self._counts[key] = self._counts.get(key, 0) + 1

    def hinc(self, key: str, seconds: float) -> None:
        """Record one latency sample; auto-registers the histogram on
        first use (stages appear dynamically as callers meet them)."""
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = PerfHistogram()
                self._types[key] = TYPE_HIST
            h.add(seconds)

    def histograms(self) -> Dict[str, PerfHistogram]:
        """Snapshot of the live histogram objects (same-process merge —
        qa/cluster + bench aggregate across daemons with these)."""
        with self._lock:
            return dict(self._hists)

    def time_block(self, key: str):
        pc = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                pc.tinc(key, time.perf_counter() - self.t0)
                return False

        return _T()

    def dump(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {}
            for k, t in self._types.items():
                if t == TYPE_U64:
                    out[k] = self._vals.get(k, 0)
                elif t == TYPE_HIST:
                    out[k] = self._hists[k].dump()
                else:
                    out[k] = {"avgcount": self._counts.get(k, 0),
                              "sum": self._sums.get(k, 0.0)}
            # untyped ad-hoc counters still show up
            for k, v in self._vals.items():
                out.setdefault(k, v)
            return out

    def dump_histograms(self) -> Dict[str, Dict]:
        with self._lock:
            return {k: h.dump_full() for k, h in self._hists.items()}

    def dump_full(self) -> Dict[str, object]:
        """Like dump(), but histograms keep their raw bucket vectors —
        the cross-process form: a remote consumer reconstructs every
        histogram bit-for-bit via PerfHistogram.from_dump and merges
        bucket-wise (the metrics plane ships THIS shape)."""
        with self._lock:
            out: Dict[str, object] = {}
            for k, t in self._types.items():
                if t == TYPE_U64:
                    out[k] = self._vals.get(k, 0)
                elif t == TYPE_HIST:
                    out[k] = self._hists[k].dump_full()
                else:
                    out[k] = {"avgcount": self._counts.get(k, 0),
                              "sum": self._sums.get(k, 0.0)}
            for k, v in self._vals.items():
                out.setdefault(k, v)
            return out


class PerfCountersCollection:
    """All counter groups in a process, for `perf dump` (admin socket)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._groups: Dict[str, PerfCounters] = {}

    def create(self, name: str) -> PerfCounters:
        with self._lock:
            pc = self._groups.get(name)
            if pc is None:
                pc = self._groups[name] = PerfCounters(name)
            return pc

    def remove(self, name: str) -> None:
        with self._lock:
            self._groups.pop(name, None)

    def dump(self) -> Dict[str, Dict]:
        with self._lock:
            return {n: g.dump() for n, g in self._groups.items()}

    def dump_histograms(self) -> Dict[str, Dict]:
        """`perf histogram dump` body: only groups that carry at least
        one histogram, full bucket vectors included (mergeable)."""
        with self._lock:
            groups = list(self._groups.items())
        out = {}
        for n, g in groups:
            h = g.dump_histograms()
            if h:
                out[n] = h
        return out

    def dump_full(self) -> Dict[str, Dict]:
        """Every group's mergeable form (counters + bucketed
        histograms): the per-daemon body of a metrics-plane snapshot
        (common/metrics.py)."""
        with self._lock:
            groups = list(self._groups.items())
        return {n: g.dump_full() for n, g in groups}
