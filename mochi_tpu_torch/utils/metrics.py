"""Lightweight latency timers and counters.

Capability parity with the reference's Dropwizard ``MetricRegistry`` +
``JmxReporter`` (``MochiDBClient.java:52-70``: timers ``read-transactions``,
``read-transactions-step1-future-wait``, ``write-transactions``), kept
in-process with percentile snapshots instead of JMX.  The reference has no
server-side metrics (SURVEY.md §5); here replicas carry the same registry.
"""

from __future__ import annotations

import math
import time
from collections import defaultdict, deque
from typing import Dict


class Timer:
    """Records durations (seconds); reports count/mean/percentiles.

    Memory-bounded: keeps a sliding window of the most recent
    ``window`` samples for percentiles (the Dropwizard reservoir analog)
    plus exact lifetime count/sum for mean and throughput.
    """

    __slots__ = ("samples", "total_count", "total_seconds", "window")

    def __init__(self, window: int = 8192) -> None:
        self.window = window
        self.samples: deque = deque(maxlen=window)
        self.total_count = 0
        self.total_seconds = 0.0

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)
        self.total_count += 1
        self.total_seconds += seconds

    def percentile(self, q: float) -> float:
        if not self.samples:
            return math.nan
        data = sorted(self.samples)
        idx = min(len(data) - 1, max(0, int(round(q / 100.0 * (len(data) - 1)))))
        return data[idx]

    @property
    def count(self) -> int:
        return self.total_count

    @property
    def mean(self) -> float:
        return self.total_seconds / self.total_count if self.total_count else math.nan

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean_ms": self.mean * 1e3,
            "p50_ms": self.percentile(50) * 1e3,
            "p95_ms": self.percentile(95) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
        }


class Histogram:
    """Fixed-bucket histogram (Prometheus-style cumulative ``le`` buckets).

    Built for the batched hot path's occupancy/latency evidence: a mean
    batch size of 1.8 can hide a bimodal 1-frame-idle / 12-frame-burst
    distribution, which is exactly the difference between "the drain never
    batches" and "the drain batches whenever there is load" — the
    distribution, not the mean, is the observable.  O(1) observe (linear
    scan of ~a dozen upper bounds beats bisect at these sizes), exact
    count/sum for the mean.
    """

    __slots__ = ("bounds", "bucket_counts", "total_count", "total_sum")

    # Occupancy-shaped default: 1..multi-thousand in ~x2-x4 steps.
    DEFAULT_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096)

    def __init__(self, bounds=DEFAULT_BOUNDS) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +inf tail
        self.total_count = 0
        self.total_sum = 0.0

    def observe(self, value: float) -> None:
        i = 0
        for bound in self.bounds:
            if value <= bound:
                break
            i += 1
        self.bucket_counts[i] += 1
        self.total_count += 1
        self.total_sum += value

    @property
    def mean(self) -> float:
        return self.total_sum / self.total_count if self.total_count else math.nan

    def snapshot(self) -> Dict[str, object]:
        return {
            "count": self.total_count,
            "sum": round(self.total_sum, 6),
            "mean": (round(self.mean, 3) if self.total_count else None),
            "buckets": {
                ("+Inf" if i == len(self.bounds) else f"{self.bounds[i]:g}"): n
                for i, n in enumerate(self.bucket_counts)
                if n
            },
        }


# Latency histograms want sub-ms resolution, not occupancy powers of two.
LATENCY_BOUNDS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
)

# Fan-out straggler lateness (milliseconds AFTER the quorum was already
# satisfied — not absolute RTT): sub-ms buckets catch loopback jitter,
# the top buckets catch a replica pinned behind a WAN hiccup or a stalled
# event loop (net/transport.fan_out early-quorum drain).
STRAGGLER_BOUNDS_MS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 1000)


class _TimerCtx:
    """Hand-rolled timing context.

    This runs ~40x per transaction across client + replicas; the
    ``@contextmanager`` generator formulation costs a generator frame, two
    ``next()`` dispatches and a ``contextlib`` helper object per use —
    measured at ~6% of cluster CPU in the config-1 profile.  A plain
    two-method object is one attribute store and two perf_counter calls.
    """

    __slots__ = ("_timer", "_start")

    def __init__(self, timer: Timer) -> None:
        self._timer = timer

    def __enter__(self) -> "_TimerCtx":
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._timer.record(time.perf_counter() - self._start)


class Metrics:
    """Registry of named timers and counters."""

    def __init__(self) -> None:
        self.timers: Dict[str, Timer] = defaultdict(Timer)
        self.counters: Dict[str, int] = defaultdict(int)
        self.histograms: Dict[str, Histogram] = {}
        # Last-write-wins instantaneous values (queue depths, link states —
        # things that go *down* as well as up, which counters cannot).
        self.gauges: Dict[str, float] = {}

    def timer(self, name: str) -> _TimerCtx:
        return _TimerCtx(self.timers[name])

    def mark(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def histogram(self, name: str, bounds=Histogram.DEFAULT_BOUNDS) -> Histogram:
        """Get-or-create; ``bounds`` only applies on first creation (a
        histogram's buckets are immutable once it has observations)."""
        h = self.histograms.get(name)
        if h is None:
            h = Histogram(bounds)
            self.histograms[name] = h
        return h

    def snapshot(self) -> Dict[str, Dict]:
        return {
            "timers": {name: t.snapshot() for name, t in self.timers.items()},
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {
                name: h.snapshot() for name, h in self.histograms.items()
            },
        }

    def to_prometheus(self, labels: Dict[str, str]) -> str:
        """Prometheus text exposition (the Dropwizard/JMX-reporter analog
        for a modern scrape stack).  Metric identity goes into the ``name``
        label so arbitrary dotted timer names stay valid.

        Exposition hygiene: every family carries
        ``# HELP`` + ``# TYPE`` headers, and EVERY label value — including
        the ``name`` label, whose dotted metric names embed peer/client
        ids on the suspicion/fan-out counters, i.e. attacker-influenced
        strings — is escaped.  tests/test_metrics_prom.py parser-roundtrips
        the whole body."""

        def esc(v: str) -> str:
            return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

        base = ",".join(f'{k}="{esc(v)}"' for k, v in sorted(labels.items()))
        lines = [
            "# HELP mochi_timer_count Lifetime sample count per named timer",
            "# TYPE mochi_timer_count counter",
            "# HELP mochi_timer_seconds_mean Lifetime mean duration per named timer",
            "# TYPE mochi_timer_seconds_mean gauge",
            "# HELP mochi_timer_seconds_p50 Sliding-window median duration per named timer",
            "# TYPE mochi_timer_seconds_p50 gauge",
            "# HELP mochi_timer_seconds_p99 Sliding-window p99 duration per named timer",
            "# TYPE mochi_timer_seconds_p99 gauge",
            "# HELP mochi_counter_total Monotonic event counters by name",
            "# TYPE mochi_counter_total counter",
        ]
        for name, t in sorted(self.timers.items()):
            lab = f'name="{esc(name)}"' + (f",{base}" if base else "")
            lines.append(f"mochi_timer_count{{{lab}}} {t.count}")
            if t.count:
                lines.append(f"mochi_timer_seconds_mean{{{lab}}} {t.mean:.9f}")
                lines.append(
                    f"mochi_timer_seconds_p50{{{lab}}} {t.percentile(50):.9f}"
                )
                lines.append(
                    f"mochi_timer_seconds_p99{{{lab}}} {t.percentile(99):.9f}"
                )
        for name, n in sorted(self.counters.items()):
            lab = f'name="{esc(name)}"' + (f",{base}" if base else "")
            lines.append(f"mochi_counter_total{{{lab}}} {n}")
        if self.gauges:
            lines.append("# HELP mochi_gauge Last-write-wins instantaneous values by name")
            lines.append("# TYPE mochi_gauge gauge")
            for name, v in sorted(self.gauges.items()):
                lab = f'name="{esc(name)}"' + (f",{base}" if base else "")
                lines.append(f"mochi_gauge{{{lab}}} {v:g}")
        if self.histograms:
            lines.append("# HELP mochi_histogram Fixed-bucket occupancy/latency histograms by name")
            lines.append("# TYPE mochi_histogram histogram")
            for name, h in sorted(self.histograms.items()):
                lab = f'name="{esc(name)}"' + (f",{base}" if base else "")
                cum = 0
                for i, bucket_n in enumerate(h.bucket_counts):
                    cum += bucket_n
                    le = (
                        "+Inf" if i == len(h.bounds) else f"{h.bounds[i]:g}"
                    )
                    lines.append(
                        f'mochi_histogram_bucket{{{lab},le="{le}"}} {cum}'
                    )
                lines.append(f"mochi_histogram_sum{{{lab}}} {h.total_sum:.9f}")
                lines.append(f"mochi_histogram_count{{{lab}}} {h.total_count}")
        return "\n".join(lines) + "\n"
