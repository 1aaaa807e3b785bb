"""Typed metrics registry with a namespaced key scheme.

Canonical naming contract (DESIGN.md §11):

* keys are ``<subsystem>.<object>.<metric>`` — e.g.
  ``serve.alloc.blocks_high_water``;
* monotone counts end in ``_total``;
* high-water gauges end in ``_high_water``;
* histograms carry a unit suffix (``_s``, ``_bytes``).

Every pre-existing ``stats()`` dict in the repo predates this scheme and
drifted (``high_water`` vs ``bytes_high_water`` vs ``blocks_high_water``,
bare counts vs ``_total``).  Rather than break the keys tests and benches
pin, :func:`absorb` maps each legacy dict into canonical metrics through a
per-namespace rename table; the legacy dicts stay as-is at their call
sites and the registry is the single place the canonical names exist.

Everything here is plain host-side Python — values entering ``absorb``/
``observe`` may be 0-d tensors (they are coerced via ``float``/``int``,
which blocks only on already-materialized chunk-boundary stats, never on
in-flight decode work).
"""
from __future__ import annotations

import json
import math


class Counter:
    """Monotone count.  ``inc`` by non-negative amounts only."""

    __slots__ = ("name", "value")

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, amount: int = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        self.value += int(amount)


class Gauge:
    """Last-written value (plus an optional high-water companion)."""

    __slots__ = ("name", "value")

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value) -> None:
        self.value = float(value)


class Histogram:
    """Fixed log-spaced-bucket histogram with streaming count/sum/min/max
    and interpolated quantiles.  Buckets span [lo, hi] in ``n`` decades-ish
    geometric steps; underflow/overflow land in the edge buckets."""

    __slots__ = ("name", "edges", "counts", "count", "total", "min", "max")

    kind = "histogram"

    def __init__(self, name: str, lo: float = 1e-6, hi: float = 1e3, n: int = 64):
        if not (0 < lo < hi):
            raise ValueError("need 0 < lo < hi")
        self.name = name
        ratio = (hi / lo) ** (1.0 / n)
        self.edges = [lo * ratio**i for i in range(n + 1)]
        self.counts = [0] * n
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        # geometric bucket index, clamped to the edge buckets
        if v <= self.edges[0]:
            i = 0
        elif v >= self.edges[-1]:
            i = len(self.counts) - 1
        else:
            lo, ratio = self.edges[0], self.edges[1] / self.edges[0]
            i = min(len(self.counts) - 1, int(math.log(v / lo, ratio)))
        self.counts[i] += 1

    def quantile(self, q: float) -> float:
        """Within-bucket linearly interpolated quantile; NaN when empty."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c > 0:
                frac = (target - seen) / c
                return self.edges[i] + frac * (self.edges[i + 1] - self.edges[i])
            seen += c
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "mean": self.mean if self.count else None,
            "p50": self.quantile(0.5) if self.count else None,
            "p99": self.quantile(0.99) if self.count else None,
        }


# legacy stats()-dict key -> canonical metric name, per namespace.  A key
# absent from its table passes through under its own (already canonical)
# name; values that are not numeric are skipped (e.g. device strings).
RENAMES = {
    "serve.pool": {
        "num_slots": "slots",
        "active": "slots_active",
        "high_water": "slots_high_water",
        "acquired": "slots_acquired_total",
        "released": "slots_released_total",
        "parked": "members_parked",
        "restored": "members_restored_total",
    },
    "serve.alloc": {
        "prefix_queries": "prefix_queries_total",
        "prefix_hits": "prefix_hits_total",
        "shared_block_hits": "shared_block_hits_total",
        "prefix_invalidated": "prefix_invalidated_total",
    },
    "serve.registry": {
        "promoted": "promotions_total",
        "rejected": "rejections_total",
        "staged_total": "staged_total",
    },
    "serve.refresh": {
        "refreshes": "refreshes_total",
        "micro_chunks": "micro_chunks_total",
        "micro_steps": "micro_steps_total",
        "steps_done": "steps_total",
        "backpressure_ticks": "backpressure_ticks_total",
        "flips_deferred": "flips_deferred_total",
        "decode_steps_stalled": "decode_steps_stalled_total",
        "promotions": "promotions_total",
        "proposals": "proposals_total",
        "rejections": "rejections_total",
    },
    "serve.engine": {
        "decode_steps": "decode_steps_total",
        "total_tokens": "tokens_total",
        "admitted": "admitted_total",
        "retired": "retired_total",
    },
    "executor": {
        "chunks": "chunks_total",
        "steps": "steps_total",
    },
}

_COUNTER_SUFFIX = "_total"


class MetricsRegistry:
    """Get-or-create store of named metrics.  Type mismatches on an
    existing name raise — a key is a counter or a gauge, never both."""

    def __init__(self):
        self._metrics: dict = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not a {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, lo: float = 1e-6, hi: float = 1e3, n: int = 64) -> Histogram:
        return self._get(name, Histogram, lo, hi, n)

    def absorb(self, namespace: str, stats: dict) -> None:
        """Fold a legacy ``stats()`` dict into canonical metrics under
        ``namespace``.  Counters are SET to the source's running total
        (legacy dicts are cumulative already), so absorbing twice is
        idempotent rather than double-counting."""
        table = RENAMES.get(namespace, {})
        for key, value in stats.items():
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                try:
                    value = float(value)
                except (TypeError, ValueError):
                    continue
                if value != value:  # NaN
                    continue
            name = f"{namespace}.{table.get(key, key)}"
            if name.endswith(_COUNTER_SUFFIX):
                c = self.counter(name)
                c.value = int(value)
            else:
                self.gauge(name).set(value)

    def snapshot(self) -> dict:
        """Flat ``{name: value-or-summary}`` dict, sorted by name."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def dump_jsonl(self, path) -> None:
        with open(path, "a") as f:
            f.write(json.dumps({"kind": "metrics", **self.snapshot()}) + "\n")


_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _REGISTRY


def reset_default() -> MetricsRegistry:
    global _REGISTRY
    _REGISTRY = MetricsRegistry()
    return _REGISTRY
