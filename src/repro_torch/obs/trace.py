"""Host-side event tracer: a fixed-capacity ring buffer of spans/instants
with Chrome/Perfetto ``trace.json`` export.

The paper's claim is a wall-clock one, and the interesting failure modes
live in *timing* — when a decode tick stalled, when a refresh micro-chunk
ran, when a snapshot flip deferred.  This tracer makes that timeline
visible without ever being allowed to change it:

* **Zero-cost when off.**  The module-level tracer defaults to a disabled
  singleton.  ``span()`` on a disabled tracer returns a shared no-op
  context manager WITHOUT reading the clock, and ``instant()`` returns
  after one attribute check — no clock reads, no allocation beyond the
  argument dict, no device interaction ever (``tests/test_obs.py`` pins
  zero ``_now()`` calls across a full engine run with tracing off).
* **Host-only recording.**  Nothing here fetches a device value: span
  timestamps are ``time.perf_counter_ns`` around host-side *dispatch*, so
  a span around asynchronously launched CUDA work measures enqueue, not
  device compute, unless the caller synchronises inside it.
* **Ring buffer, not a log.**  Events land in a preallocated list at a
  monotonically increasing cursor (mod capacity); old events are
  overwritten, never reallocated, and ``dropped`` counts the overwrites.
  Single write per event under the GIL — no locks, safe for the
  cooperative single-host-thread design (the engine, refresher and
  executor all run on the caller's thread).

Export is the Chrome trace-event JSON flavour Perfetto loads directly:
complete events (``ph: "X"``) for spans, thread-scoped instants
(``ph: "i"``), one synthetic tid per category, and the run manifest in
``otherData``.
"""
from __future__ import annotations

import json
import time
from typing import Any

# module-level clock indirection: tests monkeypatch this to prove the
# disabled tracer never reads the clock
_now = time.perf_counter_ns

# stable synthetic thread ids per category — one Perfetto track each
_TIDS = {
    "serve": 0,
    "refresh": 1,
    "executor": 2,
    "alloc": 3,
    "pool": 4,
    "sampler": 5,
}


class _NoopSpan:
    """Shared do-nothing context manager handed out by a disabled tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tr", "name", "cat", "args", "_t0")

    def __init__(self, tr: "Tracer", name: str, cat: str, args: dict):
        self._tr = tr
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0

    def __enter__(self):
        self._t0 = _now()
        return self

    def __exit__(self, *exc):
        self._tr._record(("X", self.name, self.cat, self._t0, _now() - self._t0, self.args))
        return False


class Tracer:
    """Fixed-capacity span/instant recorder.  ``enabled`` is checked first
    on every public call; a disabled tracer does no work."""

    __slots__ = ("enabled", "capacity", "_buf", "_written", "_t0")

    def __init__(self, capacity: int = 1 << 16, enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self._buf: list = [None] * self.capacity
        self._written = 0
        self._t0 = _now() if enabled else 0

    # -- recording ----------------------------------------------------------

    def _record(self, ev: tuple) -> None:
        # single GIL-atomic list-index write at the monotone cursor; the
        # ring wraps by overwriting, never by reallocating
        self._buf[self._written % self.capacity] = ev
        self._written += 1

    def span(self, name: str, cat: str = "repro", **args):
        """Context manager recording one complete ('X') event on exit.
        On a disabled tracer this returns a shared no-op without touching
        the clock."""
        if not self.enabled:
            return _NOOP
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        """Record a zero-duration ('i') event."""
        if not self.enabled:
            return
        self._record(("i", name, cat, _now(), 0, args))

    # -- introspection ------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wraparound."""
        return max(0, self._written - self.capacity)

    def __len__(self) -> int:
        return min(self._written, self.capacity)

    def events(self) -> list:
        """Recorded events, oldest first (post-wraparound order is the
        cursor-rotated ring)."""
        n = self._written
        if n <= self.capacity:
            return [e for e in self._buf[:n]]
        cur = n % self.capacity
        return self._buf[cur:] + self._buf[:cur]

    def names(self) -> set:
        return {e[1] for e in self.events()}

    # -- export -------------------------------------------------------------

    def to_chrome(self, manifest: dict | None = None) -> dict:
        """Chrome trace-event JSON object (the format Perfetto loads).
        Timestamps are microseconds relative to tracer construction."""
        events: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": "repro_torch"}},
        ]
        used = sorted({e[2] for e in self.events()}, key=lambda c: _TIDS.get(c, 99))
        for cat in used:
            events.append({
                "ph": "M", "name": "thread_name", "pid": 0,
                "tid": _TIDS.get(cat, 99), "args": {"name": cat},
            })
        for ph, name, cat, ts, dur, args in self.events():
            ev: dict[str, Any] = {
                "name": name,
                "cat": cat,
                "ph": ph,
                "ts": (ts - self._t0) / 1e3,
                "pid": 0,
                "tid": _TIDS.get(cat, 99),
            }
            if ph == "X":
                ev["dur"] = dur / 1e3
            else:
                ev["s"] = "t"
            if args:
                ev["args"] = args
            events.append(ev)
        if manifest is None:
            from repro_torch.obs.sinks import run_manifest

            manifest = run_manifest()
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"manifest": manifest, "dropped_events": self.dropped},
        }

    def export(self, path, manifest: dict | None = None) -> dict:
        """Write ``trace.json`` to ``path``; returns the exported object."""
        obj = self.to_chrome(manifest)
        with open(path, "w") as f:
            json.dump(obj, f)
        return obj


# the module-level tracer every instrumentation site reads through get():
# disabled by default, so an un-configured run pays one attribute check
# per potential event and nothing else
NULL = Tracer(capacity=1, enabled=False)
_TRACER: Tracer = NULL


def get() -> Tracer:
    """The active tracer (the disabled NULL singleton unless enabled)."""
    return _TRACER


def enable(capacity: int = 1 << 16) -> Tracer:
    """Install and return a fresh enabled tracer."""
    global _TRACER
    _TRACER = Tracer(capacity=capacity, enabled=True)
    return _TRACER


def disable() -> None:
    """Restore the disabled NULL tracer."""
    global _TRACER
    _TRACER = NULL


def install(tracer: Tracer) -> Tracer:
    """Install a specific tracer object — for save/restore around scoped
    measurements that toggle tracing themselves (e.g. the obs-overhead
    bench must hand back whatever tracer ``--trace`` installed)."""
    global _TRACER
    _TRACER = tracer
    return tracer
