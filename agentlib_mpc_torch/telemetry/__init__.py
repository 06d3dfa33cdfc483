"""Telemetry: the metric families and spans the module path writes.

The part of ``agentlib_mpc_tpu/telemetry/`` that the ported call sites
use — the data broker's counters and dispatch histogram, the actuation
guard's level gauge and counters, the backends' solver families, the
``backend.solve`` span, the ADMM residual gauges
(``ops.admm.record_residuals``) and the serving plane's families
(:func:`serving_metrics`) — with the JAX package's names, labels and
semantics (``metrics().get`` returns a counter's or gauge's value and a
histogram's observation count). Every write sits behind :func:`enabled`
(on by default; ``configure(enabled=False)`` turns writes into no-ops).
The flight-recorder journal (:mod:`.journal`) records only while one is
installed (:func:`enable_journal`), as in the JAX package; the SLO
tracker is :mod:`.slo`. The exporters, the span aggregates, the profiler
and the rest of the telemetry tooling come with the telemetry slice
(ROADMAP Queue 1 item 6).

    from agentlib_mpc_torch import telemetry

    telemetry.counter("broker_messages_total").inc(agent="room_1")
    with telemetry.span("backend.solve", backend="JAXBackend"):
        ...
    telemetry.metrics().get("broker_messages_total", agent="room_1")
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Iterable, Optional

from agentlib_mpc_torch.telemetry import journal as _journal_mod

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SpanRecord",
    "ITERATION_BUCKETS", "LATENCY_BUCKETS_S",
    "metrics", "recorder", "span", "configure", "enabled", "counter",
    "gauge", "histogram", "solver_metrics", "serving_metrics", "reset",
    "enable_journal", "disable_journal", "journal_active",
    "journal_event", "journal_set_round",
]

#: default histogram buckets for latencies in seconds
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
#: default buckets for iteration counts
ITERATION_BUCKETS = (1.0, 2.0, 3.0, 5.0, 8.0, 12.0, 20.0, 30.0, 50.0, 100.0)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Family:
    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self._registry = registry
        self.name = name
        self.help = help
        self._values: dict = {}

    def value(self, **labels) -> Optional[float]:
        """The value for one label set (None if never written)."""
        with self._registry._lock:
            return self._values.get(_label_key(labels))

    def remove(self, **labels) -> None:
        """Drop the sample of one label set (a no-op when absent), for
        label sets that go stale, such as the per-iteration gauges of a
        round that ran shorter than the one before. Runs whether or not
        telemetry is enabled."""
        with self._registry._lock:
            self._values.pop(_label_key(labels), None)


class Counter(_Family):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(
                f"counter {self.name!r} cannot decrease (got {value})")
        if self._registry.enabled:
            key = _label_key(labels)
            with self._registry._lock:
                self._values[key] = self._values.get(key, 0.0) + value


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if self._registry.enabled:
            with self._registry._lock:
                self._values[_label_key(labels)] = float(value)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, registry, name: str, help: str,
                 buckets: Iterable[float] = LATENCY_BUCKETS_S):
        super().__init__(registry, name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts: dict = {}

    def observe(self, value: float, **labels) -> None:
        if not self._registry.enabled:
            return
        key = _label_key(labels)
        slot = next((i for i, b in enumerate(self.buckets) if value <= b),
                    len(self.buckets))
        with self._registry._lock:
            counts = self._counts.setdefault(key,
                                             [0] * (len(self.buckets) + 1))
            counts[slot] += 1
            self._values[key] = self._values.get(key, 0) + 1

    def remove(self, **labels) -> None:
        with self._registry._lock:
            super().remove(**labels)
            self._counts.pop(_label_key(labels), None)


class MetricsRegistry:
    """The metric families, declared once by name (a second declaration
    returns the first)."""

    def __init__(self, enabled: bool = True):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}
        self.enabled = bool(enabled)

    def _declare(self, cls, name: str, help: str, **kwargs) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(self, name, help, **kwargs)
            elif not isinstance(fam, cls):
                raise ValueError(f"metric {name!r} is a {fam.kind}, not a "
                                 f"{cls.kind}")
            return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._declare(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._declare(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=LATENCY_BUCKETS_S) -> Histogram:
        return self._declare(Histogram, name, help, buckets=buckets)

    def get(self, name: str, **labels) -> Optional[float]:
        """A family's value for one label set (None for an unknown family
        or label set); a histogram's is its observation count."""
        fam = self._families.get(name)
        return None if fam is None else fam.value(**labels)

    def reset(self) -> None:
        """Clear every recorded value; declared families stay."""
        with self._lock:
            for fam in self._families.values():
                fam._values.clear()
                if isinstance(fam, Histogram):
                    fam._counts.clear()


DEFAULT = MetricsRegistry()


class SpanRecord:
    """One timed region; ``duration`` is None while it is open."""

    __slots__ = ("name", "labels", "start", "duration")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.start = 0.0
        self.duration: "float | None" = None

    def __enter__(self) -> "SpanRecord":
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration = time.perf_counter() - self.start
        RECORDER.record(self)


class _SpanRecorder:
    """The most recent completed spans (a bounded ring)."""

    def __init__(self, capacity: int = 4096):
        self._spans: collections.deque = collections.deque(maxlen=capacity)

    def record(self, rec: SpanRecord) -> None:
        if DEFAULT.enabled:
            self._spans.append(rec)

    def spans(self) -> list:
        return list(self._spans)

    def clear(self) -> None:
        self._spans.clear()


RECORDER = _SpanRecorder()


class _NoopSpan:
    duration = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


def metrics() -> MetricsRegistry:
    return DEFAULT


def recorder() -> _SpanRecorder:
    return RECORDER


def enabled() -> bool:
    return DEFAULT.enabled


def configure(enabled: bool) -> None:
    """Turn every telemetry write on or off, process-wide."""
    DEFAULT.enabled = bool(enabled)


def counter(name: str, help: str = "") -> Counter:
    return DEFAULT.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return DEFAULT.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets=LATENCY_BUCKETS_S) -> Histogram:
    return DEFAULT.histogram(name, help, buckets=buckets)


def span(name: str, **labels) -> "SpanRecord | _NoopSpan":
    """A timed region, recorded at exit; a no-op when telemetry is off."""
    return SpanRecord(name, labels) if DEFAULT.enabled else _NoopSpan()


def solver_metrics(registry: "MetricsRegistry | None" = None) -> dict:
    """The solver families the backends write (the JAX package's names,
    help texts and buckets): solves, failures, iterations, solve_seconds,
    kkt_error."""
    reg = registry or DEFAULT
    return {
        "solves": reg.counter(
            "solver_solves_total", "backend solve() calls"),
        "failures": reg.counter(
            "solver_failures_total",
            "backend solve() calls whose solver did not reach an "
            "acceptable point"),
        "iterations": reg.histogram(
            "solver_iterations", "interior-point iterations per solve",
            buckets=ITERATION_BUCKETS),
        "solve_seconds": reg.histogram(
            "solver_solve_seconds", "wall-clock seconds per backend solve"),
        "kkt_error": reg.gauge(
            "solver_kkt_error", "KKT error of the most recent solve"),
    }


def serving_metrics(registry: "MetricsRegistry | None" = None) -> dict:
    """The serving plane's metric families (the JAX package's names and
    help texts): requests, rounds, solves, active, queue_depth,
    round_seconds. ``serving_solves_total`` is labelled by the guard
    ``action`` (actuate/replay/hold/fallback), so availability (actuated
    over delivered) is computable from telemetry alone. The cache,
    admission and health layers declare their own families where they
    write them."""
    reg = registry or DEFAULT
    return {
        "requests": reg.counter(
            "serving_requests_total",
            "solve requests submitted to the serving plane"),
        "rounds": reg.counter(
            "serving_rounds_total", "fused rounds dispatched"),
        "solves": reg.counter(
            "serving_solves_total", "per-tenant solve results delivered"),
        "active": reg.gauge(
            "serving_active_tenants", "admitted tenants per bucket"),
        "queue_depth": reg.gauge(
            "serving_queue_depth",
            "pending solve requests at last drain"),
        "round_seconds": reg.histogram(
            "serving_round_seconds",
            "wall-clock seconds per serve_round call"),
    }


def reset() -> None:
    """Clear recorded values and spans (declared families stay; an
    installed journal stays installed)."""
    DEFAULT.reset()
    RECORDER.clear()


def enable_journal(path: str, **kwargs):
    """Install the process-global flight-recorder journal at ``path``
    (:class:`~agentlib_mpc_torch.telemetry.journal.Journal`)."""
    return _journal_mod.enable(path, **kwargs)


def disable_journal() -> None:
    """Close and uninstall the global journal (the file stays)."""
    _journal_mod.disable()


def journal_active():
    """The installed journal, or None while journaling is off."""
    return _journal_mod.active()


def journal_event(etype: str, **fields) -> "int | None":
    """Record one typed event into the global journal; a no-op (None)
    while no journal is installed."""
    if _journal_mod._GLOBAL is None:
        return None
    return _journal_mod.record(etype, **fields)


def journal_set_round(round_: "int | None") -> None:
    """Stamp later journal events with this control round."""
    _journal_mod.set_round(round_)
