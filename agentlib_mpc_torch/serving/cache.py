"""Fingerprint-keyed cache of built fused serving engines.

Port of ``agentlib_mpc_tpu/serving/cache.py``. The most expensive event
in the serving plane is building a fused engine: in the port that is the
graph traces of the certifiers, the QP routing probe, the derivative
plans and one warming round on the card (seconds). The cache makes that
a once-per-structure cost: a tenant whose problem is structurally
identical to one already built, including a tenant REJOINING after an
eviction, reuses the warm engine, and the join is a dictionary lookup
plus a slot splice.

Counters: ``serving_compile_cache_hits_total`` /
``serving_compile_cache_misses_total`` (labelled by bucket digest),
``serving_cache_evictions_total`` when a ``max_engines`` bound is set,
and the ``serving_join_build_seconds`` histogram labelled
``cached="yes"/"no"``, so the cached-against-cold join latency is always
measured. The JAX package's cross-process tier (the on-disk engine
store) comes with ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from agentlib_mpc_torch import telemetry


class CompileCache:
    """Maps hashable engine keys to built (and warmed) engine objects.

    By default the cache never evicts. A long-lived multi-structure plane
    can bound it with ``max_engines``: least-recently-USED entries (hits
    refresh recency) are dropped once the bound is exceeded, counted in
    ``serving_cache_evictions_total{bucket=}``; a rejoin of an evicted
    structure is then a measured cache MISS (a rebuild). Engines serving
    a LIVE bucket are referenced by the bucket itself, so LRU eviction
    only ever costs retired structures their warm rejoin.
    ``get_or_build(key, builder)`` returns ``(engine, hit, latency_s)``.
    """

    def __init__(self, max_engines: "int | None" = None):
        if max_engines is not None and int(max_engines) < 1:
            raise ValueError(f"max_engines must be >= 1 or None, "
                             f"got {max_engines}")
        self.max_engines = None if max_engines is None else int(max_engines)
        self._entries: "OrderedDict" = OrderedDict()  # key -> (engine, label)
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    def note_hit(self, label: str = "") -> None:
        """Count an engine reuse that never had to consult the entry
        dict: a tenant joining a LIVE bucket whose engine is already
        serving. Same counter family as lookup hits."""
        self.hits += 1
        telemetry.journal_event("cache.engine", outcome="hit",
                                bucket=label or "?", live_bucket=True)
        if telemetry.enabled():
            telemetry.counter(
                "serving_compile_cache_hits_total",
                "serving engine cache lookups that reused a compiled "
                "engine").inc(bucket=label or "?")

    def _evict_over_bound(self) -> None:
        while self.max_engines is not None and \
                len(self._entries) > self.max_engines:
            _key, (_engine, label) = self._entries.popitem(last=False)
            self.evictions += 1
            if telemetry.enabled():
                telemetry.counter(
                    "serving_cache_evictions_total",
                    "compiled serving engines dropped by the LRU bound "
                    "(max_engines)").inc(bucket=label or "?")

    def get_or_build(self, key, builder, label: str = ""):
        """The engine under ``key``, built by the zero-argument
        ``builder`` on a miss. A failed build is journaled and
        re-raised; nothing is cached for it."""
        t0 = time.perf_counter()
        entry = self._entries.get(key)
        hit = entry is not None
        if not hit:
            try:
                engine = builder()
            except Exception as exc:
                # a failed build (out of memory, chaos) is an incident
                # event of its own, not just a stack trace
                telemetry.journal_event(
                    "cache.engine", outcome="build_failed",
                    bucket=label or "?", error=repr(exc)[:300])
                raise
            self.misses += 1
            self._entries[key] = (engine, label)
            self._evict_over_bound()
        else:
            engine = entry[0]
            self._entries.move_to_end(key)       # LRU: a hit is a use
            self.hits += 1
        latency = time.perf_counter() - t0
        telemetry.journal_event(
            "cache.engine", outcome="hit" if hit else "miss",
            bucket=label or "?", latency_s=round(latency, 6))
        if telemetry.enabled():
            name = ("serving_compile_cache_hits_total" if hit
                    else "serving_compile_cache_misses_total")
            telemetry.counter(
                name, "serving engine cache lookups that "
                + ("reused a compiled engine" if hit
                   else "had to build (certify + trace + warm)")
                ).inc(bucket=label or "?")
            telemetry.histogram(
                "serving_join_build_seconds",
                "engine acquisition latency at tenant join, by cache "
                "outcome").observe(latency, cached="yes" if hit else "no")
        return engine, hit, latency
