"""Data broker: callback pub/sub for agent variables.

Port of ``agentlib_mpc_tpu/runtime/broker.py``; the port keeps its own copy
and imports nothing of the JAX package.

Replaces agentlib's DataBroker + communicator modules (the reference's
distributed communication backend, SURVEY.md §2.9): modules register
callbacks on (alias, source) and send AgentVariables
(``modules/mpc/mpc.py:281-284``, ``modules/dmpc/admm/admm.py:605-610``);
``local_broadcast`` communicators forward shared variables between agents.

Here every agent owns a `DataBroker`; a process-wide `BroadcastBus` links
brokers in one LocalMAS (the in-process fast path). The same broker API is
the seam for cross-process/MQTT interop communicators later — exactly the
reference's layering (fast path vs interop path).
"""

from __future__ import annotations

import logging
import threading
import time as _time
from collections import defaultdict
from typing import Callable, Optional

from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.runtime.variables import AgentVariable, Source

logger = logging.getLogger(__name__)

Callback = Callable[[AgentVariable], None]

# telemetry families (labeled per agent; declared at import so exports list
# them even before the first message — the bench artifact relies on that)
_MESSAGES = telemetry.counter(
    "broker_messages_total", "variables sent through DataBroker")
_CALLBACKS = telemetry.counter(
    "broker_callbacks_total", "subscriber callbacks dispatched")
_UNMATCHED = telemetry.counter(
    "broker_unmatched_total",
    "variables that matched no callback AND were not forwarded anywhere "
    "— genuinely dropped (normal broadcast fan-out to non-subscribing "
    "agents does not count, or the misconfiguration signal would drown "
    "in healthy cross-traffic)")
_DISPATCH_SECONDS = telemetry.histogram(
    "broker_dispatch_seconds",
    "wall-clock seconds spent in local callback dispatch per message")

#: dispatches at least this slow additionally record a ``broker.dispatch``
#: span — fast-path messages stay out of the span ring buffer (thousands
#: of per-message spans would evict the rare, valuable backend.solve /
#: admm.fused_step records; their timing is fully captured by the
#: ``broker_dispatch_seconds`` histogram anyway)
SLOW_DISPATCH_S = 1e-3


class DataBroker:
    """Per-agent variable router."""

    def __init__(self, agent_id: str):
        self.agent_id = agent_id
        # dispatch lock: held only to snapshot/mutate the subscriber
        # list, NEVER while user callbacks run — a callback that
        # (de)registers would deadlock on this non-reentrant lock, and
        # slow callbacks would serialize every sender. The lint
        # thread-discipline pass enforces both halves (guarded mutations
        # + no registration under the lock; docs/static_analysis.md).
        self._subs_lock = threading.Lock()  # lint: dispatch-lock
        self._subs: list[tuple[str, Source, Callback]] = []  # guarded-by: self._subs_lock
        self._bus: Optional["BroadcastBus"] = None
        #: aliases already warned about (one dropped-variable warning per
        #: alias per broker — rate limiting, not suppression of the count)
        self._warned_unmatched: set[str] = set()  # guarded-by: self._subs_lock

    def register_callback(self, alias: str, source, callback: Callback) -> None:
        with self._subs_lock:
            self._subs.append((alias, Source.coerce(source), callback))

    def deregister_callback(self, alias: str, source, callback: Callback) -> None:
        key = (alias, Source.coerce(source), callback)
        with self._subs_lock:
            self._subs = [s for s in self._subs if s != key]

    def send_variable(self, var: AgentVariable, from_external: bool = False) -> None:
        """Deliver to local subscribers; forward shared vars to the bus.

        A variable that matches no local callback AND is not forwarded
        anywhere (not shared / no bus / already external) is genuinely
        dropped: it counts into
        ``broker_unmatched_total{agent=...,alias=...}`` and logs ONE
        warning per alias — the classic silent-misconfiguration (alias
        typo, missing module) that previously vanished without a trace.
        Unmatched *external* deliveries are normal broadcast fan-out and
        deliberately do not count.
        """
        matched = 0
        t0 = _time.perf_counter()
        # snapshot under the dispatch lock, call callbacks OUTSIDE it:
        # callbacks may re-enter (register_callback from a handler, sends
        # that fan back into this broker) and must not see a held lock
        with self._subs_lock:
            subs = list(self._subs)
        for alias, source, cb in subs:
            if alias == var.alias and source.matches(var.source):
                cb(var)
                matched += 1
        dt = _time.perf_counter() - t0
        forwarded = var.shared and not from_external and self._bus is not None
        if telemetry.enabled():
            _MESSAGES.inc(agent=self.agent_id)
            if matched:
                _CALLBACKS.inc(matched, agent=self.agent_id)
            _DISPATCH_SECONDS.observe(dt, agent=self.agent_id)
            if dt >= SLOW_DISPATCH_S:
                rec = telemetry.SpanRecord(
                    "broker.dispatch",
                    {"agent": self.agent_id, "alias": var.alias})
                rec.start = t0
                rec.duration = dt
                telemetry.recorder().record(rec)
        if not matched and not forwarded and not from_external:
            _UNMATCHED.inc(agent=self.agent_id, alias=var.alias)
            with self._subs_lock:
                warn = var.alias not in self._warned_unmatched
                self._warned_unmatched.add(var.alias)
            if warn:
                logger.warning(
                    "agent %s: variable alias %r (source %s) matched no "
                    "registered callback and was not forwarded — dropped "
                    "(counted in broker_unmatched_total; warning once per "
                    "alias)", self.agent_id, var.alias, var.source)
        if forwarded:
            self._bus.broadcast(self.agent_id, var)

    def attach_bus(self, bus: "BroadcastBus") -> None:
        self._bus = bus


class BroadcastBus:
    """In-process broadcast linking all agents of a LocalMAS — the
    replacement for the reference's `local_broadcast` communicator."""

    def __init__(self):
        self._brokers: dict[str, DataBroker] = {}

    def join(self, broker: DataBroker) -> None:
        self._brokers[broker.agent_id] = broker
        broker.attach_bus(self)

    def broadcast(self, from_agent: str, var: AgentVariable) -> None:
        for agent_id, broker in self._brokers.items():
            if agent_id != from_agent:
                broker.send_variable(var, from_external=True)
