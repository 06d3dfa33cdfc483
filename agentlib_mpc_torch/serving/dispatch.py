"""Pipelined dispatch with a watchdog over the serving rounds.

Port of ``agentlib_mpc_tpu/serving/dispatch.py`` on one device.
:class:`PipelinedDispatcher` keeps the JAX package's contract: per bucket
a depth-1 pipeline in which round k+1 is launched before round k's
results are decoded, so ``dispatch()`` returns the PREVIOUS round's
results and ``flush()`` the last one; the plane's ``pipelined="auto"``
means pipelined on the card and synchronous on the CPU.

What overlaps differs. In JAX ``engine.step`` only enqueues the round.
The port's round reads its convergence flag on the host once per ADMM
iteration, so launching round k+1 runs it nearly to its end; what is
left to overlap is the decode of round k (the copy of its controls to
the host and the per-tenant results) with the tail of round k+1's
launch (the trajectory extraction the card may still be running).

**Watchdog.** With ``timeout_s`` set, both calls that can block on a card
that never answers run under a bounded wait on a
:class:`~agentlib_mpc_torch.utils.watchdog.BoundedReader` worker: the
LAUNCH (where the port's round synchronizes on the host) and the
decode. On timeout the round is marked FAILED (its tenants get
``success=False`` results and walk their guard ladders; no exception
escapes ``serve_round``), the dispatcher falls back to synchronous
dispatch for good, and a bounded probe of the card records whether it
still answers. A launch the watchdog gave up on never runs late: its
worker checks the round's abandon flag before starting the step, so a
stall that ends after the timeout cannot write the bucket's state behind
the plane's back. Solves on the worker thread take
``ops.solver.SOLVE_LOCK`` as every solve does, so a round on the worker
never interleaves with another solve.
"""

from __future__ import annotations

import logging
import threading

import torch

from agentlib_mpc_torch import telemetry
from agentlib_mpc_torch.utils.watchdog import BoundedReader

logger = logging.getLogger(__name__)

#: bound on the post-stall diagnostic probe: it only feeds ``last_probe``
#: and a counter, so it must not double the stall's blocking time
PROBE_TIMEOUT_S = 2.0


def probe_device_bounded(timeout_s: float = 5.0,
                         device=None) -> "str | None":
    """Run a tiny op on ``device`` (None: the card) and wait for it under
    a bounded wait. Returns the device type (``"cuda"``/``"cpu"``), or
    None when the device did not answer within ``timeout_s``."""
    dev = torch.device("cuda" if device is None else device)
    result: list = []

    def probe() -> None:
        t = torch.zeros((1,), device=dev) + 1.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        float(t[0])
        result.append(dev.type)

    t = threading.Thread(target=probe, daemon=True,
                         name="serving-device-probe")
    t.start()
    t.join(timeout_s)
    return result[0] if result else None


class RoundTimeout:
    """Marker for a watchdogged round that never delivered: the affected
    tenants (the launch-time membership) and nothing else; the plane
    turns each into a failed solve result."""

    def __init__(self, served: tuple):
        self.served = tuple(served)


#: the abandon flag of an unwatchdogged launch: never set
_LIVE = threading.Event()


class PipelinedDispatcher:
    """Per-bucket depth-1 pipeline over
    :class:`~agentlib_mpc_torch.serving.slots.SlotPlane` rounds, with an
    optional watchdog (``timeout_s``) on every launch and decode."""

    def __init__(self, pipelined: bool = True,
                 timeout_s: "float | None" = None,
                 max_leaked_readers: "int | None" = None,
                 device=None):
        self.pipelined = bool(pipelined)
        self.timeout_s = None if timeout_s is None else float(timeout_s)
        self.device = device
        from agentlib_mpc_torch.utils import watchdog as _watchdog

        self._reader = BoundedReader(
            name="serving-round",
            max_leaked=(_watchdog.MAX_LEAKED_READERS
                        if max_leaked_readers is None
                        else max_leaked_readers))
        self._inflight: dict = {}
        #: rounds condemned by a stall in ANOTHER bucket (drained via
        #: :meth:`drain_failed`, never decoded: the card is suspect)
        self._failed: dict = {}
        #: rounds the watchdog declared dead
        self.stalls = 0
        #: True once a stall forced the permanent sync fallback
        self.sync_fallback = False
        #: device type of the post-stall probe (None = no answer)
        self.last_probe: "str | None" = None

    # -- bounded launch and decode ----------------------------------------------

    def _launch_job(self, slot_plane, abandoned: threading.Event):
        """The watchdogged unit of work: one round's launch, skipped
        when the watchdog already gave up on it."""
        if abandoned.is_set():
            return None
        return slot_plane.launch_round()

    def _bounded(self, fn, label: str):
        """Run ``fn`` under the watchdog: its value, or a
        :class:`RoundTimeout` when the device never answered."""
        kind, value = self._reader.run(fn, self.timeout_s)
        if kind == "err":
            # an error in the round is not a stall: the caller sees it
            raise value
        if kind == "timeout":
            return self._stall(label)
        if kind == "saturated":
            return self._stall(label, waited=False)
        return value

    def _launch(self, slot_plane, label: str = ""):
        """Launch one round; a handle, or a :class:`RoundTimeout`."""
        if self.timeout_s is None:
            return self._launch_job(slot_plane, _LIVE)
        abandoned = threading.Event()
        out = self._bounded(
            lambda: self._launch_job(slot_plane, abandoned), label)
        if isinstance(out, RoundTimeout):
            abandoned.set()
        return out

    def _materialize(self, slot_plane, handle, label: str = ""):
        """Decode one round, bounded by the watchdog when armed: the
        decoded results, or a :class:`RoundTimeout`."""
        if self.timeout_s is None:
            return slot_plane.materialize(handle)
        return self._bounded(lambda: slot_plane.materialize(handle), label)

    def _stall(self, label: str, waited: bool = True) -> RoundTimeout:
        self.stalls += 1
        self.sync_fallback = True
        was_pipelined = self.pipelined
        self.pipelined = False
        if telemetry.enabled():
            telemetry.counter(
                "serving_watchdog_stalls_total",
                "in-flight rounds declared dead by the dispatch "
                "watchdog").inc(bucket=label or "?")
        if not waited:
            # the leak cap refused the call outright: the device is
            # already known dead; a probe would just leak one more thread
            telemetry.journal_event(
                "serve.stall", bucket=label or "?", waited=False,
                sync_fallback=True,
                wedged_readers=self._reader.max_leaked)
            logger.error(
                "serving round refused at the watchdog leak cap "
                "(%d wedged readers, bucket %s); shedding its tenants "
                "without waiting", self._reader.max_leaked, label or "?")
            return RoundTimeout(served=())
        self.last_probe = probe_device_bounded(
            min(self.timeout_s, PROBE_TIMEOUT_S), self.device)
        if telemetry.enabled():
            telemetry.counter(
                "serving_watchdog_probes_total",
                "post-stall bounded device probes, by outcome").inc(
                result=self.last_probe or "dead")
        telemetry.journal_event(
            "serve.stall", bucket=label or "?", waited=True,
            budget_s=self.timeout_s, sync_fallback=True,
            probe=self.last_probe or "dead")
        logger.error(
            "serving round stalled past the %.1fs watchdog (bucket %s); "
            "shedding its tenants, %sfalling back to sync dispatch "
            "(device probe: %s)", self.timeout_s, label or "?",
            "" if was_pipelined else "already sync — ",
            self.last_probe or "no answer")
        return RoundTimeout(served=())

    def _condemn_inflight(self) -> None:
        """After a stall, other buckets' in-flight rounds must not
        strand: condemned now, :meth:`drain_failed` sheds them."""
        for k2, (_plane2, handle2) in self._inflight.items():
            self._failed[k2] = RoundTimeout(served=handle2.served)
        self._inflight.clear()

    # -- dispatch -------------------------------------------------------------

    def dispatch(self, key, slot_plane) -> "dict | RoundTimeout | None":
        """Run one round of ``slot_plane``. Synchronous mode returns this
        round's decoded results; pipelined mode returns the previous
        round's (None on the bucket's first round). Either may be a
        :class:`RoundTimeout` when the watchdog fired."""
        label = getattr(key, "digest", None) or str(key)
        if not self.pipelined:
            handle = self._launch(slot_plane, label)
            if isinstance(handle, RoundTimeout):
                handle.served = slot_plane.served_now()
                return handle
            res = self._materialize(slot_plane, handle, label)
            if isinstance(res, RoundTimeout):
                res.served = handle.served
            return res
        handle = self._launch(slot_plane, label)      # k+1 ...
        prev = self._inflight.pop(key, None)
        if isinstance(handle, RoundTimeout):
            # the launch hung: this round's tenants and the previous
            # round's (never decoded: the card is suspect) shed
            handle.served = tuple(dict.fromkeys(
                (*(prev[1].served if prev is not None else ()),
                 *slot_plane.served_now())))
            self._condemn_inflight()
            return handle
        self._inflight[key] = (slot_plane, handle)
        if prev is None:
            return None
        prev_plane, prev_handle = prev
        res = self._materialize(prev_plane, prev_handle, label)
        if isinstance(res, RoundTimeout):
            res.served = prev_handle.served
            # the stall flipped us sync: the round launched above would
            # otherwise sit in flight behind a dead device; shed ITS
            # tenants too
            dead = self._inflight.pop(key, None)
            if dead is not None:
                res.served = tuple(dict.fromkeys(
                    (*res.served, *dead[1].served)))
            self._condemn_inflight()
        return res

    def drain_failed(self) -> dict:
        """Rounds condemned by a stall elsewhere: ``{key:
        RoundTimeout}``, each to be assessed as a failed round. Empties
        the set."""
        out, self._failed = self._failed, {}
        return out

    def flush(self, key=None) -> dict:
        """Decode in-flight rounds (one bucket, or all): ``{key:
        results}``, where a watchdogged (or condemned) bucket's value is
        a :class:`RoundTimeout`. A key with nothing in flight yields no
        entry. Once one bucket stalls inside this drain, the remaining
        rounds are condemned without waiting."""
        keys = [key] if key is not None else list(self._inflight)
        out = {}
        stalled = False
        for k in keys:
            entry = self._inflight.pop(k, None)
            if entry is None:
                continue
            plane, handle = entry
            if stalled:
                out[k] = RoundTimeout(served=handle.served)
                continue
            label = getattr(k, "digest", None) or str(k)
            res = self._materialize(plane, handle, label)
            if isinstance(res, RoundTimeout):
                res.served = handle.served
                stalled = True
            out[k] = res
        if key is None:
            out.update(self.drain_failed())
        else:
            failed = self._failed.pop(key, None)
            if failed is not None:
                out[key] = failed
        return out
