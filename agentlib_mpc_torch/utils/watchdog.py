"""Bounded-wait readers for watchdogged device work.

Port of ``agentlib_mpc_tpu/utils/watchdog.py``. The serving plane's
watchdog survives a card that never answers by running the blocking call
on a daemon thread and abandoning it on timeout: the thread cannot be
cancelled (it is blocked inside a CUDA call) and stays until the card
answers or the process exits. :class:`BoundedReader` bounds what that
costs:

* **A capped leak.** At most ``max_leaked`` reader threads may be wedged
  at once; at the cap a new call is refused at once (outcome
  ``"saturated"``) instead of waiting out another timeout against a card
  already known dead.
* **One thread for healthy calls.** One persistent worker runs every call
  that completes in time; a new worker is started only while the
  previous one is still wedged, and a wedged worker that unblocks is
  reused.

The number of wedged readers is the ``dispatch_watchdog_threads_leaked``
gauge (labelled by reader name).
"""

from __future__ import annotations

import queue
import threading

from agentlib_mpc_torch import telemetry

#: default cap on concurrently-wedged reader threads per BoundedReader
MAX_LEAKED_READERS = 4


class _Worker:
    """One persistent daemon worker: a job queue in, a per-job result
    queue out. ``busy`` is True from submission until the result is
    posted — a worker stuck inside a wedged device call stays busy."""

    def __init__(self, name: str):
        self._jobs: "queue.Queue" = queue.Queue()
        self.busy = False
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name=name)
        self.thread.start()

    def _loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:              # poison pill: retire the thread
                return
            fn, resq = job
            try:
                res = ("ok", fn())
            except BaseException as exc:  # noqa: BLE001 - forwarded
                res = ("err", exc)
            resq.put(res)
            self.busy = False

    def retire(self) -> None:
        """Ask the (idle) worker thread to exit — an idle worker the
        reader will never reuse must not linger as a silent leak."""
        self._jobs.put(None)

    def submit(self, fn, timeout_s: float):
        """Run ``fn`` on the worker; returns ("ok", value)/("err", exc)
        or None when the bound expired first (the worker stays busy
        until the call unblocks)."""
        resq: "queue.Queue" = queue.Queue()
        self.busy = True
        self._jobs.put((fn, resq))
        try:
            out = resq.get(timeout=timeout_s)
        except queue.Empty:
            return None
        self.busy = False
        return out


class BoundedReader:
    """Reusable bounded-wait runner with a leak cap.

    ``run(fn, timeout_s)`` returns one of::

        ("ok", value)        # fn completed in time
        ("err", exception)   # fn raised (caller re-raises)
        ("timeout", None)    # bound expired; the worker is leaked
        ("saturated", None)  # max_leaked workers already wedged — the
                             # read was refused WITHOUT waiting

    Treat ``timeout`` and ``saturated`` identically at the policy layer
    (the round is dead); ``saturated`` just costs zero extra seconds and
    zero extra threads.
    """

    def __init__(self, name: str = "watchdog-reader",
                 max_leaked: int = MAX_LEAKED_READERS):
        self.name = name
        self.max_leaked = max(1, int(max_leaked))
        self._worker: "_Worker | None" = None
        self._wedged: list = []
        #: previously-wedged workers that unblocked: reusable, never
        #: silently dropped (a dropped worker's thread would idle on
        #: its queue forever — the exact leak this class bounds)
        self._idle: list = []
        #: reads refused at the leak cap (observability)
        self.saturations = 0
        self._lock = threading.Lock()

    def _sweep_locked(self) -> None:
        """Drop dead threads from the wedged set and move workers that
        have since unblocked into the idle (reusable) pool — retiring
        any beyond one spare, so recoveries can never accumulate
        untracked idle threads."""
        recovered = [w for w in self._wedged
                     if not w.busy and w.thread.is_alive()]
        self._wedged = [w for w in self._wedged
                        if w.busy and w.thread.is_alive()]
        self._idle = [w for w in self._idle if w.thread.is_alive()]
        self._idle.extend(recovered)
        while len(self._idle) > 1:
            self._idle.pop().retire()

    def _export_gauge(self) -> None:
        if telemetry.enabled():
            telemetry.gauge(
                "dispatch_watchdog_threads_leaked",
                "watchdog reader threads currently wedged inside an "
                "unanswered device call (capped at max_leaked)").set(
                float(len(self._wedged)), reader=self.name)

    @property
    def leaked(self) -> int:
        with self._lock:
            self._sweep_locked()
            n = len(self._wedged)
        self._export_gauge()
        return n

    def run(self, fn, timeout_s: float):
        with self._lock:
            self._sweep_locked()
            w = self._worker
            if w is not None and (w.busy or not w.thread.is_alive()):
                # the previous read is still blocked (or its thread
                # died): account it wedged and find a replacement
                if w.busy and w.thread.is_alive() and w not in self._wedged:
                    self._wedged.append(w)
                w = None
            if w is None and self._idle:
                # a previously-wedged worker unblocked: reuse it instead
                # of spawning (the single-use-executor reuse)
                w = self._idle.pop(0)
            if w is None:
                if len(self._wedged) >= self.max_leaked:
                    self.saturations += 1
                    self._export_gauge()
                    return ("saturated", None)
                w = _Worker(self.name)
            self._worker = w
        out = w.submit(fn, float(timeout_s))
        if out is None:
            with self._lock:
                if w not in self._wedged:
                    self._wedged.append(w)
                if self._worker is w:
                    self._worker = None
            self._export_gauge()
            return ("timeout", None)
        self._export_gauge()
        return out
