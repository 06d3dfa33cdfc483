"""Discrete-event / real-time execution environment.

Port of ``agentlib_mpc_tpu/runtime/environment.py``; the port keeps its own copy
and imports nothing of the JAX package.

Replaces the simpy environment the reference's agentlib runs on (module
``process()`` generators yielding ``env.timeout(dt)``,
``modules/mpc/mpc.py:273-276``; real-time flag ``agent.env.config.rt``,
``modules/dmpc/admm/admm_coordinator.py:136-141``). Implementation is a
plain heap scheduler: processes are Python generators yielding float delays;
in rt mode the loop sleeps the (factor-scaled) wall-clock difference.

Design note: the environment only sequences *host-side* control logic —
all numerics happen in the tensor programs the scheduled callbacks launch
on the agent's device. Keeping the scheduler tiny and deterministic is
what makes the fast-sim test mode exactly reproducible.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import time as _time
from typing import Callable, Generator, Iterable, Optional

logger = logging.getLogger(__name__)


class Environment:
    """Cooperative scheduler with simulated or real-time clock."""

    def __init__(self, rt: bool = False, factor: float = 1.0,
                 t_sample: float = 0.0, offset: float = 0.0):
        self.rt = rt
        #: rt speed factor: wall seconds per sim second (reference env
        #: config ``factor``, e.g. 0.01 → 100x fast-forward)
        self.factor = factor
        self.t_sample = t_sample
        self._now = float(offset)
        self._queue: list = []
        self._counter = itertools.count()
        self._stopped = False
        self._t0_wall: Optional[float] = None

    @property
    def now(self) -> float:
        return self._now

    # reference code reads env.time
    time = now

    def process(self, gen: Generator) -> None:
        """Register a process generator; it runs from the current time."""
        self._schedule(self._now, gen)

    def call_at(self, t: float, fn: Callable[[], None]) -> None:
        def _once():
            fn()
            return
            yield  # pragma: no cover - makes this a generator

        self._schedule(max(t, self._now), _once())

    def call_in(self, delay: float, fn: Callable[[], None]) -> None:
        self.call_at(self._now + delay, fn)

    def _schedule(self, t: float, gen: Generator) -> None:
        heapq.heappush(self._queue, (t, next(self._counter), gen))

    def run(self, until: float) -> None:
        """Run the event loop until sim time `until`."""
        self._stopped = False
        self._t0_wall = _time.monotonic() - self._now * self.factor \
            if self.rt else None
        while self._queue and not self._stopped:
            t, _, gen = heapq.heappop(self._queue)
            if t > until:
                # put it back for a potential continuation run
                heapq.heappush(self._queue, (t, next(self._counter), gen))
                break
            if self.rt:
                target_wall = self._t0_wall + t * self.factor
                delay = target_wall - _time.monotonic()
                if delay > 0:
                    _time.sleep(delay)
            self._now = t
            try:
                delay = next(gen)
            except StopIteration:
                continue
            if delay is None:
                delay = 0.0
            self._schedule(self._now + float(delay), gen)
        if not self._stopped:
            # completed the window: clock lands on `until`. After stop()
            # the clock stays at the stop time so resumes are consistent.
            self._now = until

    def stop(self) -> None:
        self._stopped = True
