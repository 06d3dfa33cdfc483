"""Process-per-agent MAS with a localhost broadcast broker.

Port of ``agentlib_mpc_tpu/runtime/multiprocessing_mas.py``; the port
keeps its own copy and imports nothing of the JAX package.

Counterpart of the reference's ``MultiProcessingMAS`` +
``multiprocessing_broadcast`` communicator
(``examples/admm/admm_example_multiprocessing.py:28-36``): every agent runs
in its own OS process with a real-time(-scaled) clock, linked through a
central TCP relay on localhost. The relay forwards length-prefixed JSON
frames from each connection to every other — the same star topology as
the reference's ``MultiProcessingBroker``.

The per-agent wiring mirrors the in-process ``BroadcastBus`` seam: shared
variables leaving an agent's DataBroker are framed onto the socket; a
reader thread injects received variables with ``from_external=True``.
Everything device-side (CUDA context, kernels, warm starts) stays
process-local: the children are started by the ``spawn`` context, so they
inherit no CUDA state, and each builds its agent on the ``device`` and in
the ``dtype`` the MAS was given (None: the card).
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import socket
import threading
import time as _time
from typing import Optional

import torch

from agentlib_mpc_torch.runtime.wire import (
    FramedSocket,
    var_from_wire,
    var_to_wire,
)
from agentlib_mpc_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class MultiProcessingBroker:
    """Central localhost relay (reference ``MultiProcessingBroker``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen()
        self.host, self.port = self._server.getsockname()
        self._clients: list[FramedSocket] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                raw, _ = self._server.accept()
            except OSError:
                return
            conn = FramedSocket(raw)
            with self._lock:
                self._clients.append(conn)
            t = threading.Thread(target=self._relay_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _relay_loop(self, conn: FramedSocket) -> None:
        while not self._stop.is_set():
            try:
                frame = conn.recv_frame()
            except OSError:
                break
            if frame is None:
                break
            with self._lock:
                targets = [c for c in self._clients if c is not conn]
            for c in targets:
                try:
                    c.send_frame(frame)
                except OSError:
                    pass
        with self._lock:
            if conn in self._clients:
                self._clients.remove(conn)
        conn.close()

    def close(self) -> None:
        self._stop.set()
        try:
            self._server.close()
        except OSError:
            pass
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()


class SocketBus:
    """Drop-in for BroadcastBus backed by the relay socket."""

    def __init__(self, sock: socket.socket, broker):
        self._sock = FramedSocket(sock)
        self._broker = broker
        self._stop = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)

    def start(self) -> None:
        self._reader.start()

    def broadcast(self, from_agent: str, var) -> None:
        try:
            self._sock.send_frame(var_to_wire(var))
        except OSError as exc:
            logger.warning("broadcast failed: %s", exc)

    def _read_loop(self) -> None:
        while not self._stop.is_set():
            try:
                frame = self._sock.recv_frame()
            except OSError:
                return
            if frame is None:
                return
            try:
                var = var_from_wire(frame)
            except (ValueError, KeyError) as exc:
                logger.warning("dropping malformed frame: %s", exc)
                continue
            self._broker.send_variable(var, from_external=True)

    def stop(self) -> None:
        """Close the socket and join the reader thread: a variable it is
        delivering may be running a solve (a coordinated participant
        solves in the delivering thread), and a daemon thread inside a
        torch call when the interpreter exits aborts the process."""
        self._stop.set()
        try:
            self._sock.sock.shutdown(socket.SHUT_RDWR)   # wakes recv()
        except OSError:
            pass
        self._sock.close()
        if self._reader.is_alive() \
                and self._reader is not threading.current_thread():
            self._reader.join(timeout=30.0)


def _agent_process_main(agent_config: dict, env_config: dict,
                        host: str, port: int, until: float,
                        result_queue: mp.Queue,
                        bootstrap=None, barrier=None,
                        device: str = "cuda",
                        dtype: torch.dtype = torch.float32) -> None:
    """Child entry: build the agent on ``device`` in ``dtype``, bridge its
    broker to the relay, run.

    ``bootstrap``: optional callable executed first in the fresh process —
    the per-process runtime hook (logging setup, thread counts, core
    affinity). Spawned children inherit no parent runtime state.

    ``barrier``: start barrier across all agent processes. Without it,
    import and start-up skew (torch's import, the CUDA context, the kernel
    libraries a precompiling backend loads) means one agent's real-time
    clock can run out before another is even connected — the same reason
    the reference opens a registration window before each round
    (``admm.py:249-261``). Each child creates its CUDA context before
    the barrier."""
    if bootstrap is not None:
        bootstrap()
    import agentlib_mpc_torch.modules  # noqa: F401 - register module types
    from agentlib_mpc_torch.runtime.agent import Agent
    from agentlib_mpc_torch.runtime.environment import Environment

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.zeros((), device=dev)   # the context, before the clock
    sock = socket.create_connection((host, port), timeout=10.0)
    # the timeout bounds the dial only: the reader blocks between frames,
    # and a quiet spell (the barrier, a long solve) must not end it
    sock.settimeout(None)
    env = Environment(**env_config)
    agent = Agent(agent_config, env, device=dev, dtype=dtype)
    bus = SocketBus(sock, agent.data_broker)
    agent.data_broker.attach_bus(bus)
    bus.start()
    agent.start()
    try:
        if barrier is not None:
            barrier.wait(timeout=600.0)
        env.run(until=until)
        results = {}
        for module_id, module in agent.modules.items():
            res = module.results()
            if res is not None:
                results[module_id] = res
        result_queue.put((agent.id, results))
    finally:
        agent.terminate()
        bus.stop()


class MultiProcessingMAS:
    """Process-per-agent runner (reference ``MultiProcessingMAS``).

    env defaults to real time with a fast-forward factor — cross-process
    sync has no shared simulated clock, exactly like the reference, which
    is real-time-locked in this mode. Every child computes on ``device``
    (None: the card; resolved here, so a missing card raises before any
    child starts) in ``dtype``, as :class:`LocalMAS` does."""

    def __init__(self, agent_configs: list[dict],
                 env: Optional[dict] = None, host: str = "127.0.0.1",
                 bootstrap=None, device=None,
                 dtype: torch.dtype = torch.float32):
        self.agent_configs = list(agent_configs)
        self.bootstrap = bootstrap
        self.device = resolve_device(device)
        self.dtype = dtype
        self.env_config = {"rt": True, "factor": 1.0, **(env or {})}
        if not self.env_config.get("rt", True):
            raise ValueError(
                "MultiProcessingMAS requires a real-time environment "
                "(rt=True, optionally factor<1 for fast-forward); use "
                "LocalMAS for fast simulation")
        self.broker = MultiProcessingBroker(host=host)
        self._results: dict = {}

    def run(self, until: float, join_timeout: Optional[float] = None) -> None:
        ctx = mp.get_context("spawn")
        queue: mp.Queue = ctx.Queue()
        barrier = ctx.Barrier(len(self.agent_configs))
        procs = []
        for cfg in self.agent_configs:
            p = ctx.Process(
                target=_agent_process_main,
                args=(cfg, self.env_config, self.broker.host,
                      self.broker.port, until, queue, self.bootstrap,
                      barrier, str(self.device), self.dtype),
                daemon=True)
            p.start()
            procs.append(p)
        if join_timeout is None:
            join_timeout = until * self.env_config.get("factor", 1.0) + 60.0
        deadline = _time.monotonic() + join_timeout
        for _ in procs:
            remaining = max(deadline - _time.monotonic(), 0.1)
            try:
                agent_id, results = queue.get(timeout=remaining)
                self._results[agent_id] = results
            except Exception:  # queue.Empty
                logger.warning("an agent process missed the deadline")
                break
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.terminate()
        self.broker.close()

    def get_results(self) -> dict:
        return dict(self._results)
