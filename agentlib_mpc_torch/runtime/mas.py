"""Multi-agent system runners.

Port of ``agentlib_mpc_tpu/runtime/mas.py``; the port keeps its own copy
and imports nothing of the JAX package.

`LocalMAS` replaces the reference's LocalMASAgency
(``examples/one_room_mpc/physical/simple_mpc.py:16,223-227``): build agents
from config dicts, link their brokers over an in-process broadcast bus, run
the shared environment, collect per-module results.

Every agent computes on the MAS's ``device`` (None: the card) in its
``dtype`` (float32 by default); ``device="cpu"`` is the caller's choice,
never a fallback. Fleet scale is
:class:`~agentlib_mpc_torch.parallel.config_bridge.FusedFleet`'s: it batches
structure-identical agents into one engine. A broker-based real-time mode
(rt=True) remains for heterogeneous/interop deployments.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from agentlib_mpc_torch.runtime.agent import Agent
from agentlib_mpc_torch.runtime.broker import BroadcastBus
from agentlib_mpc_torch.runtime.environment import Environment
from agentlib_mpc_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class LocalMAS:
    """All agents in one process on a shared simulated/real-time clock."""

    def __init__(self, agent_configs: list[dict],
                 env: Optional[dict | Environment] = None,
                 variable_logging: bool = False, device=None,
                 dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype
        if isinstance(env, Environment):
            self.env = env
        else:
            env = dict(env or {})
            self.env = Environment(
                rt=bool(env.get("rt", False)),
                factor=float(env.get("factor", 1.0)),
                t_sample=float(env.get("t_sample", 0.0)),
                offset=float(env.get("offset", 0.0)),
            )
        self.bus = BroadcastBus()
        self.agents: dict[str, Agent] = {}
        for cfg in agent_configs:
            agent = Agent(cfg, self.env, device=self.device, dtype=dtype)
            if agent.id in self.agents:
                raise ValueError(f"duplicate agent id {agent.id!r}")
            self.agents[agent.id] = agent
            self.bus.join(agent.data_broker)
        self.variable_logging = variable_logging
        self._started = False

    def run(self, until: float) -> None:
        # start agents exactly once; later run() calls continue the clock
        # without re-registering processes/callbacks
        if not self._started:
            for agent in self.agents.values():
                agent.start()
            self._started = True
        self.env.run(until)

    def terminate(self) -> None:
        """Join background worker threads of all agents' modules. Without
        this, a realtime ADMM worker blocked in a wait can be killed
        mid-C-frame at interpreter exit ('FATAL: exception not rethrown').
        Idempotent; call after the last :meth:`run`."""
        for agent in self.agents.values():
            agent.terminate()

    def get_results(self, cleanup: bool = False) -> dict:
        """dict[agent_id][module_id] → DataFrame (reference
        ``mas.get_results()`` shape, tests/test_examples.py:39-72)."""
        out: dict[str, dict] = {}
        for agent_id, agent in self.agents.items():
            mod_results = {}
            for module_id, module in agent.modules.items():
                res = module.results()
                if res is not None:
                    mod_results[module_id] = res
                if cleanup:
                    module.cleanup_results()
            out[agent_id] = mod_results
        return out


# alias matching the reference's class name for easy migration
LocalMASAgency = LocalMAS
