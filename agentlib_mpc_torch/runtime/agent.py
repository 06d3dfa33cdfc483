"""Agent: a named bundle of modules sharing a data broker.

Port of ``agentlib_mpc_tpu/runtime/agent.py``; the port keeps its own copy
and imports nothing of the JAX package.

Replaces agentlib's Agent (``modules/mpc/mpc.py:9``): holds the per-agent
DataBroker, instantiates modules from config dicts, and wires their
processes into the environment. An agent carries the ``device`` (None: the
card) and ``dtype`` its modules compute on.
"""

from __future__ import annotations

import logging

import torch

from agentlib_mpc_torch.runtime.broker import DataBroker
from agentlib_mpc_torch.runtime.environment import Environment
from agentlib_mpc_torch.runtime.module import BaseModule, create_module
from agentlib_mpc_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)


class Agent:
    def __init__(self, config: dict, env: Environment, device=None,
                 dtype: torch.dtype = torch.float32):
        self.id = config["id"]
        self.env = env
        self.device = resolve_device(device)
        self.dtype = dtype
        self.config = config
        self.data_broker = DataBroker(self.id)
        self.modules: dict[str, BaseModule] = {}
        for mod_cfg in config.get("modules", []):
            # communicator entries of the reference configs are accepted and
            # skipped for config compatibility: the buses carry the traffic
            # ("local"/"local_broadcast": the LocalMAS bus;
            # "multiprocessing_broadcast": the relay of
            # runtime/multiprocessing_mas.py; "mqtt": runtime/mqtt.MqttBus,
            # attached by runtime/container.py)
            if mod_cfg.get("type") in ("local", "local_broadcast",
                                       "multiprocessing_broadcast", "mqtt"):
                continue
            module = create_module(mod_cfg, self)
            if module.id in self.modules:
                raise ValueError(
                    f"duplicate module_id {module.id!r} in agent {self.id}")
            self.modules[module.id] = module

    def start(self) -> None:
        for module in self.modules.values():
            module.register_callbacks()
        for module in self.modules.values():
            gen = module.process()
            if gen is not None:
                self.env.process(gen)

    def get_module(self, module_id: str) -> BaseModule:
        return self.modules[module_id]

    def terminate(self) -> None:
        """Shut down every module's background resources (reverse order).
        A failing terminate() is logged, not raised — but never silent: a
        skipped module's worker thread resurfaces as an interpreter-exit
        crash, and the log line is the only clue connecting the two."""
        for module in reversed(list(self.modules.values())):
            try:
                module.terminate()
            except Exception:  # noqa: BLE001 - shutdown must not raise
                logger.exception(
                    "terminate() of module %r failed",
                    getattr(module, "module_id", module))
