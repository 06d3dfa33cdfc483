"""Module base class and registry.

Port of ``agentlib_mpc_tpu/runtime/module.py``; the port keeps its own copy
and imports nothing of the JAX package.

Replaces agentlib's BaseModule/BaseModuleConfig contract that every
reference module builds on (``modules/mpc/mpc.py:9-14``): a module is
instantiated from a JSON-shaped config dict, owns a typed variable store,
receives variable updates through broker callbacks, and contributes a
``process()`` generator to the environment.

Modules read the agent's ``device`` and ``dtype`` (set on
:class:`~agentlib_mpc_torch.runtime.agent.Agent`); nothing else chooses a
device. A config naming a module type of a later slice of the port would
raise ``NotImplementedError`` naming its ROADMAP item
(:data:`DEFERRED_MODULE_TYPES`, empty since the ML slice).

Config shape (compatible with the reference's agent configs):
    {"module_id": "myMPC", "type": "mpc", <scalar options...>,
     "inputs": [{...var...}], "outputs": [...], ...}

Module classes declare which config keys are variable groups
(``variable_groups``) and which groups are broadcast by default
(``shared_groups``). String type keys resolve through MODULE_TYPES —
the reference's registry pattern (``modules/__init__.py:21-79``) without
the import indirection.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Iterable, Optional, Type

from agentlib_mpc_torch.runtime.variables import AgentVariable, Source

logger = logging.getLogger(__name__)

MODULE_TYPES: dict[str, Type["BaseModule"]] = {}

#: module types of the JAX package whose slice of the port has not come
#: yet, with the ROADMAP Queue 1 item that brings each
DEFERRED_MODULE_TYPES: dict[str, str] = {}


def register_module(*names: str):
    def deco(cls):
        for n in names:
            MODULE_TYPES[n] = cls
        cls.type_names = names
        return cls
    return deco


def create_module(config: dict, agent) -> "BaseModule":
    type_key = config.get("type")
    if isinstance(type_key, dict):
        # custom injection: {"file": path, "class_name": X} — the reference's
        # custom_injection hook (modules/mpc/mpc.py:120-122)
        from agentlib_mpc_torch.backends.backend import load_custom_class

        cls = load_custom_class(type_key["file"], type_key["class_name"])
    else:
        # importing the package registers every ported type, so a LocalMAS
        # needs no import of its own
        import agentlib_mpc_torch.modules  # noqa: F401

        if type_key in DEFERRED_MODULE_TYPES and type_key not in MODULE_TYPES:
            raise NotImplementedError(
                f"module type {type_key!r} is not ported yet: it comes with "
                f"ROADMAP Queue 1 item {DEFERRED_MODULE_TYPES[type_key]}")
        if type_key not in MODULE_TYPES:
            raise KeyError(
                f"unknown module type {type_key!r}; known: "
                f"{sorted(MODULE_TYPES)}")
        cls = MODULE_TYPES[type_key]
    return cls(config, agent)


class BaseModule:
    """Base for all agent modules."""

    #: config keys parsed as lists of AgentVariables
    variable_groups: tuple[str, ...] = ("inputs", "outputs", "states",
                                        "parameters")
    #: groups whose variables default to shared=True (broadcast)
    shared_groups: tuple[str, ...] = ("outputs",)
    type_names: tuple[str, ...] = ()

    def __init__(self, config: dict, agent):
        self.config = dict(config)
        self.agent = agent
        self.id = config.get("module_id", type(self).__name__)
        self.env = agent.env
        #: the agent's device and dtype: what backends and plants run on
        self.device = agent.device
        self.dtype = agent.dtype
        self.logger = logging.getLogger(
            f"{type(self).__name__}[{agent.id}/{self.id}]")
        #: shutdown signal for modules running background workers; checked
        #: by abortable loops (e.g. ADMM round termination) and set by
        #: :meth:`terminate`. Part of the module contract, not ad-hoc.
        self._stop = threading.Event()
        self.vars: dict[str, AgentVariable] = {}
        self._groups: dict[str, list[str]] = {}
        for group in self.variable_groups:
            names = []
            for cfg in config.get(group, []):
                var = AgentVariable.from_config(cfg)
                # group default shared=True applies only when the config
                # did not set the flag explicitly (dict without "shared");
                # an AgentVariable instance always carries its own choice
                explicit = isinstance(cfg, AgentVariable) or (
                    isinstance(cfg, dict) and "shared" in cfg)
                if group in self.shared_groups and not explicit:
                    var.shared = True
                self._declare(var, group)
                names.append(var.name)
            self._groups[group] = names

    # -- variable store -------------------------------------------------------

    def _declare(self, var: AgentVariable, group: str) -> None:
        if var.name in self.vars:
            raise ValueError(
                f"duplicate variable {var.name!r} in module {self.id}")
        self.vars[var.name] = var

    def variables_in_group(self, group: str) -> list[AgentVariable]:
        return [self.vars[n] for n in self._groups.get(group, [])]

    def get(self, name: str) -> AgentVariable:
        return self.vars[name]

    def get_value(self, name: str):
        return self.vars[name].value

    def set(self, name: str, value) -> None:
        """Update a variable and publish it to the broker (the reference's
        ``self.set(...)`` → data_broker.send_variable path)."""
        var = self.vars[name]
        var.value = value
        var.timestamp = self.env.now
        out = var.copy(source=Source(agent_id=self.agent.id,
                                     module_id=self.id))
        self.agent.data_broker.send_variable(out)

    def send(self, var: AgentVariable) -> None:
        """Publish an ad-hoc variable (not necessarily declared)."""
        out = var.copy(source=Source(agent_id=self.agent.id,
                                     module_id=self.id))
        out.timestamp = self.env.now
        self.agent.data_broker.send_variable(out)

    # -- lifecycle ------------------------------------------------------------

    def register_callbacks(self) -> None:
        """Subscribe to updates for declared variables that reference an
        external source or alias. Default: every variable whose config gave
        an explicit source, or whose alias differs from its name, is
        listened for; received values update the local store."""
        for var in self.vars.values():
            explicit_source = var.source.agent_id is not None \
                or var.source.module_id is not None
            if explicit_source or var.alias != var.name or not var.shared:
                self.agent.data_broker.register_callback(
                    var.alias, var.source, self._make_update_callback(var.name))

    def _make_update_callback(self, name: str):
        def _cb(incoming: AgentVariable):
            local = self.vars[name]
            local.value = incoming.value
            local.timestamp = incoming.timestamp
        return _cb

    def process(self):
        """Override: generator yielding delays (seconds). Default: inert."""
        return None

    def terminate(self) -> None:
        """Release background resources (worker threads, sockets). Called
        by :meth:`Agent.terminate` at MAS shutdown; the default sets the
        ``_stop`` event. Must be idempotent and must not raise."""
        self._stop.set()

    def _join_worker(self, thread, wake_events=(), timeout: float = 10.0):
        """Shared worker-shutdown sequence: signal stop, wake the thread
        out of any event wait, join with a budget, report a stuck worker.
        Returns None (the caller clears its thread reference)."""
        self._stop.set()
        for event in wake_events:
            event.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=timeout)
            if thread.is_alive():  # pragma: no cover - diagnostic path
                self.logger.error(
                    "worker thread %s did not stop within %.1fs",
                    thread.name, timeout)
        return None

    def cleanup_results(self) -> None:
        pass

    def results(self):
        """Override: return a pandas DataFrame of recorded results."""
        return None
