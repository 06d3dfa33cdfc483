"""Agent runtime: variables, broker, clock, modules, agents, LocalMAS.

Port of ``agentlib_mpc_tpu/runtime/{variables,environment,broker,module,
agent,mas}.py`` (none of which imports JAX; the port keeps its own
copies). Agents and modules carry an explicit ``device`` (None: the card)
and ``dtype``.

The out-of-process runtime, ported from the same package: ``wire`` (the
length-prefixed JSON frames), ``multiprocessing_mas`` (one spawned process
per agent over a localhost TCP relay), ``mqtt_native`` (the MQTT 3.1.1
subset client and ``MiniBroker``; ``python -m
agentlib_mpc_torch.runtime.mqtt_native PORT`` runs the broker), ``mqtt``
(``MqttBus``) and ``container`` (``python -m
agentlib_mpc_torch.runtime.container``, configured by environment
variables). They are imported where used, not here.
"""

from agentlib_mpc_torch.runtime.variables import AgentVariable, Source
from agentlib_mpc_torch.runtime.environment import Environment
from agentlib_mpc_torch.runtime.broker import DataBroker, BroadcastBus
from agentlib_mpc_torch.runtime.module import BaseModule, register_module
from agentlib_mpc_torch.runtime.agent import Agent
from agentlib_mpc_torch.runtime.mas import LocalMAS
