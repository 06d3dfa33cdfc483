"""Agent runtime: variables, broker, clock, modules, agents, LocalMAS.

Port of ``agentlib_mpc_tpu/runtime/{variables,environment,broker,module,
agent,mas}.py`` (none of which imports JAX; the port keeps its own
copies). Agents and modules carry an explicit ``device`` (None: the card)
and ``dtype``. The out-of-process runtime (wire, MQTT, multiprocessing,
container) comes with ROADMAP Queue 1 item 2e.
"""

from agentlib_mpc_torch.runtime.variables import AgentVariable, Source
from agentlib_mpc_torch.runtime.environment import Environment
from agentlib_mpc_torch.runtime.broker import DataBroker, BroadcastBus
from agentlib_mpc_torch.runtime.module import BaseModule, register_module
from agentlib_mpc_torch.runtime.agent import Agent
from agentlib_mpc_torch.runtime.mas import LocalMAS
