"""MQTT communicator: cross-machine interop path.

Port of ``agentlib_mpc_tpu/runtime/mqtt.py``; the port keeps its own copy
and imports nothing of the JAX package.

Counterpart of the reference's MQTT communicator (topics
``/agentlib/<agent_id>``, ``docs/source/tutorials/ADMM.md:69-97``).
paho-mqtt is used when installed (full interop with external brokers,
auth, TLS via paho configuration); without it the bus falls back to the
first-party MQTT 3.1.1 subset client
(:mod:`agentlib_mpc_torch.runtime.mqtt_native`) — real TCP sockets,
wildcard subscriptions, automatic reconnect — so the MQTT transport
works out of the box with zero optional dependencies (against
:class:`~agentlib_mpc_torch.runtime.mqtt_native.MiniBroker` or any
standard broker speaking MQTT 3.1.1).
"""

from __future__ import annotations

import logging
from typing import Optional

from agentlib_mpc_torch.runtime.wire import var_from_wire, var_to_wire

logger = logging.getLogger(__name__)

# The JAX package's prefix, kept as it is: the topic is part of the wire
# contract, so agents of both packages can share one broker (a mixed fleet).
TOPIC_PREFIX = "/agentlib_mpc_tpu"


class MqttBus:
    """BroadcastBus-compatible bridge publishing shared variables to
    ``<prefix>/<agent_id>`` and subscribing to ``<prefix>/#``."""

    def __init__(self, agent_id: str, broker_host: str = "localhost",
                 broker_port: int = 1883, prefix: str = TOPIC_PREFIX,
                 username: Optional[str] = None,
                 password: Optional[str] = None,
                 reconnect_base: float = 0.05,
                 reconnect_max_delay: float = 1.0):
        """``reconnect_base`` / ``reconnect_max_delay`` bound the native
        client's decorrelated-jitter redial backoff (a fleet must not
        thundering-herd a restarting broker); with paho installed they
        map onto ``reconnect_delay_set(min_delay, max_delay)``."""
        self.agent_id = agent_id
        self.prefix = prefix.rstrip("/")
        self._broker = None
        try:
            import paho.mqtt.client as mqtt
        except ImportError:
            from agentlib_mpc_torch.runtime.mqtt_native import MiniMqttClient

            logger.info("paho-mqtt not installed; using the first-party "
                        "MQTT 3.1.1 subset client")
            self.client_impl = "native"
            self._client = MiniMqttClient(
                client_id=agent_id, reconnect_base=reconnect_base,
                reconnect_max_delay=reconnect_max_delay)
        else:
            self.client_impl = "paho"
            try:  # paho-mqtt >= 2.0 requires an explicit callback version
                self._client = mqtt.Client(mqtt.CallbackAPIVersion.VERSION1)
            except AttributeError:  # paho-mqtt 1.x
                self._client = mqtt.Client()
            try:
                self._client.reconnect_delay_set(
                    min_delay=max(reconnect_base, 1e-3),
                    max_delay=reconnect_max_delay)
            except AttributeError:   # stub/exotic client without the knob
                pass
        if username:
            self._client.username_pw_set(username, password)
        self._client.on_message = self._on_message
        self._client.connect(broker_host, broker_port)
        self._client.subscribe(f"{self.prefix}/#")
        self._client.loop_start()

    def attach(self, data_broker) -> None:
        self._broker = data_broker
        data_broker.attach_bus(self)

    # BroadcastBus seam -------------------------------------------------------
    def broadcast(self, from_agent: str, var) -> None:
        self._client.publish(f"{self.prefix}/{from_agent}",
                             var_to_wire(var))

    def _on_message(self, client, userdata, msg) -> None:
        if msg.topic == f"{self.prefix}/{self.agent_id}":
            return  # own echo
        if self._broker is None:
            return
        try:
            var = var_from_wire(msg.payload)
        except (ValueError, KeyError) as exc:
            logger.warning("dropping malformed MQTT payload: %s", exc)
            return
        self._broker.send_variable(var, from_external=True)

    def close(self) -> None:
        self._client.loop_stop()
        self._client.disconnect()
