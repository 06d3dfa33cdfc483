"""The port's MQTT transport against the JAX package's.

``agentlib_mpc_torch.runtime.{mqtt,mqtt_native}``: the fast tests of
``tests/test_mqtt.py`` and ``tests/test_mqtt_native.py`` on the port
(the fake-paho bridge, wildcards, pub/sub over TCP, reconnect after a
drop, the seeded backoff ladder, malformed frames, the spec's golden
frames); the packets byte for byte against the JAX package's encoder and
broker; a port agent and a JAX agent exchanging variables both ways over
each package's ``MiniBroker``; and the real-time cooled-room ADMM pair
with each agent in its own ``LocalMAS`` (float64 on the CPU), bridged only
by MQTT frames over TCP.
"""

import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
import torch

from agentlib_mpc_torch.runtime import mqtt as pmqtt
from agentlib_mpc_torch.runtime import mqtt_native as pnative
from agentlib_mpc_torch.runtime.mqtt_native import (
    MiniBroker,
    MiniMqttClient,
    topic_matches,
)
from agentlib_mpc_torch.runtime.variables import AgentVariable, Source
from agentlib_mpc_tpu.runtime import mqtt as jmqtt
from agentlib_mpc_tpu.runtime import mqtt_native as jnative
from agentlib_mpc_tpu.runtime.variables import AgentVariable as JVar
from agentlib_mpc_tpu.runtime.variables import Source as JSource
from test_mqtt import _FakeBrokerHub, _install_fake_paho
from test_mqtt_native import (
    GOLDEN_CONNACK,
    GOLDEN_CONNECT,
    GOLDEN_PUBLISH,
    GOLDEN_SUBACK,
    GOLDEN_SUBSCRIBE,
    _read_frame,
)

from _torch_threads import one_torch_thread  # noqa: F401

#: every socket wait of these tests is bounded: a lost peer fails its test
#: instead of holding the worker
SOCKET_TIMEOUT = 10.0


def _wait_for(predicate, timeout=20.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _force_native(monkeypatch):
    """Make ``import paho.mqtt.client`` fail even if paho were installed."""
    for mod in ("paho", "paho.mqtt", "paho.mqtt.client"):
        monkeypatch.setitem(sys.modules, mod, None)


class _RecordingBroker:
    def __init__(self):
        self.received = []

    def attach_bus(self, bus):
        pass

    def send_variable(self, var, from_external=False):
        self.received.append((var, from_external))


@pytest.fixture()
def broker():
    b = MiniBroker()
    yield b
    b.stop()


# -- the fake-paho bridge (tests/test_mqtt.py) --------------------------------

def test_fake_paho_loopback_and_malformed_payload(monkeypatch, caplog):
    import logging

    hub = _FakeBrokerHub()
    fake_client_cls = _install_fake_paho(monkeypatch, hub)
    bus_a = pmqtt.MqttBus("AgentA", username="u", password="p")
    bus_b = pmqtt.MqttBus("AgentB")
    assert bus_a.client_impl == "paho"
    assert isinstance(bus_a._client, fake_client_cls)
    assert bus_a._client.credentials == ("u", "p")
    rec_a, rec_b = _RecordingBroker(), _RecordingBroker()
    bus_a.attach(rec_a)
    bus_b.attach(rec_b)
    var = AgentVariable(name="T", alias="T_room",
                        value=torch.tensor([1.0, 2.0], dtype=torch.float64),
                        source=Source(agent_id="AgentA", module_id="mpc"))
    bus_a.broadcast("AgentA", var)
    (got, from_external), = rec_b.received
    assert from_external is True and got.alias == "T_room"
    assert got.value == [1.0, 2.0] and got.source.agent_id == "AgentA"
    assert rec_a.received == []          # own echo filtered by topic
    with caplog.at_level(logging.WARNING):
        bus_a._client.publish(f"{pmqtt.TOPIC_PREFIX}/AgentA", b"{not json!")
    assert len(rec_b.received) == 1
    assert any("malformed" in r.message for r in caplog.records)
    bus_a.close()
    bus_b.close()
    assert bus_a._client.loop_running is False


def test_topic_prefix_is_the_wire_contract():
    assert pmqtt.TOPIC_PREFIX == jmqtt.TOPIC_PREFIX == "/agentlib_mpc_tpu"


# -- the native subset (tests/test_mqtt_native.py) ----------------------------

def test_topic_wildcards_match_the_jax_package():
    cases = [("a/b", "a/b"), ("a/b", "a/c"), ("a/+", "a/b"),
             ("a/+", "a/b/c"), ("a/#", "a/b/c"), ("a/#", "a"),
             ("#", "anything/at/all"), ("a/#/b", "a/x/b"),
             ("a/b/c", "a/b"), ("+/+", "/x"), ("+", "")]
    got = [topic_matches(f, t) for f, t in cases]
    assert got == [jnative.topic_matches(f, t) for f, t in cases]
    assert got[:9] == [True, False, True, False, True, True, True, False,
                       False]


def test_pubsub_roundtrip_over_tcp(broker):
    got = []
    sub = MiniMqttClient("sub")
    sub.on_message = lambda c, u, m: got.append((m.topic, bytes(m.payload)))
    sub.connect(broker.host, broker.port)
    sub.subscribe("/fleet/#")
    sub.loop_start()
    pub = MiniMqttClient("pub")
    pub.connect(broker.host, broker.port)
    pub.loop_start()
    assert _wait_for(lambda: broker.n_clients == 2)
    time.sleep(0.1)
    pub.publish("/fleet/roomA", b"hello")
    pub.publish("/other/topic", b"filtered out")
    pub.publish("/fleet/roomB", "text payload")
    assert _wait_for(lambda: len(got) == 2), got
    assert got == [("/fleet/roomA", b"hello"),
                   ("/fleet/roomB", b"text payload")]
    sub.disconnect()
    pub.disconnect()
    assert _wait_for(lambda: broker.n_clients == 0)


def test_mqtt_bus_native_fallback_end_to_end(monkeypatch, broker):
    _force_native(monkeypatch)
    bus_a = pmqtt.MqttBus("AgentA", broker_host=broker.host,
                          broker_port=broker.port)
    bus_b = pmqtt.MqttBus("AgentB", broker_host=broker.host,
                          broker_port=broker.port)
    assert bus_a.client_impl == bus_b.client_impl == "native"
    rec_a, rec_b = _RecordingBroker(), _RecordingBroker()
    bus_a.attach(rec_a)
    bus_b.attach(rec_b)
    assert _wait_for(lambda: broker.n_clients == 2)
    time.sleep(0.1)
    var = AgentVariable(name="T", alias="T_room", value=[1.0, 2.0],
                        source=Source(agent_id="AgentA", module_id="mpc"))
    bus_a.broadcast("AgentA", var)
    assert _wait_for(lambda: len(rec_b.received) == 1)
    got, from_external = rec_b.received[0]
    assert from_external is True and got.alias == "T_room"
    assert list(got.value) == [1.0, 2.0]
    time.sleep(0.1)
    assert rec_a.received == []
    bus_a.close()
    bus_b.close()


def test_reconnect_after_drop(broker):
    got = []
    sub = MiniMqttClient("sub")
    sub.on_message = lambda c, u, m: got.append(bytes(m.payload))
    sub.connect(broker.host, broker.port)
    sub.subscribe("t/#")
    sub.loop_start()
    pub = MiniMqttClient("pub")
    pub.connect(broker.host, broker.port)
    pub.loop_start()
    assert _wait_for(lambda: broker.n_clients == 2)
    time.sleep(0.1)
    pub.publish("t/1", b"before")
    assert _wait_for(lambda: got == [b"before"])
    broker.drop_clients()
    assert _wait_for(lambda: sub.reconnects >= 1 and pub.reconnects >= 1), \
        "clients did not reconnect after the drop"
    assert _wait_for(lambda: broker.n_clients == 2)
    time.sleep(0.1)
    pub.publish("t/2", b"after")
    assert _wait_for(lambda: got == [b"before", b"after"]), got
    sub.disconnect()
    pub.disconnect()


def test_silent_peer_cannot_wedge_connect():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    try:
        client = MiniMqttClient("wedge")
        t0 = time.time()
        with pytest.raises(OSError):
            client.connect(*srv.getsockname(), timeout=0.5)
        assert time.time() - t0 < 5.0
    finally:
        srv.close()


def test_credentials_are_refused_loudly(caplog):
    import logging

    client = MiniMqttClient("auth")
    with caplog.at_level(logging.WARNING, logger=pnative.__name__):
        client.username_pw_set("user", "hunter2")
    assert "NOT be sent" in caplog.text and "hunter2" not in caplog.text

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(SOCKET_TIMEOUT)

    def refuse():
        sess, _ = srv.accept()
        sess.recv(1024)
        sess.sendall(bytes([0x20, 0x02, 0x00, 0x05]))   # not authorized
        sess.close()

    t = threading.Thread(target=refuse, daemon=True)
    t.start()
    try:
        with pytest.raises(ConnectionError, match="credentials"):
            client.connect(*srv.getsockname(), timeout=2.0)
    finally:
        t.join(timeout=5.0)
        srv.close()


def test_backoff_ladder_is_the_jax_package_ladder():
    """Seeded decorrelated jitter: the port's sequence is the JAX
    package's for the same client id, seed and bounds."""
    for kwargs in ({}, {"reconnect_seed": 1}, {"reconnect_seed": 2},
                   {"reconnect_max_delay": 0.2, "reconnect_seed": 3}):
        p = MiniMqttClient("a", **kwargs)
        j = jnative.MiniMqttClient("a", **kwargs)
        seq = [p._next_backoff() for _ in range(12)]
        assert seq == [j._next_backoff() for _ in range(12)]
        cap = kwargs.get("reconnect_max_delay", 1.0)
        assert all(0.05 <= s <= cap for s in seq)
    a = MiniMqttClient("a", reconnect_seed=1)
    assert [a._next_backoff() for _ in range(8)] != [
        min(0.05 * 2 ** (i + 1), 1.0) for i in range(8)]
    with pytest.raises(ValueError, match="reconnect_max_delay"):
        MiniMqttClient("a", reconnect_base=0.5, reconnect_max_delay=0.1)


def test_reader_redials_with_jitter_on_a_fake_socket(monkeypatch):
    client = MiniMqttClient("jitter", reconnect_max_delay=0.5,
                            reconnect_seed=7)
    sleeps: list[float] = []
    monkeypatch.setattr(pnative.time, "sleep", sleeps.append)
    dials = {"n": 0}

    def fake_dial(timeout=1.0):
        dials["n"] += 1
        if dials["n"] <= 5:
            raise OSError("connection refused")
        client._stop.set()

    monkeypatch.setattr(client, "_dial", fake_dial)

    class DeadSocket:
        def recv(self, n):
            raise ConnectionError("gone")

    client._sock = DeadSocket()
    client._reader()
    assert dials["n"] == 6 and len(sleeps) == 5
    assert all(0.05 <= s <= 0.5 for s in sleeps) and len(set(sleeps)) > 1
    assert client.reconnects == 1
    assert client._backoff == client._reconnect_base


@pytest.mark.parametrize("frame", [
    b"\x00", b"\xf0\x00", b"\x10\x02\x00", b"\x10\x80\x80\x80\x80\x80",
    bytes([0x10, 0x06]) + b"\x00\x99MQTT", b"\x30\x03\x00\x10a",
    b"\x82\x03\x00\x01\x05",
], ids=["type0", "type15", "short-connect", "varint-overflow",
        "bad-proto-len", "bad-topic-len", "short-subscribe"])
def test_malformed_first_frame_costs_only_its_session(broker, frame):
    s = socket.create_connection((broker.host, broker.port),
                                 timeout=SOCKET_TIMEOUT)
    s.sendall(frame)
    s.close()
    assert _wait_for(lambda: broker.n_clients == 0)
    c = MiniMqttClient(client_id="health")
    got = []
    c.on_message = lambda _c, _u, m: got.append(m.payload)
    c.connect(broker.host, broker.port)
    c.loop_start()
    c.subscribe("h/#")
    time.sleep(0.1)
    c.publish("h/x", b"ok")
    assert _wait_for(lambda: got == [b"ok"])
    c.disconnect()


# -- byte equality with the JAX package and the spec ---------------------------

def test_varint_and_packets_equal_the_jax_encoder():
    for n in (0, 1, 127, 128, 16383, 16384, 2097151, 2097152, 268435455):
        assert pnative._encode_varint(n) == jnative._encode_varint(n)
    assert pnative._encode_varint(16384) == b"\x80\x80\x01"
    for ptype, flags, body in ((pnative.CONNECT, 0, b"x" * 5),
                               (pnative.PUBLISH, 0, b"y" * 300),
                               (pnative.SUBSCRIBE, 2, b"z" * 20000),
                               (pnative.PINGREQ, 0, b"")):
        assert pnative._packet(ptype, flags, body) == jnative._packet(
            ptype, flags, body)
    assert pnative._mqtt_str("sensors/+/temp") == jnative._mqtt_str(
        "sensors/+/temp")


def _client_frames(client_cls, payload):
    """Every frame a client of ``client_cls`` puts on a raw socket for one
    CONNECT, SUBSCRIBE, PUBLISH and DISCONNECT."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(SOCKET_TIMEOUT)
    client = client_cls(client_id="demo")
    frames = []
    try:
        t = threading.Thread(
            target=lambda: client.connect("127.0.0.1", srv.getsockname()[1]),
            daemon=True)
        t.start()
        conn, _ = srv.accept()
        conn.settimeout(SOCKET_TIMEOUT)
        frames.append(_read_frame(conn))
        conn.sendall(GOLDEN_CONNACK)
        t.join(timeout=5.0)
        assert not t.is_alive()
        client.subscribe("sensors/+/temp")
        frames.append(_read_frame(conn))
        conn.sendall(GOLDEN_SUBACK)
        client.publish("sensors/a/temp", payload)
        frames.append(_read_frame(conn))
        client.disconnect()
        frames.append(_read_frame(conn))
        conn.close()
    finally:
        client.loop_stop()
        srv.close()
    return frames


def test_client_packets_equal_the_jax_client_and_the_spec():
    big = bytes(range(256)) * 600      # a 3-byte remaining length
    for payload in ("21.5", big):
        port = _client_frames(MiniMqttClient, payload)
        assert port == _client_frames(jnative.MiniMqttClient, payload)
    port = _client_frames(MiniMqttClient, "21.5")
    assert port[:3] == [GOLDEN_CONNECT, GOLDEN_SUBSCRIBE, GOLDEN_PUBLISH]
    assert port[3] == b"\xe0\x00"        # DISCONNECT


def _broker_conversation(broker):
    sub = socket.create_connection((broker.host, broker.port),
                                   timeout=SOCKET_TIMEOUT)
    pub = socket.create_connection((broker.host, broker.port),
                                   timeout=SOCKET_TIMEOUT)
    try:
        sub.sendall(GOLDEN_CONNECT)
        out = [_read_frame(sub)]
        sub.sendall(GOLDEN_SUBSCRIBE)
        out.append(_read_frame(sub))
        pub.sendall(bytes([0x10, 0x10]) + b"\x00\x04MQTT\x04\x02"
                    + struct.pack(">H", 60) + b"\x00\x04pub0")
        out.append(_read_frame(pub))
        pub.sendall(GOLDEN_PUBLISH)
        out.append(_read_frame(sub))
        pub.sendall(bytes([0xC0, 0x00]))          # PINGREQ
        out.append(_read_frame(pub))
    finally:
        sub.close()
        pub.close()
    return out


def test_broker_speaks_the_jax_brokers_bytes(broker):
    jbroker = jnative.MiniBroker()
    try:
        port = _broker_conversation(broker)
        assert port == _broker_conversation(jbroker)
    finally:
        jbroker.stop()
    assert port == [GOLDEN_CONNACK, GOLDEN_SUBACK, GOLDEN_CONNACK,
                    GOLDEN_PUBLISH, b"\xd0\x00"]


# -- a mixed fleet: port and JAX agents on one broker --------------------------

@pytest.mark.parametrize("broker_pkg", ["port", "jax"])
def test_port_and_jax_agents_exchange_variables(monkeypatch, broker_pkg):
    _force_native(monkeypatch)
    mb = (MiniBroker if broker_pkg == "port" else jnative.MiniBroker)()
    try:
        pbus = pmqtt.MqttBus("PortRoom", broker_host=mb.host,
                             broker_port=mb.port)
        jbus = jmqtt.MqttBus("JaxCooler", broker_host=mb.host,
                             broker_port=mb.port)
        prec, jrec = _RecordingBroker(), _RecordingBroker()
        pbus.attach(prec)
        jbus.attach(jrec)
        assert _wait_for(lambda: mb.n_clients == 2)
        time.sleep(0.1)
        traj = np.linspace(0.01, 0.05, 4)
        pbus.broadcast("PortRoom", AgentVariable(
            name="mDot", alias="air", value=torch.tensor(traj),
            source=Source(agent_id="PortRoom", module_id="admm")))
        jbus.broadcast("JaxCooler", JVar(
            name="mDot_out", alias="air", value=2.0 * traj,
            source=JSource(agent_id="JaxCooler", module_id="admm")))
        assert _wait_for(lambda: len(prec.received) == 1
                         and len(jrec.received) == 1)
        (at_jax, ext_j), = jrec.received
        (at_port, ext_p), = prec.received
        assert ext_j and ext_p
        assert (at_jax.name, at_jax.alias, at_jax.source.agent_id) == (
            "mDot", "air", "PortRoom")
        assert (at_port.name, at_port.alias, at_port.source.agent_id) == (
            "mDot_out", "air", "JaxCooler")
        np.testing.assert_array_equal(at_jax.value, traj)
        np.testing.assert_array_equal(at_port.value, 2.0 * traj)
        pbus.close()
        jbus.close()
    finally:
        mb.stop()


# -- the real-time cooled-room pair over MQTT ----------------------------------

def test_realtime_cooled_room_pair_over_mqtt(monkeypatch, broker):
    """tests/test_admm_realtime.py's pair with each agent in its own
    LocalMAS (f64 on the CPU, 10 s of wall clock): every coupling
    broadcast crosses the wire as MQTT frames."""
    _force_native(monkeypatch)
    from agentlib_mpc_torch import reference_configs as rc
    from agentlib_mpc_torch.runtime.mas import LocalMAS

    room_cfg, cool_cfg = rc.admm_realtime_pair_configs()
    mases = [LocalMAS([cfg], env={"rt": True, "factor": 1.0}, device="cpu",
                      dtype=torch.float64) for cfg in (room_cfg, cool_cfg)]
    buses = []
    for mas in mases:
        for agent_id, agent in mas.agents.items():
            bus = pmqtt.MqttBus(agent_id, broker_host=broker.host,
                                broker_port=broker.port)
            bus.attach(agent.data_broker)
            buses.append(bus)
    room = mases[0].agents["Room"].get_module("admm")
    cooler = mases[1].agents["Cooler"].get_module("admm")
    try:
        t_cool = threading.Thread(target=lambda: mases[1].run(until=10.0),
                                  daemon=True)
        t_cool.start()
        mases[0].run(until=10.0)
        t_cool.join(timeout=30.0)
        assert not t_cool.is_alive()
        assert _wait_for(lambda: all(
            m.rounds_run + m.failed_rounds >= 1 and not m.start_step.is_set()
            for m in (room, cooler)), timeout=30.0)
    finally:
        for mas in mases:
            mas.terminate()
        for bus in buses:
            bus.close()
    wire = "admm_coupling_air"
    assert any(s.agent_id == "Cooler"
               for s in room._registered_participants[wire])
    assert any(s.agent_id == "Room"
               for s in cooler._registered_participants[wire])
    assert broker.messages_routed > 0
    for m in (room, cooler):
        assert m.failed_rounds == 0 and m.rounds_run >= 1
        assert m._iter_rows and all(r["stats"]["success"]
                                    for r in m._iter_rows)
        assert m.backend.dtype == torch.float64
    mean = np.asarray(room._admm_values["admm_coupling_mean_mDot"])
    assert mean.shape == (4,) and np.isfinite(mean).all()
