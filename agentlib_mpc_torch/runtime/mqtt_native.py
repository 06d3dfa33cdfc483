"""First-party MQTT 3.1.1 subset: broker + client over real TCP sockets.

Port of ``agentlib_mpc_tpu/runtime/mqtt_native.py``; the port keeps its
own copy and imports nothing of the JAX package. The packets are byte for
byte the JAX package's, so a client of either package works against a
broker of the other.

The reference's MQTT path rides paho-mqtt against an external broker
(``examples/admm/configs/communicators/cooled_room_mqtt.json``), both of
them optional installs. So that the transport works and is tested without
either, the protocol subset the framework uses is implemented natively —
the same first-party move as the C++ CIA schedule replacing pycombina:

- :class:`MiniBroker` — a threaded broker: CONNECT/CONNACK,
  SUBSCRIBE/SUBACK with ``+``/``#`` wildcard filters, QoS-0 PUBLISH
  fan-out, PINGREQ/PINGRESP, DISCONNECT. Enough to serve paho clients
  too (it speaks real MQTT 3.1.1 frames).
- :class:`MiniMqttClient` — the client seam
  :class:`~agentlib_mpc_torch.runtime.mqtt.MqttBus` needs (``connect``,
  ``subscribe``, ``publish``, ``on_message``, ``loop_start``…), with
  automatic reconnect + re-subscribe after a dropped connection.

QoS 0 only: the framework's broadcasts are periodic state/coupling
updates where the next message supersedes a lost one (the reference's
communicator publishes QoS 0 for the same reason). Everything here is
plain sockets + threads — no third-party dependency.
"""

from __future__ import annotations

import logging
import random
import socket
import struct
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)

# MQTT 3.1.1 control-packet types (spec table 2.1)
CONNECT, CONNACK = 0x1, 0x2
PUBLISH = 0x3
SUBSCRIBE, SUBACK = 0x8, 0x9
PINGREQ, PINGRESP = 0xC, 0xD
DISCONNECT = 0xE


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _read_packet(sock: socket.socket) -> tuple[int, int, bytes]:
    """(type, flags, body) of one control packet."""
    head = _read_exact(sock, 1)[0]
    length, shift = 0, 0
    for _ in range(4):
        byte = _read_exact(sock, 1)[0]
        length |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    else:
        raise ValueError("malformed remaining-length varint")
    return head >> 4, head & 0x0F, _read_exact(sock, length)


def _packet(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + _encode_varint(len(body)) + body


def _mqtt_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def topic_matches(filt: str, topic: str) -> bool:
    """MQTT 3.1.1 wildcard matching (spec 4.7): ``+`` one level,
    ``#`` the (possibly empty) remainder, only as the last level."""
    f_parts = filt.split("/")
    t_parts = topic.split("/")
    for i, fp in enumerate(f_parts):
        if fp == "#":
            return i == len(f_parts) - 1
        if i >= len(t_parts):
            return False
        if fp != "+" and fp != t_parts[i]:
            return False
    return len(f_parts) == len(t_parts)


class _Session:
    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.filters: list[str] = []
        self.wlock = threading.Lock()
        self.client_id = ""

    def send(self, data: bytes) -> None:
        with self.wlock:
            self.sock.sendall(data)


class MiniBroker:
    """Threaded QoS-0 MQTT broker on a real TCP listener.

    ``MiniBroker(port=0)`` binds an ephemeral port (read it back from
    ``.port``) and serves until :meth:`stop`. :meth:`drop_clients`
    hard-closes every live connection without stopping the listener —
    the reconnect-after-drop test hook."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen()
        self.host, self.port = self._srv.getsockname()
        self._sessions: list[_Session] = []  # guarded-by: self._lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.messages_routed = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="mini-mqtt-accept", daemon=True)
        self._accept_thread.start()

    # -- lifecycle ------------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        # shutdown() wakes the accept() blocked in the accept thread
        # (close() alone does not on Linux, and the join below would wait
        # out its timeout)
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        self.drop_clients()
        self._accept_thread.join(timeout=2.0)

    def drop_clients(self) -> None:
        """Hard-close every live client socket (clients see EOF)."""
        with self._lock:
            sessions, self._sessions = self._sessions, []
        for sess in sessions:
            try:
                sess.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sess.sock.close()
            except OSError:
                pass

    @property
    def n_clients(self) -> int:
        with self._lock:
            return len(self._sessions)

    # -- serving --------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._srv.accept()
            except OSError:
                return
            sess = _Session(sock, addr)
            with self._lock:
                self._sessions.append(sess)
            threading.Thread(target=self._serve, args=(sess,),
                             name=f"mini-mqtt-{addr[1]}",
                             daemon=True).start()

    def _serve(self, sess: _Session) -> None:
        try:
            ptype, _flags, body = _read_packet(sess.sock)
            if ptype != CONNECT:
                raise ValueError(f"expected CONNECT, got type {ptype}")
            # body: protocol name/level/flags/keepalive, then client id
            proto_len = struct.unpack(">H", body[:2])[0]
            cid_at = 2 + proto_len + 4
            cid_len = struct.unpack(">H", body[cid_at:cid_at + 2])[0]
            sess.client_id = body[cid_at + 2:cid_at + 2 + cid_len].decode(
                errors="replace")
            sess.send(_packet(CONNACK, 0, b"\x00\x00"))
            while not self._stop.is_set():
                ptype, flags, body = _read_packet(sess.sock)
                if ptype == PUBLISH:
                    self._route(body, flags)
                elif ptype == SUBSCRIBE:
                    pid = body[:2]
                    at, grants = 2, bytearray()
                    while at < len(body):
                        flen = struct.unpack(">H", body[at:at + 2])[0]
                        filt = body[at + 2:at + 2 + flen].decode()
                        at += 2 + flen + 1          # + requested qos
                        sess.filters.append(filt)
                        grants.append(0x00)          # granted QoS 0
                    sess.send(_packet(SUBACK, 0, pid + bytes(grants)))
                elif ptype == PINGREQ:
                    sess.send(_packet(PINGRESP, 0, b""))
                elif ptype == DISCONNECT:
                    break
                # anything else in the subset is ignored
        except (ConnectionError, ValueError, OSError,
                struct.error, IndexError) as exc:
            # struct.error/IndexError: malformed frame BODIES (truncated
            # length fields, short CONNECT) — a hostile or broken client
            # must cost exactly its own session, never an unhandled
            # thread death (the malformed-frame fuzz tests pin this)
            logger.debug("mini-mqtt session %s ended: %s", sess.addr, exc)
        finally:
            with self._lock:
                if sess in self._sessions:
                    self._sessions.remove(sess)
            try:
                sess.sock.close()
            except OSError:
                pass

    def _route(self, body: bytes, flags: int) -> None:
        tlen = struct.unpack(">H", body[:2])[0]
        topic = body[2:2 + tlen].decode(errors="replace")
        at = 2 + tlen
        if (flags >> 1) & 0x3:       # QoS 1/2 carry a packet id we skip
            at += 2
        payload = body[at:]
        frame = _packet(PUBLISH, 0, _mqtt_str(topic) + payload)
        with self._lock:
            targets = [s for s in self._sessions
                       if any(topic_matches(f, topic) for f in s.filters)]
        for sess in targets:
            try:
                sess.send(frame)
                self.messages_routed += 1
            except OSError:
                pass                  # reader thread will reap it


class _Message:
    __slots__ = ("topic", "payload")

    def __init__(self, topic: str, payload: bytes):
        self.topic = topic
        self.payload = payload


class MiniMqttClient:
    """Minimal client with the paho surface
    :class:`~agentlib_mpc_torch.runtime.mqtt.MqttBus` uses, plus automatic
    reconnect: on EOF the reader thread redials with decorrelated-jitter
    backoff and re-subscribes its filters, so a broker restart (or
    :meth:`MiniBroker.drop_clients`) only costs the messages published
    while the link was down — QoS-0 semantics, like paho's
    ``reconnect_delay_set`` behavior.

    Backoff: a fixed 0.05 → 1.0 doubling ladder makes every client of a
    fleet redial on the SAME schedule after a broker restart — a
    thundering herd precisely when the broker is weakest. Each redial
    instead sleeps ``min(cap, uniform(base, 3 · previous))`` (the
    decorrelated-jitter scheme) from a per-client seeded stream, so the
    fleet's dials spread out while any single client's sequence stays
    reproducible. ``reconnect_max_delay`` configures the cap,
    ``reconnect_base`` the floor, ``reconnect_seed`` pins the stream
    (defaults to the client id, so a named client is deterministic)."""

    def __init__(self, client_id: str = "", reconnect_base: float = 0.05,
                 reconnect_max_delay: float = 1.0,
                 reconnect_seed: "int | str | None" = None):
        self.client_id = client_id or f"mini-{id(self):x}"
        self.on_message: Optional[Callable] = None
        self._sock: Optional[socket.socket] = None  # guarded-by: self._wlock
        self._host = self._port = None
        self._filters: list[str] = []  # guarded-by: self._wlock
        self._wlock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._connected = threading.Event()
        self.reconnects = 0
        self._reconnect_base = float(reconnect_base)
        self._reconnect_cap = float(reconnect_max_delay)
        if self._reconnect_cap < self._reconnect_base:
            raise ValueError(
                f"reconnect_max_delay={self._reconnect_cap} must be >= "
                f"reconnect_base={self._reconnect_base}")
        self._backoff_rng = random.Random(
            self.client_id if reconnect_seed is None else reconnect_seed)
        self._backoff = self._reconnect_base

    def _next_backoff(self) -> float:
        """Advance the decorrelated-jitter sequence and return the next
        redial delay."""
        self._backoff = min(
            self._reconnect_cap,
            self._backoff_rng.uniform(self._reconnect_base,
                                      self._backoff * 3))
        return self._backoff

    def _reset_backoff(self) -> None:
        self._backoff = self._reconnect_base

    # paho-compat stub: the MQTT subset carries no auth fields, so any
    # credentials handed in are silently dropped on the wire — say so
    # loudly, and again if the broker then refuses the CONNECT
    def username_pw_set(self, username, password=None) -> None:
        if username is None:          # paho idiom: clear credentials
            self._credentials_dropped = False
            return
        self._credentials_dropped = True
        logger.warning(
            "MiniMqttClient has no authentication support: the "
            "username/password for client %r will NOT be sent to the "
            "broker (use the paho client for authenticated brokers)",
            self.client_id)

    def connect(self, host: str, port: int = 1883,
                timeout: float = 5.0) -> None:
        self._host, self._port = host, int(port)
        self._dial(timeout)

    def _dial(self, timeout: float = 5.0) -> None:
        sock = socket.create_connection((self._host, self._port),
                                        timeout=timeout)
        # keep the dial timeout in force through the whole MQTT
        # handshake: a peer that accepts TCP but never sends CONNACK
        # (half-open proxy, wedged broker) must raise here, not hang
        # connect() — and with it the reconnect loop — forever. Only the
        # steady-state reader blocks without a deadline.
        body = (_mqtt_str("MQTT") + bytes([4])          # protocol level 4
                + bytes([0x02])                          # clean session
                + struct.pack(">H", 60)                  # keepalive
                + _mqtt_str(self.client_id))
        try:
            sock.sendall(_packet(CONNECT, 0, body))
            ptype, _f, ack = _read_packet(sock)
        except (OSError, ValueError):
            sock.close()
            raise
        if ptype != CONNACK or ack[1] != 0:
            sock.close()
            dropped = (" (note: credentials were set via username_pw_set "
                       "but this client cannot send them)"
                       if getattr(self, "_credentials_dropped", False)
                       else "")
            raise ConnectionError(f"CONNACK refused: {ack!r}{dropped}")
        sock.settimeout(None)
        with self._wlock:
            self._sock = sock
            filters = list(self._filters)
        for filt in filters:
            self._send_subscribe(filt)
        self._connected.set()

    def subscribe(self, filt: str, qos: int = 0) -> None:
        # _filters is iterated by the reader thread's redial
        # (_dial re-subscribes); mutate under the write lock
        with self._wlock:
            if filt not in self._filters:
                self._filters.append(filt)
        if self._sock is not None:
            self._send_subscribe(filt)

    def _send_subscribe(self, filt: str) -> None:
        body = struct.pack(">H", 1) + _mqtt_str(filt) + bytes([0])
        self._send(_packet(SUBSCRIBE, 0x2, body))

    def publish(self, topic: str, payload) -> None:
        if isinstance(payload, str):
            payload = payload.encode()
        try:
            self._send(_packet(PUBLISH, 0, _mqtt_str(topic) + bytes(payload)))
        except (OSError, ConnectionError):
            # QoS 0 while the link is down: dropped, reconnect is the
            # reader thread's job
            logger.debug("publish to %s dropped (link down)", topic)

    def _send(self, frame: bytes) -> None:
        with self._wlock:
            if self._sock is None:
                raise ConnectionError("not connected")
            self._sock.sendall(frame)

    # -- reader / reconnect ---------------------------------------------------

    def loop_start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._reader, name=f"mini-mqtt-{self.client_id}",
                daemon=True)
            self._thread.start()

    def _reader(self) -> None:
        while not self._stop.is_set():
            sock = self._sock
            if sock is None:
                time.sleep(self._reconnect_base)
                continue
            try:
                ptype, _flags, body = _read_packet(sock)
            except (ConnectionError, OSError, ValueError):
                if self._stop.is_set():
                    return
                self._connected.clear()
                with self._wlock:
                    self._sock = None
                while not self._stop.is_set():
                    try:
                        self._dial(timeout=1.0)
                        self.reconnects += 1
                        self._reset_backoff()
                        break
                    except OSError:
                        time.sleep(self._next_backoff())
                continue
            if ptype == PUBLISH and self.on_message is not None:
                tlen = struct.unpack(">H", body[:2])[0]
                msg = _Message(body[2:2 + tlen].decode(errors="replace"),
                               body[2 + tlen:])
                try:
                    self.on_message(self, None, msg)
                except Exception:   # user callback must not kill the loop
                    logger.exception("on_message callback failed")

    def loop_stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # unblock the reader: shutdown() wakes its recv(), which
            # close() alone does not on Linux
            with self._wlock:
                if self._sock is not None:
                    try:
                        self._sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
            self._thread.join(timeout=2.0)
            self._thread = None

    def disconnect(self) -> None:
        try:
            self._send(_packet(DISCONNECT, 0, b""))
        except (OSError, ConnectionError):
            pass
        self.loop_stop()


def main(argv: "list[str] | None" = None) -> int:
    """Standalone broker service: ``python -m
    agentlib_mpc_torch.runtime.mqtt_native [port]`` (default 1883, host
    0.0.0.0) — the broker container of the deploy/ fleet."""
    import signal
    import sys as _sys

    args = _sys.argv[1:] if argv is None else argv
    port = int(args[0]) if args else 1883
    logging.basicConfig(level="INFO")
    broker = MiniBroker(host="0.0.0.0", port=port)
    logger.info("mini-mqtt broker serving on %s:%s", broker.host,
                broker.port)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    stop.wait()
    broker.stop()
    logger.info("mini-mqtt broker stopped (%d messages routed)",
                broker.messages_routed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
