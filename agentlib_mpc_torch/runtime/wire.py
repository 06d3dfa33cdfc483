"""Wire serialization of AgentVariables for cross-process/network comms.

Port of ``agentlib_mpc_tpu/runtime/wire.py``; the port keeps its own copy
and imports nothing of the JAX package.

Counterpart of the reference's orjson-serialized payloads
(``data_structures/admm_datatypes.py:334-363``; AgentVariable JSON in the
multiprocessing/MQTT communicators): numpy-aware JSON with a 4-byte
length-prefixed framing for stream transports. JSON stays at the MAS
boundary only — on-device data never crosses it.

The frame bytes are the JAX package's for the same values (the same keys
in the same order, the same ``json.dumps``), so agents of both packages
can share one relay or one broker. A torch tensor (on the card, or one
that requires grad) is detached and copied to the host before it is
listed.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Optional

import numpy as np
import torch

from agentlib_mpc_torch.runtime.variables import AgentVariable, Source

_LEN = struct.Struct("!I")


class FramedSocket:
    """Socket wrapper serializing sends: ``sendall`` is not atomic for
    payloads beyond the send buffer, so concurrent writers (relay threads,
    env thread + reader-thread callbacks) would interleave bytes and
    desync the length-prefixed stream."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._send_lock = threading.Lock()

    def send_frame(self, payload: bytes) -> None:
        with self._send_lock:
            send_frame(self.sock, payload)

    def recv_frame(self) -> Optional[bytes]:
        # single reader per socket by design; no lock needed
        return recv_frame(self.sock)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def _jsonable(value):
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().tolist()
    if hasattr(value, "tolist"):  # other array-likes
        return np.asarray(value).tolist()
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return value


def var_to_wire(var: AgentVariable) -> bytes:
    doc = {
        "name": var.name,
        "value": _jsonable(var.value),
        "alias": var.alias,
        "timestamp": var.timestamp,
        "shared": var.shared,
        "source": {"agent_id": var.source.agent_id,
                   "module_id": var.source.module_id},
    }
    return json.dumps(doc).encode()


def var_from_wire(payload: bytes) -> AgentVariable:
    doc = json.loads(payload.decode())
    src = doc.get("source") or {}
    var = AgentVariable(
        name=doc["name"], value=doc.get("value"),
        alias=doc.get("alias", doc["name"]),
        shared=bool(doc.get("shared", True)),
        source=Source(agent_id=src.get("agent_id"),
                      module_id=src.get("module_id")))
    var.timestamp = doc.get("timestamp", 0.0)
    return var


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Optional[bytes]:
    """One length-prefixed frame; None on EOF."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf
