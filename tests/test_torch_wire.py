"""The port's wire frames against the JAX package's.

``agentlib_mpc_torch.runtime.wire`` must put the same bytes on the wire as
``agentlib_mpc_tpu.runtime.wire`` for the same values, so agents of both
packages can share one relay or broker; a torch tensor (float32, float64,
one that requires grad) is framed as the JAX package frames a numpy array
of the same values. Plus the round trips and the localhost relay of
``runtime/multiprocessing_mas.py``.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from agentlib_mpc_torch.runtime import wire as pwire
from agentlib_mpc_torch.runtime.multiprocessing_mas import (
    MultiProcessingBroker,
)
from agentlib_mpc_torch.runtime.variables import AgentVariable as PVar
from agentlib_mpc_torch.runtime.variables import Source as PSource
from agentlib_mpc_tpu.runtime import wire as jwire
from agentlib_mpc_tpu.runtime.variables import AgentVariable as JVar
from agentlib_mpc_tpu.runtime.variables import Source as JSource

from _torch_threads import one_torch_thread  # noqa: F401

#: every socket wait of these tests is bounded: a lost peer fails its test
#: instead of holding the worker
SOCKET_TIMEOUT = 10.0

RNG = np.random.default_rng(11)
TRAJ = RNG.normal(size=(3, 4))


def _pair(value_port, value_jax, **kw):
    """The same variable in both packages (timestamp and source set)."""
    out = []
    for cls, src, value in ((PVar, PSource, value_port),
                            (JVar, JSource, value_jax)):
        var = cls(name="T", value=value, alias="T_room", shared=True,
                  source=src(agent_id="Room", module_id="admm"), **kw)
        var.timestamp = 42.5
        out.append(var)
    return out


@pytest.mark.parametrize("value", [
    295.15, 3, None, "on", [1.0, 2.5], np.arange(3.0),
    np.float64(0.25), np.int64(7),
    {"coef": np.ones((1, 2)), "dt": 60.0, "nested": {"x": [np.float32(1.5)]}},
], ids=["float", "int", "none", "str", "list", "ndarray", "np-float",
        "np-int", "nested-dict"])
def test_frames_equal_the_jax_package_frames(value):
    pvar, jvar = _pair(value, value)
    assert pwire.var_to_wire(pvar) == jwire.var_to_wire(jvar)


@pytest.mark.parametrize("dtype,grad", [
    (torch.float32, False), (torch.float64, False), (torch.float64, True),
    (torch.float32, True)], ids=["f32", "f64", "f64-grad", "f32-grad"])
@pytest.mark.parametrize("shape", [(), (4,), (3, 4)],
                         ids=["0d", "1d", "2d"])
def test_tensor_frames_equal_numpy_frames(dtype, grad, shape):
    """A port tensor goes out as the JAX package sends the numpy array of
    the same values and type."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    values = TRAJ[:shape[0], :shape[1]] if len(shape) == 2 else (
        TRAJ[0, :shape[0]] if shape else TRAJ[0, 0])
    array = np.asarray(values, dtype=np_dtype)
    tensor = torch.tensor(array, dtype=dtype, requires_grad=grad)
    pvar, jvar = _pair(tensor * 1.0 if grad else tensor, array)
    frame = pwire.var_to_wire(pvar)
    assert frame == jwire.var_to_wire(jvar)
    # and the list in the frame is the tensor's exact values
    back = pwire.var_from_wire(frame).value
    np.testing.assert_array_equal(np.asarray(back, dtype=np_dtype), array)


def test_round_trips_and_cross_package_decoding():
    pvar, jvar = _pair({"traj": torch.tensor(TRAJ)}, {"traj": TRAJ})
    for encode, decode in ((pwire.var_to_wire, pwire.var_from_wire),
                           (pwire.var_to_wire, jwire.var_from_wire),
                           (jwire.var_to_wire, pwire.var_from_wire)):
        back = decode(encode(pvar if encode is pwire.var_to_wire else jvar))
        assert (back.name, back.alias, back.shared, back.timestamp) == (
            "T", "T_room", True, 42.5)
        assert (back.source.agent_id, back.source.module_id) == (
            "Room", "admm")
        np.testing.assert_array_equal(np.asarray(back.value["traj"]), TRAJ)
    # a minimal frame takes the defaults in both packages
    minimal = b'{"name": "u"}'
    for decode in (pwire.var_from_wire, jwire.var_from_wire):
        back = decode(minimal)
        assert (back.alias, back.shared, back.timestamp, back.value) == (
            "u", True, 0.0, None)


def test_length_prefixed_frames_over_a_socket_pair():
    a, b = socket.socketpair()
    a.settimeout(SOCKET_TIMEOUT)
    b.settimeout(SOCKET_TIMEOUT)
    try:
        big = b"x" * (1 << 20)     # beyond one send buffer
        framed = pwire.FramedSocket(a)
        for payload in (b"", b"hello", big):
            sender = threading.Thread(target=framed.send_frame,
                                      args=(payload,), daemon=True)
            sender.start()
            assert jwire.recv_frame(b) == payload
            sender.join(timeout=5.0)
            assert not sender.is_alive()
        jwire.send_frame(b, b"back")
        assert framed.recv_frame() == b"back"
        b.close()
        assert framed.recv_frame() is None          # EOF
    finally:
        a.close()
        b.close()


def test_relay_broadcasts_to_others_not_sender():
    broker = MultiProcessingBroker()
    conns = []
    try:
        conns = [socket.create_connection((broker.host, broker.port),
                                          timeout=SOCKET_TIMEOUT)
                 for _ in range(3)]
        deadline = time.time() + 5.0
        while len(broker._clients) < 3 and time.time() < deadline:
            time.sleep(0.01)
        pwire.send_frame(conns[0], b"hello")
        assert pwire.recv_frame(conns[1]) == b"hello"
        assert pwire.recv_frame(conns[2]) == b"hello"
        conns[0].settimeout(0.3)
        with pytest.raises(socket.timeout):
            conns[0].recv(1)  # the sender must not receive its own frame
    finally:
        for c in conns:
            c.close()
        broker.close()
