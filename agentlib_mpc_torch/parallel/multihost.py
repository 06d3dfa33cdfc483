"""Slot granularity of the serving plane on one device.

Of ``agentlib_mpc_tpu/parallel/multihost.py`` the port has only
:func:`serving_slot_multiple` (JAX ``:321``): the serving plane rounds
every bucket's capacity up to it. The port's engines run on one device,
so the multiple is 1. The device mesh, the multi-process helpers and the
mesh form of this function come with ROADMAP Queue 1 item 5 (multi-GPU).
"""

from __future__ import annotations

__all__ = ["serving_slot_multiple"]


def serving_slot_multiple(mesh=None) -> int:
    """Slot-count granularity of the serving plane's padded buckets: 1,
    the device count of the port's single-device engines. ``mesh=`` (a
    sharded plane) raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(
            "serving_slot_multiple(mesh=) needs the device mesh, which is "
            "not ported yet (ROADMAP Queue 1 item 5: multi-GPU)")
    return 1
