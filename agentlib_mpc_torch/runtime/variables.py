"""Agent variables: the typed payloads exchanged over the data broker.

Port of ``agentlib_mpc_tpu/runtime/variables.py``; the port keeps its own copy
and imports nothing of the JAX package.

Mirrors the semantics the reference relies on from agentlib's AgentVariable
(used throughout, e.g. ``modules/mpc/mpc.py:9-14``): a variable has a local
``name``, a network-facing ``alias`` (defaults to the name), and a ``source``
identifying the producing agent (and optionally module); subscriptions match
on (alias, source). Values may be scalars, lists, or serialized trajectories
(the reference ships pandas Series as JSON; here trajectories are
(times, values) tuples or plain lists).
"""

from __future__ import annotations

import dataclasses
import math
import time as _time
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class Source:
    """Identifies the producer of a variable: agent id and/or module id.
    A field left as None is a wildcard when matching subscriptions."""

    agent_id: Optional[str] = None
    module_id: Optional[str] = None

    def matches(self, other: "Source") -> bool:
        if self.agent_id is not None and self.agent_id != other.agent_id:
            return False
        if self.module_id is not None and self.module_id != other.module_id:
            return False
        return True

    @classmethod
    def coerce(cls, value) -> "Source":
        if value is None:
            return cls()
        if isinstance(value, Source):
            return value
        if isinstance(value, str):
            return cls(agent_id=value)
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"cannot build Source from {value!r}")


@dataclasses.dataclass
class AgentVariable:
    """A named value with alias/source addressing and optional bounds."""

    name: str
    value: Any = None
    alias: Optional[str] = None
    source: Source = dataclasses.field(default_factory=Source)
    unit: str = "-"
    description: str = ""
    lb: float = -math.inf
    ub: float = math.inf
    shared: bool = False
    type: str = "float"
    timestamp: float = 0.0

    def __post_init__(self):
        if self.alias is None:
            self.alias = self.name
        self.source = Source.coerce(self.source)

    def copy(self, **updates) -> "AgentVariable":
        d = dataclasses.replace(self)
        for k, v in updates.items():
            setattr(d, k, v)
        if "source" in updates:
            d.source = Source.coerce(updates["source"])
        return d

    @classmethod
    def from_config(cls, cfg: dict | "AgentVariable") -> "AgentVariable":
        if isinstance(cfg, AgentVariable):
            return cfg.copy()
        cfg = dict(cfg)
        if cfg.get("lb") is None:
            cfg["lb"] = -math.inf
        if cfg.get("ub") is None:
            cfg["ub"] = math.inf
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in known})


def wall_clock() -> float:
    return _time.time()
