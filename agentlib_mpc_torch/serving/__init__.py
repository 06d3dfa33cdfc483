"""MPC-as-a-service: the serving plane, on one device.

Port of ``agentlib_mpc_tpu/serving/``: serves solve traffic for a
changing tenant population over the fused engines
(``parallel/fused_admm.py``, ``scenario/fleet.py``):

* :mod:`.fingerprint`: :class:`TenantSpec` and the structural-fingerprint
  bucket key (aten-graph digests, certificates, horizon, coupling layout,
  solver options, scenario tree).
* :mod:`.cache`: :class:`CompileCache`, fingerprint-keyed reuse of built
  and warmed engines, with hit/miss counters and measured join latency.
* :mod:`.slots`: :class:`SlotPlane`, pre-padded agent slots per bucket;
  tenants join and leave by lane splices and mask flips, so membership
  churn builds no engine.
* :mod:`.admission`: :class:`AdmissionQueue`, a bounded queue with
  per-tenant deadlines; overload sheds into the guard ladder.
* :mod:`.dispatch`: the depth-1 pipelined dispatch loop and its watchdog.
* :mod:`.plane`: :class:`ServingPlane`, the front door (``join`` /
  ``leave`` / ``submit`` / ``serve_round``).
* :mod:`.health`: :class:`HealthLedger`, the per-tenant quarantine →
  eviction → probation ladder.
* :mod:`.checkpoint`: durable plane snapshots; recovery rebuilds buckets
  through the compile cache.

The JAX package's SLO autopilot (``serving/autopilot.py``) and on-disk
engine store (``serving/store.py``) come with ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

from agentlib_mpc_torch.serving.admission import (  # noqa: F401
    AdmissionQueue,
    SolveRequest,
)
from agentlib_mpc_torch.serving.cache import CompileCache  # noqa: F401
from agentlib_mpc_torch.serving.checkpoint import (  # noqa: F401
    RestoreReport,
    has_plane_checkpoint,
    plane_checkpoint_topology,
    restore_plane,
    save_plane,
)
from agentlib_mpc_torch.serving.fingerprint import (  # noqa: F401
    TenantSpec,
    bucket_key,
    tenant_fingerprint,
)
from agentlib_mpc_torch.serving.health import (  # noqa: F401
    HealthLedger,
    HealthPolicy,
)
from agentlib_mpc_torch.serving.plane import (  # noqa: F401
    JoinReceipt,
    MemoryBudgetExceeded,
    RoundResult,
    ServingPlane,
)
from agentlib_mpc_torch.serving.slots import SlotPlane  # noqa: F401
