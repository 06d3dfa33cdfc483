"""Tenant specs and the structural-fingerprint bucket key.

Port of ``agentlib_mpc_tpu/serving/fingerprint.py``. A tenant is one MPC
problem instance: a transcribed OCP plus its parameter values, coupling
layout and solver configuration. Two tenants belong to the same *bucket*
(and share one built fused engine) exactly when everything that shapes
the engine is equal:

* the :class:`~agentlib_mpc_torch.lint.fx.StructuralFingerprint` of the
  OCP's NLP (aten-graph digests with their baked constants, and the
  certificates: the same proved routing facts),
* the horizon,
* the coupling and exchange alias layout,
* the (cold and warm) solver options and the QP-fast-path mode,
* the scenario tree of a robust tenant (a single-scenario tree is the
  flat problem and lands in the flat bucket).

Parameter VALUES (theta) never enter the key: they are the batched axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

from agentlib_mpc_torch.ops.solver import SolverOptions

#: per-OCP-object memo of the (expensive: traces and certifier passes)
#: structural fingerprint, keyed by object identity like
#: ``bucket_agents``: ``id(ocp) -> (ocp, fingerprint)`` (holding the ocp
#: keeps the id stable). The VALUE is structural, so two distinct OCP
#: objects of identical structure fingerprint EQUAL, but each distinct
#: object pays the certifier once; transcribe once per model class
_FP_MEMO: dict = {}


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's problem definition, as handed to
    :meth:`~agentlib_mpc_torch.serving.plane.ServingPlane.join`.

    ``theta`` is the tenant's parameter pytree (one agent row, NOT
    batched; the plane moves it to its device and dtype);
    ``couplings``/``exchanges`` map global aliases to this model's
    control names exactly like :class:`~agentlib_mpc_torch.parallel.
    fused_admm.AgentGroup`. ``deadline_s`` is the tenant's per-request
    service deadline for the admission queue (None: the plane default).
    """

    tenant_id: str
    ocp: object                  # TranscribedOCP
    theta: object                # OCPParams
    couplings: dict = dataclasses.field(default_factory=dict)
    exchanges: dict = dataclasses.field(default_factory=dict)
    solver_options: SolverOptions = SolverOptions()
    warm_solver_options: "SolverOptions | None" = None
    qp_fast_path: str = "auto"
    deadline_s: "float | None" = None
    #: robust tenant: a :class:`~agentlib_mpc_torch.scenario.tree.
    #: ScenarioTree` lifts this tenant into a SCENARIO bucket: its lane
    #: solves S disturbance branches per round on a :class:`~agentlib_
    #: mpc_torch.scenario.fleet.ScenarioFleet` engine, and ``theta``
    #: must carry the (S, ...)-leading per-branch parameter stack
    #: (``scenario.generate`` builds it). Tree identity enters the
    #: bucket key. The single-scenario tree normalizes into the FLAT
    #: bucket (theta's branch axis squeezed at join).
    scenario_tree: "object | None" = None
    #: robust-round knobs (a hashable ``ScenarioFleetOptions``); None =
    #: the fleet defaults. Ignored without ``scenario_tree``.
    scenario_options: "object | None" = None


class BucketKey(NamedTuple):
    """Hashable engine-bucket identity (everything but capacity: the
    :class:`~agentlib_mpc_torch.serving.cache.CompileCache` key adds the
    padded slot count and the engine options on top)."""

    structure_digest: str
    horizon: int
    couplings: tuple         # sorted (alias, control) pairs
    exchanges: tuple
    solver_options: SolverOptions
    warm_solver_options: "SolverOptions | None"
    qp_fast_path: str
    #: scenario-tree identity: a robust bucket's engine is a
    #: ScenarioFleet built FOR this tree (branch count, node groups and
    #: probabilities), so tenants bucket together exactly when their
    #: trees are equal. None = flat bucket (the S=1 tree included)
    scenario_tree: "object | None" = None
    scenario_options: "object | None" = None

    @property
    def digest(self) -> str:
        import hashlib

        return hashlib.sha256(repr(self).encode()).hexdigest()[:12]


def tenant_fingerprint(ocp):
    """The memoized structural fingerprint of one transcribed OCP.

    The first call per OCP *object* pays the traces and certifiers
    (seconds); every later call on the same object is a lookup. A
    different object of identical structure pays once too and then
    fingerprints EQUAL, so it lands in the same serving bucket. Returns
    a :class:`~agentlib_mpc_torch.lint.fx.StructuralFingerprint`.
    """
    entry = _FP_MEMO.get(id(ocp))
    if entry is None:
        from agentlib_mpc_torch.lint.fx import structural_fingerprint

        fp = structural_fingerprint(
            ocp.nlp, ocp.default_params(device="cpu"), ocp.n_w,
            getattr(ocp, "stage_partition", None))
        # hold the ocp alongside its fingerprint: the id() key is only
        # collision-free while the object lives
        entry = _FP_MEMO[id(ocp)] = (ocp, fp)
    return entry[1]


def bucket_key(spec: TenantSpec) -> BucketKey:
    """Bucket identity of one tenant spec (see module docstring)."""
    fp = tenant_fingerprint(spec.ocp)
    tree = spec.scenario_tree
    if tree is not None and tree.n_scenarios == 1:
        # degenerate contract: the single-scenario tree IS the flat
        # problem — it must land in the flat bucket, not fork a
        # second compiled program for the same structure
        tree = None
    return BucketKey(
        structure_digest=fp.digest,
        horizon=int(spec.ocp.N),
        couplings=tuple(sorted(spec.couplings.items())),
        exchanges=tuple(sorted(spec.exchanges.items())),
        solver_options=spec.solver_options,
        warm_solver_options=spec.warm_solver_options,
        qp_fast_path=spec.qp_fast_path,
        scenario_tree=tree,
        scenario_options=(spec.scenario_options if tree is not None
                          else None),
    )
