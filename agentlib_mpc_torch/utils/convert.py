"""Carry per-solve parameters and fleet state across frameworks.

New in the port (no JAX counterpart). The system's "weights" are the
per-solve :class:`~agentlib_mpc_torch.ops.transcription.OCPParams` and the
fleet's warm-start state; they cross as numpy arrays, so the port never
imports JAX:

    ocp_params_from_numpy({k: np.asarray(v) for k, v in
                           jax_theta._asdict().items()}, device, dtype)

A stage partition crosses as its fields (``stage_partition_from_fields``);
a stage-sparse derivative plan as its defining key, the partition and the
per-row stages of ``h`` (``stage_jacobian_plan_from_fields``), and its
derived index arrays come back out as numpy (``plan_arrays``) to be held
against another framework's entry for entry.

The fused engine's state and round statistics cross the same way: any
object with the fields of :class:`~agentlib_mpc_torch.parallel.fused_admm.
FusedState` (or ``IterationStats``) whose leaves are numpy arrays, in
dicts and tuples as the engine nests them, comes in through
:func:`fused_state_from_numpy` / :func:`iteration_stats_from_numpy`, and
:func:`to_numpy` takes the port's back out (the same field names, so
``OtherFusedState(**to_numpy(state)._asdict())`` rebuilds the other
framework's). A fleet's per-group stacked parameters come in through
:func:`theta_batches_from_numpy`, and a module-path backend's warm start
(``OptimizationBackend.warm_state()``) through :func:`warm_state_from_jax`
(an ADMM backend's too: the same ``w``, ``y``, ``z`` and ``cold``).
Floating leaves take the given dtype; integer and boolean leaves keep
theirs. A decentralized ADMM module's own state, the local, mean and
multiplier trajectories it keeps on the host, comes in through
:func:`admm_values_from_jax`, and an ADMM coordinator's (per coupling the
participants' local trajectories and multipliers by source, the mean and
the mean before it, exchange deviations and the shared multiplier, the
penalty and the participants' statuses) through
:func:`coordinator_state_from_jax` into :func:`load_coordinator_state`.
An ML model's trained parameters (``MLModel.ml_params``, a pytree of
arrays per surrogate) come in through :func:`ml_params_from_jax`, and into
an ML backend (its model and its device copy) through
:func:`load_ml_model_state`; serialized model documents need no
conversion (both packages read and write the same JSON). A scenario
fleet's state (``ScenarioState``) comes in through
:func:`scenario_state_from_jax`, checked against the fleet it continues in
by :func:`load_scenario_state`. A whole serving plane (occupancy and slot
maps, each bucket's engine state, theta batch and mask, guard ladders,
the health and SLO ledgers, queue carryover, round counters) comes out of
the JAX package's ``ServingPlane`` through :func:`serving_state_from_jax`
and into the port's through :func:`load_serving_state`.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

from agentlib_mpc_torch.ops.stagejac import (
    StageJacobianPlan,
    build_stage_jacobian_plan,
)
from agentlib_mpc_torch.ops.stagewise import StagePartition
from agentlib_mpc_torch.ops.transcription import OCPParams
from agentlib_mpc_torch.utils.device import resolve_device


def ocp_params_from_numpy(d: Mapping[str, np.ndarray], device=None,
                          dtype: torch.dtype = torch.float32) -> OCPParams:
    """OCPParams from a mapping of its field names to arrays."""
    missing = set(OCPParams._fields) - set(d)
    if missing:
        raise KeyError(f"OCPParams fields missing: {sorted(missing)}")
    dev = resolve_device(device)
    return OCPParams(**{k: torch.tensor(np.asarray(d[k]), dtype=dtype,
                                        device=dev)
                        for k in OCPParams._fields})


def fleet_args_from_numpy(arrays: Sequence[np.ndarray], device=None,
                          dtype: torch.dtype = torch.float32) -> tuple:
    """The control step's positional arguments ``(x0s, loads, w, y, z, zbar,
    lams, rho)`` from arrays in the same order."""
    if len(arrays) != 8:
        raise ValueError(f"expected the 8 control-step arguments (x0s, "
                         f"loads, w, y, z, zbar, lams, rho), got "
                         f"{len(arrays)}")
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a), dtype=dtype, device=dev)
                 for a in arrays)


def _tensors(tree, device, dtype):
    """Numpy leaves of nested dicts, tuples and lists as tensors."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tensors(v, device, dtype) for v in tree)
    arr = np.asarray(tree)
    t = torch.tensor(arr, device=device)
    return t.to(dtype) if t.is_floating_point() else t


def _named_from_numpy(cls, obj, device, dtype):
    get = (obj.__getitem__ if isinstance(obj, Mapping)
           else lambda k: getattr(obj, k))
    dev = resolve_device(device)
    return cls(**{k: _tensors(get(k), dev, dtype) for k in cls._fields})


def fused_state_from_numpy(state, device=None,
                           dtype: torch.dtype = torch.float32):
    """The port's ``FusedState`` from any object or mapping with its
    fields holding numpy leaves."""
    from agentlib_mpc_torch.parallel.fused_admm import FusedState

    return _named_from_numpy(FusedState, state, device, dtype)


def iteration_stats_from_numpy(stats, device=None,
                               dtype: torch.dtype = torch.float32):
    """The port's ``IterationStats`` from any object or mapping with its
    fields holding numpy leaves (None where the round recorded none)."""
    from agentlib_mpc_torch.parallel.fused_admm import IterationStats

    return _named_from_numpy(IterationStats, stats, device, dtype)


def theta_batches_from_numpy(batches: Sequence, device=None,
                             dtype: torch.dtype = torch.float32) -> list:
    """Per-group stacked OCPParams (agent axis first) from objects or
    mappings with the OCPParams fields holding numpy arrays."""
    return [_named_from_numpy(OCPParams, b, device, dtype) for b in batches]


def stage_partition_from_fields(partition) -> StagePartition:
    """The port's :class:`StagePartition` from any object with the same
    fields (``n_stages``, ``block``, ``n_w``, ``n_total``, ``perm``) or a
    mapping of them, every value as plain Python ints."""
    get = (partition.__getitem__ if isinstance(partition, Mapping)
           else lambda k: getattr(partition, k))
    return StagePartition(
        n_stages=int(get("n_stages")), block=int(get("block")),
        n_w=int(get("n_w")), n_total=int(get("n_total")),
        perm=tuple(int(i) for i in get("perm")))


#: the derived arrays of a :class:`StageJacobianPlan` (numpy, built from
#: the plan's key)
PLAN_ARRAYS = (
    "ct_matrix", "hess_seeds", "g_cols", "g_cols_safe", "g_src", "g_mask",
    "h_cols", "h_cols_safe", "h_src", "h_mask", "hrow_cols",
    "hrow_cols_safe", "hrow_src", "hrow_mask", "de_init", "hasm_dst",
    "gasm_dst1", "gasm_dst2", "jh_dst", "var_diag_dst", "eq_diag_dst",
)


def stage_jacobian_plan_from_fields(plan) -> StageJacobianPlan:
    """The port's (memoized) plan from any object or mapping with the
    fields ``partition`` (itself carried by
    :func:`stage_partition_from_fields`) and ``h_row_stages``."""
    get = (plan.__getitem__ if isinstance(plan, Mapping)
           else lambda k: getattr(plan, k))
    return build_stage_jacobian_plan(
        stage_partition_from_fields(get("partition")),
        tuple(int(s) for s in get("h_row_stages")))


def plan_arrays(plan) -> dict:
    """The derived index and seed arrays of a plan (either framework's:
    both build them in numpy) as a name → numpy array mapping."""
    return {k: np.asarray(getattr(plan, k)) for k in PLAN_ARRAYS}


def to_numpy(tree):
    """Every tensor leaf of ``tree`` as a numpy array (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)


def warm_state_from_jax(tree: Mapping, device=None,
                        dtype: torch.dtype = torch.float32) -> dict:
    """A backend's warm state from another framework's ``warm_state()``
    with its arrays as numpy (``w``, ``y``, ``z`` and the ``cold`` flag),
    in the port's form: tensors on ``device`` (None: the card) in
    ``dtype``, ready for ``OptimizationBackend.set_warm_state``."""
    dev = resolve_device(device)
    out = {k: torch.tensor(np.asarray(tree[k]), dtype=dtype, device=dev)
           for k in ("w", "y", "z")}
    out["cold"] = bool(tree["cold"])
    return out


def admm_values_from_jax(values: Mapping) -> dict:
    """A decentralized ADMM module's trajectories from another framework's
    (its ``_admm_values``: per coupling the local, mean or exchange
    deviation and multiplier trajectories on the coupling grid, keyed by
    their wire names) as float64 numpy copies: both packages keep this
    state on the host."""
    return {str(k): np.array(np.asarray(v), dtype=np.float64)
            for k, v in values.items()}


def _source_key(source) -> tuple:
    return (source.agent_id, source.module_id)


def _arrays_by_source(mapping) -> dict:
    return {_source_key(src): np.array(np.asarray(v), dtype=np.float64)
            for src, v in mapping.items()}


def _optional(arr):
    return None if arr is None else np.array(np.asarray(arr),
                                             dtype=np.float64)


def coordinator_state_from_jax(coord) -> dict:
    """An ADMM coordinator's state as plain data, from either framework's
    coordinator (both keep it as host numpy): sources as
    ``(agent_id, module_id)``, statuses by their names, trajectories as
    float64 numpy copies. :func:`load_coordinator_state` puts it into the
    port's coordinator."""
    consensus = {
        alias: {"local": _arrays_by_source(var.local_trajectories),
                "multipliers": _arrays_by_source(var.multipliers),
                "mean": _optional(var.mean_trajectory),
                "last_mean": _optional(var._last_mean)}
        for alias, var in coord._coupling_variables.items()}
    exchange = {
        alias: {"local": _arrays_by_source(var.local_trajectories),
                "diff": _arrays_by_source(var.diff_trajectories),
                "multiplier": _optional(var.multiplier),
                "mean": _optional(var.mean_trajectory),
                "last_mean": _optional(var._last_mean)}
        for alias, var in coord._exchange_variables.items()}
    agents = {_source_key(src): {"status": entry.status.value,
                                 "coup_vars": list(entry.coup_vars),
                                 "exchange_vars": list(entry.exchange_vars),
                                 "missed_rounds": int(entry.missed_rounds)}
              for src, entry in coord.agent_dict.items()}
    return {"consensus": consensus, "exchange": exchange, "agents": agents,
            "penalty_parameter": float(coord.penalty_parameter)}


def load_coordinator_state(coord, state: Mapping) -> None:
    """Replace the port's coordinator ``coord``'s state by ``state`` (from
    :func:`coordinator_state_from_jax`)."""
    from agentlib_mpc_torch.modules.coordinator import (
        AgentEntry,
        AgentStatus,
        ConsensusVariable,
        ExchangeVariable,
    )
    from agentlib_mpc_torch.runtime.variables import Source

    def by_source(mapping):
        return {Source(agent_id=a, module_id=m): np.array(v)
                for (a, m), v in mapping.items()}

    with coord._registration_lock:
        coord._coupling_variables = {}
        for alias, data in state["consensus"].items():
            var = coord._coupling_variables[alias] = ConsensusVariable()
            var.local_trajectories = by_source(data["local"])
            var.multipliers = by_source(data["multipliers"])
            var.mean_trajectory = _optional(data["mean"])
            var._last_mean = _optional(data["last_mean"])
        coord._exchange_variables = {}
        for alias, data in state["exchange"].items():
            var = coord._exchange_variables[alias] = ExchangeVariable()
            var.local_trajectories = by_source(data["local"])
            var.diff_trajectories = by_source(data["diff"])
            var.multiplier = _optional(data["multiplier"])
            var.mean_trajectory = _optional(data["mean"])
            var._last_mean = _optional(data["last_mean"])
        coord.agent_dict = {
            Source(agent_id=a, module_id=m): AgentEntry(
                source=Source(agent_id=a, module_id=m),
                status=AgentStatus(entry["status"]),
                coup_vars=list(entry["coup_vars"]),
                exchange_vars=list(entry["exchange_vars"]),
                missed_rounds=int(entry["missed_rounds"]))
            for (a, m), entry in state["agents"].items()}
        coord.penalty_parameter = float(state["penalty_parameter"])


def ml_params_from_jax(model_or_params, device=None,
                       dtype: torch.dtype = torch.float64) -> dict:
    """An ML model's trained parameters (another framework's
    ``MLModel.ml_params``, or the model itself) as the port's pytree:
    every array leaf a tensor on ``device`` (None: the card) in
    ``dtype``, the nesting (per surrogate key, per parameter name, lists
    of layers) kept."""
    params = getattr(model_or_params, "ml_params", model_or_params)
    dev = resolve_device(device)

    def leaf(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return leaf(node)

    return walk(params)


def load_ml_model_state(backend, model_or_params) -> None:
    """Put another framework's trained ML parameters (its model or its
    ``ml_params``) into the port's ML backend ``backend``: its model's
    host copy (float64 on the CPU) and the copy its solves use (its
    device and dtype). The surrogate structure must be the same."""
    from agentlib_mpc_torch.ml.predictors import cast_params

    host = ml_params_from_jax(model_or_params, device="cpu")
    model = backend.model
    if set(host) != set(model.ml_params):
        raise KeyError(f"surrogates {sorted(host)} do not match the "
                       f"backend's {sorted(model.ml_params)}")
    for key, params in host.items():
        old = tree_map(lambda t: tuple(t.shape), model.ml_params[key])
        new = tree_map(lambda t: tuple(t.shape), params)
        if old != new:
            raise ValueError(f"surrogate {key!r}: parameter shapes {new} "
                             f"do not match the backend's {old}")
    model.ml_params.update(host)
    backend._theta0 = backend._theta0._replace(ml_params=cast_params(
        model.ml_params, backend.device, backend.dtype))


def scenario_state_from_jax(state, device=None,
                            dtype: torch.dtype = torch.float32):
    """The port's :class:`~agentlib_mpc_torch.scenario.fleet.ScenarioState`
    from another framework's (any object or mapping with its fields, the
    leaves numpy arrays: ``zbar`` and ``lam`` per alias, ``nu``,
    ``na_target``, ``w``, ``y``, ``z``), on ``device`` (None: the card) in
    ``dtype``: a round the JAX package started continues in the port."""
    from agentlib_mpc_torch.scenario.fleet import ScenarioState

    return _named_from_numpy(ScenarioState, state, device, dtype)


def load_scenario_state(fleet, state, dtype: torch.dtype = torch.float32):
    """:func:`scenario_state_from_jax` onto ``fleet``'s device, checked
    against its layout: ``(n_agents, S)`` leading every per-branch leaf,
    ``(S, T)`` every mean, the robust horizon and the controls in ``nu``
    and ``na_target``, and one entry per coupling alias. Raises
    ``ValueError`` on a state of another fleet."""
    out = scenario_state_from_jax(state, fleet.device, dtype)
    n_a, S, T = fleet.group.n_agents, fleet.S, fleet.T
    if sorted(out.zbar) != sorted(fleet.group.couplings) or \
            sorted(out.lam) != sorted(fleet.group.couplings):
        raise ValueError(
            f"state couples {sorted(out.zbar)}, the fleet "
            f"{sorted(fleet.group.couplings)}")
    ocp = fleet.group.ocp
    want = {"nu": (n_a, S, fleet.R, fleet.n_u),
            "na_target": (n_a, S, fleet.R, fleet.n_u),
            "w": (n_a, S, ocp.n_w), "y": (n_a, S, ocp.n_g),
            "z": (n_a, S, ocp.n_h)}
    want.update({f"zbar[{a}]": (S, T) for a in out.zbar})
    want.update({f"lam[{a}]": (n_a, S, T) for a in out.lam})
    have = {"nu": out.nu, "na_target": out.na_target, "w": out.w,
            "y": out.y, "z": out.z}
    have.update({f"zbar[{a}]": v for a, v in out.zbar.items()})
    have.update({f"lam[{a}]": v for a, v in out.lam.items()})
    for name, shape in want.items():
        if tuple(have[name].shape) != shape:
            raise ValueError(
                f"state's {name} is {tuple(have[name].shape)}, the fleet "
                f"needs {shape}")
    return out


def _host_tree(obj):
    """Another framework's nested NamedTuples, dicts, tuples and arrays as
    the same nesting with numpy leaves (named tuples as field dicts)."""
    if obj is None:
        return None
    if hasattr(obj, "_fields"):
        return {k: _host_tree(getattr(obj, k)) for k in obj._fields}
    if isinstance(obj, Mapping):
        return {k: _host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_host_tree(v) for v in obj)
    return np.asarray(obj)


def serving_state_from_jax(plane) -> dict:
    """Everything a serving plane of another framework (the JAX package's
    ``ServingPlane``) carries between rounds, as plain data with numpy
    arrays: per bucket the capacity, slot map, rounds served and its
    engine state, theta batch and mask; the evicted tenants; every
    guard's ladder and the health ledger; the SLO ledger; the pending
    queue; the round counters. The layout is the port's plane checkpoint
    manifest, so :func:`load_serving_state` continues it in the port."""
    import time

    buckets, arrays = [], []
    for key, bucket in plane._buckets.items():
        if not bucket.tenants:
            continue
        buckets.append({"digest": key.digest,
                        "capacity": int(bucket.capacity),
                        "slots": list(bucket.slots),
                        "rounds_served": int(bucket.rounds_served),
                        "scenarios": int(getattr(bucket, "n_scenarios",
                                                 1))})
        arrays.append({"state": _host_tree(bucket.state),
                       "theta": _host_tree(bucket.theta_batch),
                       "mask": np.asarray(bucket.mask, dtype=bool)})
    health = getattr(plane, "_health", None)
    return {
        "buckets": buckets,
        "arrays": arrays,
        "evicted": {tid: key.digest for tid, key in plane._evicted.items()},
        "guards": {tid: g.snapshot() for tid, g in plane._guards.items()},
        "health": health.snapshot() if health is not None else None,
        "slo": plane.slo.snapshot(),
        "queue": plane.queue.snapshot(time.monotonic()),
        "rounds": int(plane.rounds),
        "served_rounds": int(plane.served_rounds),
    }


def load_serving_state(plane, state: Mapping, specs):
    """Continue another framework's serving plane (the plain data of
    :func:`serving_state_from_jax`) in the port's ``plane``, which must be
    empty: buckets rebuilt through its compile cache at the recorded
    capacities, the slot maps, engine states, theta batches and masks
    placed on its device in its dtype (each bucket's structure and leaf
    shapes checked against the rebuilt bucket's), the guard ladders, the
    health and SLO ledgers, the queue and the round counters. ``specs``
    are the tenants' problem definitions in the port (``TenantSpec`` per
    tenant). The JAX package's bucket digests are not the port's; every
    tenant of a bucket must fingerprint into one port bucket. Returns
    ``(buckets, per_tenant_s, requeued)``."""
    from torch.utils._pytree import tree_flatten

    from agentlib_mpc_torch.serving.checkpoint import restore_into

    if plane._tenant_bucket or plane._buckets:
        raise ValueError("load_serving_state needs an EMPTY plane; this "
                         f"one has {len(plane._tenant_bucket)} tenants")

    def signature(tree):
        leaves, spec = tree_flatten(tree)
        return spec, [tuple(t.shape) for t in leaves]

    def load_arrays(templates):
        out = []
        for tmpl, data in zip(templates, state["arrays"]):
            got = {k: _named_from_numpy(type(tmpl[k]), data[k],
                                        plane.device, plane.dtype)
                   for k in ("state", "theta")}
            got["mask"] = torch.as_tensor(np.asarray(data["mask"]))
            if signature(got) != signature(tmpl):
                raise ValueError(
                    f"carried bucket state {signature(got)[1]} does not "
                    f"fit the port's bucket {signature(tmpl)[1]}")
            out.append(got)
        return out

    manifest = {k: state.get(k) for k in ("buckets", "evicted", "guards",
                                          "health", "slo", "queue",
                                          "rounds")}
    out = restore_into(plane, manifest, specs, load_arrays,
                       check_digests=False)
    plane.served_rounds = int(state.get("served_rounds",
                                        plane.served_rounds))
    return out
