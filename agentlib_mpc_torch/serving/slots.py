"""Padded tenant slots over one fused engine.

Port of ``agentlib_mpc_tpu/serving/slots.py`` on one device. A
:class:`SlotPlane` owns ONE single-group
:class:`~agentlib_mpc_torch.parallel.fused_admm.FusedADMM` engine built at
a fixed, pre-padded capacity. Tenants occupy slots; free slots are
padding lanes: they solve the uniform dense math but are masked out of
every consensus mean, multiplier update, residual norm and health flag
(the ``pad_group_to_devices`` contract, made dynamic):

* **join**: take a free slot, write the tenant's parameters and a fresh
  warm start into that lane of the carried tensors (an in-place splice
  at the lane index), set the slot's mask bit;
* **leave**: clear the bit. The lane keeps solving its last parameters
  as padding; nothing changes shape;
* **serve**: one fused ADMM round over the whole batch with the current
  mask.

No engine is built when a tenant joins or leaves: capacity, shapes and
dtype never change, so the engine a bucket was built with serves every
membership state of it. The JAX package's learned warm start at
admission (``ml/warmstart.py``) comes with ROADMAP Queue 1 item 5; every
admission here takes the plain fresh start (the OCP's initial guess,
zero equality duals, inequality duals 0.1, zero coupling multipliers).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from agentlib_mpc_torch.ops.solver import INIT_POINT_SOURCES

#: the inequality-dual value of a fresh start (the engines' ``init_state``)
Z_COLD = 0.1


def tree_repeat(tree, n: int):
    """Stack one agent row into an (n, ...) batch: every lane starts as a
    copy of the seed tenant (the padding semantics of
    ``pad_group_to_devices``). One definition, shared by the slot
    plane's theta batch and the plane's warming batch."""
    return tree_map(
        lambda leaf: leaf.unsqueeze(0).expand(
            (n,) + tuple(leaf.shape)).clone(), tree)


def tree_row(batch, i: int):
    """Agent row ``i`` of a batched pytree (the inverse seam: tenant
    migration when a bucket grows)."""
    return tree_map(lambda leaf: leaf[i], batch)


def splice_rows(batch, lanes, rows) -> None:
    """Write the stacked ``rows`` (k, ...) into lanes ``lanes`` of
    ``batch``, in place, with ONE host-to-device copy: the rows' leaves
    and the lane indices travel together in one host buffer of the
    batch's dtype (lane indices are exact in it below 2**24)."""
    b_leaves, spec = tree_flatten(batch)
    r_leaves, r_spec = tree_flatten(rows)
    if r_spec != spec:
        raise ValueError(f"parameter rows have structure {r_spec}, the "
                         f"bucket's batch {spec}")
    k = len(lanes)
    dtype, device = b_leaves[0].dtype, b_leaves[0].device
    widths = [int(np.prod(leaf.shape[1:], dtype=np.int64))
              for leaf in b_leaves]
    host = torch.empty((k, 1 + sum(widths)), dtype=dtype)
    host[:, 0] = torch.as_tensor(lanes, dtype=dtype)
    col = 1
    for r, b, w in zip(r_leaves, b_leaves, widths):
        if tuple(r.shape[1:]) != tuple(b.shape[1:]):
            raise ValueError(
                f"parameter rows have a leaf of shape {tuple(r.shape[1:])}"
                f", the bucket expects {tuple(b.shape[1:])}")
        host[:, col:col + w] = r.reshape(k, w)
        col += w
    dev = host.to(device, non_blocking=False)
    idx = dev[:, 0].to(torch.long)
    col = 1
    for b, w in zip(b_leaves, widths):
        b.index_copy_(0, idx, dev[:, col:col + w].reshape(
            (k,) + tuple(b.shape[1:])))
        col += w


class RoundHandle(NamedTuple):
    """A served round whose results are not decoded yet."""

    trajs: object            # trajectory pytrees (device)
    stats: object            # IterationStats / ScenarioStats (device)
    #: (tenant_id, slot) at launch: results are decoded against THIS
    #: membership, not the one at materialize time
    served: tuple
    #: robust rounds only: the non-anticipativity projection's actuated
    #: controls, (capacity, S, n_u) on the device, identical across a
    #: node group's branches by construction
    u0: object = None


class _SlotBookkeeping:
    """The occupancy surface both slot planes share. Subclasses own
    ``capacity``, ``slots``, ``_slot_of``, ``mask`` and ``device``."""

    @property
    def n_active(self) -> int:
        return int(self.mask.sum())

    @property
    def free_slots(self) -> int:
        return self.capacity - self.n_active

    def slot_of(self, tenant_id: str) -> "int | None":
        return self._slot_of.get(tenant_id)

    @property
    def tenants(self) -> tuple:
        return tuple(t for t in self.slots if t is not None)

    def served_now(self) -> tuple:
        """(tenant_id, slot) of the current membership."""
        return tuple((t, s) for s, t in enumerate(self.slots)
                     if t is not None)

    def _alloc_slot(self, tenant_id: str) -> int:
        """A free slot for a new tenant (duplicate ids and full planes
        raise: the serving plane grows capacity when full)."""
        if tenant_id in self._slot_of:
            raise ValueError(f"tenant {tenant_id!r} already admitted")
        try:
            return self.slots.index(None)
        except ValueError:
            raise ValueError(
                f"no free slot (capacity {self.capacity})") from None

    def _bind_slot(self, slot: int, tenant_id: str) -> None:
        self.slots[slot] = tenant_id
        self._slot_of[tenant_id] = slot
        self.mask[slot] = True
        self._mask_dev = None

    def evict(self, tenant_id: str) -> int:
        """Free a tenant's slot (mask off; the lane becomes padding and
        keeps its last parameters: shapes never change)."""
        slot = self._slot_of.pop(tenant_id)
        self.slots[slot] = None
        self.mask[slot] = False
        self._mask_dev = None
        return slot

    def mask_on_device(self) -> torch.Tensor:
        """The participation mask on the engine's device, copied once
        per membership change."""
        if self._mask_dev is None:
            self._mask_dev = torch.as_tensor(self.mask, device=self.device)
        return self._mask_dev

    def restore_occupancy(self, slots: "list[str | None]") -> None:
        """Overwrite the occupancy wholesale: the checkpoint-restore seam.
        A restored plane must reproduce the SAVED slot layout (gaps
        included), because the per-lane state restored beside it is
        indexed by those slots."""
        if len(slots) != self.capacity:
            raise ValueError(
                f"occupancy snapshot has {len(slots)} slots for a "
                f"capacity-{self.capacity} plane")
        self.slots = list(slots)
        self._slot_of = {t: s for s, t in enumerate(slots)
                         if t is not None}
        self.mask = np.asarray([t is not None for t in slots], dtype=bool)
        self._mask_dev = None

    def _init_occupancy(self, capacity: int) -> None:
        self.capacity = capacity
        #: slot -> tenant_id or None
        self.slots: list = [None] * capacity
        self._slot_of: dict = {}
        self.mask = np.zeros((capacity,), dtype=bool)
        self._mask_dev = None
        self.rounds_served = 0
        #: per-slot INIT_POINT_SOURCES code of the lane's last admission
        #: (always "plain" until learned warm starts are ported)
        self.init_sources = np.zeros((capacity,), dtype=np.int32)

    def update_theta(self, tenant_id: str, theta_row) -> None:
        """Write one tenant's fresh parameters into its lane."""
        self.update_thetas([self._slot_of[tenant_id]],
                           tree_map(lambda t: t.unsqueeze(0), theta_row))

    def update_thetas(self, slots, rows) -> None:
        """Write stacked fresh parameter rows (k, ...) into ``slots``
        with one host-to-device copy (:func:`splice_rows`)."""
        splice_rows(self.theta_batch, list(slots), rows)


def _state_template(engine, make):
    """The fresh-state template of one engine, built once (the first
    plane over a cached engine pays ``init_state``; later ones clone
    it). Every admitted lane is re-spliced anyway, so the template only
    has to be finite and shape-true."""
    tmpl = engine.__dict__.get("_serving_state_template")
    if tmpl is None:
        tmpl = engine.__dict__["_serving_state_template"] = make()
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, tmpl)


class SlotPlane(_SlotBookkeeping):
    """Slot bookkeeping and lane splicing for one bucket's fused engine.

    ``engine`` must be a single-group :class:`FusedADMM` (the serving
    plane builds one engine per structure bucket); ``theta0`` (on the
    engine's device, in the serving dtype) seeds the padding lanes'
    parameters."""

    def __init__(self, engine, ocp, theta0, shift_between_rounds=True):
        if len(engine.groups) != 1:
            raise ValueError(
                "SlotPlane serves single-group engines (one structure "
                f"bucket per plane); got {len(engine.groups)} groups")
        self.engine = engine
        self.ocp = ocp
        self.device = engine.device
        self._init_occupancy(engine.groups[0].n_agents)
        self.shift_between_rounds = bool(shift_between_rounds)
        # padding lanes repeat the seed tenant's parameters
        self.theta_batch = tree_repeat(theta0, self.capacity)
        self.state = _state_template(
            engine, lambda: engine.init_state([self.theta_batch]))

    # -- membership -----------------------------------------------------------

    def _reset_lane(self, slot: int, theta_row) -> None:
        """Fresh start for a newly admitted tenant's lane, written in
        place: a recycled slot must not leak the previous tenant's
        iterate or multipliers."""
        st = self.state
        st.w[0][slot] = self.ocp.initial_guess(theta_row)
        st.y[0][slot] = 0.0
        st.z[0][slot] = Z_COLD
        for pieces in st.lam.values():
            pieces[0][slot] = 0.0
        for pieces in st.ex_diff.values():
            pieces[0][slot] = 0.0

    def admit(self, tenant_id: str, theta_row) -> int:
        """Place a tenant into a free slot; returns the slot index.
        Raises ``ValueError`` when full (the plane grows capacity) or on
        a duplicate id."""
        slot = self._alloc_slot(tenant_id)
        tree_map(lambda b, r: b[slot].copy_(r), self.theta_batch,
                 theta_row)
        self._reset_lane(slot, theta_row)
        self.init_sources[slot] = 0
        self._bind_slot(slot, tenant_id)
        return slot

    # -- serving --------------------------------------------------------------

    def launch_round(self) -> RoundHandle:
        """Run one fused ADMM round for the current membership. The
        port's round reads its convergence flag on the host each ADMM
        iteration, so this returns once the round has run; only the
        trajectory extraction may still be in flight. The carried state
        is shifted for the next round here."""
        served = self.served_now()
        state, trajs, stats = self.engine.step(
            self.state, [self.theta_batch],
            active=[self.mask_on_device()])
        self.state = self.engine.shift_state(state) \
            if self.shift_between_rounds else state
        self.rounds_served += 1
        return RoundHandle(trajs=trajs, stats=stats, served=served)

    def materialize(self, handle: RoundHandle) -> dict:
        """Copy a round's outputs to the host and decode per-tenant
        results: ``tenant_id -> {"u0": {name: float}, "traj": {"u": row},
        "stats": {...}}``, the result-dict shape
        :func:`~agentlib_mpc_torch.resilience.guard.check_result`
        consumes."""
        u = handle.trajs[0]["u"].cpu().numpy()      # (capacity, N, n_u)
        stats = handle.stats
        converged = bool(stats.converged)
        iterations = int(stats.iterations)
        # per-lane quarantine attribution: the engine substitutes a sick
        # lane's iterate, so its decoded u comes back FINITE; without
        # this column a persistently NaN tenant looks healthy forever
        lane_q = None
        if stats.lane_quarantined is not None:
            lane_q = stats.lane_quarantined[0].cpu().numpy()
        names = list(self.ocp.control_names)
        out = {}
        for tenant_id, slot in handle.served:
            u_row = u[slot]
            out[tenant_id] = {
                "u0": {nm: float(u_row[0, k])
                       for k, nm in enumerate(names)},
                "traj": {"u": u_row},
                "stats": {
                    # per-tenant success: this lane produced a finite
                    # plan; the fleet-level convergence rides along
                    "success": bool(np.isfinite(u_row).all()),
                    "round_converged": converged,
                    "iterations": iterations,
                    "quarantined_iters": (int(lane_q[slot])
                                          if lane_q is not None else 0),
                    "init_point_source":
                        INIT_POINT_SOURCES[int(self.init_sources[slot])],
                },
            }
        return out


class ScenarioSlotPlane(_SlotBookkeeping):
    """Padded tenant slots over one :class:`~agentlib_mpc_torch.scenario.
    fleet.ScenarioFleet` engine, the robust sibling of :class:`SlotPlane`.

    A lane is one ROBUST tenant whose per-round data is an (S, ...)-
    leading per-branch parameter stack (``scenario.generate`` builds it),
    solved as S disturbance branches inside the fused robust round.
    Join, leave and update are the same lane splices and mask flips.

    Decoded results: ``u0`` is the non-anticipativity projection's
    first-interval command of branch 0 (for a fan tree every branch of
    the root group carries the identical row by construction); ``traj``
    carries all S branch trajectories; ``stats.quarantined_iters`` is the
    worst branch's quarantine count (one persistently sick branch marks
    the tenant sick), with the per-branch counts in
    ``stats.branch_quarantined``."""

    def __init__(self, engine, ocp, theta0, shift_between_rounds=True):
        self.engine = engine
        self.ocp = ocp
        self.device = engine.device
        self._init_occupancy(engine.group.n_agents)
        self.n_scenarios = engine.S
        self.shift_between_rounds = bool(shift_between_rounds)
        self.theta_batch = tree_repeat(theta0, self.capacity)
        self.state = _state_template(
            engine, lambda: engine.init_state(self.theta_batch))

    def _check_branch_stack(self, tenant_id: str, theta_row) -> None:
        s_lead = int(tree_flatten(theta_row)[0][0].shape[0])
        if s_lead != self.n_scenarios:
            raise ValueError(
                f"robust tenant {tenant_id!r} submitted a "
                f"{s_lead}-branch theta stack for a "
                f"{self.n_scenarios}-scenario bucket — build it with "
                f"scenario.generate for the bucket's tree")

    def _reset_lane(self, slot: int, theta_row) -> None:
        """Fresh start for a newly admitted robust tenant's lane: the
        plain initial point per branch, zero non-anticipativity and
        coupling multipliers."""
        st = self.state
        st.w[slot] = vmap(self.ocp.initial_guess)(theta_row)
        st.y[slot] = 0.0
        st.z[slot] = Z_COLD
        st.nu[slot] = 0.0
        st.na_target[slot] = 0.0
        for leaf in st.lam.values():
            leaf[slot] = 0.0

    def admit(self, tenant_id: str, theta_row) -> int:
        self._check_branch_stack(tenant_id, theta_row)
        slot = self._alloc_slot(tenant_id)
        tree_map(lambda b, r: b[slot].copy_(r), self.theta_batch,
                 theta_row)
        self._reset_lane(slot, theta_row)
        self.init_sources[slot] = 0
        self._bind_slot(slot, tenant_id)
        return slot

    def update_thetas(self, slots, rows) -> None:
        lead = int(tree_flatten(rows)[0][0].shape[1])
        if lead != self.n_scenarios:
            raise ValueError(
                f"robust rows carry {lead} branches for a "
                f"{self.n_scenarios}-scenario bucket")
        super().update_thetas(slots, rows)

    # -- serving --------------------------------------------------------------

    def launch_round(self) -> RoundHandle:
        served = self.served_now()
        state, trajs, stats = self.engine.step(
            self.state, self.theta_batch, active=self.mask_on_device())
        u0 = self.engine.actuated_u0(state)
        self.state = self.engine.shift_state(state) \
            if self.shift_between_rounds else state
        self.rounds_served += 1
        return RoundHandle(trajs=trajs, stats=stats, served=served, u0=u0)

    def materialize(self, handle: RoundHandle) -> dict:
        u = handle.trajs["u"].cpu().numpy()     # (capacity, S, N, n_u)
        u0 = handle.u0.cpu().numpy()            # (capacity, S, n_u)
        stats = handle.stats
        converged = bool(stats.converged)
        iterations = int(stats.iterations)
        na_spread = float(stats.na_spread)
        lane_q = None
        if stats.lane_quarantined is not None:
            lane_q = stats.lane_quarantined.cpu().numpy()   # (cap, S)
        names = list(self.ocp.control_names)
        out = {}
        for tenant_id, slot in handle.served:
            u_lane = u[slot]                    # (S, N, n_u)
            u0_row = u0[slot, 0]                # nominal-branch command
            branch_q = (lane_q[slot].tolist() if lane_q is not None
                        else [0] * self.n_scenarios)
            out[tenant_id] = {
                "u0": {nm: float(u0_row[k])
                       for k, nm in enumerate(names)},
                "traj": {"u": u_lane},
                "stats": {
                    "success": bool(np.isfinite(u_lane).all()
                                    and np.isfinite(u0_row).all()),
                    "round_converged": converged,
                    "iterations": iterations,
                    "na_spread": na_spread,
                    # worst branch: one persistently quarantined branch
                    # marks the robust tenant sick
                    "quarantined_iters": int(max(branch_q)),
                    "branch_quarantined": branch_q,
                    "init_point_source":
                        INIT_POINT_SOURCES[int(self.init_sources[slot])],
                },
            }
        return out


def stack_rows(rows: list):
    """Stack per-tenant host parameter rows into one (k, ...) pytree."""
    leaves = [tree_flatten(r)[0] for r in rows]
    spec = tree_flatten(rows[0])[1]
    return tree_unflatten([torch.stack(ls) for ls in zip(*leaves)], spec)
