"""Scenario-tree metadata and the tree-structured KKT solve.

Port of ``agentlib_mpc_tpu/scenario/tree.py``. A scenario tree for robust
MPC (multi-stage NMPC) is, per agent, S copies of one transcribed OCP, one
per disturbance realization, coupled only by non-anticipativity: the
scenarios that share a tree node up to stage ``t`` apply the same control
at ``t``.

The coupled KKT system is block diagonal over branches (each block
block-tridiagonal under the branch's
:class:`~agentlib_mpc_torch.ops.stagewise.StagePartition`, so it factors
as S stage sweeps in one batch,
:func:`~agentlib_mpc_torch.ops.stagewise.factor_kkt_scenarios`) plus thin
equality rows, pairwise control pins within each node group, whose Schur
complement onto the coupling multipliers is a small dense SPD system. That
one is factored by the same LDLᵀ wrappers (``ops/kkt.py``), as a batch of
one: on a CUDA tensor every factor and solve of the tree solve runs on
the two Hopper kernels.

The metadata (:class:`ScenarioTree`, :class:`TreePartition`, the coupling
layout) is plain Python and numpy, copied from the JAX package, so it
equals the JAX package's entry for entry. Batch-first: the scenario axis
is the batch axis of the sweep, and the m unit-vector resolves the JAX
package maps over run as one resolve of m·S right-hand sides
(:func:`~agentlib_mpc_torch.ops.stagewise.repeat_scenario_factor`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from agentlib_mpc_torch.ops import kkt as kkt_ops
from agentlib_mpc_torch.ops.stagewise import (
    StagePartition,
    factor_kkt_scenarios,
    repeat_scenario_factor,
    resolve_kkt_scenarios,
    synthetic_stage_kkt,
)
from agentlib_mpc_torch.utils.device import resolve_device

__all__ = [
    "ScenarioTree",
    "TreePartition",
    "TreeStructureCertificate",
    "branching_tree",
    "build_tree_partition",
    "certify_tree_structure",
    "factor_kkt_tree",
    "fan_tree",
    "resolve_kkt_tree",
    "single_scenario",
    "solve_kkt_tree",
    "synthetic_tree_kkt",
    "tree_kkt_residual",
    "tree_method_available",
    "tree_partition_for_ocp",
]

#: the probe's bound on the coupled system's residual (the JAX package's)
TREE_PROBE_TOL = 1e-3


class ScenarioTree(NamedTuple):
    """Static scenario-tree metadata; hashable (ints and nested int
    tuples), so it can key engine caches like a stage partition.

    ``node_of`` lists, per non-anticipative control interval ``t``
    (outer tuple, length = robust horizon), the tree-node id of every
    scenario: scenarios sharing the node at ``t`` apply the same ``u_t``.
    An empty ``node_of`` means independent scenarios. ``probabilities``
    weight each branch's objective (data, not structure)."""

    n_scenarios: int
    node_of: tuple          # per robust stage: tuple(scenario -> node id)
    probabilities: tuple

    @property
    def robust_horizon(self) -> int:
        """Control intervals under non-anticipativity coupling."""
        return len(self.node_of)

    def groups_at(self, t: int) -> tuple:
        """Non-anticipativity groups at robust stage ``t``: tuple of
        scenario-index tuples, one per tree node, singletons included."""
        nodes: dict = {}
        for s, node in enumerate(self.node_of[t]):
            nodes.setdefault(node, []).append(s)
        return tuple(tuple(v) for _k, v in sorted(nodes.items()))

    def validate(self, N: "int | None" = None) -> "ScenarioTree":
        if self.n_scenarios < 1:
            raise ValueError("a scenario tree needs >= 1 scenario")
        if len(self.probabilities) != self.n_scenarios:
            raise ValueError(
                f"{len(self.probabilities)} probabilities for "
                f"{self.n_scenarios} scenarios")
        if abs(sum(self.probabilities) - 1.0) > 1e-9:
            raise ValueError("scenario probabilities must sum to 1")
        for t, nodes in enumerate(self.node_of):
            if len(nodes) != self.n_scenarios:
                raise ValueError(
                    f"node_of[{t}] lists {len(nodes)} scenarios, tree "
                    f"has {self.n_scenarios}")
        if N is not None and self.robust_horizon > N:
            raise ValueError(
                f"robust horizon {self.robust_horizon} exceeds the "
                f"{N}-interval control horizon")
        return self

    def subtree(self, keep) -> "ScenarioTree":
        """The tree restricted to the surviving scenario indices ``keep``
        (strictly ascending), the probabilities renormalized to sum to
        one (uniform where every kept branch had probability 0). Node
        groups shrink with their members."""
        keep = tuple(int(s) for s in keep)
        if not keep:
            raise ValueError("subtree needs >= 1 surviving scenario")
        if list(keep) != sorted(set(keep)):
            raise ValueError(
                f"surviving scenario indices must be strictly "
                f"ascending, got {keep}")
        bad = [s for s in keep if not 0 <= s < self.n_scenarios]
        if bad:
            raise ValueError(
                f"surviving indices {bad} outside the "
                f"{self.n_scenarios}-scenario tree")
        probs = tuple(self.probabilities[s] for s in keep)
        total = sum(probs)
        probs = (tuple(p / total for p in probs) if total > 0
                 else _uniform(len(keep)))
        node_of = tuple(tuple(nodes[s] for s in keep)
                        for nodes in self.node_of)
        return ScenarioTree(n_scenarios=len(keep), node_of=node_of,
                            probabilities=probs).validate()


def _uniform(n: int) -> tuple:
    return tuple(1.0 / n for _ in range(n))


def fan_tree(n_scenarios: int, robust_horizon: int = 1,
             probabilities=None) -> ScenarioTree:
    """All scenarios branch at the root: one non-anticipativity group per
    robust stage (``u_0..u_{R-1}`` identical across every scenario)."""
    probs = tuple(probabilities) if probabilities is not None \
        else _uniform(n_scenarios)
    node_of = tuple((0,) * n_scenarios for _ in range(max(robust_horizon,
                                                          0)))
    return ScenarioTree(n_scenarios=int(n_scenarios), node_of=node_of,
                        probabilities=probs).validate()


def branching_tree(factors, probabilities=None) -> ScenarioTree:
    """Multi-stage tree from per-stage branching factors: ``(3, 2)`` is 6
    scenarios; all share ``u_0``, triples sharing the first branch share
    ``u_1``. Scenario ``s`` enumerates branch choices lexicographically,
    so its node at stage ``t`` is ``s // prod(factors[t:])``."""
    factors = tuple(int(f) for f in factors)
    if not factors or any(f < 1 for f in factors):
        raise ValueError(f"branching factors must be >= 1, got {factors}")
    n = int(np.prod(factors))
    node_of = []
    for t in range(len(factors)):
        stride = int(np.prod(factors[t:], dtype=np.int64))
        node_of.append(tuple(s // stride for s in range(n)))
    probs = tuple(probabilities) if probabilities is not None \
        else _uniform(n)
    return ScenarioTree(n_scenarios=n, node_of=tuple(node_of),
                        probabilities=probs).validate()


def single_scenario() -> ScenarioTree:
    """The degenerate tree: one branch, no coupling."""
    return ScenarioTree(n_scenarios=1, node_of=(), probabilities=(1.0,))


class TreePartition(NamedTuple):
    """The per-branch :class:`StagePartition`, the tree, and per robust
    stage ``t`` the tuple of per-branch primal indices holding ``u_t``
    (``na_indices``), the coordinates the coupling rows difference across
    the scenarios of a node group. Hashable."""

    base: StagePartition
    tree: ScenarioTree
    na_indices: tuple

    @property
    def n_scenarios(self) -> int:
        return self.tree.n_scenarios

    @property
    def n_coupling_rows(self) -> int:
        """Per robust stage and node group, ``|group|-1`` pairwise pins
        per coupled coordinate."""
        rows = 0
        for t in range(self.tree.robust_horizon):
            for grp in self.tree.groups_at(t):
                rows += (len(grp) - 1) * len(self.na_indices[t])
        return rows


def build_tree_partition(base: StagePartition, tree: ScenarioTree,
                         na_indices) -> TreePartition:
    """Validate and assemble a :class:`TreePartition`; ``na_indices``
    holds one tuple of primal indices (below ``base.n_w``) per robust
    stage."""
    tree.validate()
    na_indices = tuple(tuple(int(i) for i in idx) for idx in na_indices)
    if len(na_indices) != tree.robust_horizon:
        raise ValueError(
            f"na_indices covers {len(na_indices)} stages, tree couples "
            f"{tree.robust_horizon}")
    for t, idx in enumerate(na_indices):
        bad = [i for i in idx if not 0 <= i < base.n_w]
        if bad:
            raise ValueError(
                f"na_indices[{t}] contains non-primal indices {bad} "
                f"(n_w={base.n_w})")
    return TreePartition(base=base, tree=tree, na_indices=na_indices)


def tree_partition_for_ocp(ocp, tree: ScenarioTree) -> TreePartition:
    """Tree partition of a transcribed OCP: its stage partition per
    branch, the robust-stage controls located in the decision layout (the
    ``u`` blocks lead it)."""
    if ocp.stage_partition is None:
        raise ValueError(
            f"OCP {ocp.model.__class__.__name__} carries no stage "
            f"partition — transcribe() attaches one")
    tree.validate(ocp.N)
    n_u = len(ocp.control_names)
    na_indices = tuple(
        tuple(range(t * n_u, (t + 1) * n_u))
        for t in range(tree.robust_horizon))
    return build_tree_partition(ocp.stage_partition, tree, na_indices)


# --------------------------------------------------------------------------
# the non-anticipativity coupling layout
# --------------------------------------------------------------------------

def _coupling_layout(tp: TreePartition):
    """Rows of the coupling matrix A: per row a (w-index, scenario,
    reference scenario) pairwise pin, as int64 arrays of length ``m``
    (empty for degenerate trees)."""
    idx, s_pos, s_ref = [], [], []
    for t in range(tp.tree.robust_horizon):
        for grp in tp.tree.groups_at(t):
            ref = grp[0]
            for s in grp[1:]:
                for i in tp.na_indices[t]:
                    idx.append(i)
                    s_pos.append(s)
                    s_ref.append(ref)
    return (np.asarray(idx, dtype=np.int64),
            np.asarray(s_pos, dtype=np.int64),
            np.asarray(s_ref, dtype=np.int64))


_LAYOUTS: dict = {}


def _layout_tensors(tp: TreePartition, device: torch.device):
    """:func:`_coupling_layout` as index tensors on ``device``, built once
    per (partition, device)."""
    key = (tp, device)
    out = _LAYOUTS.get(key)
    if out is None:
        out = tuple(torch.as_tensor(a, device=device)
                    for a in _coupling_layout(tp))
        _LAYOUTS[key] = out
    return out


def _apply_A(x_batch: torch.Tensor, layout) -> torch.Tensor:
    """A @ x for stacked per-scenario solutions x (..., S, M): pairwise
    differences at the coupled coordinates, (..., m)."""
    idx, s_pos, s_ref = layout
    return x_batch[..., s_pos, idx] - x_batch[..., s_ref, idx]


def _apply_AT(nu: torch.Tensor, layout, n_scenarios: int,
              n_total: int) -> torch.Tensor:
    """Aᵀ @ ν scattered into (..., S, M) right-hand-side stacks for
    ν (..., m)."""
    idx, s_pos, s_ref = layout
    lead = nu.shape[:-1]
    flat = nu.new_zeros(lead + (n_scenarios * n_total,))
    flat = flat.index_add(-1, s_pos * n_total + idx, nu)
    flat = flat.index_add(-1, s_ref * n_total + idx, -nu)
    return flat.reshape(lead + (n_scenarios, n_total))


# --------------------------------------------------------------------------
# tree factor / resolve (mirrors factor_kkt_stage / resolve_kkt_stage)
# --------------------------------------------------------------------------

def factor_kkt_tree(K_batch: torch.Tensor, tp: TreePartition,
                    delta_c: float = 1e-8):
    """Factor the non-anticipativity-coupled tree KKT system

        [[blkdiag(K_s), Aᵀ], [A, -δ_c I]]

    from the per-scenario stacks ``K_batch`` (S, M, M): S stage sweeps in
    one batch plus the coupling Schur complement ``S_c = A K⁻¹ Aᵀ + δ_c I``
    (SPD: A touches primal coordinates only), factored once by the LDLᵀ
    wrapper as a batch of one. Degenerate trees (one scenario, or no
    coupled stage) have no Schur complement."""
    from agentlib_mpc_torch.ops.solver import _true_f32_matmul

    S = tp.n_scenarios
    if K_batch.shape[0] != S:
        raise ValueError(
            f"K_batch has {K_batch.shape[0]} scenarios, partition "
            f"describes {S}")
    with _true_f32_matmul():
        F = factor_kkt_scenarios(K_batch, tp.base)
        layout = _layout_tensors(tp, K_batch.device)
        m = layout[0].shape[0]
        if m == 0:
            return (F, None, None)
        # columns of K⁻¹ Aᵀ: the m coupled unit vectors resolved against
        # the scenario factors in one (refined) resolve of m·S systems
        eye = torch.eye(m, dtype=K_batch.dtype, device=K_batch.device)
        rhs = _apply_AT(eye, layout, S, tp.base.n_total)     # (m, S, M)
        KinvAT = resolve_kkt_scenarios(
            repeat_scenario_factor(F, m), rhs.reshape(m * S, -1),
            tp.base).reshape(rhs.shape)
        Sc = _apply_A(KinvAT, layout)                           # (m, m)
        Sc = 0.5 * (Sc + Sc.T) + delta_c * eye
        Fc = kkt_ops.ldl_factor(Sc[None])
    return (F, Fc, KinvAT)


def resolve_kkt_tree(factor, rhs_batch: torch.Tensor, tp: TreePartition,
                     refine_steps: int = 2) -> torch.Tensor:
    """Solve the coupled tree system for a right-hand-side stack (S, M)
    (the coupling rows' right-hand side is 0) by block elimination
    through the stored factors:

        ν = S_c⁻¹ A K⁻¹ b,   x = K⁻¹ (b − Aᵀ ν).
    """
    from agentlib_mpc_torch.ops.solver import _true_f32_matmul

    F, Fc, _KinvAT = factor
    with _true_f32_matmul():
        x = resolve_kkt_scenarios(F, rhs_batch, tp.base, refine_steps)
        if Fc is None:
            return x
        layout = _layout_tensors(tp, rhs_batch.device)
        nu = kkt_ops.ldl_solve(Fc, _apply_A(x, layout)[None])[0]
        corr = _apply_AT(nu, layout, tp.n_scenarios, tp.base.n_total)
        return x - resolve_kkt_scenarios(F, corr, tp.base, refine_steps)


def solve_kkt_tree(K_batch: torch.Tensor, rhs_batch: torch.Tensor,
                   tp: TreePartition, refine_steps: int = 2,
                   delta_c: float = 1e-8) -> torch.Tensor:
    """Factor and resolve in one call, the tree counterpart of
    :func:`~agentlib_mpc_torch.ops.stagewise.solve_kkt_stage`."""
    return resolve_kkt_tree(factor_kkt_tree(K_batch, tp, delta_c),
                            rhs_batch, tp, refine_steps)


def tree_kkt_residual(K_batch: torch.Tensor, rhs_batch: torch.Tensor,
                      x: torch.Tensor, tp: TreePartition) -> torch.Tensor:
    """The coupled system's residual of a solution ``x`` (S, M), as a
    0-dim tensor: at the coupled coordinates ``K x − b`` equals the
    coupling force −Aᵀν by construction, so it is taken OFF them, and the
    constraint ``A x = 0`` ON them (true-f32 products)."""
    from agentlib_mpc_torch.ops.solver import _true_f32_matmul

    layout = _layout_tensors(tp, x.device)
    with _true_f32_matmul():
        r = torch.matmul(K_batch, x[..., None])[..., 0] - rhs_batch
    if layout[0].shape[0]:
        idx, s_pos, s_ref = layout
        coupled = torch.zeros(r.shape, dtype=torch.bool, device=r.device)
        coupled[s_pos, idx] = True
        coupled[s_ref, idx] = True
        r = torch.where(coupled, r.new_zeros(()), r)
        return torch.maximum(r.abs().amax(), _apply_A(x, layout).abs().amax())
    return r.abs().amax()


def synthetic_tree_kkt(tp: TreePartition, seed: int = 0, dtype=None):
    """Per-scenario synthetic banded quasi-definite stacks (S, M, M) and
    right-hand sides (S, M), as numpy (the JAX package's numbers): branch
    ``s`` draws seed ``seed + s``."""
    Ks, rhs = [], []
    for s in range(tp.n_scenarios):
        K_s, r_s = synthetic_stage_kkt(tp.base, seed=seed + s, dtype=dtype)
        Ks.append(K_s)
        rhs.append(r_s)
    return np.stack(Ks), np.stack(rhs)


_TREE_PROBE: dict = {}


def tree_method_available(tp: TreePartition, device=None,
                          dtype: torch.dtype = torch.float32) -> bool:
    """Once per (device type, dtype, partition): solve the synthetic tree
    system at ``tp``'s shape on ``device`` (None: the card) and check the
    FULL coupled system's residual (:func:`tree_kkt_residual`) below
    :data:`TREE_PROBE_TOL`. A kernel or shape failure answers False."""
    dev = resolve_device(device)
    key = (dev.type, dtype, tp)
    if key in _TREE_PROBE:
        return _TREE_PROBE[key]
    K, rhs = synthetic_tree_kkt(tp)
    Kt = torch.as_tensor(K, dtype=dtype, device=dev)
    rt = torch.as_tensor(rhs, dtype=dtype, device=dev)
    try:
        x = solve_kkt_tree(Kt, rt, tp)
        res = float(tree_kkt_residual(Kt, rt, x, tp))
        ok = bool(np.isfinite(res) and res < TREE_PROBE_TOL)
    except (RuntimeError, ValueError):
        ok = False
    _TREE_PROBE[key] = ok
    return ok


# --------------------------------------------------------------------------
# structure certification
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeStructureCertificate:
    """The stage-structure certificate extended to a scenario tree: the
    branches share one traced structure (branch data is theta), so one
    flat certification answers for every branch; ``ok`` gates the
    tree-banded derivative path as the flat certificate gates the flat
    one."""

    base: "object"                 # lint.fx.structure.StructureCertificate
    n_scenarios: int
    robust_horizon: int
    n_coupling_rows: int

    @property
    def ok(self) -> bool:
        return bool(self.base.ok)

    def describe(self) -> str:
        return (f"{self.base.describe()} x {self.n_scenarios} "
                f"scenario branch(es), {self.n_coupling_rows} "
                f"non-anticipativity row(s) over "
                f"{self.robust_horizon} robust stage(s)")


def certify_tree_structure(nlp, theta, n_w: int,
                           tp: TreePartition) -> TreeStructureCertificate:
    """Prove the per-branch KKT structure once for the whole tree; the
    coupling rows are constructed selector rows and need no proof."""
    from agentlib_mpc_torch.lint.fx import certify_stage_structure

    base = certify_stage_structure(nlp, theta, n_w, tp.base)
    return TreeStructureCertificate(
        base=base, n_scenarios=tp.n_scenarios,
        robust_horizon=tp.tree.robust_horizon,
        n_coupling_rows=tp.n_coupling_rows)
