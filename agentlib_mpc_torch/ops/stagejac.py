"""Stage-sparse derivative pipeline: banded eval+jac for stage-banded OCPs.

Port of ``agentlib_mpc_tpu/ops/stagejac.py`` (lines 74-526). The dense
pipeline (``ops/solver.py``) computes the full ``(1+m_e+m_h) × n_w``
Jacobian by ``jacrev`` and the dense Lagrangian Hessian over all ``n_w``
columns, though a transcription's KKT system is block-banded under its
:class:`~agentlib_mpc_torch.ops.stagewise.StagePartition`. This module
recovers both from a constant number of compressed passes:

* **Row-compressed pullbacks.** Constraint rows anchored at stages ``s``
  and ``s' ≥ s+3`` have disjoint column supports, so one VJP cotangent
  carries one row from every third stage: ``1 + 3·e_s + 3·h_s`` pullbacks
  (``e_s``/``h_s`` the most constraint rows of one stage) instead of
  ``1 + m_e + m_h``.
* **Column-compressed Hessian.** The Lagrangian Hessian couples stages
  within distance 1, so ``3·v_s`` forward-over-reverse seeds (``v_s`` the
  most variables of one stage) recover every column instead of ``n_w``.
* **Direct banded assembly.** The compressed results scatter straight
  into the ``(D, E)`` blocks
  :func:`~agentlib_mpc_torch.ops.stagewise.factor_kkt_stage_banded`
  takes; the dense KKT matrix never exists on this path.

The plan (:class:`StageJacobianPlan`) is numpy, copied from the JAX
package, so its index arrays equal the JAX package's entry for entry; its
tensors are built once per (plan, device). Routing follows the JAX
package: the stage-structure certificate (``lint/fx``) is the only source
of a plan (:func:`plan_from_certificate`); refuted or unknown structure
keeps the dense pipeline, with a log line.

Batch-first. The traced building blocks take a batch of lanes: ``w``
(B, n), per-lane arguments batched on axis 0 (``in_dims``), the model
functions per problem, batched with ``torch.func.vmap`` over ``vjp``
cotangents (``banded_fgh_jac``) and ``jvp`` seeds
(``banded_lagrangian_hessian``). Gathers and scatters run on index
tensors of the plan.

The scenario-tree variants (``tree_*``, the JAX package's lines 537-605)
run a scenario batch through the same functions: every branch evaluates
the same traced structure (branch data is theta), so the flat plan's seeds
serve every branch and, batch-first, the scenario axis is the lane axis. A
one-scenario batch takes the flat call with its theta row bound, as the
JAX package calls its flat functions unwrapped.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch.func import jvp, vjp, vmap
from torch.utils._pytree import tree_map

from agentlib_mpc_torch.ops.stagewise import StagePartition, stage_of_index

__all__ = [
    "StageJacobianPlan",
    "assemble_kkt_banded",
    "attach_plan_if_worthwhile",
    "band_matvec",
    "band_rmatvec",
    "band_row_absmax",
    "banded_fgh_jac",
    "banded_lagrangian_hessian",
    "build_stage_jacobian_plan",
    "hessian_rows",
    "plan_from_certificate",
    "stacked_fgh",
    "tree_assemble_kkt_banded",
    "tree_banded_fgh_jac",
    "tree_banded_lagrangian_hessian",
    "tree_plan_from_certificate",
]

logger = logging.getLogger(__name__)


class StageJacobianPlan:
    """Static metadata of the stage-sparse derivative pipeline for ONE
    problem structure: compressed-cotangent seed matrices, row-window
    gather indices, and banded-KKT scatter targets.

    Hashable/comparable by its *defining key* ``(partition,
    h_row_stages)`` only — the derived index arrays (tens of thousands
    of ints for long horizons) are deterministic functions of the key
    and are deliberately excluded, so hashing stays as cheap as the
    partition's (the plan rides in ``SolverOptions``). Build through
    :func:`build_stage_jacobian_plan` (memoized: equal keys return the
    identical object) or :func:`plan_from_certificate`."""

    def __init__(self, partition: StagePartition, h_row_stages: tuple):
        p = partition
        S, ns = p.n_stages, p.block
        n_w, n_total = p.n_w, p.n_total
        m_e = n_total - n_w
        m_h = len(h_row_stages)
        self.partition = p
        self.h_row_stages = tuple(int(s) for s in h_row_stages)
        self.n_w, self.m_e, self.m_h = n_w, m_e, m_h

        perm = np.asarray(p.perm, dtype=np.int64)
        stage_of = stage_of_index(p)
        pos_of = np.empty((n_total,), dtype=np.int64)
        valid = perm >= 0
        pos_of[perm[valid]] = np.nonzero(valid)[0]
        slot_of = pos_of % ns

        # per-stage variable / equality-row layout (rank = order within
        # the stage's padded block, so it is deterministic)
        var_count = np.zeros((S,), dtype=np.int64)
        eq_count = np.zeros((S,), dtype=np.int64)
        var_rank = np.zeros((n_w,), dtype=np.int64)
        eq_rank = np.zeros((max(m_e, 1),), dtype=np.int64)
        for pos in range(S * ns):
            orig = perm[pos]
            if orig < 0:
                continue
            s = pos // ns
            if orig < n_w:
                var_rank[orig] = var_count[s]
                var_count[s] += 1
            else:
                eq_rank[orig - n_w] = eq_count[s]
                eq_count[s] += 1
        v_s = int(var_count.max()) if n_w else 1
        e_s = int(eq_count.max()) if m_e else 0
        var_cols = np.full((S, v_s), -1, dtype=np.int64)
        fill = np.zeros((S,), dtype=np.int64)
        for pos in range(S * ns):
            orig = perm[pos]
            if 0 <= orig < n_w:
                s = pos // ns
                var_cols[s, fill[s]] = orig
                fill[s] += 1
        self.v_s, self.e_s = v_s, e_s

        eq_stage = stage_of[n_w:] if m_e else np.zeros((0,), np.int64)
        h_base = np.asarray(self.h_row_stages, dtype=np.int64)
        if m_h and (h_base.min() < 0 or h_base.max() >= S):
            raise ValueError(
                f"h_row_stages outside the partition's {S} stages")
        h_count = np.zeros((S,), dtype=np.int64)
        h_rank = np.zeros((max(m_h, 1),), dtype=np.int64)
        for r in range(m_h):
            h_rank[r] = h_count[h_base[r]]
            h_count[h_base[r]] += 1
        h_s = int(h_count.max()) if m_h else 0
        self.h_s = h_s

        # ---- compressed VJP cotangents over the stacked [f; g; h] ------
        # seed (c, k) sums row k of every stage ≡ c (mod 3): rows three
        # stages apart have disjoint column supports, so the compressed
        # pullback is loss-free
        n_ct = 1 + 3 * e_s + 3 * h_s
        ct = np.zeros((n_ct, 1 + m_e + m_h))
        ct[0, 0] = 1.0
        g_seed = np.zeros((max(m_e, 1),), dtype=np.int64)
        for r in range(m_e):
            g_seed[r] = 1 + (int(eq_stage[r]) % 3) * e_s + eq_rank[r]
            ct[g_seed[r], 1 + r] = 1.0
        h_seed = np.zeros((max(m_h, 1),), dtype=np.int64)
        for r in range(m_h):
            h_seed[r] = 1 + 3 * e_s + (int(h_base[r]) % 3) * h_s + h_rank[r]
            ct[h_seed[r], 1 + m_e + r] = 1.0
        self.n_ct = n_ct
        self.ct_matrix = ct

        # ---- Hessian forward seeds -------------------------------------
        # column compression: variables of stages ≡ c (mod 3) share one
        # seed per in-stage rank (Hessian rows of two such columns are
        # disjoint because interactions stay within stage distance 1)
        n_hs = 3 * v_s
        hess_seeds = np.zeros((n_hs, n_w))
        for s in range(S):
            for b in range(v_s):
                j = var_cols[s, b]
                if j >= 0:
                    hess_seeds[(s % 3) * v_s + b, j] = 1.0
        self.hess_seeds = hess_seeds

        def window_cols(stages):
            out = []
            for s in stages:
                if 0 <= s < S:
                    out.extend(var_cols[s].tolist())
                else:
                    out.extend([-1] * v_s)
            return out

        def hseed_of_col(j):
            return (int(stage_of[j]) % 3) * v_s + var_rank[j]

        # ---- Jg / Jh / H row windows (gathered from compressed results)
        W_g = 3 * v_s
        g_cols = np.full((max(m_e, 1), W_g), -1, dtype=np.int64)
        g_src = np.zeros((max(m_e, 1), W_g), dtype=np.int64)
        for r in range(m_e):
            sr = int(eq_stage[r])
            g_cols[r] = window_cols((sr - 1, sr, sr + 1))
            g_src[r] = g_seed[r] * n_w + np.maximum(g_cols[r], 0)
        self.W_g = W_g
        self.g_cols = g_cols[:m_e]
        self.g_cols_safe = np.maximum(self.g_cols, 0).astype(np.int32)
        self.g_src = g_src[:m_e].astype(np.int32)
        self.g_mask = self.g_cols >= 0

        W_h = 2 * v_s
        h_cols = np.full((max(m_h, 1), W_h), -1, dtype=np.int64)
        h_src = np.zeros((max(m_h, 1), W_h), dtype=np.int64)
        for r in range(m_h):
            s0 = int(h_base[r])
            h_cols[r] = window_cols((s0, s0 + 1))
            h_src[r] = h_seed[r] * n_w + np.maximum(h_cols[r], 0)
        self.W_h = W_h
        self.h_cols = h_cols[:m_h]
        self.h_cols_safe = np.maximum(self.h_cols, 0).astype(np.int32)
        self.h_src = h_src[:m_h].astype(np.int32)
        self.h_mask = self.h_cols >= 0

        W_H = 3 * v_s
        hrow_cols = np.full((n_w, W_H), -1, dtype=np.int64)
        hrow_src = np.zeros((n_w, W_H), dtype=np.int64)
        for i in range(n_w):
            si = int(stage_of[i])
            hrow_cols[i] = window_cols((si - 1, si, si + 1))
            for k, j in enumerate(hrow_cols[i]):
                if j >= 0:
                    hrow_src[i, k] = hseed_of_col(j) * n_w + i
        self.W_H = W_H
        self.hrow_cols = hrow_cols
        self.hrow_cols_safe = np.maximum(hrow_cols, 0).astype(np.int32)
        self.hrow_src = hrow_src.astype(np.int32)
        self.hrow_mask = hrow_cols >= 0

        # ---- banded-KKT scatter layout ---------------------------------
        # one flat buffer [D (S·ns²) | E ((S-1)·ns²) | garbage (1)];
        # entries that belong to an implicit-transpose block (the sweep
        # reads only D and the sub-diagonal E) scatter into the garbage
        # slot and are dropped
        n_D = S * ns * ns
        n_E = (S - 1) * ns * ns
        garbage = n_D + n_E
        self._n_D, self._n_E, self._S, self._ns = n_D, n_E, S, ns

        def dst_of(i_orig, j_orig):
            """Flat destination of entry (row i, col j) of the permuted
            KKT matrix, or the garbage slot when the entry lives in an
            implicit-transpose block (it is covered from (j, i))."""
            si, sj = int(stage_of[i_orig]), int(stage_of[j_orig])
            ai, aj = int(slot_of[i_orig]), int(slot_of[j_orig])
            if si == sj:
                return si * ns * ns + ai * ns + aj
            if si == sj + 1:                      # sub-diagonal block
                return n_D + sj * ns * ns + ai * ns + aj
            if si == sj - 1:                      # super-diagonal: E^T
                return garbage
            raise AssertionError(
                f"entry ({i_orig}, {j_orig}) couples stages {si} and "
                f"{sj} — outside the certified band")

        de_init = np.zeros((n_D + n_E + 1,))
        for pos in range(S * ns):
            if perm[pos] < 0:                     # decoupled unit pivot
                s, a = pos // ns, pos % ns
                de_init[s * ns * ns + a * ns + a] = 1.0
        self.de_init = de_init

        # Hessian: every (var row i, window col) entry of H_rows
        hasm = np.full((n_w, W_H), garbage, dtype=np.int64)
        for i in range(n_w):
            for k, j in enumerate(hrow_cols[i]):
                if j >= 0:
                    hasm[i, k] = dst_of(i, j)
        self.hasm_dst = hasm.reshape(-1).astype(np.int32)

        # Jg: orientation 1 = (equality row, variable column) placed
        # wherever it lands in {D, E-or-transpose-partner}; orientation 2
        # = the symmetric (variable, equality) entry, needed only for
        # same-stage pairs (cross-stage partners are the E entries
        # orientation 1 already wrote)
        g1 = np.full((max(m_e, 1), W_g), garbage, dtype=np.int64)
        g2 = np.full((max(m_e, 1), W_g), garbage, dtype=np.int64)
        for r in range(m_e):
            i = n_w + r
            for k, j in enumerate(g_cols[r]):
                if j < 0:
                    continue
                d1 = dst_of(i, j)
                if d1 == garbage:                 # super-diagonal: write
                    d1 = dst_of(j, i)             # the (var, eq) partner
                g1[r, k] = d1
                if int(stage_of[i]) == int(stage_of[j]):
                    g2[r, k] = dst_of(j, i)
        self.gasm_dst1 = g1[:m_e].reshape(-1).astype(np.int32)
        self.gasm_dst2 = g2[:m_e].reshape(-1).astype(np.int32)

        # Jhᵀ Σ Jh: per-row outer products over the row's window
        jh = np.full((max(m_h, 1), W_h, W_h), garbage, dtype=np.int64)
        for r in range(m_h):
            for k1, c1 in enumerate(h_cols[r]):
                if c1 < 0:
                    continue
                for k2, c2 in enumerate(h_cols[r]):
                    if c2 < 0:
                        continue
                    jh[r, k1, k2] = dst_of(c1, c2)
        self.jh_dst = jh[:m_h].reshape(-1).astype(np.int32)

        vd = np.zeros((n_w,), dtype=np.int64)
        for i in range(n_w):
            vd[i] = dst_of(i, i)
        self.var_diag_dst = vd.astype(np.int32)
        ed = np.zeros((max(m_e, 1),), dtype=np.int64)
        for r in range(m_e):
            ed[r] = dst_of(n_w + r, n_w + r)
        self.eq_diag_dst = ed[:m_e].astype(np.int32)

    # identity is defined by the key; derived arrays are deterministic
    def _key(self):
        return (self.partition, self.h_row_stages)

    def __eq__(self, other):
        return (isinstance(other, StageJacobianPlan)
                and self._key() == other._key())

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"StageJacobianPlan(stages={self.partition.n_stages}, "
                f"block={self.partition.block}, n_w={self.n_w}, "
                f"m_e={self.m_e}, m_h={self.m_h}, "
                f"seeds={self.n_ct}+{3 * self.v_s})")

    @property
    def kkt_band_entries(self) -> int:
        """Banded KKT storage (floats) the sparse path carries per agent:
        S + (S-1) blocks of n_s² — O(N) vs the dense O(N²) matrix."""
        return self._n_D + self._n_E


    def tensors(self, device) -> dict:
        """The plan's index and seed arrays as tensors on ``device`` (built
        once per device; floating seeds as float64, cast at use)."""
        dev = torch.device(device)
        cache = self.__dict__.setdefault("_tensor_cache", {})
        out = cache.get(dev)
        if out is None:
            t = lambda a, dt=torch.int64: torch.as_tensor(
                np.asarray(a), dtype=dt, device=dev)
            out = {
                "ct": t(self.ct_matrix, torch.float64),
                "hess_seeds": t(self.hess_seeds, torch.float64),
                "de_init": t(self.de_init, torch.float64),
                "g_cols": t(self.g_cols_safe), "h_cols": t(self.h_cols_safe),
                "hrow_cols": t(self.hrow_cols_safe),
                "g_src": t(self.g_src), "h_src": t(self.h_src),
                "hrow_src": t(self.hrow_src),
                "g_mask": t(self.g_mask, torch.bool),
                "h_mask": t(self.h_mask, torch.bool),
                "hrow_mask": t(self.hrow_mask, torch.bool),
                "hasm_dst": t(self.hasm_dst),
                "gasm_dst1": t(self.gasm_dst1),
                "gasm_dst2": t(self.gasm_dst2),
                "jh_dst": t(self.jh_dst),
                "var_diag_dst": t(self.var_diag_dst),
                "eq_diag_dst": t(self.eq_diag_dst),
            }
            cache[dev] = out
        return out


_PLAN_CACHE: dict = {}


def build_stage_jacobian_plan(partition: StagePartition,
                              h_row_stages=()) -> StageJacobianPlan:
    """Build (memoized) the stage-sparse derivative plan for a partition
    plus the per-row base stages of ``h`` (the certificate's
    ``h_row_stages``; each row's column support must lie in stages
    ``{s, s+1}`` — exactly certificate condition 2)."""
    key = (partition, tuple(int(s) for s in h_row_stages))
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = StageJacobianPlan(*key)
        _PLAN_CACHE[key] = plan
    return plan


def plan_from_certificate(nlp, theta, n_w: int, partition: StagePartition,
                          log=None, label: str = "problem"
                          ) -> "StageJacobianPlan | None":
    """Routing authority for the sparse derivative pipeline: run the
    stage-structure certifier (``lint/fx``) and build a plan ONLY from a
    proved certificate. Refuted or unknown structure (opaque ops, a trace
    that failed) returns None and the dense pipeline stays, with a log
    line. ``theta`` is ONE problem's parameters."""
    from agentlib_mpc_torch.lint.fx import certify_stage_structure

    log = log or logger
    cert = certify_stage_structure(nlp, theta, n_w, partition)
    if not cert.ok or cert.h_row_stages is None:
        log.warning(
            "stage structure not proved for %s (%s): keeping the dense "
            "derivative pipeline (jacobian='sparse' would drop real "
            "out-of-band couplings)", label, cert.describe())
        return None
    log.info(
        "stage structure proved for %s (%s): stage-sparse derivative "
        "pipeline eligible", label, cert.describe())
    return build_stage_jacobian_plan(partition, cert.h_row_stages)


def attach_plan_if_worthwhile(options, partition, nlp, theta, n_w: int,
                              log=None, label: str = "problem",
                              device=None):
    """The one gate+certify+attach seam: run the certifier only when
    ``plan_worthwhile`` says the solve could route sparse on ``device``,
    and attach the resulting plan (or nothing, with a log line) to the
    options. Returns the (possibly updated) options."""
    from agentlib_mpc_torch.ops.solver import (
        attach_jacobian_plan,
        plan_worthwhile,
    )

    if not plan_worthwhile(options, partition, device):
        return options
    plan = plan_from_certificate(nlp, theta, n_w, partition, log=log,
                                 label=label)
    return attach_jacobian_plan(options, plan)


# --------------------------------------------------------------------------
# batch-first building blocks (index arrays are the plan's tensors)
# --------------------------------------------------------------------------

def stacked_fgh(nlp, theta):
    """The stacked residual [f, g..., h...] of ONE problem as a function of
    ``w`` — the single-primal-pass stacking the solver evaluates."""
    def fgh(w):
        return torch.cat([nlp.f(w, theta).reshape(1), nlp.g(w, theta),
                          nlp.h(w, theta)])

    return fgh


def band_matvec(rows: torch.Tensor, cols: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """J @ x for banded rows: ``rows`` (B, m, W) with padded entries exactly
    zero, ``cols`` (m, W) column indices (padding clamped to 0 — its
    coefficient is zero), ``x`` (B, n) → (B, m)."""
    return (rows * x[:, cols]).sum(dim=-1)


def band_rmatvec(rows: torch.Tensor, cols: torch.Tensor, y: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Jᵀ @ y by scatter-add over the rows' column windows: (B, m, W),
    (m, W), (B, m) → (B, n)."""
    B = rows.shape[0]
    vals = (rows * y[..., None]).reshape(B, -1)
    return rows.new_zeros((B, n)).index_add_(1, cols.reshape(-1), vals)


def band_row_absmax(rows: torch.Tensor, cols: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """Per-row max |J[r, :] * d| (the gradient-based row scaling), from
    banded rows: (B, m, W), (m, W), (B, n) → (B, m)."""
    if rows.shape[1] == 0:
        return rows.new_zeros(rows.shape[:2])
    return (rows * d[:, cols]).abs().amax(dim=-1)


def _lane_dims(args, in_dims):
    return (0,) * len(args) if in_dims is None else tuple(in_dims)


def banded_fgh_jac(plan: StageJacobianPlan, fgh, w: torch.Tensor, *args,
                   in_dims=None):
    """Values + banded Jacobian rows of the stacked residual of every lane
    in ONE primal pass and ``1 + 3·e_s + 3·h_s`` compressed pullbacks.
    ``fgh(w, *args)`` is one problem's stacked residual; ``w`` (B, n) and
    ``args`` are batched per ``in_dims`` (default: all on axis 0). Returns
    ``(vals (B, 1+m_e+m_h), gf (B, n), Jg_rows (B, m_e, W_g),
    Jh_rows (B, m_h, W_h))``, rows in the plan's column windows."""
    ix = plan.tensors(w.device)
    ct = ix["ct"].to(w.dtype)

    def lane(w_, *a):
        vals, pullback = vjp(lambda ww: fgh(ww, *a), w_)
        return vals, vmap(lambda c: pullback(c)[0])(ct)

    vals, comp = vmap(lane, in_dims=(0,) + _lane_dims(args, in_dims))(
        w, *args)                                   # comp (B, n_ct, n)
    B = w.shape[0]
    flat = comp.reshape(B, -1)
    zero = w.new_zeros(())
    if plan.m_e:
        Jg_rows = torch.where(ix["g_mask"], flat[:, ix["g_src"]], zero)
    else:
        Jg_rows = w.new_zeros((B, 0, plan.W_g))
    if plan.m_h:
        Jh_rows = torch.where(ix["h_mask"], flat[:, ix["h_src"]], zero)
    else:
        Jh_rows = w.new_zeros((B, 0, plan.W_h))
    return vals, comp[:, 0], Jg_rows, Jh_rows


def banded_lagrangian_hessian(plan: StageJacobianPlan, grad_fn,
                              w: torch.Tensor, *args, in_dims=None
                              ) -> torch.Tensor:
    """Compressed Lagrangian-Hessian columns of every lane: ``3·v_s``
    forward passes of ``grad_fn(w, *args)`` (one problem's Lagrangian
    gradient) instead of ``n_w``. Returns CH (B, 3·v_s, n) with
    ``CH[:, seed_of(col j), i] = H[i, j]``."""
    seeds = plan.tensors(w.device)["hess_seeds"].to(w.dtype)

    def lane(w_, *a):
        g = lambda ww: grad_fn(ww, *a)
        return vmap(lambda s: jvp(g, (w_,), (s,))[1])(seeds)

    return vmap(lane, in_dims=(0,) + _lane_dims(args, in_dims))(w, *args)


def hessian_rows(plan: StageJacobianPlan, CH: torch.Tensor) -> torch.Tensor:
    """Banded H rows (B, n_w, W_H) gathered from compressed columns — the
    matvec form of the Hessian."""
    ix = plan.tensors(CH.device)
    flat = CH.reshape(CH.shape[0], -1)
    return torch.where(ix["hrow_mask"], flat[:, ix["hrow_src"]],
                       CH.new_zeros(()))


def assemble_kkt_banded(plan: StageJacobianPlan, CH: torch.Tensor,
                        Jg_rows: torch.Tensor, Jh_rows: torch.Tensor,
                        sigma_s: torch.Tensor, w_diag: torch.Tensor,
                        delta_c: float):
    """Assemble the reduced KKT systems of a batch of lanes

        K = [[H + diag(w_diag) + Jhᵀ diag(σ_s) Jh, Jgᵀ],
             [Jg, -δ_c I]]

    directly as stage-permuted banded blocks ``D`` (B, S, ns, ns) and
    ``E`` (B, S-1, ns, ns) for
    :func:`~agentlib_mpc_torch.ops.stagewise.factor_kkt_stage_banded`;
    the dense matrix is never materialised. Entries that belong to an
    implicit-transpose block scatter into a garbage slot and are
    dropped."""
    ix = plan.tensors(w_diag.device)
    B = w_diag.shape[0]
    de = ix["de_init"].to(w_diag.dtype).expand(B, -1).clone()
    H_rows = hessian_rows(plan, CH)
    de.index_add_(1, ix["hasm_dst"], H_rows.reshape(B, -1))
    if plan.m_e:
        gflat = Jg_rows.reshape(B, -1)
        de.index_add_(1, ix["gasm_dst1"], gflat)
        de.index_add_(1, ix["gasm_dst2"], gflat)
        de.index_add_(1, ix["eq_diag_dst"],
                      w_diag.new_full((B, plan.m_e), -delta_c))
    if plan.m_h:
        outer = (sigma_s[:, :, None, None] * Jh_rows[:, :, :, None]
                 * Jh_rows[:, :, None, :])
        de.index_add_(1, ix["jh_dst"], outer.reshape(B, -1))
    de.index_add_(1, ix["var_diag_dst"], w_diag)
    S, ns = plan._S, plan._ns
    D = de[:, :plan._n_D].reshape(B, S, ns, ns)
    E = de[:, plan._n_D:plan._n_D + plan._n_E].reshape(B, max(S - 1, 0),
                                                        ns, ns)
    # the two H orientations come from different compressed columns (equal
    # in exact arithmetic): symmetrise so the pivot-free quasi-definite
    # sweep sees an exactly symmetric block
    return 0.5 * (D + D.transpose(-1, -2)), E


# --------------------------------------------------------------------------
# tree-banded seeds: the scenario axis of a tree-structured OCP. One proved
# flat certificate (one compressed seed set) serves the whole tree.
# --------------------------------------------------------------------------

def _theta_row(theta_batch, s: int):
    return tree_map(lambda leaf: leaf[s], theta_batch)


def tree_banded_fgh_jac(plan: StageJacobianPlan, fgh, w_batch: torch.Tensor,
                        theta_batch):
    """Values and banded Jacobian rows for a scenario batch: ``fgh(w,
    theta)`` is the branch-shared stacked residual, ``w_batch`` (S, n_w)
    and the scenario-stacked ``theta_batch`` the per-branch data. Returns
    :func:`banded_fgh_jac`'s tuple with a leading S axis."""
    if w_batch.shape[0] == 1:
        th0 = _theta_row(theta_batch, 0)
        return banded_fgh_jac(plan, lambda w: fgh(w, th0), w_batch)
    return banded_fgh_jac(plan, fgh, w_batch, theta_batch)


def tree_banded_lagrangian_hessian(plan: StageJacobianPlan, grad_fn,
                                   w_batch: torch.Tensor, theta_batch
                                   ) -> torch.Tensor:
    """Compressed Lagrangian-Hessian columns per scenario branch:
    ``grad_fn(w, theta)`` is the branch-shared Lagrangian gradient; the
    flat plan's ``3·v_s`` forward seeds serve every branch. (S, 3·v_s,
    n_w)."""
    if w_batch.shape[0] == 1:
        th0 = _theta_row(theta_batch, 0)
        return banded_lagrangian_hessian(plan, lambda w: grad_fn(w, th0),
                                         w_batch)
    return banded_lagrangian_hessian(plan, grad_fn, w_batch, theta_batch)


def tree_assemble_kkt_banded(plan: StageJacobianPlan, CH_batch, Jg_batch,
                             Jh_batch, sigma_batch, w_diag_batch,
                             delta_c: float):
    """Scenario-batched banded KKT assembly: (D, E) stacks with a leading
    scenario axis, ready for
    :func:`~agentlib_mpc_torch.ops.stagewise.factor_kkt_scenarios_banded`.
    The flat assembly is batch-first, so every scenario count takes it."""
    return assemble_kkt_banded(plan, CH_batch, Jg_batch, Jh_batch,
                               sigma_batch, w_diag_batch, delta_c)


def tree_plan_from_certificate(nlp, theta, n_w: int, tree_partition,
                               log=None, label: str = "scenario tree"
                               ) -> "StageJacobianPlan | None":
    """Routing authority of the tree-banded derivative pipeline: one flat
    certification against the tree partition's per-branch
    :class:`~agentlib_mpc_torch.ops.stagewise.StagePartition` answers for
    every branch; refuted or unknown structure returns None (dense)."""
    base = getattr(tree_partition, "base", tree_partition)
    return plan_from_certificate(nlp, theta, n_w, base, log=log,
                                 label=label)
