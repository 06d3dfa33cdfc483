"""Stage-structure certification: dependence + Hessian-interaction pass.

Port of ``agentlib_mpc_tpu/lint/jaxpr/structure.py``. The block-
tridiagonal KKT sweep (``ops/stagewise.py``) drops every matrix entry
outside the tridiagonal band, and the stage-sparse derivative pipeline
(``ops/stagejac.py``) compresses rows and columns on the same band — both
correct ONLY if the transcription really produces a banded system under
the attached :class:`~agentlib_mpc_torch.ops.stagewise.StagePartition`.
This pass proves it against the traced functions themselves:

* every ``w`` element is seeded with its stage (a one-hot row over the
  partition's stages); dependence propagates through the aten graph per
  element, giving the exact w→(g, h) dependence at stage granularity;
* every nonlinear combination records an *interaction* between the stage
  sets it combines — a sound over-approximation of Lagrangian-Hessian
  sparsity (mul gives ∂²/∂a∂b, a smooth unary gives ∂²/∂a∂a, ...). The
  JAX package keeps the set of interacting mask pairs; here the union of
  their outer products, an (S, S) boolean matrix, which is out of band
  exactly when some recorded pair is;
* :func:`certify_stage_structure` then checks the band conditions:

  1. equality row ``r`` (KKT index ``n_w + r``, stage ``s_r``) may depend
     only on stages ``s_r − 1 … s_r + 1`` (the ``Jg``/``Jgᵀ`` blocks);
  2. each inequality row's dependence stages span ≤ 1 (rows of ``Jh``
     enter ``W`` as ``Jhᵀ Σ Jh``, coupling all their stages pairwise);
  3. every recorded Hessian interaction lies in the band.

``aten.detach`` kills dependence (the pass models what AD — and hence the
solver's KKT assembly — sees). Opaque ops with tainted inputs smear to
all stages they saw, so they can only ever *fail* certification.

A payload is a boolean array ``value_shape + (S,)`` (the JAX package packs
the same set into a Python-int bitmask per element).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from agentlib_mpc_torch.lint.fx.interp import Domain, run_nlp_function
from agentlib_mpc_torch.ops.stagewise import StagePartition, stage_of_index

__all__ = ["StructureCertificate", "DependenceDomain",
           "certify_stage_structure"]


class DependenceDomain(Domain):
    """Per-element dependence set over stages, plus the global (S, S)
    interaction matrix."""

    dtype = np.bool_

    def __init__(self, stage_of_w: np.ndarray, n_stages: int):
        super().__init__()
        self.stage_of_w = np.asarray(stage_of_w, dtype=np.int64)
        self.tail = (int(n_stages),)
        self.coupled = np.zeros((n_stages, n_stages), dtype=bool)

    def w_payload(self, n: int):
        out = np.zeros((n,) + self.tail, dtype=bool)
        out[np.arange(n), self.stage_of_w[:n]] = True
        return out

    def join(self, args):
        out = np.asarray(args[0], dtype=bool)
        for a in args[1:]:
            out = out | a
        return np.array(out, dtype=bool)

    def join_reduce(self, p, axes):
        return np.any(p, axis=tuple(axes))

    def _record(self, a, b):
        """Every element pairs its two stage sets: union of outer
        products."""
        S = self.tail[0]
        A = np.asarray(a, dtype=np.float32).reshape(-1, S)
        B = np.asarray(b, dtype=np.float32).reshape(-1, S)
        if A.shape[0]:
            self.coupled |= (A.T @ B) > 0

    def mul(self, a, b):
        self._record(a, b)
        return a | b

    def div(self, a, b):
        # ∂²(a/b) has a·b and b·b terms, no a·a term
        self._record(a, b)
        self._record(b, b)
        return a | b

    def int_pow(self, a, y: int):
        if y == 0:
            return np.zeros_like(a, dtype=bool)
        if y != 1:
            self._record(a, a)
        return np.array(a, dtype=bool)

    def nonlinear(self, args):
        j = self.join(args)
        self._record(j, j)
        return j

    def nonsmooth(self, args):
        # piecewise-LINEAR in its inputs: second derivatives vanish a.e.,
        # so the branch interactions (already recorded while computing the
        # branches) cover the Hessian the solver ever materialises
        return self.join(args)

    def select(self, pred, cases):
        # w-dependent predicate: the KKT derivatives a.e. are the branch
        # derivatives — keep the union, no extra interactions
        return self.join([pred] + list(cases))

    def top_like(self, shape, args):
        mask = np.zeros(self.tail, dtype=bool)
        for a in args:
            if a.size:
                mask |= np.asarray(a).reshape(-1, self.tail[0]).any(axis=0)
        # an opaque op could couple everything it saw
        self.coupled |= np.outer(mask, mask)
        return np.broadcast_to(mask, tuple(shape) + self.tail).copy()

    def contract_const(self, p, nz):
        # out[b, m, n, s] = any_k p[b, m, k, s] & nz[b, k, n]
        pf = np.moveaxis(p, -1, 2).astype(np.float32)       # (Bt, M, S, K)
        hit = np.matmul(pf, nz.astype(np.float32)[:, None]) > 0
        return np.moveaxis(hit, 2, -1)                       # (Bt, M, N, S)

    def contract_both(self, a, b):
        if a.shape[2] == 0:
            return np.zeros(a.shape[:2] + (b.shape[2],) + self.tail, bool)
        # join over k of (a[m, k] | b[k, n]); every (m, k, n) pairs
        # a[m, k] with b[k, n]: per k, the union over m against the union
        # over n
        self._record(a.any(axis=1), b.any(axis=2))
        rows = a.any(axis=2)                                 # (Bt, M, S)
        cols = b.any(axis=1)                                 # (Bt, N, S)
        return rows[:, :, None] | cols[:, None]


@dataclasses.dataclass(frozen=True)
class StructureCertificate:
    """``ok`` iff the traced w→(g, h) dependence graph and the Hessian
    interactions are covered by the partition's block-tridiagonal band.
    ``violations`` name each out-of-band coupling.

    ``h_row_stages`` records, per inequality row, the SMALLEST stage the
    row's traced dependence reaches (0 for rows with no ``w``
    dependence). Only meaningful when ``ok`` — condition 2 then bounds
    each row's column support to stages ``{s, s+1}``, the static metadata
    the stage-sparse derivative pipeline needs to compress ``Jh``
    pullbacks; ``None`` when certification failed before reaching h."""

    ok: bool
    n_stages: int
    violations: tuple = ()
    notes: tuple = ()
    opaque: tuple = ()
    h_row_stages: "tuple | None" = None

    def describe(self) -> str:
        if self.ok:
            return f"banded over {self.n_stages} stages"
        head = "; ".join(self.violations[:3])
        more = f" (+{len(self.violations) - 3} more)" \
            if len(self.violations) > 3 else ""
        return f"NOT banded: {head}{more}"


def _rows(outs, S: int) -> np.ndarray:
    if not outs:
        return np.zeros((0, S), dtype=bool)
    return np.concatenate([np.asarray(o.payload, dtype=bool).reshape(-1, S)
                           for o in outs], axis=0)


def certify_stage_structure(nlp, theta, n_w: int,
                            partition: StagePartition
                            ) -> StructureCertificate:
    """Prove the KKT system of ``nlp`` block-tridiagonal under
    ``partition`` (for all theta); ``theta`` is ONE problem's
    parameters."""
    stage_of = stage_of_index(partition)
    if n_w != partition.n_w:
        # the band checks index equality rows at stage_of[n_w + r] — only
        # meaningful when the partition's primal offset matches
        raise ValueError(
            f"partition covers n_w={partition.n_w} primal variables, "
            f"the NLP has {n_w}")
    S = partition.n_stages
    violations: list[str] = []
    notes: list[str] = []
    opaque: list[str] = []
    coupled = np.zeros((S, S), dtype=bool)

    results = {}
    for name, fn in (("f", nlp.f), ("g", nlp.g), ("h", nlp.h)):
        dom = DependenceDomain(stage_of[:n_w], S)
        try:
            outs = run_nlp_function(fn, theta, n_w, dom)
        except Exception as exc:  # noqa: BLE001 — report, don't crash
            return StructureCertificate(
                ok=False, n_stages=S,
                violations=(f"{name}: interpreter error: {exc!r}",),
                opaque=("interpreter-error",))
        results[name] = outs
        coupled |= dom.coupled
        notes.extend(dom.notes)
        opaque.extend(dom.opaque)

    stages = np.arange(S)
    # 1. equality rows: deps within one stage of the row's own stage
    for r, deps in enumerate(_rows(results["g"], S)):
        s_r = int(stage_of[n_w + r])
        bad = stages[deps & (np.abs(stages - s_r) > 1)].tolist()
        if bad:
            violations.append(
                f"g[{r}] (stage {s_r}) depends on stage(s) {bad}")

    # 2. inequality rows: dependence stages must span ≤ 1 (Jhᵀ Σ Jh)
    h_row_stages = []
    for r, deps in enumerate(_rows(results["h"], S)):
        hit = stages[deps]
        h_row_stages.append(int(hit[0]) if hit.size else 0)
        if hit.size and hit[-1] - hit[0] > 1:
            violations.append(
                f"h[{r}] couples stages {int(hit[0])}..{int(hit[-1])} "
                f"through Jhᵀ·Σ·Jh")

    # 3. Hessian interactions inside the band
    coupled |= coupled.T
    ia, ib = np.nonzero(np.triu(coupled, k=2))
    for sa, sb in zip(ia.tolist(), ib.tolist()):
        violations.append(
            f"Hessian interaction couples stages {sa} x {sb}")

    if opaque:
        notes.append("opaque op(s) smeared dependence: "
                     + ",".join(sorted(set(opaque))))
    return StructureCertificate(
        ok=not violations, n_stages=S, violations=tuple(violations),
        notes=tuple(notes), opaque=tuple(opaque),
        h_row_stages=tuple(h_row_stages))
