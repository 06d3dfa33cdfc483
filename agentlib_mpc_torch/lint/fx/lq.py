"""Sound LQ certification: a polynomial-degree lattice over the aten graph.

Port of ``agentlib_mpc_tpu/lint/jaxpr/lq.py``. Per element, a value
carries its maximum possible polynomial degree in ``w``: 0 (independent
of ``w`` — including every theta input), 1 (affine), 2 (quadratic), 3
(``NONPOLY`` — degree ≥ 3, transcendental, piecewise in a
``w``-dependent predicate, or behind an opaque op). Add joins, mul adds,
a smooth nonlinearity of anything ``w``-dependent is ``NONPOLY``; a
``where`` whose predicate carries no ``w`` dependence (a *theta-gated*
branch) takes the max of its branches, because for every FIXED theta the
selected branch is a polynomial of that degree. That is the case the
sampled probe ``ops/qp.py:is_lq`` gets wrong: it evaluates at one theta,
sees one branch, and certifies; the lattice sees both.

An LQ program needs objective degree ≤ 2 and constraint degrees ≤ 1;
:func:`certify_lq` proves it for all theta, refutes it with the offending
degree, or returns ``"unknown"`` when an opaque op or a failed trace
blocks the proof — the caller then falls back to the sampled probe,
loudly (``ops/qp.py:resolve_qp_routing``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from agentlib_mpc_torch.lint.fx.interp import Domain, run_nlp_function

__all__ = ["LQCertificate", "DegreeDomain", "certify_lq", "NONPOLY"]

#: lattice top: not a polynomial of degree ≤ 2 (or not provably one)
NONPOLY = 3


class DegreeDomain(Domain):
    """Per-element polynomial degree in ``w``: int8 in {0, 1, 2, 3}."""

    dtype = np.int8
    tail = ()

    def w_payload(self, n: int):
        return np.ones((n,), dtype=self.dtype)

    def join(self, args):
        out = np.asarray(args[0])
        for a in args[1:]:
            out = np.maximum(out, a)
        return np.array(out, dtype=self.dtype)

    def join_reduce(self, p, axes):
        return np.max(p, axis=tuple(axes), initial=0).astype(self.dtype)

    def mul(self, a, b):
        return np.minimum(a.astype(np.int16) + b.astype(np.int16),
                          NONPOLY).astype(self.dtype)

    def div(self, a, b):
        # b is symbolic here (concrete divisors take the linear path)
        return np.where(b == 0, a, NONPOLY).astype(self.dtype)

    def int_pow(self, a, y: int):
        if y == 0:
            return np.zeros_like(a, dtype=self.dtype)
        if y < 0:
            return np.where(a == 0, 0, NONPOLY).astype(self.dtype)
        return np.minimum(a.astype(np.int16) * y, NONPOLY).astype(self.dtype)

    def nonlinear(self, args):
        j = self.join(args)
        return np.where(j == 0, 0, NONPOLY).astype(self.dtype)

    def nonsmooth(self, args):
        # piecewise: degree-0 inputs stay degree 0 (a fixed theta picks a
        # constant), anything else is not a polynomial
        return self.nonlinear(args)

    def select(self, pred, cases):
        # theta-gated where (pred degree 0): each fixed theta picks ONE
        # branch, so the result is a polynomial of at most the max branch
        # degree. A w-dependent predicate makes the value piecewise in w.
        return np.where(pred == 0, self.join(cases), NONPOLY).astype(
            self.dtype)

    def top_like(self, shape, args):
        return np.full(shape, NONPOLY, dtype=self.dtype)

    def contract_const(self, p, nz):
        # per output element: max degree over the k with a nonzero
        # coefficient; one indicator matmul per degree value
        nzf = nz.astype(np.float32)
        out = np.zeros(p.shape[:2] + (nz.shape[2],), dtype=self.dtype)
        for d in range(1, NONPOLY + 1):
            hit = np.matmul((p == d).astype(np.float32), nzf) > 0
            out = np.where(hit, np.maximum(out, d), out)
        return out.astype(self.dtype)

    def contract_both(self, a, b):
        out = np.zeros(a.shape[:2] + (b.shape[2],), dtype=self.dtype)
        for da in range(NONPOLY + 1):
            ia = (a == da).astype(np.float32)
            if not ia.any():
                continue
            for db in range(NONPOLY + 1):
                if da == db == 0:
                    continue
                ib = (b == db).astype(np.float32)
                if not ib.any():
                    continue
                hit = np.matmul(ia, ib) > 0
                out = np.where(hit, np.maximum(out, min(da + db, NONPOLY)),
                               out)
        return out.astype(self.dtype)


@dataclasses.dataclass(frozen=True)
class LQCertificate:
    """Outcome of :func:`certify_lq`.

    ``status``:

    * ``"lq"`` — proved linear-quadratic in ``w`` for ALL theta;
    * ``"not_lq"`` — the graph contains a ``w``-path of too-high degree
      (for a gated nonlinearity this is a real refutation: some theta
      activates it);
    * ``"unknown"`` — an opaque op with ``w``-tainted inputs, or a
      function the tracer could not record, blocks the proof; route on
      the sampled probe instead.
    """

    status: str
    objective_degree: int
    eq_degree: int
    ineq_degree: int
    opaque: tuple = ()
    notes: tuple = ()

    @property
    def proved_lq(self) -> bool:
        return self.status == "lq"

    def describe(self) -> str:
        return (f"{self.status} (deg f={self.objective_degree}, "
                f"g={self.eq_degree}, h={self.ineq_degree}"
                + (f", opaque={','.join(sorted(set(self.opaque)))}"
                   if self.opaque else "") + ")")


def _max_degree(avals) -> int:
    out = 0
    for a in avals:
        if a.payload.size:
            out = max(out, int(np.max(a.payload)))
    return out


def certify_lq(nlp, theta, n: int) -> LQCertificate:
    """Prove/refute LQ structure of an :class:`ops.solver.NLPFunctions`
    triple in ``w`` for all theta. ``n`` is the primal dimension; ``theta``
    is ONE problem's parameters (any pytree of tensors)."""
    degs, opaque, notes = {}, [], []
    for name, fn in (("f", nlp.f), ("g", nlp.g), ("h", nlp.h)):
        dom = DegreeDomain()
        try:
            outs = run_nlp_function(fn, theta, n, dom)
            degs[name] = _max_degree(outs)
        except Exception as exc:  # noqa: BLE001 — an uninterpretable
            # function is "unknown"; the caller's probe decides, loudly
            degs[name] = NONPOLY
            notes.append(f"{name}: interpreter error: {exc!r}")
            opaque.append("interpreter-error")
            continue
        opaque.extend(dom.opaque)
        notes.extend(dom.notes)
    if degs["f"] <= 2 and degs["g"] <= 1 and degs["h"] <= 1:
        status = "lq"
    elif opaque:
        # the excessive degree may be an artifact of the opaque smear:
        # neither provable nor refutable
        status = "unknown"
    else:
        status = "not_lq"
    return LQCertificate(status=status, objective_degree=degs["f"],
                         eq_degree=degs["g"], ineq_degree=degs["h"],
                         opaque=tuple(opaque), notes=tuple(notes))
