"""Stage-structured KKT factorization: block-tridiagonal LDLᵀ over stages.

Port of ``agentlib_mpc_tpu/ops/stagewise.py`` (lines 134-528). An OCP
transcribed by collocation or multiple shooting gives the interior-point
KKT matrix ``K = [[W, Jgᵀ], [Jg, -δ_c I]]`` a stage structure: every
entry couples variables and equality multipliers of at most two adjacent
horizon intervals. Under the symmetric stage permutation of
:func:`build_stage_partition` the matrix is block tridiagonal and factors
by a Riccati-style block sweep (Rao, Wright & Rawlings 1998),

    C₀ = D₀,   C_k = D_k − E_k C_{k-1}⁻¹ E_kᵀ   (k = 1..S-1),

each stage block C_k by the pivot-free quasi-definite LDLᵀ of
``ops/kkt.py``. Every factor and every block solve is a call of the
``ldl_factor``/``ldl_solve`` wrappers, so on a CUDA tensor the sweep runs
on the two Hopper kernels (one factor launch per stage; one solve launch
per stage and right-hand-side set, many-right-hand-side solves through
``kkt.ldl_solve_many``) and on a CPU tensor on their plain versions.
Symmetric Jacobi equilibration and iterative refinement against the full
scaled matrix wrap the sweep as they wrap the dense paths.

Batch-first. ``K`` is (B, M, M) — any leading axes, flattened to one
batch axis inside — and the stage blocks are (B, S, ns, ns). The JAX
package's ``lax.scan`` over stages is a Python loop. The stage factors are
stored stage-major, so the batch of stage ``k`` (``F[:, k]``) is one
contiguous (B, ns, ns) tensor, what the kernels take. Lanes never mix: a
frozen lane of the batch-first solver whose factor holds NaN keeps it to
itself, and padding and band masks are applied by ``torch.where``, never by
a mask product.

Not ported: ``stage_boundary`` (an ``optimization_barrier`` that pins
stage hand-offs for the JAX package's ``fusion="off"``) has no counterpart
in eager PyTorch, which materialises every intermediate anyway; and the
JAX package's eager probe with a dense fallback
(``stage_method_available`` there) is replaced by a static answer: a
kernel failure inside the sweep raises.

The partition code (:class:`StagePartition`, :func:`build_stage_partition`,
:func:`stage_of_index`, :func:`_perm_arrays`) is numpy, copied from the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from agentlib_mpc_torch.ops import kkt as kkt_ops

#: refinement steps every stored-factor resolve runs (dense, stage sweep,
#: banded sweep, scenario variants)
ITERATIVE_REFINEMENT_STEPS = 2

__all__ = [
    "ITERATIVE_REFINEMENT_STEPS",
    "StagePartition",
    "band_matvec_blocks",
    "build_stage_partition",
    "factor_kkt_scenarios",
    "factor_kkt_scenarios_banded",
    "factor_kkt_stage",
    "factor_kkt_stage_banded",
    "repeat_scenario_factor",
    "resolve_kkt_scenarios",
    "resolve_kkt_scenarios_banded",
    "resolve_kkt_stage",
    "resolve_kkt_stage_banded",
    "solve_kkt_stage",
    "stage_method_available",
    "stage_of_index",
    "synthetic_stage_kkt",
]


class StagePartition(NamedTuple):
    """Static stage metadata of a transcribed OCP's KKT system.

    Hashable (plain ints and an int tuple). ``perm`` lists, stage by
    stage, the original KKT index (variable indices < ``n_w``, equality row
    ``j`` at ``n_w + j``) each padded slot holds; ``-1`` marks padding
    slots (stages are padded to one uniform ``block`` size)."""

    n_stages: int          # S: horizon intervals + the terminal state
    block: int             # n_s: uniform (padded) stage block size
    n_w: int               # primal dimension (indices below are variables)
    n_total: int           # KKT dimension this partition describes
    perm: tuple            # len S*n_s; original index or -1 (padding)


def build_stage_partition(N: int, n_x: int, n_u: int, n_z: int, d: int,
                          method: str,
                          fix_initial_state: bool = True) -> StagePartition:
    """Stage partition for :func:`ops.transcription.transcribe` layouts.

    Mirrors the flat decision layout (keys u, x, xc, z) and the equality
    stacking order of ``g_fn`` (initial pin, then all defects, then
    continuity for collocation; initial pin then defects for shooting).
    Stage ``i < N`` holds (u_i, x_i, xc_i, z_i) plus the multipliers of the
    constraints anchored at interval ``i``; stage ``N`` holds x_N."""
    if method not in ("collocation", "multiple_shooting"):
        raise ValueError(f"unknown transcription method {method!r}")
    is_colloc = method == "collocation"
    n_xc = d * n_x if is_colloc else 0
    n_zi = d * n_z if is_colloc else n_z
    n_def = d * n_x if is_colloc else n_x

    off_u = 0
    off_x = N * n_u
    off_xc = off_x + (N + 1) * n_x
    off_z = off_xc + N * n_xc
    n_w = off_z + N * n_zi

    base = n_w                       # equality row j sits at KKT index base+j
    off_init = base
    n_init = n_x if fix_initial_state else 0
    off_def = off_init + n_init
    off_cont = off_def + N * n_def   # collocation only
    m_e = n_init + N * n_def + (N * n_x if is_colloc else 0)
    n_total = n_w + m_e

    stages = []
    for i in range(N):
        idx = []
        idx += list(range(off_u + i * n_u, off_u + (i + 1) * n_u))
        idx += list(range(off_x + i * n_x, off_x + (i + 1) * n_x))
        idx += list(range(off_xc + i * n_xc, off_xc + (i + 1) * n_xc))
        idx += list(range(off_z + i * n_zi, off_z + (i + 1) * n_zi))
        if i == 0:
            idx += list(range(off_init, off_init + n_init))
        idx += list(range(off_def + i * n_def, off_def + (i + 1) * n_def))
        if is_colloc:
            idx += list(range(off_cont + i * n_x, off_cont + (i + 1) * n_x))
        stages.append(idx)
    stages.append(list(range(off_x + N * n_x, off_x + (N + 1) * n_x)))

    block = max(1, max(len(s) for s in stages))
    perm = []
    for s in stages:
        perm += s + [-1] * (block - len(s))
    used = sorted(p for p in perm if p >= 0)
    if used != list(range(n_total)):
        raise AssertionError(
            "stage partition does not cover the KKT index space — the "
            "transcription layout and build_stage_partition drifted apart")
    return StagePartition(n_stages=len(stages), block=block, n_w=n_w,
                          n_total=n_total, perm=tuple(perm))


def stage_of_index(p: StagePartition) -> np.ndarray:
    """Stage holding each original KKT index (length ``n_total`` int
    array): entry (i, j) of the KKT matrix may be nonzero only if
    ``|stage_of[i] − stage_of[j]| ≤ 1``, the band :func:`_stage_blocks`
    keeps."""
    perm = np.asarray(p.perm, dtype=np.int64)
    valid = perm >= 0
    out = np.full((p.n_total,), -1, dtype=np.int64)
    out[perm[valid]] = np.nonzero(valid)[0] // p.block
    if np.any(out < 0):
        missing = np.nonzero(out < 0)[0][:5].tolist()
        raise ValueError(
            f"stage partition does not cover KKT indices {missing}"
            f"{'...' if int(np.sum(out < 0)) > 5 else ''}")
    return out


# --------------------------------------------------------------------------
# permutation / block plumbing (index arrays are static numpy, turned into
# tensors once per (partition, device))
# --------------------------------------------------------------------------

def _perm_arrays(p: StagePartition):
    perm = np.asarray(p.perm, dtype=np.int64)
    valid = perm >= 0
    safe = np.where(valid, perm, 0)
    # inverse map: padded-slot index holding each original KKT index
    inv = np.empty((p.n_total,), dtype=np.int64)
    inv[perm[valid]] = np.nonzero(valid)[0]
    return perm, valid, safe, inv


_INDEX_CACHE: dict = {}


def _indices(p: StagePartition, device: torch.device) -> dict:
    """The partition's index tensors on ``device``, built once: ``safe``
    and ``inv`` (gather maps between original and padded-slot order),
    ``valid`` (S, ns), the row/column indices of the diagonal blocks
    (``d_rows`` (S, ns, 1), ``d_cols`` (S, 1, ns)) and of the sub-diagonal
    blocks (``e_rows`` (S-1, ns, 1): stage k+1, ``e_cols`` (S-1, 1, ns):
    stage k), and the masks of each block's valid entries and padding
    pivots."""
    key = (p, device)
    out = _INDEX_CACHE.get(key)
    if out is not None:
        return out
    _, valid, safe, inv = _perm_arrays(p)
    S, ns = p.n_stages, p.block
    vb = valid.reshape(S, ns)
    sb = safe.reshape(S, ns)
    t = lambda a: torch.as_tensor(a, device=device)
    out = {
        "safe": t(safe), "inv": t(inv), "valid": t(vb),
        "d_rows": t(sb[:, :, None]), "d_cols": t(sb[:, None, :]),
        "e_rows": t(sb[1:, :, None]), "e_cols": t(sb[:-1, None, :]),
        "d_mask": t(vb[:, :, None] & vb[:, None, :]),
        "e_mask": t(vb[1:, :, None] & vb[:-1, None, :]),
        "pad_diag": t(np.eye(ns, dtype=bool)[None] & ~vb[:, :, None]),
    }
    _INDEX_CACHE[key] = out
    return out


def _stage_major(t: torch.Tensor) -> torch.Tensor:
    """(B, S, ...) with stage-major storage: ``t[:, k]`` is contiguous."""
    return t.transpose(0, 1).contiguous().transpose(0, 1)


def _stage_blocks(Ks: torch.Tensor, p: StagePartition):
    """Extract the diagonal (B, S, ns, ns) and sub-diagonal (B, S-1, ns, ns)
    stage blocks of (B, M, M) matrices in stage order (``E[:, k]`` is block
    (k+1, k)), gathering the band only. Padding slots become decoupled
    identity rows (pivot 1, rhs 0). Entries outside the tridiagonal band
    are dropped unread — the transcription layout makes them zero."""
    ix = _indices(p, Ks.device)
    zero = Ks.new_zeros(())
    D = torch.where(ix["d_mask"], Ks[:, ix["d_rows"], ix["d_cols"]], zero)
    D = torch.where(ix["pad_diag"], Ks.new_ones(()), D)
    if p.n_stages > 1:
        E = torch.where(ix["e_mask"], Ks[:, ix["e_rows"], ix["e_cols"]], zero)
    else:
        E = Ks.new_zeros((Ks.shape[0], 0, p.block, p.block))
    return _stage_major(D), _stage_major(E)


def _mv(A, v):
    """(B, m, n) @ (B, n) → (B, m)."""
    return torch.matmul(A, v[..., None])[..., 0]


def _factor_blocks(D, E):
    """Riccati-style block sweep: factor every stage Schur complement
    C_k = D_k − E_k C_{k-1}⁻¹ E_kᵀ with the pivot-free LDLᵀ. Returns the
    stage factors (B, S, ns, ns), stored stage-major."""
    F = [kkt_ops.ldl_factor(D[:, 0])]
    for k in range(1, D.shape[1]):
        Ek = E[:, k - 1]
        Y = kkt_ops.ldl_solve_many(F[-1], Ek)         # Yᵀ = C_{k-1}⁻¹ Ekᵀ
        Ck = D[:, k] - torch.matmul(Ek, Y.transpose(-1, -2))
        Ck = 0.5 * (Ck + Ck.transpose(-1, -2))        # exact symmetry in fp
        F.append(kkt_ops.ldl_factor(Ck))
    return torch.stack(F, dim=0).transpose(0, 1)


def _solve_blocks(F, E, b):
    """Forward/backward block substitution with the stored stage factors
    (b (B, S, ns)): y₀ = b₀, y_k = b_k − E_k C_{k-1}⁻¹ y_{k-1};
    x_S = C_S⁻¹ y_S, x_k = C_k⁻¹ (y_k − E_{k+1}ᵀ x_{k+1})."""
    S = b.shape[1]
    if S == 1:
        return kkt_ops.ldl_solve(F[:, 0], b[:, 0])[:, None]
    ys = [b[:, 0]]
    for k in range(1, S):
        t = kkt_ops.ldl_solve(F[:, k - 1], ys[-1])
        ys.append(b[:, k] - _mv(E[:, k - 1], t))
    xs = [kkt_ops.ldl_solve(F[:, S - 1], ys[S - 1])]
    for k in range(S - 2, -1, -1):
        xs.append(kkt_ops.ldl_solve(
            F[:, k], ys[k] - _mv(E[:, k].transpose(-1, -2), xs[-1])))
    return torch.stack(xs[::-1], dim=1)


def _stage_solve_once(F, E, b, p: StagePartition):
    """One block substitution of (B, M) right-hand sides in original KKT
    order; padding slots get zeros."""
    ix = _indices(p, b.device)
    bp = b[:, ix["safe"]].reshape(b.shape[0], p.n_stages, p.block)
    bp = torch.where(ix["valid"], bp, b.new_zeros(()))
    xp = _solve_blocks(F, E, bp).reshape(b.shape[0], -1)
    return xp[:, ix["inv"]]


def _check_partition(M: int, p: StagePartition) -> None:
    if p.n_total != M:
        raise ValueError(f"stage partition covers a {p.n_total}-dim KKT "
                         f"system, the matrix is {M}x{M}")


# --------------------------------------------------------------------------
# public factor / solve API (mirrors kkt.factor_kkt_ldl / resolve_kkt_ldl)
# --------------------------------------------------------------------------

def factor_kkt_stage(K: torch.Tensor, partition: StagePartition):
    """Equilibrate + block-tridiagonal factor of (..., M, M) matrices once;
    returns an opaque factor for :func:`resolve_kkt_stage` (predictor and
    corrector re-solve new right-hand sides at one block substitution
    each). The stage factors are ``factor[0]``, (B, S, ns, ns) with the
    leading axes flattened to B."""
    M = K.shape[-1]
    _check_partition(M, partition)
    lead = K.shape[:-2]
    Kb = K.reshape(-1, M, M)
    Ks, scale = kkt_ops.equilibrate(Kb)
    D, E = _stage_blocks(Ks, partition)
    F = _factor_blocks(D, E)
    return (F, E, Ks, scale, lead)


def resolve_kkt_stage(factor, rhs: torch.Tensor, partition: StagePartition,
                      refine_steps: int = ITERATIVE_REFINEMENT_STEPS
                      ) -> torch.Tensor:
    """Solve (..., M) right-hand sides with a stored stage factor +
    iterative refinement (f32-safe; the residual product runs against the
    FULL scaled matrix, so dropped out-of-band entries would surface in it
    rather than pass silently)."""
    F, E, Ks, scale, lead = factor
    M = Ks.shape[-1]
    rs = rhs.reshape(-1, M) * scale
    x = _stage_solve_once(F, E, rs, partition)
    for _ in range(refine_steps):
        r = rs - _mv(Ks, x)
        x = x + _stage_solve_once(F, E, r, partition)
    return (x * scale).reshape(lead + (M,))


def solve_kkt_stage(K: torch.Tensor, rhs: torch.Tensor,
                    partition: StagePartition,
                    refine_steps: int = ITERATIVE_REFINEMENT_STEPS
                    ) -> torch.Tensor:
    """Equilibrated block-tridiagonal solve with iterative refinement —
    drop-in for :func:`kkt.solve_kkt_ldl` when a stage partition exists."""
    return resolve_kkt_stage(factor_kkt_stage(K, partition), rhs,
                             partition, refine_steps)


# --------------------------------------------------------------------------
# banded-input factor / solve: the stage-sparse derivative pipeline
# assembles the KKT system directly as (D, E) blocks in stage-permuted
# layout, so these entry points take the blocks themselves; refinement runs
# against the banded product
# --------------------------------------------------------------------------

def band_matvec_blocks(D: torch.Tensor, E: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """K @ x for symmetric block-tridiagonal K given as diagonal blocks
    ``D`` (B, S, ns, ns) and sub-diagonal blocks ``E`` (B, S-1, ns, ns)
    (``E[:, k]`` = block (k+1, k); the super-diagonal is its transpose),
    with ``x`` (B, S, ns)."""
    y = torch.einsum("bsij,bsj->bsi", D, x)
    if D.shape[1] > 1:
        lower = torch.einsum("bsij,bsj->bsi", E, x[:, :-1])
        upper = torch.einsum("bsji,bsj->bsi", E, x[:, 1:])
        y = y + torch.cat([torch.zeros_like(y[:, :1]), lower], dim=1) \
            + torch.cat([upper, torch.zeros_like(y[:, :1])], dim=1)
    return y


def _band_row_max(D: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """Per-row max |entry| over the whole banded matrix, (B, S, ns)."""
    m = D.abs().amax(dim=3)
    if D.shape[1] > 1:
        from_e = E.abs().amax(dim=3)           # rows of stage k+1
        from_et = E.abs().amax(dim=2)          # rows of stage k (Eᵀ)
        m = torch.maximum(m, torch.cat([torch.zeros_like(m[:, :1]), from_e],
                                       dim=1))
        m = torch.maximum(m, torch.cat([from_et, torch.zeros_like(m[:, :1])],
                                       dim=1))
    return m


def factor_kkt_stage_banded(D: torch.Tensor, E: torch.Tensor):
    """Equilibrate + block-tridiagonal factor from banded blocks only,
    ``D`` (B, S, ns, ns), ``E`` (B, S-1, ns, ns). Same symmetric Jacobi
    equilibration as :func:`factor_kkt_stage`, computed from the band, and
    the same stage sweep."""
    rm = _band_row_max(D, E)
    scale = 1.0 / torch.sqrt(torch.clamp_min(rm, 1e-12))
    Ds = _stage_major(D * scale[..., :, None] * scale[..., None, :])
    if D.shape[1] > 1:
        Es = E * scale[:, 1:, :, None] * scale[:, :-1, None, :]
    else:
        Es = E
    Es = _stage_major(Es)
    F = _factor_blocks(Ds, Es)
    return (F, Es, Ds, scale)


def resolve_kkt_stage_banded(factor, rhs: torch.Tensor,
                             partition: StagePartition,
                             refine_steps: int = ITERATIVE_REFINEMENT_STEPS
                             ) -> torch.Tensor:
    """Solve (B, M) right-hand sides in ORIGINAL KKT order with a stored
    banded stage factor + iterative refinement against the banded
    product."""
    F, Es, Ds, scale = factor
    ix = _indices(partition, rhs.device)
    B = rhs.shape[0]
    bp = rhs[:, ix["safe"]].reshape(B, partition.n_stages, partition.block)
    bp = torch.where(ix["valid"], bp, rhs.new_zeros(())) * scale
    x = _solve_blocks(F, Es, bp)
    for _ in range(refine_steps):
        r = bp - band_matvec_blocks(Ds, Es, x)
        x = x + _solve_blocks(F, Es, r)
    return (x * scale).reshape(B, -1)[:, ix["inv"]]


# --------------------------------------------------------------------------
# scenario-batched sweep: a scenario tree's KKT system is block diagonal
# over scenario branches except for the non-anticipativity rows, so the
# separable part factors as independent stage sweeps. Batch-first, the
# scenario axis is simply the batch axis; a stack of one scenario keeps the
# JAX package's "flat" tag (there the unwrapped flat sweep, here the same
# call).
# --------------------------------------------------------------------------

def _scenario_tag(n: int) -> str:
    return "flat" if n == 1 else "batch"


def factor_kkt_scenarios(K_batch: torch.Tensor, partition: StagePartition):
    """Factor a scenario-batched KKT stack ``K_batch`` (S, M, M), each
    scenario's matrix through the equilibrated block sweep; returns an
    opaque factor for :func:`resolve_kkt_scenarios`."""
    if K_batch.ndim != 3:
        raise ValueError(
            f"K_batch must be (n_scenarios, M, M), got {tuple(K_batch.shape)}")
    return (_scenario_tag(K_batch.shape[0]),
            factor_kkt_stage(K_batch, partition))


def resolve_kkt_scenarios(factor, rhs_batch: torch.Tensor,
                          partition: StagePartition,
                          refine_steps: int = ITERATIVE_REFINEMENT_STEPS
                          ) -> torch.Tensor:
    """Solve ``rhs_batch`` (S, M) against a stored scenario-batched factor;
    rows are in original KKT order per scenario."""
    return resolve_kkt_stage(factor[1], rhs_batch, partition, refine_steps)


def repeat_scenario_factor(factor, reps: int):
    """A scenario-batched factor (:func:`factor_kkt_scenarios`) whose batch
    is the stored one ``reps`` times over, so that one resolve takes
    ``reps`` right-hand-side stacks at once: ``rhs`` (reps·S, M), stack
    ``r`` in rows ``r·S .. (r+1)·S``. The batched form of the JAX package's
    ``vmap`` of resolves against one factor."""
    tag, (F, E, Ks, scale, _lead) = factor
    rep = lambda t: t.repeat((reps,) + (1,) * (t.ndim - 1))
    return (tag, (rep(F), rep(E), rep(Ks), rep(scale),
                  (reps * Ks.shape[0],)))


def factor_kkt_scenarios_banded(D_batch: torch.Tensor,
                                E_batch: torch.Tensor):
    """Banded-input scenario batch: ``D_batch`` (S, n_stages, n_s, n_s),
    ``E_batch`` (S, n_stages-1, n_s, n_s)."""
    return (_scenario_tag(D_batch.shape[0]),
            factor_kkt_stage_banded(D_batch, E_batch))


def resolve_kkt_scenarios_banded(factor, rhs_batch: torch.Tensor,
                                 partition: StagePartition,
                                 refine_steps: int = ITERATIVE_REFINEMENT_STEPS
                                 ) -> torch.Tensor:
    return resolve_kkt_stage_banded(factor[1], rhs_batch, partition,
                                    refine_steps)


# --------------------------------------------------------------------------
# synthetic workload and the static availability answer
# --------------------------------------------------------------------------

def synthetic_stage_kkt(partition: StagePartition, seed: int = 0,
                        dtype=None):
    """Random symmetric quasi-definite matrix with EXACTLY the partition's
    block-tridiagonal sparsity (in original index order) plus a matching
    right-hand side, as numpy arrays (the JAX package's construction, the
    same numbers from the same seed). Signed diagonal dominance (positive
    on variable slots, negative on equality slots) makes it quasi-definite
    and well conditioned."""
    rng = np.random.default_rng(seed)
    perm, valid, _safe, _inv = _perm_arrays(partition)
    S, ns = partition.n_stages, partition.block
    Kp = np.zeros((S * ns, S * ns))
    for k in range(S):
        blk = rng.normal(size=(ns, ns))
        Kp[k * ns:(k + 1) * ns, k * ns:(k + 1) * ns] = 0.5 * (blk + blk.T)
        if k:
            off = 0.3 * rng.normal(size=(ns, ns))
            Kp[k * ns:(k + 1) * ns, (k - 1) * ns:k * ns] = off
            Kp[(k - 1) * ns:k * ns, k * ns:(k + 1) * ns] = off.T
    mask = valid[:, None] & valid[None, :]
    Kp[~mask] = 0.0
    dom = 4.0 * ns
    sign = np.where(perm < partition.n_w, 1.0, -1.0)
    diag = np.where(valid, sign * dom, 0.0)
    Kp[np.diag_indices_from(Kp)] += diag
    M = partition.n_total
    src = np.nonzero(valid)[0]
    K = np.zeros((M, M))
    K[np.ix_(perm[src], perm[src])] = Kp[np.ix_(src, src)]
    rhs = rng.normal(size=(M,))
    if dtype is not None:
        K = K.astype(dtype)
        rhs = rhs.astype(dtype)
    return K, rhs


def stage_method_available(partition: StagePartition, device) -> bool:
    """Whether the stage sweep can run ``partition`` on ``device``: on the
    CPU always (plain versions); on CUDA when the LDLᵀ kernels take the
    stage block (``kkt.ldl_fits``). A static answer, no probe: the solver
    never routes away from a path it chose, and a kernel failure inside
    the sweep raises."""
    dev = torch.device(device)
    return dev.type == "cpu" or kkt_ops.ldl_fits(partition.block, dev)
