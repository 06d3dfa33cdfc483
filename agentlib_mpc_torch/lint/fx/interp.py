"""Shared abstract interpreter over aten graphs.

Port of ``agentlib_mpc_tpu/lint/jaxpr/interp.py`` (``AVal``, ``Domain``,
the rule tables ``:125-207``, ``_Interpreter :242-595``,
``run_nlp_function :603``). The JAX package walks the closed jaxpr of
``fn(w, theta)``; here the walk runs over the aten graph that
``torch.fx.experimental.proxy_tensor.make_fx`` records for
``fn(w, *theta_leaves)``, traced in ``tracing_mode="fake"`` under
``torch.func.functionalize`` (so no theta value is baked into the graph,
and every in-place write is a functional ``*_scatter``/``copy`` node). A
trace that fails — a Python branch on data, an ``.item()`` — is reported to
the caller, which makes the certificate "unknown", never a proof.

One walk, many domains: the LQ-degree pass and the stage-dependence pass
differ only in the per-element payload they propagate and in how
arithmetic combines payloads. This module owns the domain-independent
part:

* the abstract value model — :class:`AVal` couples a per-element
  ``payload`` (numpy, shaped like the value, plus the domain's ``tail``
  axes) with the *concrete* value where it is independent of every
  symbolic input. Graph constants (closure tensors, recorded as
  ``get_attr``) are concrete; an aten op whose inputs are all concrete is
  evaluated eagerly, so index tensors stay exact;
* the op registry: every aten op is linear, smooth nonlinear, nonsmooth,
  a reduction, a contraction or pure data movement. Data movement is
  handled by the *ID trick*: the op is re-run on int64 element-id
  tensors, which yields the exact output→input element map without
  re-implementing ``index``/``gather``/``*_scatter`` semantics;
* contractions (``mm``, ``bmm``, ``mv``, ``dot``, ``addmm``, ...) fold
  their contraction axis per output element; a concrete zero coefficient
  contributes no dependence (the transcription multiplies by constant
  matrices whose zeros are what keeps stages apart);
* ``aten.detach`` plays the part of ``stop_gradient``: no dependence
  survives into any derivative the solvers extract;
* the soundness fallback: an op that is not in the registry and has
  ``w``-tainted inputs smears to the domain's top and is recorded on the
  domain; with untainted inputs its output is provably ``w``-independent
  (an aten op is a pure function of its inputs), so precision survives.

Domains vectorise over elements with numpy (see :mod:`.lq` and
:mod:`.structure`): a payload is an array of shape ``value_shape + tail``.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["AVal", "Domain", "TraceError", "interpret_graph",
           "run_nlp_function", "trace_nlp_function", "w_template_for"]


@dataclasses.dataclass
class AVal:
    """Abstract value: per-element ``payload`` (numpy, ``value_shape +
    domain.tail``) plus the concrete value (a tensor, or a Python number
    for scalar-valued ops) when it is independent of every symbolic input
    (``None`` otherwise)."""

    payload: np.ndarray
    const: Any = None

    @property
    def is_const(self) -> bool:
        return self.const is not None


class Domain:
    """Payload algebra one pass plugs into the shared walk.

    Payloads are numpy arrays of shape ``value_shape + tail``. ``zeros``
    is the payload of a value with no ``w`` dependence; every hook maps
    zero payloads to zero payloads. The elementwise hooks receive payloads
    already broadcast to the output shape.
    """

    dtype: Any = np.int8
    tail: tuple = ()

    def __init__(self):
        self.notes: list[str] = []
        self.opaque: list[str] = []   # tainted opaque ops seen

    # -- payload constructors ------------------------------------------------
    def zeros(self, shape) -> np.ndarray:
        return np.zeros(tuple(shape) + self.tail, dtype=self.dtype)

    def w_payload(self, n: int) -> np.ndarray:
        """Payload of the flat ``w`` input, (n,) + tail."""
        raise NotImplementedError

    def is_zero(self, p: np.ndarray) -> bool:
        return not bool(np.any(p))

    # -- algebra -------------------------------------------------------------
    def join(self, args: "list[np.ndarray]") -> np.ndarray:
        """Linear combination (add/sub/...): no new nonlinearity."""
        raise NotImplementedError

    def join_reduce(self, p: np.ndarray, axes: tuple) -> np.ndarray:
        """Join along value ``axes`` (removed from the result)."""
        raise NotImplementedError

    def mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def div(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def int_pow(self, a: np.ndarray, y: int) -> np.ndarray:
        raise NotImplementedError

    def nonlinear(self, args: "list[np.ndarray]") -> np.ndarray:
        """Smooth nonlinear op (sin/exp/..., generic pow)."""
        raise NotImplementedError

    def nonsmooth(self, args: "list[np.ndarray]") -> np.ndarray:
        """Piecewise-linear / comparison ops (max, min, abs, lt, ...)."""
        raise NotImplementedError

    def select(self, pred: np.ndarray, cases: "list[np.ndarray]"
               ) -> np.ndarray:
        """``where`` with a symbolic predicate."""
        raise NotImplementedError

    def top_like(self, shape, args: "list[np.ndarray]") -> np.ndarray:
        """Smear: conservative payload for an opaque op."""
        raise NotImplementedError

    def contract_const(self, p: np.ndarray, nz: np.ndarray) -> np.ndarray:
        """Contraction of a symbolic (Bt, M, K) operand with a concrete
        (Bt, K, N) one whose nonzero pattern is ``nz``: per output element,
        the join over the k whose coefficient is nonzero."""
        raise NotImplementedError

    def contract_both(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Contraction of two symbolic operands (Bt, M, K) x (Bt, K, N):
        per output element, the join over k of ``mul(a[m, k], b[k, n])``."""
        raise NotImplementedError


class TraceError(RuntimeError):
    """``make_fx`` could not record the function (data-dependent control
    flow, ``.item()``, an unsupported op)."""


# --------------------------------------------------------------------------
# op classification (names are aten overload packets)
# --------------------------------------------------------------------------

#: value-preserving / linear elementwise ops: payload = join of the
#: (broadcast) tensor inputs
LINEAR_EW = {
    "add", "sub", "rsub", "neg", "positive", "clone", "alias", "alias_copy",
    "contiguous", "lift_fresh", "lift_fresh_copy", "real", "imag",
}
#: linear reductions over ``dim`` (None / [] = all)
LINEAR_REDUCE = {"sum", "mean", "nansum"}
#: cumulative linear ops: every element joins its whole axis
LINEAR_CUMULATIVE = {"cumsum"}

#: smooth nonlinear elementwise ops
NONLINEAR_EW = {
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "exp", "exp2", "expm1", "log", "log2",
    "log10", "log1p", "sqrt", "rsqrt", "sigmoid", "logit", "erf", "erfc",
    "erfinv", "atan2", "fmod", "remainder", "lgamma", "digamma",
    "softplus", "xlogy", "hypot", "logaddexp", "logaddexp2", "silu",
    "gelu", "elu", "nextafter", "cumprod", "cumlogsumexp", "special_expit",
    "mish", "lerp",
}

#: piecewise / comparison / boolean elementwise ops
NONSMOOTH_EW = {
    "maximum", "minimum", "fmax", "fmin", "abs", "sign", "sgn", "floor",
    "ceil", "round", "trunc", "frac", "clamp", "clamp_min", "clamp_max",
    "clip", "relu", "hardtanh", "threshold", "heaviside", "lt", "le", "gt",
    "ge", "eq", "ne", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_not", "isfinite", "isnan", "isinf", "floor_divide",
    "nan_to_num", "copysign",
}

#: reductions: nonlinear / nonsmooth (the JAX package joins every element
#: into one total, then applies the op)
NONLINEAR_REDUCE = {"prod", "logsumexp", "norm", "linalg_vector_norm",
                    "var", "std", "var_mean", "std_mean"}
NONSMOOTH_REDUCE = {"amax", "amin", "max", "min", "argmax", "argmin",
                    "any", "all", "aminmax"}

#: pure data movement, re-run on element-id tensors (the ID trick). Value:
#: the top-level argument positions that are INDEX operands (must be
#: concrete); every other tensor argument is data.
STRUCTURAL: "dict[str, frozenset]" = {name: frozenset() for name in (
    "view", "view_copy", "_unsafe_view", "reshape", "expand", "expand_copy",
    "expand_as", "slice", "slice_copy", "select", "select_copy", "cat",
    "stack", "hstack", "vstack", "permute", "permute_copy", "t", "t_copy",
    "transpose", "transpose_copy", "unsqueeze", "unsqueeze_copy",
    "squeeze", "squeeze_copy", "flip", "constant_pad_nd", "roll",
    "repeat", "tile", "narrow", "narrow_copy", "movedim", "unbind",
    "unbind_copy", "split", "split_copy", "split_with_sizes",
    "split_with_sizes_copy", "chunk", "diagonal", "diagonal_copy",
    "diag_embed", "diag", "tril", "triu", "unfold", "unfold_copy",
    "select_scatter", "slice_scatter", "diagonal_scatter", "copy",
    "flatten", "unflatten", "ravel", "atleast_1d", "atleast_2d",
    "broadcast_to",
)}
STRUCTURAL.update({
    "index": frozenset({1}),
    "_unsafe_index": frozenset({1}),
    "index_put": frozenset({1}),
    "_unsafe_index_put": frozenset({1}),
    "gather": frozenset({2}),
    "index_select": frozenset({2}),
    "take": frozenset({1}),
    "take_along_dim": frozenset({1}),
    "masked_fill": frozenset({1}),
    "scatter": frozenset({2}),
    "where": frozenset({0}),
})
#: positions of Python fill values in structural ops: replaced by 0 in the
#: id run (a filled element comes from no operand)
_FILL_ARG = {"constant_pad_nd": 2, "masked_fill": 2, "scatter": 3,
             "where": None}
#: ops whose output value never depends on the VALUES of its tensor
#: inputs (shape/dtype only): concrete whatever the input
VALUE_INDEPENDENT = {
    "zeros_like", "ones_like", "full_like", "empty_like", "new_zeros",
    "new_ones", "new_full", "new_empty", "new_empty_strided", "fill",
    "zero", "scalar_tensor", "arange", "zeros", "ones", "full", "empty",
    "eye", "linspace", "empty_strided",
}
#: contractions handled per output element
CONTRACTIONS = {"mm", "bmm", "mv", "dot", "vdot", "addmm", "addmv",
                "baddbmm", "addbmm"}
#: ops that AD sees as a constant (stop_gradient)
STOP_GRADIENT = {"detach", "detach_copy"}


def _op_name(target) -> str:
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(target, "__name__", str(target))


def _is_aval(x) -> bool:
    return isinstance(x, AVal)


def _aval_leaves(args) -> list:
    leaves, _ = tree_flatten(args)
    return [a for a in leaves if _is_aval(a)]


def _shape_of(meta) -> tuple:
    return tuple(int(s) for s in meta.shape)


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))




def _node_meta(x):
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else None


def _map2(fn, a, node_arg):
    """Apply ``fn(leaf, graph_leaf)`` over a resolved argument and the
    graph's own argument in parallel."""
    if isinstance(a, (list, tuple)):
        node_seq = node_arg if isinstance(node_arg, (list, tuple)) \
            else [None] * len(a)
        return type(a)(_map2(fn, x, nx) for x, nx in zip(a, node_seq))
    return fn(a, node_arg)


class _Symbolic(Exception):
    """An index operand of a structural op is symbolic."""


# --------------------------------------------------------------------------
# the walk
# --------------------------------------------------------------------------

class _Interpreter:
    def __init__(self, domain: Domain, gm: torch.fx.GraphModule):
        self.domain = domain
        self.gm = gm

    # -- helpers -------------------------------------------------------------
    def _const_aval(self, value) -> AVal:
        shape = tuple(value.shape) if isinstance(value, torch.Tensor) else ()
        return AVal(self.domain.zeros(shape), value)

    def _wrap(self, out):
        """Concrete op result(s) → AVal(s)."""
        if isinstance(out, (tuple, list)):
            return [self._wrap(o) for o in out]
        if isinstance(out, (torch.Tensor, bool, int, float)):
            return self._const_aval(out)
        return out

    def _per_output(self, meta, make):
        if isinstance(meta, (tuple, list)):
            return [self._per_output(m, make) for m in meta]
        shape = _shape_of(meta) if isinstance(meta, torch.Tensor) else ()
        return AVal(make(shape))

    def _smear(self, name: str, leaves, meta):
        """Opaque op with tainted inputs: domain top + a record."""
        dom = self.domain
        dom.opaque.append(name)
        top = dom.top_like((), [a.payload for a in leaves])
        return self._per_output(meta, lambda s: np.broadcast_to(
            top, s + dom.tail).copy())

    def _bcast(self, p: np.ndarray, shape) -> np.ndarray:
        return np.broadcast_to(p, tuple(shape) + self.domain.tail)

    def _ew(self, avals, shape) -> list:
        return [self._bcast(a.payload, shape) for a in avals]

    # -- entry ---------------------------------------------------------------
    def run(self, in_avals: "list[AVal]") -> "list[AVal]":
        env: dict = {}

        def read(a):
            if isinstance(a, torch.fx.Node):
                return env[a]
            if isinstance(a, (list, tuple)):
                return type(a)(read(x) for x in a)
            if isinstance(a, dict):
                return {k: read(v) for k, v in a.items()}
            return a

        inputs = iter(in_avals)
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(inputs)
            elif node.op == "get_attr":
                attr = self.gm
                for part in node.target.split("."):
                    attr = getattr(attr, part)
                env[node] = self._const_aval(attr)
            elif node.op == "call_function":
                env[node] = self.call(node, read(node.args),
                                      read(node.kwargs))
            elif node.op == "output":
                leaves, _ = tree_flatten(read(node.args[0]))
                return [a for a in leaves if _is_aval(a)]
            else:
                raise TraceError(f"unsupported graph node {node.op!r}")
        raise TraceError("graph has no output node")

    def call(self, node, args, kwargs):
        target = node.target
        if target is operator.getitem:
            return args[0][args[1]]
        name = _op_name(target)
        dom = self.domain
        meta = node.meta.get("val")
        leaves = _aval_leaves((args, kwargs))

        # anything computable from constants stays exact — including the
        # whole index universe (arange, index arithmetic on constants)
        if all(a.is_const for a in leaves) or name in VALUE_INDEPENDENT:
            return self._wrap(self._concrete(node, args, kwargs))
        # with no w-tainted input the output provably carries no
        # w-dependence, whatever the op
        if all(dom.is_zero(a.payload) for a in leaves):
            return self._per_output(meta, dom.zeros)
        if name in STRUCTURAL:
            res = self._structural(name, target, args, kwargs)
            if res is not None:
                return res
            if name != "where":
                return self._smear(name, leaves, meta)
        if name in NONLINEAR_REDUCE or name in NONSMOOTH_REDUCE:
            return self._reduce_all(name, args[0], meta)
        if not isinstance(meta, torch.Tensor):
            return self._smear(name, leaves, meta)
        shape = _shape_of(meta)

        if name in STOP_GRADIENT:
            return AVal(dom.zeros(shape))
        if name in LINEAR_EW:
            return AVal(dom.join(self._ew(leaves, shape)))
        if name in ("_to_copy", "to", "type_as", "_convert_element_type"):
            # float→float / int→anything is value-preserving (linear);
            # float→int/bool truncates (nonsmooth)
            src = _node_meta(node.args[0])
            in_float = not isinstance(src, torch.Tensor) \
                or src.is_floating_point()
            p = self._bcast(args[0].payload, shape)
            if in_float and not meta.is_floating_point():
                return AVal(dom.nonsmooth([p]))
            return AVal(dom.join([p]))
        if name == "mul":
            a, b = args[0], args[1]
            if not (_is_aval(a) and _is_aval(b)) or a.is_const or b.is_const:
                return AVal(dom.join(self._ew(_aval_leaves(args[:2]),
                                              shape)))
            return AVal(dom.mul(self._bcast(a.payload, shape),
                                self._bcast(b.payload, shape)))
        if name in ("div", "true_divide"):
            a, b = args[0], args[1]
            if kwargs.get("rounding_mode") is not None:
                return AVal(dom.nonsmooth(self._ew(_aval_leaves(args[:2]),
                                                   shape)))
            if not _is_aval(b) or b.is_const:
                return AVal(dom.join(self._ew(_aval_leaves(args[:2]),
                                              shape)))
            pa = self._bcast(a.payload, shape) if _is_aval(a) \
                else dom.zeros(shape)
            return AVal(dom.div(pa, self._bcast(b.payload, shape)))
        if name == "reciprocal":
            return AVal(dom.int_pow(self._bcast(args[0].payload, shape), -1))
        if name == "square":
            return AVal(dom.int_pow(self._bcast(args[0].payload, shape), 2))
        if name == "pow":
            return AVal(self._pow(args, shape))
        if name in ("addcmul", "addcdiv"):
            s, t1, t2 = args[0], args[1], args[2]
            p1, p2 = self._bcast(t1.payload, shape), self._bcast(t2.payload,
                                                                 shape)
            if name == "addcmul":
                prod = dom.join([p1, p2]) if (t1.is_const or t2.is_const) \
                    else dom.mul(p1, p2)
            else:
                prod = dom.join([p1, p2]) if t2.is_const else dom.div(p1, p2)
            return AVal(dom.join([self._bcast(s.payload, shape), prod]))
        if name in NONLINEAR_EW:
            return AVal(dom.nonlinear(self._ew(leaves, shape)))
        if name in NONSMOOTH_EW:
            return AVal(dom.nonsmooth(self._ew(leaves, shape)))
        if name in LINEAR_REDUCE:
            return AVal(self._linear_reduce(args, kwargs, shape))
        if name in LINEAR_CUMULATIVE:
            p = args[0].payload
            nd = p.ndim - len(dom.tail)
            ax = int(args[1]) % max(nd, 1)
            total = dom.join_reduce(p, (ax,)) if nd else p
            return AVal(np.broadcast_to(np.expand_dims(total, ax) if nd
                                        else total, shape + dom.tail).copy())
        if name == "where":
            # symbolic predicate (a concrete one took the ID trick)
            pred = args[0]
            cases = [self._bcast(c.payload, shape) if _is_aval(c)
                     else dom.zeros(shape) for c in args[1:3]]
            return AVal(dom.select(self._bcast(pred.payload, shape), cases))
        if name in CONTRACTIONS:
            return AVal(self._contraction(name, args, shape))
        return self._smear(name, leaves, meta)

    # -- rules ---------------------------------------------------------------
    def _concrete(self, node, args, kwargs):
        def real(a, graph_arg):
            if not _is_aval(a):
                return a
            if a.is_const:
                return a.const
            # a value-independent op on a symbolic input: any tensor of
            # the input's shape, dtype and device gives the same output
            meta = _node_meta(graph_arg)
            if not isinstance(meta, torch.Tensor):
                raise TraceError(f"{node.target}: symbolic input without "
                                 f"a recorded shape")
            return torch.zeros(meta.shape, dtype=meta.dtype,
                               device=meta.device)

        return node.target(
            *[_map2(real, a, na) for a, na in zip(args, node.args)],
            **{k: _map2(real, v, node.kwargs.get(k))
               for k, v in kwargs.items()})

    def _pow(self, args, shape) -> np.ndarray:
        dom = self.domain
        base, exp = args[0], args[1]
        if not _is_aval(base):                      # pow.Scalar(s, tensor)
            return dom.nonlinear([self._bcast(exp.payload, shape)])
        y = None
        if not _is_aval(exp):
            y = exp
        elif exp.is_const:
            c = exp.const
            if not isinstance(c, torch.Tensor):
                y = c
            elif c.numel() == 1:
                y = c.item()
        pb = self._bcast(base.payload, shape)
        if y is not None and float(y).is_integer():
            return dom.int_pow(pb, int(y))
        ps = [pb] + ([self._bcast(exp.payload, shape)] if _is_aval(exp)
                     else [])
        return dom.nonlinear(ps)

    def _linear_reduce(self, args, kwargs, shape) -> np.ndarray:
        dom = self.domain
        p = args[0].payload
        nd = p.ndim - len(dom.tail)
        dim = args[1] if len(args) > 1 else kwargs.get("dim")
        if isinstance(dim, torch.dtype):            # sum.default(x, dtype)
            dim = None
        if dim is None or (isinstance(dim, (list, tuple)) and not dim):
            axes = tuple(range(nd))
        else:
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            axes = tuple(sorted({int(d) % max(nd, 1) for d in dims}))
        out = dom.join_reduce(p, axes) if nd else p
        # keepdim only inserts unit axes: the element count is the same
        return out.reshape(shape + dom.tail)

    def _reduce_all(self, name, src: AVal, meta):
        dom = self.domain
        p = src.payload
        nd = p.ndim - len(dom.tail)
        total = dom.join_reduce(p, tuple(range(nd))) if nd else p
        op = dom.nonlinear if name in NONLINEAR_REDUCE else dom.nonsmooth
        joined = op([total])
        return self._per_output(meta, lambda s: np.broadcast_to(
            joined, s + dom.tail).copy())

    def _contraction(self, name, args, shape) -> np.ndarray:
        """Align both operands to (Bt, M, K) x (Bt, K, N) index space and
        fold the contraction per output element."""
        dom = self.domain
        tail = dom.tail
        bias = None
        if name in ("addmm", "addmv", "baddbmm", "addbmm"):
            bias, a, b = args[0], args[1], args[2]
        else:
            a, b = args[0], args[1]

        def as_batched(x: AVal, lhs: bool):
            p, c = x.payload, x.const
            if isinstance(c, torch.Tensor):
                c = c.detach().cpu()
            nd = p.ndim - len(tail)
            if nd == 1:                 # vector: a row (lhs) or column
                p = p[None] if lhs else p[:, None]
                c = None if c is None else (c[None] if lhs else c[:, None])
            if nd <= 2:
                p = p[None]
                c = None if c is None else c[None]
            return p, c

        pa, ca = as_batched(a, True)
        pb, cb = as_batched(b, False)
        if ca is not None:
            # out^T = b^T a^T with the concrete operand on the right
            nz = (ca != 0).numpy()
            out = np.swapaxes(dom.contract_const(
                np.swapaxes(pb, 1, 2), np.swapaxes(nz, 1, 2)), 1, 2)
        elif cb is not None:
            out = dom.contract_const(pa, (cb != 0).numpy())
        else:
            out = dom.contract_both(pa, pb)
        if name == "addbmm":
            out = dom.join_reduce(out, (0,))
        out = out.reshape(shape + tail)
        if bias is not None:
            out = dom.join([out, self._bcast(bias.payload, shape)])
        return out

    def _structural(self, name, target, args, kwargs):
        """ID trick: run the op on int64 element ids; map payloads through
        the resulting output→input element mapping. Index operands must
        be concrete (else None: the caller smears, or ``where`` takes the
        symbolic-predicate rule)."""
        dom = self.domain
        index_pos = STRUCTURAL[name]
        if name in ("index_put", "_unsafe_index_put") and (
                kwargs.get("accumulate") or (len(args) > 3 and args[3])):
            return None                           # a sum, not a move
        if name == "scatter" and ("reduce" in kwargs or len(args) > 4):
            return None
        tables = [dom.zeros((1,))]                 # id 0: from no operand
        next_id = [1]

        def ids_for(a: AVal):
            vshape = a.payload.shape[:a.payload.ndim - len(dom.tail)]
            n = _numel(vshape)
            ids = (torch.arange(n, dtype=torch.int64) + next_id[0]
                   ).reshape(vshape)
            next_id[0] += n
            tables.append(a.payload.reshape((n,) + dom.tail))
            return ids

        def convert(a, is_index: bool):
            if _is_aval(a):
                if is_index:
                    if not a.is_const:
                        raise _Symbolic
                    c = a.const
                    return c.detach().cpu() if isinstance(c, torch.Tensor) \
                        else c
                return ids_for(a)
            if isinstance(a, (list, tuple)):
                return type(a)(convert(x, is_index) for x in a)
            return a

        try:
            id_args = [convert(a, i in index_pos) for i, a in enumerate(args)]
            id_kwargs = {k: convert(v, k in ("index", "indices", "mask",
                                             "condition"))
                         for k, v in kwargs.items()}
        except _Symbolic:
            return None
        # a Python fill value comes from no operand: id 0
        fill = _FILL_ARG.get(name, -1)
        if fill is None:                            # where: scalar branches
            id_args = [0 if i > 0 and isinstance(a, (bool, int, float))
                       else a for i, a in enumerate(id_args)]
        elif 0 <= fill < len(id_args) and isinstance(id_args[fill],
                                                     (bool, int, float)):
            id_args[fill] = 0
        id_kwargs = {k: (0 if k in ("value", "fill_value")
                         and isinstance(v, (bool, int, float)) else v)
                     for k, v in id_kwargs.items()}
        id_kwargs.pop("device", None)
        outs = target(*id_args, **id_kwargs)
        flat = np.concatenate(tables, axis=0)
        multi = isinstance(outs, (tuple, list))
        results = []
        for out in (outs if multi else [outs]):
            src = out.to(torch.int64).reshape(-1).numpy()
            results.append(AVal(flat[src].reshape(tuple(out.shape)
                                                   + dom.tail)))
        return results if multi else results[0]


def interpret_graph(gm: torch.fx.GraphModule, in_avals: "list[AVal]",
                    domain: Domain) -> "list[AVal]":
    """Run ``domain`` over an aten graph (placeholders in order)."""
    return _Interpreter(domain, gm).run(in_avals)


def trace_nlp_function(fn, w_template: torch.Tensor, theta):
    """Record the aten graph of ``fn(w, theta)`` with ``w`` and every tensor
    leaf of ``theta`` as placeholders, in fake mode (no value is baked in)
    and functionalised (no in-place op, no aliasing view), after one real
    evaluation on ``w_template``. Returns
    ``(graph_module, theta_tensor_leaves)``; raises :class:`TraceError`
    when the function cannot be recorded."""
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves, spec = tree_flatten(theta)
    tensor_pos = [i for i, t in enumerate(leaves)
                  if isinstance(t, torch.Tensor)]
    tensors = [leaves[i] for i in tensor_pos]

    def flat_fn(w, *tensor_leaves):
        full = list(leaves)
        for i, t in zip(tensor_pos, tensor_leaves):
            full[i] = t
        return fn(w, tree_unflatten(full, spec))

    try:
        # one real evaluation first: a function that fills a lazy cache
        # (the transcription's constants, per dtype and device) must fill
        # it with real tensors, not with the fake ones of the trace below
        with torch.no_grad():
            flat_fn(w_template, *tensors)
        gm = make_fx(torch.func.functionalize(flat_fn,
                                              remove="mutations_and_views"),
                     tracing_mode="fake",
                     _allow_non_fake_inputs=True)(w_template, *tensors)
    except Exception as exc:  # noqa: BLE001 — any trace failure is "unknown"
        raise TraceError(f"make_fx could not record the function: "
                         f"{type(exc).__name__}: {exc}") from exc
    return gm, tensors


def w_template_for(theta, n: int) -> torch.Tensor:
    """A zero ``w`` on the device and in the floating dtype of ``theta``'s
    first floating tensor leaf (float64 on the CPU when there is none)."""
    leaves, _ = tree_flatten(theta)
    for t in leaves:
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return torch.zeros((n,), dtype=t.dtype, device=t.device)
    return torch.zeros((n,), dtype=torch.float64)


def run_nlp_function(fn, theta, n: int, domain: Domain) -> "list[AVal]":
    """Trace ``fn(w, theta)`` for a flat ``w`` of ``n`` elements and
    interpret it with ``w`` symbolic (payload ``domain.w_payload``) and
    every theta leaf a symbolic *constant-in-w* (zero payload, unknown
    value) — so whatever the pass proves holds for ALL theta, not one
    sample."""
    gm, tensors = trace_nlp_function(fn, w_template_for(theta, n), theta)
    in_avals = [AVal(domain.w_payload(n))]
    in_avals += [AVal(domain.zeros(tuple(t.shape))) for t in tensors]
    return interpret_graph(gm, in_avals, domain)
