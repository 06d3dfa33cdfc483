#!/usr/bin/env python3
"""Both packages' interior-point steps on identical inputs, CPU, float64.

    JAX_PLATFORMS=cpu python3 scripts/fixed_3900_identical_inputs.py [--out PATH]

The fixed-binary MINLP program at t = 3 900 s of examples/minlp_switched_room.py
(``tests/data/torch_cia_fixed_3900.json``, from ``scripts/module_f32_witness.py
--fixture``) in float64 on the plain LDLᵀ (``kkt_method="ldl"``) stops on a
wedged point more often in the port than in the JAX package. This script
tells a formula that differs from rounding that is amplified: it copies both
solver modules into a temporary tree, adds a hook that hands out the solver's
own closures (the iteration body, the KKT error, the derivative functions)
and its initial state, and then, iteration by iteration:

- ``seq``: each package's own iterate sequence (the JAX package's body run op
  by op under ``jax.disable_jit``), its KKT error, and the JAX package's
  compiled solve stopped after the same number of iterations;
- ``same_point``: at a few iterations, both packages' derivatives, KKT error
  and step on the port's iterate, and the JAX package's body compiled
  (``jax.jit``) against the same body run op by op, with the condition number
  of the assembled KKT matrix there.

Differences are max |a - b| / max |b| over each array. One JSON line each.
Takes about 3 minutes; nothing in the repository is changed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOOK = ("    if STEP_HOOK is not None:\n"
        "        STEP_HOOK(dict(body=body, kkt_error=kkt_error, init={init}, "
        "lb=lb, ub=ub, fgh_and_jac=fgh_and_jac, hess_l=hess_l{extra}))\n")
#: where each solver's hook goes, and what it hands out beyond the common keys
PATCHES = {
    "agentlib_mpc_tpu/ops/solver.py": (
        "    final = jax.lax.while_loop(cond, body, init)\n", "init", ""),
    "agentlib_mpc_torch/ops/solver.py": (
        "    # the batched while loop: the body runs on every lane",
        "st", ", sc=sc"),
}
SAME_POINT_ITERATIONS = (4, 8, 12, 13, 16, 17)
FIELDS = ("w", "s", "y", "z", "zL", "zU", "mu", "delta", "kkt0", "best_err",
          "stall", "frozen", "fv", "gf", "gv", "Jg", "hv", "Jh")


def make_tree(dst: str) -> None:
    for pkg in ("agentlib_mpc_tpu", "agentlib_mpc_torch"):
        shutil.copytree(os.path.join(ROOT, pkg), os.path.join(dst, pkg),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel in ("scripts/module_f32_witness.py",
                "tests/data/torch_cia_fixed_3900.json"):
        os.makedirs(os.path.join(dst, os.path.dirname(rel)), exist_ok=True)
        shutil.copy(os.path.join(ROOT, rel), os.path.join(dst, rel))
    for rel, (anchor, init, extra) in PATCHES.items():
        path = os.path.join(dst, rel)
        with open(path) as fh:
            src = fh.read()
        assert anchor in src, rel
        src = src.replace(anchor, HOOK.format(init=init, extra=extra)
                          + anchor, 1)
        src = src.replace("class NLPFunctions(NamedTuple):",
                          "STEP_HOOK = None\n\n\nclass NLPFunctions"
                          "(NamedTuple):", 1)
        with open(path, "w") as fh:
            fh.write(src)


def child(tree: str) -> None:
    sys.path[:0] = [tree]
    import numpy as np
    import torch
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "witness", os.path.join(tree, "scripts/module_f32_witness.py"))
    wit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wit)
    import agentlib_mpc_tpu.ops.solver as JS
    import agentlib_mpc_torch.ops.solver as PS

    with open(os.path.join(tree, "tests/data/torch_cia_fixed_3900.json")) as fh:
        a = {k: np.asarray(v, dtype=np.float64)
             for k, v in json.load(fh).items()}
    names = ("u_prev", "d_traj", "p", "x_lb", "x_ub", "u_lb", "u_ub", "t0")
    jb = wit.make_mas("jax", "f64", "cia").agents["Controller"] \
        .get_module("mpc").backend
    pb = wit.make_mas("torch", "f64", "cia").agents["Controller"] \
        .get_module("mpc").backend
    mu0 = float(a["mu0"])
    jo, jopts, po, popts = (jb.ocp_fixed, jb._fixed_options, pb.ocp_fixed,
                            pb._fixed_options)
    jth = jo.default_params(**{k: jnp.asarray(a[k]) for k in names},
                            x0=jnp.asarray(a["x0"]))
    pth = po.default_params(device="cpu", dtype=torch.float64)._replace(
        **{k: torch.as_tensor(a[k]) for k in names},
        x0=torch.as_tensor(a["x0"]))
    hooks = {}
    JS.STEP_HOOK = lambda d: hooks.__setitem__("jax", d)
    PS.STEP_HOOK = lambda d: hooks.__setitem__("torch", d)
    jlb, jub = jo.bounds(jth)
    with jax.disable_jit():
        JS.solve_nlp(jo.nlp, jo.initial_guess(jth), jth, jlb, jub, jopts,
                     mu0=mu0, max_iter=0)
    plb, pub = po.bounds(pth)
    PS.solve_nlp(po.nlp, po.initial_guess(pth), pth, plb, pub, popts,
                 mu0=mu0, max_iter=0)
    J, P = hooks["jax"], hooks["torch"]
    JS.STEP_HOOK = None
    emit = lambda obj: print("RESULT " + json.dumps(obj), flush=True)

    def rel(x, y):
        x, y = np.asarray(x, float).ravel(), np.asarray(y, float).ravel()
        return 0.0 if x.size == 0 else float(
            np.abs(x - y).max() / max(np.abs(y).max(), 1e-300))

    def to_jax(st):
        return J["init"]._replace(
            **{f: jnp.asarray(getattr(st, f)[0].numpy()) for f in FIELDS},
            it=jnp.asarray(int(st.it[0])), done=jnp.asarray(bool(st.done[0])))

    def errors_jax(st):
        return [float(v) for v in J["kkt_error"](
            st.gf, st.Jg, st.Jh, st.gv, st.hv, st.s, st.y, st.z, st.zL,
            st.zU, st.w, 0.0)]

    def errors_port(st):
        return [float(v[0]) for v in P["kkt_error"](
            st.gf, st.Jg, st.Jh, st.gv, st.hv, st.s, st.y, st.z, st.zL,
            st.zU, st.w, 0.0)]

    compiled = {k: float(JS.solve_nlp(
        jo.nlp, jo.initial_guess(jth), jth, jlb, jub, jopts, mu0=mu0,
        max_iter=k).stats.kkt_error) for k in range(1, 21)}
    jbody = jax.jit(J["body"])
    js, ps = J["init"], P["init"]
    for k in range(1, 21):
        if k in SAME_POINT_ITERATIONS:
            pj = to_jax(ps)
            with jax.disable_jit():
                jv, jjac = J["fgh_and_jac"](pj.w)
                jhess = J["hess_l"](pj.w, pj.y, pj.z)
                eager = J["body"](pj)
            pv, pjac = P["fgh_and_jac"](ps.w, *P["sc"])
            phess = P["hess_l"](ps.w, ps.y, ps.z, *P["sc"])
            port, comp = P["body"](ps), jbody(pj)
            lb, ub, w = (np.asarray(J["lb"]), np.asarray(J["ub"]),
                         np.asarray(pj.w))
            W = np.asarray(jhess) + np.diag(
                float(pj.delta) + np.asarray(pj.zL)
                / np.maximum(w - lb, 1e-12) + np.asarray(pj.zU)
                / np.maximum(ub - w, 1e-12))
            Jh, Jg = np.asarray(pj.Jh), np.asarray(pj.Jg)
            sigma_s = np.asarray(pj.z) / np.maximum(np.asarray(pj.s), 1e-12)
            W = W + Jh.T @ (sigma_s[:, None] * Jh)
            K = np.block([[W, Jg.T], [Jg, -jopts.delta_c
                                      * np.eye(Jg.shape[0])]])
            emit({"line": "same_point", "k": k, "mu": float(pj.mu),
                  "values": rel(jv, pv[0].numpy()),
                  "jacobian": rel(jjac, pjac[0].numpy()),
                  "hessian": rel(jhess, phess[0].numpy()),
                  "kkt_error_jax_fn": errors_jax(pj),
                  "kkt_error_port_fn": errors_port(ps),
                  "kkt_error_fn_rel": rel(errors_port(ps), errors_jax(pj)),
                  **{f"step_{f}_port_vs_jax_op_by_op": rel(
                      getattr(port, f)[0].numpy(), getattr(eager, f))
                     for f in ("w", "y", "z")},
                  **{f"step_{f}_jax_compiled_vs_op_by_op": rel(
                      getattr(comp, f), getattr(eager, f))
                     for f in ("w", "y", "z")},
                  "kkt_matrix_cond": float(np.linalg.cond(K))})
        with jax.disable_jit():
            js = J["body"](js)
        ps = P["body"](ps)
        emit({"line": "seq", "k": k,
              "jax_op_by_op_kkt": float(js.kkt0),
              "port_kkt": float(ps.kkt0[0]),
              "jax_compiled_kkt": compiled[k],
              "w_rel": rel(ps.w[0].numpy(), js.w)})


def main() -> int:
    if "--child" in sys.argv:
        child(sys.argv[sys.argv.index("--child") + 1])
        return 0
    parser = argparse.ArgumentParser()
    parser.add_argument("--out")
    args = parser.parse_args()
    tree = tempfile.mkdtemp(prefix="fixed_3900_identical_")
    try:
        make_tree(tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree],
            capture_output=True, text=True, cwd=tree,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
    finally:
        shutil.rmtree(tree, ignore_errors=True)
    lines = [ln[len("RESULT "):] for ln in proc.stdout.splitlines()
             if ln.startswith("RESULT ")]
    if proc.returncode != 0 or not lines:
        print(proc.stderr[-3000:], file=sys.stderr)
        return 1
    text = "\n".join(lines)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
