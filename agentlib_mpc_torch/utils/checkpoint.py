"""Durable control-state checkpoints.

Port of ``agentlib_mpc_tpu/utils/checkpoint.py`` with the port's own
format: the JAX package writes orbax directories; here a checkpoint is a
directory holding one ``torch.save`` file of the tree's leaves, moved to
the CPU, beside the tree's structure. The two packages cannot read each
other's checkpoints. The protocol is the JAX package's: the new
checkpoint is written completely into a ``<path>.tmp-<pid>`` sibling,
the old one is parked at ``<path>.old-<pid>`` while the new one is
renamed into place, and a restore falls back to the newest complete
sibling when ``path`` itself is missing. A restore whose stored structure
or leaf shapes and dtypes differ from the template is refused with
``ValueError``.

:class:`~agentlib_mpc_torch.parallel.config_bridge.FusedFleet` wires these
into ``save_checkpoint``/``restore_checkpoint``; a hand-built
:class:`~agentlib_mpc_torch.parallel.fused_admm.FusedState` is its own
template.
"""

from __future__ import annotations

import glob
import os
import shutil
from typing import Any

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["save_pytree", "load_pytree", "has_checkpoint"]

#: the one file of a checkpoint directory; it is renamed into place only
#: once written, so its presence marks a complete checkpoint
_TREE_FILE = "tree.pt"


def _stale_siblings(path: str) -> list:
    return sorted(glob.glob(f"{path}.tmp-*") + glob.glob(f"{path}.old-*"),
                  key=os.path.getmtime)


def _looks_complete(path: str) -> bool:
    return os.path.isfile(os.path.join(path, _TREE_FILE))


def has_checkpoint(path: str) -> bool:
    """True when :func:`load_pytree` has something complete to try at
    ``path``: the checkpoint directory or a crash-recovery sibling
    (``.old-*`` / ``.tmp-*``) holding a fully written tree."""
    path = os.path.abspath(path)
    if os.path.isdir(path) and _looks_complete(path):
        return True
    return any(_looks_complete(s) for s in _stale_siblings(path))


def _leaf_signature(leaf):
    if isinstance(leaf, torch.Tensor):
        return ("tensor", tuple(leaf.shape), str(leaf.dtype))
    return (type(leaf).__name__,)


def save_pytree(path: str, tree: Any) -> str:
    """Write a pytree of tensors and Python scalars to ``path`` (a
    directory), replacing any existing checkpoint crash-safely. Returns
    the absolute path."""
    path = os.path.abspath(path)
    leaves, spec = tree_flatten(tree)
    payload = {
        "spec": str(spec),
        "signature": [list(_leaf_signature(x)) for x in leaves],
        "leaves": [x.detach().to("cpu") if isinstance(x, torch.Tensor)
                   else x for x in leaves],
    }
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    partial = os.path.join(tmp, _TREE_FILE + ".partial")
    torch.save(payload, partial)
    os.replace(partial, os.path.join(tmp, _TREE_FILE))
    if os.path.isdir(path):
        old = f"{path}.old-{os.getpid()}"
        if os.path.isdir(old):
            shutil.rmtree(old)
        os.rename(path, old)
        os.rename(tmp, path)
    else:
        os.rename(tmp, path)
    # the new checkpoint is in place: drop every leftover sibling
    for stale in _stale_siblings(path):
        shutil.rmtree(stale, ignore_errors=True)
    return path


def _restore(path: str, template: Any) -> Any:
    payload = torch.load(os.path.join(path, _TREE_FILE), weights_only=True)
    t_leaves, t_spec = tree_flatten(template)
    expected = [list(_leaf_signature(x)) for x in t_leaves]
    if payload["spec"] != str(t_spec) or \
            [list(s) for s in payload["signature"]] != expected:
        raise ValueError(
            f"checkpoint at {path} is not compatible with the template: "
            f"stored leaves {payload['signature']} != template leaves "
            f"{expected} — restore into a fleet built from the same "
            f"config")
    leaves = [x.to(t.device) if isinstance(t, torch.Tensor) else x
              for x, t in zip(payload["leaves"], t_leaves)]
    return tree_unflatten(leaves, t_spec)


def load_pytree(path: str, template: Any) -> Any:
    """Restore a pytree written by :func:`save_pytree`.

    ``template`` supplies the structure, container types, leaf shapes and
    dtypes and the device of every tensor leaf; its values are ignored.
    When ``path`` is missing, the ``.old-*``/``.tmp-*`` siblings are tried
    newest first."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        return _restore(path, template)
    candidates = _stale_siblings(path)
    if not candidates:
        raise FileNotFoundError(f"no checkpoint at {path}")
    errors = []
    last_exc = None
    for candidate in reversed(candidates):
        try:
            return _restore(candidate, template)
        except (OSError, ValueError, RuntimeError) as exc:
            errors.append(f"{candidate}: {exc}")
            last_exc = exc
    # checkpoint data exists but none of it restored: not "no checkpoint"
    raise RuntimeError(
        f"checkpoint at {path} is missing its primary directory and "
        f"every crash-recovery sibling failed to restore: "
        f"{'; '.join(errors)}") from last_exc
