"""Carry per-solve parameters and fleet state across frameworks.

New in the port (no JAX counterpart). The system's "weights" are the
per-solve :class:`~agentlib_mpc_torch.ops.transcription.OCPParams` and the
fleet's warm-start state; they cross as numpy arrays, so the port never
imports JAX:

    ocp_params_from_numpy({k: np.asarray(v) for k, v in
                           jax_theta._asdict().items()}, device, dtype)

A stage partition crosses as its fields (``stage_partition_from_fields``).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch.utils._pytree import tree_map

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


def to_numpy(tree):
    """Every tensor leaf of ``tree`` as a numpy array (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else t, tree)
