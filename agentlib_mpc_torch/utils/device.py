"""Device resolution for the port's entry points.

Role counterpart of ``agentlib_mpc_tpu/utils/jax_setup.py`` (which picks
and pins the JAX platform). Here every entry point takes an explicit
``device``: ``None`` means the card, and nothing falls back to the CPU on
its own — a caller that wants the CPU says ``"cpu"``, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raises when CUDA is asked for but absent.

    ``"cpu"`` (or a ``torch.device`` of type cpu) is honoured as given.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested (device=None means 'cuda') but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev
