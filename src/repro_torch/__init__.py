"""PyTorch/CUDA port of the LIFE reproduction.

The JAX package ``repro`` stays the reference; this package runs the
continuous-batching serving engine, the trainer and quantized linears on
an NVIDIA H100 with hand-written Hopper kernels, and carries a copy of
LIFE's analytical half (``configs``, ``core``, ``traffic``, ``api``) so
that forecasts for the card sit beside measurements on it.  It imports
``torch`` and numpy only, never ``jax`` and nothing of ``repro``.

Entry points take a ``device`` argument that defaults to ``"cuda"``: on a
host without a GPU they raise unless the caller passes ``device="cpu"``
explicitly (the CPU tests do).  Nothing falls back to the CPU silently.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for but
    absent, instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host explicitly")
    return dev
