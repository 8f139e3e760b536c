"""PyTorch/CUDA port of the LIFE reproduction's measured half.

The JAX package ``repro`` stays the reference; this package runs the
continuous-batching serving engine on an NVIDIA H100 with hand-written
Hopper kernels for paged attention.  It imports ``torch`` and numpy only,
never ``jax`` and nothing of ``repro``.

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
