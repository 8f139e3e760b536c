"""Parameter bridge: the JAX package's parameter tree <-> the port's tensors.

The JAX model zoo keeps parameters as nested dicts with a stacked
``(L, ...)`` layer axis and einsum layouts: ``wq (d,H,hd)``,
``wk/wv (d,Hk,hd)``, ``wo (H,hd,d)``, ``lm_head (d,V)``.  The port keeps
those layouts unchanged, so a tree converted here drives
``repro_torch.models.forward`` and the engine with the same weights.

The tree crosses as nested dicts of **numpy** arrays (``np.asarray`` of
each JAX leaf).  numpy's ``bfloat16`` comes from ml_dtypes and
``torch.from_numpy`` rejects it, so bf16 crosses bit for bit through an
int16 view.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import resolve_device


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.name == "bfloat16"


def tensor_from_numpy(arr: np.ndarray, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One numpy array (bf16 from ml_dtypes included) -> tensor, bit for
    bit; ``dtype`` optionally casts after the exact crossing."""
    dev = resolve_device(device)
    arr = np.array(arr, order="C", copy=True)   # writable, owned by torch
    if _is_bf16(arr):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(dev)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array; bf16 comes back as ml_dtypes' bfloat16."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # only the round trip to the JAX side needs it
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Dict, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (floating leaves optionally cast to ``dtype``)."""
    return {k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
                else tensor_from_numpy(v, device, dtype))
            for k, v in tree.items()}


def params_to_numpy(tree: Dict) -> Dict:
    """Inverse of :func:`params_from_numpy` (bit for bit)."""
    return {k: (params_to_numpy(v) if isinstance(v, dict)
                else tensor_to_numpy(v))
            for k, v in tree.items()}


def opt_state_from_numpy(state, device="cuda"):
    """An optimizer state ``(count, mu, nu)`` of numpy arrays (the JAX
    package's ``AdamWState`` converted leaf by leaf, or any 3-sequence)
    -> the port's ``AdamWState`` of tensors on ``device``, bit for bit."""
    from repro_torch.optim.adamw import AdamWState
    count, mu, nu = state
    return AdamWState(count=tensor_from_numpy(np.asarray(count), device),
                      mu=params_from_numpy(mu, device),
                      nu=params_from_numpy(nu, device))


def opt_state_to_numpy(state):
    """Inverse of :func:`opt_state_from_numpy`: ``(count, mu, nu)`` as
    numpy arrays, in the field order of both packages' ``AdamWState``."""
    count, mu, nu = state
    return (tensor_to_numpy(count), params_to_numpy(mu), params_to_numpy(nu))
