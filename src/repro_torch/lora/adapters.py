"""LoRA adapters (paper §3.3.5): one-time ahead-of-time merge vs dynamic
per-GEMM application — the two operating modes LIFE models (Eq. 7,
Table 12 / Fig. 9).  The port's counterpart of the JAX package's
``lora/adapters.py``; random factors come from an explicit
``torch.Generator`` where the reference takes a JAX key (the draws
differ, so tests carry factors across with ``repro_torch.bridge``).
"""
from __future__ import annotations

from typing import Dict

import torch


def init_adapter(gen: torch.Generator, k: int, n: int, rank: int,
                 dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """``A`` normal with std ``rank ** -0.5``, ``B`` zeros (the adapter
    starts as the identity), on the generator's device."""
    a = torch.randn((k, rank), generator=gen, device=gen.device, dtype=dtype)
    return {
        "A": a * (1.0 / rank) ** 0.5,
        "B": torch.zeros((rank, n), dtype=dtype, device=gen.device),
    }


def init_adapters_for_tree(gen: torch.Generator, params: Dict, rank: int,
                           min_size: int = 1 << 16,
                           dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Adapter pair for every large 2-D weight; mirrors the param tree
    (``None`` where a leaf gets no adapter).

    Adapters live in the COMPUTE dtype (``dtype``, default bf16), not the
    storage dtype of the base weight: a quantized (int8/int4) or fp8 base
    weight must not drag its adapters down to a dtype the low-rank GEMMs
    can't run in — inline application multiplies activations by A and B
    directly, and the merge path upcasts to f32 anyway.  Leaves are
    visited in sorted key order, as JAX flattens a dict.
    """
    def visit(leaf):
        if isinstance(leaf, dict):
            return {key: visit(leaf[key]) for key in sorted(leaf)}
        # a tensor's shape, or a quantized weight's logical (k, n)
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) == 2 and shape[0] * shape[1] >= min_size:
            return init_adapter(gen, shape[0], shape[1], rank, dtype)
        return None

    return visit(params)


def _is_adapter(a) -> bool:
    return isinstance(a, dict) and "A" in a


def merge(params: Dict, adapters: Dict, scale: float = 1.0) -> Dict:
    """One-time merge: W' = W + scale · A @ B (Eq. 7), in f32, cast back
    to W's dtype; leaves without an adapter are returned as they are."""
    def m(w, a):
        if a is None:
            return w
        if _is_adapter(a):
            return (w.float() + scale * (a["A"].float() @ a["B"].float())
                    ).to(w.dtype)
        return {key: m(w[key], a[key]) for key in w}

    return m(params, adapters)


def apply_inline(x: torch.Tensor, w: torch.Tensor, adapter: Dict,
                 scale: float = 1.0) -> torch.Tensor:
    """Dynamic mode: y = x@W + scale·(x@A)@B every call — costs
    2·k·r·n extra ops exactly as LIFE charges for inline LoRA."""
    y = x @ w
    return y + (scale * ((x @ adapter["A"]) @ adapter["B"])).to(y.dtype)


def merge_flops(k: int, n: int, rank: int) -> float:
    """Analytical merge cost of one linear (cross-check vs LIFE)."""
    return 2.0 * k * rank * n + k * n
