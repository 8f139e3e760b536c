"""Plain PyTorch versions of the paged attention kernels.

They implement the *gather semantics* the engine's ``"gather"`` path
executes: a slot's blocks are gathered into its contiguous virtual
sequence and attention runs over it eagerly, in f32.  The CUDA kernels in
``csrc/`` compute the same function block by block; the wrappers in
``ops.py`` fall to these only for tensors on the CPU, and ``chip_smoke.py``
holds each kernel against them on the card, within ``kernel_tolerance``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _gather_pages(cache: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(N, bs, Hk, d)[table] -> (..., L_virt, Hk, d) contiguous pages."""
    bs = cache.shape[1]
    pages = cache[table.long()]                       # (..., nb, bs, Hk, d)
    return pages.reshape(*table.shape[:-1], table.shape[-1] * bs,
                         *cache.shape[2:])


def paged_decode_ref(q, cache_k, cache_v, block_tables, pos):
    """q: (S, Hk, G, d); caches: (N, bs, Hk, d); tables: (S, nb); pos: (S,).

    Each slot attends its one query token over keys ``[0, pos[s]]`` of its
    gathered virtual sequence."""
    S, Hk, G, d = q.shape
    pk = _gather_pages(cache_k, block_tables).float()     # (S, L, Hk, d)
    pv = _gather_pages(cache_v, block_tables).float()
    L = pk.shape[1]
    k_pos = torch.arange(L, device=q.device)
    sc = torch.einsum("skgd,slkd->skgl", q.float(), pk) * d ** -0.5
    live = k_pos[None, :] <= pos.to(q.device).long()[:, None]    # (S, L)
    sc = torch.where(live[:, None, None, :], sc,
                     torch.full((), NEG_INF, device=q.device))
    pr = torch.softmax(sc, dim=-1)
    return torch.einsum("skgl,slkd->skgd", pr, pv).to(q.dtype)


def paged_verify_ref(q, cache_k, cache_v, block_tables, pos):
    """q: (S, Q, Hk, G, d); caches: (N, bs, Hk, d); tables: (S, nb);
    pos: (S,).

    Speculative verify semantics: slot ``s``'s query ``i`` sits at
    absolute position ``pos[s] + i`` and attends keys ``[0, pos[s] + i]``
    of its gathered virtual sequence (the candidate keys themselves
    included: they were written before attention, like a prefill chunk's
    own tokens)."""
    S, Q, Hk, G, d = q.shape
    pk = _gather_pages(cache_k, block_tables).float()     # (S, L, Hk, d)
    pv = _gather_pages(cache_v, block_tables).float()
    L = pk.shape[1]
    sc = torch.einsum("sqkgd,slkd->sqkgl", q.float(), pk) * d ** -0.5
    q_pos = (pos.to(q.device).long()[:, None]
             + torch.arange(Q, device=q.device)[None, :])    # (S, Q)
    k_pos = torch.arange(L, device=q.device)
    live = k_pos[None, None, :] <= q_pos[:, :, None]        # (S, Q, L)
    sc = torch.where(live[:, :, None, None, :], sc,
                     torch.full((), NEG_INF, device=q.device))
    pr = torch.softmax(sc, dim=-1)
    return torch.einsum("sqkgl,slkd->sqkgd", pr, pv).to(q.dtype)


def paged_prefill_ref(q, cache_k, cache_v, block_table, start, valid):
    """q: (C, Hk, G, d) chunk at absolute positions ``start + [0, C)``;
    keys ``[0, start + valid)`` of the gathered virtual sequence are live
    (causally masked); chunk rows past ``valid`` are padding."""
    C, Hk, G, d = q.shape
    pk = _gather_pages(cache_k, block_table).float()      # (L, Hk, d)
    pv = _gather_pages(cache_v, block_table).float()
    L = pk.shape[0]
    start, valid = int(start), int(valid)
    sc = torch.einsum("ckgd,lkd->ckgl", q.float(), pk) * d ** -0.5
    q_pos = start + torch.arange(C, device=q.device)
    k_pos = torch.arange(L, device=q.device)
    live = ((k_pos[None, :] <= q_pos[:, None])
            & (k_pos[None, :] < start + valid))              # (C, L)
    sc = torch.where(live[:, None, None, :], sc,
                     torch.full((), NEG_INF, device=q.device))
    pr = torch.softmax(sc, dim=-1)
    return torch.einsum("ckgl,lkd->ckgd", pr, pv).to(q.dtype)


def kernel_tolerance(ref: torch.Tensor, cache_v: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on ``|kernel - plain|`` for one output ``ref``.

    Both sides accumulate in f32 from the same inputs and round once to
    the output dtype; they differ by summation order and that rounding.
    bf16 outputs: one bf16 ulp of each element (at most 2**-7 of it) plus
    1e-3 of the mean magnitude for the f32 summation slack.  f32 outputs:
    1e-4 of max|v| (every output is a convex combination of V rows); int8
    scores reach the hundreds, where f32 rounds a score by ~1e-5 and the
    softmax turns that into a relative change of each weight.
    """
    r = ref.float().abs()
    if ref.dtype == torch.bfloat16:
        return 2.0 ** -7 * r + 1e-3 * r.mean()
    scale = max(1.0, float(cache_v.float().abs().max()))
    return torch.full_like(r, 1e-4 * scale)
