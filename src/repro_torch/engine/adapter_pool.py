"""Multi-tenant adapter pool + host-side adapter store (LoRA serving).

The PyTorch counterpart of the JAX package's ``engine/adapter_pool.py``.
The engine keeps a global device-resident pool of ``n_slots`` adapter
positions (stacked, rank-padded A/B factors for every attention
projection of every layer — see the ``BlockPagedKVCache`` lora buffers),
and requests reference pool slots by per-request ``adapter_id``.  Slots
are ref-counted so concurrent requests of one tenant share a single
resident copy; a miss loads the tenant's factors from the host-side
:class:`AdapterStore` into the LRU evictable slot (only adapters no
running request references may be evicted).

:class:`AdapterPool` is pure host bookkeeping, a copy of the reference's:
``acquire`` returns which pool slot a tenant occupies and whether its
weights must be (re)loaded; ``release`` drops the reference when the
request frees its engine slot.  A released adapter stays resident and
warm (hit on re-acquire) until its slot is actually needed.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class AdapterPoolExhausted(RuntimeError):
    """Raised by :meth:`AdapterPool.acquire` when every pool slot is
    pinned by a running request (no free or evictable slot)."""


class AdapterPool:
    """Ref-counted LRU pool of device adapter slots, keyed by tenant id."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots))
        self._slot_of: Dict[int, int] = {}      # adapter_id -> pool slot
        self._id_of: Dict[int, int] = {}        # pool slot -> adapter_id
        self._ref: Dict[int, int] = {}          # adapter_id -> refcount
        self._last_used: Dict[int, int] = {}    # adapter_id -> LRU clock
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @property
    def n_resident(self) -> int:
        return len(self._slot_of)

    def refcount(self, adapter_id: int) -> int:
        return self._ref.get(adapter_id, 0)

    def slot_of(self, adapter_id: int) -> Optional[int]:
        """Pool slot of a resident adapter, else None."""
        return self._slot_of.get(adapter_id)

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)

    # ------------------------------------------------------------------
    def can_acquire(self, adapter_id: int) -> bool:
        """Would :meth:`acquire` succeed right now?  (Admission gate —
        a False here is backpressure, like KV-pool exhaustion.)"""
        if adapter_id in self._slot_of or self._free:
            return True
        return any(self._ref[a] == 0 for a in self._slot_of)

    def acquire(self, adapter_id: int) -> Tuple[int, bool]:
        """Pin ``adapter_id`` into the pool; returns ``(slot, loaded)``.

        ``loaded`` is True when the caller must copy the adapter's
        factors into device slot ``slot`` (miss / evicted victim);
        False means the tenant was already resident (hit).
        """
        slot = self._slot_of.get(adapter_id)
        if slot is not None:
            self._ref[adapter_id] += 1
            self._last_used[adapter_id] = self._tick()
            self.hits += 1
            return slot, False
        self.misses += 1
        if self._free:
            slot = self._free.pop(0)
        else:
            victims = [a for a in self._slot_of if self._ref[a] == 0]
            if not victims:
                raise AdapterPoolExhausted(
                    f"all {self.n_slots} adapter slots pinned by running "
                    f"requests")
            victim = min(victims, key=lambda a: self._last_used[a])
            slot = self._slot_of.pop(victim)
            del self._ref[victim]
            del self._last_used[victim]
            del self._id_of[slot]
            self.evictions += 1
        self._slot_of[adapter_id] = slot
        self._id_of[slot] = adapter_id
        self._ref[adapter_id] = 1
        self._last_used[adapter_id] = self._tick()
        return slot, True

    def release(self, adapter_id: int) -> None:
        """Drop one reference (request freed its engine slot).  The
        adapter stays resident — warm for the next acquire — until LRU
        eviction needs its slot."""
        ref = self._ref.get(adapter_id, 0)
        if ref <= 0:
            raise ValueError(f"release of unacquired adapter {adapter_id}")
        self._ref[adapter_id] = ref - 1


# ---------------------------------------------------------------------------
# host-side adapter store: deterministic per-tenant factors
# ---------------------------------------------------------------------------

#: projection factor names the engine's lora state buffers carry, in the
#: order the store emits them: q/k/v deltas hook in pre-RoPE, o on the
#: attention output (see ``repro_torch.engine.decode_loop``).
LORA_FACTORS = ("A_q", "B_q", "A_k", "B_k", "A_v", "B_v", "A_o", "B_o")

#: dtype of the factors, on the host and in the device adapter pool
LORA_DTYPE = torch.bfloat16

#: standard deviation of the B factors' entries (A's is rank**-0.5)
FACTOR_SCALE = 0.05


class AdapterStore:
    """Host-side store of per-tenant LoRA factors, materialized lazily.

    Tenant ``t`` gets rank ``ranks[t % len(ranks)]`` and deterministic
    factors drawn from ``np.random.default_rng((seed, adapter_id))`` in
    the reference's order, so the same seed gives the same factors in
    both packages (bit for bit after the round-to-nearest cast to bf16).
    Factors come back zero-padded to the pool-wide ``max_rank`` so mixed
    ranks share one device pool shape (padded lanes are exact zeros).
    """

    def __init__(self, cfg, n_tenants: int, ranks: Sequence[int], *,
                 seed: int = 0):
        if n_tenants < 1:
            raise ValueError(f"n_tenants must be >= 1, got {n_tenants}")
        ranks = tuple(int(r) for r in ranks)
        if not ranks or min(ranks) < 1:
            raise ValueError(f"ranks must be non-empty positive ints, "
                             f"got {ranks!r}")
        self.cfg = cfg
        self.n_tenants = n_tenants
        self.ranks = ranks
        self.max_rank = max(ranks)
        self.seed = seed

    def rank_of(self, adapter_id: int) -> int:
        if not 0 <= adapter_id < self.n_tenants:
            raise ValueError(f"adapter_id {adapter_id} outside tenant "
                             f"population [0, {self.n_tenants})")
        return self.ranks[adapter_id % len(self.ranks)]

    def _shapes(self):
        c = self.cfg
        d, H, Hk, hd = c.d_model, c.n_heads, c.n_kv_heads, c.head_dim
        return {"q": (d, H * hd), "k": (d, Hk * hd), "v": (d, Hk * hd),
                "o": (H * hd, d)}

    @functools.lru_cache(maxsize=256)
    def factors(self, adapter_id: int) -> Dict[str, torch.Tensor]:
        """Stacked, rank-padded factors of one tenant, on the host.

        Returns ``{name: tensor}`` over :data:`LORA_FACTORS` with shapes
        ``A_p: (L, k_p, max_rank)`` / ``B_p: (L, max_rank, n_p)``; lanes
        past the tenant's true rank are zero."""
        r = self.rank_of(adapter_id)
        R = self.max_rank
        L = self.cfg.n_layers
        rng = np.random.default_rng((self.seed, adapter_id))
        out = {}
        for name, (k, n) in self._shapes().items():
            a = np.zeros((L, k, R), np.float32)
            a[:, :, :r] = rng.standard_normal((L, k, r)) * r ** -0.5
            # non-trivial B so tenants actually differ from the base model
            b = np.zeros((L, R, n), np.float32)
            b[:, :r, :] = rng.standard_normal((L, r, n)) * FACTOR_SCALE
            out[f"A_{name}"] = torch.from_numpy(a).to(LORA_DTYPE)
            out[f"B_{name}"] = torch.from_numpy(b).to(LORA_DTYPE)
        return out

    def merged_params(self, params, adapter_id: int, scale: float = 1.0):
        """Params with this tenant's adapter merged into the attention
        projections (W' = W + scale·A@B in f32) — the single-adapter
        "merged path" the multi-tenant engine must token-match when every
        request shares one tenant."""
        c = self.cfg
        H, Hk, hd, d = c.n_heads, c.n_kv_heads, c.head_dim, c.d_model
        dev = params["embed"].device
        f = {k: v.float().to(dev) for k, v in self.factors(adapter_id).items()}
        attn = dict(params["layers"]["attn"])

        def add(w, a, b, shape):
            delta = scale * torch.einsum("lkr,lrn->lkn", a, b)
            return (w.float() + delta.reshape(shape)).to(w.dtype)

        L = c.n_layers
        attn["wq"] = add(attn["wq"], f["A_q"], f["B_q"], (L, d, H, hd))
        attn["wk"] = add(attn["wk"], f["A_k"], f["B_k"], (L, d, Hk, hd))
        attn["wv"] = add(attn["wv"], f["A_v"], f["B_v"], (L, d, Hk, hd))
        attn["wo"] = add(attn["wo"], f["A_o"], f["B_o"], (L, H, hd, d))
        layers = dict(params["layers"])
        layers["attn"] = attn
        out = dict(params)
        out["layers"] = layers
        return out


__all__ = ["AdapterPool", "AdapterPoolExhausted", "AdapterStore",
           "FACTOR_SCALE", "LORA_DTYPE", "LORA_FACTORS"]
