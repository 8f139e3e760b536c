"""Block-paged KV cache for the continuous-batching engine.

KV storage is one global pool of ``n_blocks`` fixed-size blocks of
``block_size`` token positions, in preallocated buffers shaped

    (n_attn_layers, n_blocks, block_size, n_kv_heads, head_dim)

Each of ``max_slots`` concurrent requests owns a *block table* — a row of
physical block ids whose concatenation is the request's virtual KV
sequence — plus a write cursor ``pos``.  Blocks are ref-counted by the
host-side :class:`~.block_pool.BlockPool` (radix prefix caching,
copy-on-write on divergence).  int8 storage is a plain saturating cast
with no scale (paper §3.3.3).  With ``lora_slots > 0`` the state also
carries the device adapter pool of multi-tenant LoRA serving.

Where the reference donates the state through ``jit``, the port updates
the buffers in place: :meth:`reset_slot` and :meth:`copy_block` write into
the state's tensors and return the same dict.

On a mesh (``tp``, ``pp`` > 1) each rank allocates its own pool,
``(n_attn_layers/pp, n_blocks, block_size, n_kv_heads/tp, head_dim)``:
its stage's layers and its KV heads (the reference's named sharding of
the pool, as buffers of the rank's own, never views of a whole pool: the
kernels take contiguous caches).  Its LoRA pool keeps its stage's layers
and ``lora_max_rank/tp`` rank lanes: A's columns and B's rows.  Block
tables, cursors and tokens are whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig

from .adapter_pool import LORA_DTYPE
from .sampling import kv_torch_dtype


def engine_supported(cfg: ArchConfig) -> bool:
    """The engine serves homogeneous full-attention stacks (GQA/MHA/MQA)."""
    return (all(k == "attn" for k in cfg.block_kinds())
            and cfg.mla is None
            and not cfg.local_window
            and not cfg.n_encoder_layers)


def check_supported(cfg: ArchConfig) -> None:
    if not engine_supported(cfg):
        raise ValueError(
            f"engine does not support arch {cfg.name!r} "
            f"(family={cfg.family}, mla={cfg.mla is not None}, "
            f"local_window={cfg.local_window}); it is served by the "
            f"lockstep repro_torch.runtime.serve.Server")


@dataclasses.dataclass(frozen=True)
class BlockPagedKVCache:
    """Geometry + (de)allocation of the block-paged cache buffers.

    ``max_blocks_per_seq`` is the block-table width — the per-request
    virtual KV capacity is ``max_blocks_per_seq * block_size`` positions.
    """
    cfg: ArchConfig
    max_slots: int
    n_blocks: int
    block_size: int
    max_blocks_per_seq: int
    kv_dtype: str = "bf16"
    # multi-tenant LoRA geometry: when lora_slots > 0 the state carries a
    # device adapter pool — stacked rank-padded A/B factors for the four
    # attention projections of every layer (see .adapter_pool) — plus a
    # per-slot adapter pool-slot index (-1 = base model).
    lora_slots: int = 0
    lora_max_rank: int = 0
    # this rank's place on a mesh: tensor-parallel ways and index, pipeline
    # stages and stage (1, 0, 1, 0 on one device)
    tp: int = 1
    tp_rank: int = 0
    pp: int = 1
    stage: int = 0

    def __post_init__(self):
        check_supported(self.cfg)
        if min(self.max_slots, self.n_blocks, self.block_size,
               self.max_blocks_per_seq) < 1:
            raise ValueError("cache geometry fields must all be >= 1")
        if self.lora_slots > 0 and self.lora_max_rank < 1:
            raise ValueError("lora_slots > 0 requires lora_max_rank >= 1")
        if self.lora_slots > 0 and self.lora_max_rank % self.tp:
            # the reference's refusal: the pool's rank lanes split over tp
            raise ValueError(
                f"tensor-parallel grouped LoRA shards the rank axis: "
                f"tp={self.tp} must divide the padded pool rank "
                f"{self.lora_max_rank}")

    @property
    def max_len(self) -> int:
        """Virtual KV positions addressable by one request's table."""
        return self.max_blocks_per_seq * self.block_size

    @property
    def n_layers(self) -> int:
        """Layers of this rank's stage."""
        return self.cfg.n_layers // self.pp

    @property
    def lanes(self) -> int:
        """LoRA rank lanes this rank holds."""
        return self.lora_max_rank // self.tp

    def buffer_shape(self):
        c = self.cfg
        return (self.n_layers, self.n_blocks, self.block_size,
                c.n_kv_heads // self.tp, c.head_dim)

    def init_state(self, device="cuda") -> Dict[str, torch.Tensor]:
        """Fresh engine device state: empty block pool + per-slot tables."""
        dev = resolve_device(device)
        kvd = kv_torch_dtype(self.kv_dtype)
        shape = self.buffer_shape()
        state = {
            "cache_k": torch.zeros(shape, dtype=kvd, device=dev),
            "cache_v": torch.zeros(shape, dtype=kvd, device=dev),
            # per-slot block table: physical block id of each virtual page
            "block_tables": torch.zeros(
                (self.max_slots, self.max_blocks_per_seq), dtype=torch.int32,
                device=dev),
            # per-slot number of cached tokens (the slot's write cursor)
            "pos": torch.zeros((self.max_slots,), dtype=torch.int32,
                               device=dev),
            # last sampled token per slot (input to the next decode step)
            "tok": torch.zeros((self.max_slots,), dtype=torch.int32,
                               device=dev),
        }
        if self.lora_slots > 0:
            state.update(self._lora_buffers(dev))
            # adapter pool slot serving each engine slot (-1 = base model)
            state["adapter_slots"] = torch.full(
                (self.max_slots,), -1, dtype=torch.int32, device=dev)
        return state

    def _lora_buffers(self, dev) -> Dict[str, torch.Tensor]:
        """Device adapter pool: (L, lora_slots, k_p, R) / (L, lora_slots,
        R, n_p) per projection, rank-padded to ``lora_max_rank`` (on a
        mesh: the stage's layers and the rank's R/tp lanes)."""
        c = self.cfg
        L, P, R = self.n_layers, self.lora_slots, self.lanes
        d, H, Hk, hd = c.d_model, c.n_heads, c.n_kv_heads, c.head_dim
        dims = {"q": (d, H * hd), "k": (d, Hk * hd), "v": (d, Hk * hd),
                "o": (H * hd, d)}
        out = {}
        for name, (k, n) in dims.items():
            out[f"lora_A_{name}"] = torch.zeros(
                (L, P, k, R), dtype=LORA_DTYPE, device=dev)
            out[f"lora_B_{name}"] = torch.zeros(
                (L, P, R, n), dtype=LORA_DTYPE, device=dev)
        return out

    def shard_factor(self, name: str, f: torch.Tensor) -> torch.Tensor:
        """This rank's part of one tenant factor ``A_p (L, k, R)`` or
        ``B_p (L, R, n)`` (whole, as ``AdapterStore.factors`` gives it):
        its stage's layers and its rank lanes."""
        f = f.narrow(0, self.stage * self.n_layers, self.n_layers)
        lane_dim = 2 if name.startswith("A_") else 1
        return f.narrow(lane_dim, self.tp_rank * self.lanes, self.lanes)

    # ------------------------------------------------------------------
    # slot lifecycle (host-side, between engine steps)
    # ------------------------------------------------------------------
    def reset_slot(self, state: Dict[str, torch.Tensor], slot: int
                   ) -> Dict[str, torch.Tensor]:
        """Clear a slot's cursor for reuse.  O(1): stale KV entries are
        unreachable once ``pos == 0`` (block frees happen in the pool)."""
        state["pos"][slot] = 0
        state["tok"][slot] = 0
        if "adapter_slots" in state:
            state["adapter_slots"][slot] = -1
        return state

    def copy_block(self, state: Dict[str, torch.Tensor], src: int, dst: int
                   ) -> Dict[str, torch.Tensor]:
        """Copy-on-write fork: duplicate physical block ``src`` into the
        freshly allocated ``dst`` across all layers and both K/V buffers."""
        for c in ("cache_k", "cache_v"):
            state[c][:, dst] = state[c][:, src]
        return state

    def bytes_per_block(self) -> int:
        """Bytes of one block on this rank (its layers and KV heads)."""
        el = torch.empty((), dtype=kv_torch_dtype(self.kv_dtype)).element_size()
        _, _, bs, hk, hd = self.buffer_shape()
        return 2 * self.n_layers * bs * hk * hd * el

    def total_bytes(self) -> int:
        return self.n_blocks * self.bytes_per_block()
