"""Lockstep serving: single-shot, whole-batch generation (the PyTorch
counterpart of the JAX package's ``runtime/serve.py``).

The continuous-batching engine (``repro_torch.engine``) serves
homogeneous full-attention stacks.  The families it does not serve —
SSM (Mamba), hybrid RG-LRU / local-attention, MLA latent caches and
encoder-decoders — generate here, and this server is also the numerical
reference the engine is held against.  It keeps the reference's serving
options: chunked prefill, a bf16 or int8 KV cache, greedy or temperature
sampling (the engine's ``sampling`` helpers).

It runs on one device, eagerly.  The reference's mesh, sharding policy
and jitted ``make_serve_fns`` belong to the multi-device slice (ROADMAP
queue 1, item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.engine.sampling import kv_torch_dtype, sample
from repro_torch.models import init_decode_state, step

__all__ = ["ServeConfig", "Server"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    max_len: int
    chunk_size: Optional[int] = None      # chunked prefill
    kv_dtype: str = "bf16"                # bf16 | int8 (KV compression)
    temperature: float = 0.0              # 0 = greedy


class Server:
    """Lockstep batched generation (a host-side loop over tokens): every
    sequence of the batch prefills and decodes together and finishes
    with the others.  For continuous traffic use
    ``repro_torch.engine.Engine``.

    ``device`` defaults to the card; without a GPU the constructor raises
    unless the caller passes ``device="cpu"``."""

    def __init__(self, cfg: ArchConfig, params: Dict, sc: ServeConfig, *,
                 device="cuda"):
        self.cfg, self.params, self.sc = cfg, params, sc
        self.device = resolve_device(device)

    def init_state(self) -> Dict:
        return init_decode_state(self.cfg, self.sc.batch, self.sc.max_len,
                                 kv_dtype=kv_torch_dtype(self.sc.kv_dtype),
                                 device=self.device)

    @torch.no_grad()
    def prefill(self, state: Dict, token_ids: torch.Tensor,
                extra: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """One prefill chunk; ``extra`` (a VLM's ``vision_embeds``, an
        encoder-decoder's ``frames``) goes with the first chunk only."""
        return step(self.cfg, self.params, token_ids, state, **(extra or {}))

    @torch.no_grad()
    def decode(self, state: Dict, token_ids: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict]:
        return step(self.cfg, self.params, token_ids, state)

    def generate(self, prompt_ids, n_new: int, extra: Optional[Dict] = None,
                 seed: int = 0) -> Tuple[torch.Tensor, Dict]:
        """prompt_ids: (batch, prompt_len).  Returns (tokens (batch, n_new)
        int64 on the device, {"final_pos": tokens cached})."""
        prompt_ids = torch.as_tensor(prompt_ids, device=self.device)
        state = self.init_state()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        chunk = self.sc.chunk_size or prompt_ids.shape[1]
        # chunked prefill: equal chunks reusing the cache
        logits = None
        for off in range(0, prompt_ids.shape[1], chunk):
            logits, state = self.prefill(state, prompt_ids[:, off:off + chunk],
                                         extra if off == 0 else None)
        tok = sample(logits, self.sc.temperature, gen)
        outs = [tok]
        for _ in range(n_new - 1):
            logits, state = self.decode(state, tok[:, None])
            tok = sample(logits, self.sc.temperature, gen)
            outs.append(tok)
        return torch.stack(outs, dim=1), {"final_pos": state["pos"]}
