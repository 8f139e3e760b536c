"""Lockstep serving: single-shot, whole-batch generation (the PyTorch
counterpart of the JAX package's ``runtime/serve.py``).

The continuous-batching engine (``repro_torch.engine``) serves
homogeneous full-attention stacks.  The families it does not serve —
SSM (Mamba), hybrid RG-LRU / local-attention, MLA latent caches and
encoder-decoders — generate here, and this server is also the numerical
reference the engine is held against.  It keeps the reference's serving
options: chunked prefill, a bf16 or int8 KV cache, greedy or temperature
sampling (the engine's ``sampling`` helpers).

On one device it runs eagerly.  On a mesh (``repro_torch.launch.mesh``,
one process per rank) each rank serves the same batch on its shard:
:func:`make_serve_fns` installs the mesh hint and the rank's params and
decode state are cut by ``runtime.sharding`` (the reference's
``spec_for`` rules and the port's overrides listed there); the model's
step runs the rank's heads and channels with one ``all_reduce`` after
each row-parallel product, and its pipeline stage's layers.  Every rank
ends a step with the same logits, so every rank samples the same token
from the same seeded generator.  Where the reference jits the two
functions with in/out shardings and donates the state, the port calls
the step eagerly and writes the state in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.engine.sampling import kv_torch_dtype, sample
from repro_torch.models import act_sharding, init_decode_state, step
from . import sharding as S

__all__ = ["ServeConfig", "Server", "make_serve_fns"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch: int
    max_len: int
    chunk_size: Optional[int] = None      # chunked prefill
    kv_dtype: str = "bf16"                # bf16 | int8 (KV compression)
    temperature: float = 0.0              # 0 = greedy


def make_serve_fns(cfg: ArchConfig, mesh, policy: S.ShardingPolicy,
                   sc: ServeConfig):
    """Returns ``(prefill_fn, decode_fn, {"params": specs, "state":
    specs})`` for this rank of ``mesh`` (None: one device):
    ``prefill_fn(params, state, token_ids, extra)`` and
    ``decode_fn(params, state, token_ids)`` run ``models.step`` (the state
    written in place), and the specs are what the rank holds of each
    parameter leaf and decode-state key (``sharding.rank_spec``; a dim
    of one rank stays whole).  Installs the mesh hint, as the
    reference's does."""
    act_sharding.set_mesh(mesh, policy.dp_axes, policy.tp_axis)

    @torch.no_grad()
    def prefill(params, state, token_ids, extra):
        return step(cfg, params, token_ids, state, **extra)

    @torch.no_grad()
    def decode(params, state, token_ids):
        return step(cfg, params, token_ids, state)

    return prefill, decode, S.rank_specs(cfg, sc.batch, sc.max_len, mesh,
                                         policy)


class Server:
    """Lockstep batched generation (a host-side loop over tokens): every
    sequence of the batch prefills and decodes together and finishes
    with the others.  For continuous traffic use
    ``repro_torch.engine.Engine``.

    ``params`` is the whole tree on one device, or on a ``mesh`` this
    rank's shard of it (``runtime.sharding.init_shard`` or
    ``bridge.shard_from_numpy``).  ``device`` defaults to the mesh's
    device, else the card; without a GPU the constructor raises unless
    the caller passes ``device="cpu"``."""

    def __init__(self, cfg: ArchConfig, params: Dict, sc: ServeConfig, *,
                 device=None, mesh=None,
                 policy: S.ShardingPolicy = S.ShardingPolicy()):
        self.cfg, self.params, self.sc = cfg, params, sc
        self.mesh, self.policy = mesh, policy
        self.device = resolve_device(
            device if device is not None
            else mesh.device if mesh is not None else "cuda")
        self.prefill_fn, self.decode_fn, self.shardings = make_serve_fns(
            cfg, mesh, policy, sc)

    def init_state(self) -> Dict:
        kv = kv_torch_dtype(self.sc.kv_dtype)
        if self.mesh is None:
            return init_decode_state(self.cfg, self.sc.batch,
                                     self.sc.max_len, kv_dtype=kv,
                                     device=self.device)
        return S.init_state_shard(self.cfg, self.sc.batch, self.sc.max_len,
                                  self.mesh, self.policy, kv_dtype=kv,
                                  device=self.device)

    def prefill(self, state: Dict, token_ids: torch.Tensor,
                extra: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """One prefill chunk; ``extra`` (a VLM's ``vision_embeds``, an
        encoder-decoder's ``frames``) goes with the first chunk only."""
        return self.prefill_fn(self.params, state, token_ids, extra or {})

    def decode(self, state: Dict, token_ids: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict]:
        return self.decode_fn(self.params, state, token_ids)

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
