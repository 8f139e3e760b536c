"""Deterministic synthetic data pipeline (the PyTorch counterpart of the
JAX package's ``data/pipeline.py``).

``batch(step)`` is a pure function of (seed, step), drawn with numpy
exactly as the reference draws it, so both packages see bit-identical
tokens and a restarted trainer regenerates the same stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    #: simulated document length for packing (0 = one doc per row)
    mean_doc_len: int = 0


class SyntheticTokens:
    """Zipf-ish token stream with optional document packing + EOS resets.

    ``batch`` returns int64 ``inputs`` / ``targets`` and f32 ``mask``
    tensors on ``device`` (default ``"cuda"``); a VLM's batch also holds
    bf16 ``vision_embeds`` (b, vision_prefix_len, d), and its text is
    ``seq_len - vision_prefix_len`` tokens long; an encoder-decoder's
    holds bf16 encoder ``frames`` (b, encoder_len, d)."""

    def __init__(self, cfg: ArchConfig, data: DataConfig, device="cuda"):
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(device)
        # Zipf ranks make the loss non-degenerate (learnable marginal)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    # -- pure function of step: resumable -------------------------------
    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        d, cfg = self.data, self.cfg
        rng = np.random.default_rng(np.uint64(d.seed * 1_000_003 + step))
        n_text = d.seq_len
        out: Dict[str, torch.Tensor] = {}
        as_t = lambda a: torch.from_numpy(a).to(self.device)
        if cfg.family == "vlm":
            n_text = d.seq_len - cfg.vision_prefix_len
            # drawn before the tokens, as the reference draws them; f64
            # -> f32 -> bf16, each rounding to nearest even
            ve = rng.standard_normal(
                (d.global_batch, cfg.vision_prefix_len, cfg.d_model))
            out["vision_embeds"] = as_t(ve.astype(np.float32)).to(
                torch.bfloat16)
        if cfg.family == "encdec":
            # after any vision embeds and before the tokens, as drawn by
            # the reference, rounded as the vision embeds are
            fr = rng.standard_normal(
                (d.global_batch, cfg.encoder_len, cfg.d_model))
            out["frames"] = as_t(fr.astype(np.float32)).to(torch.bfloat16)
        toks = rng.choice(cfg.vocab_size, p=self._probs,
                          size=(d.global_batch, n_text + 1)).astype(np.int32)
        mask = np.ones((d.global_batch, n_text), np.float32)
        if d.mean_doc_len:
            # document packing: EOS boundaries drop next-token targets
            boundaries = rng.random((d.global_batch, n_text)) < 1.0 / d.mean_doc_len
            mask[boundaries] = 0.0
        out.update(inputs=as_t(toks[:, :-1].astype(np.int64)),
                   targets=as_t(toks[:, 1:].astype(np.int64)),
                   mask=as_t(mask))
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
