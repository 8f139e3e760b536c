"""Draft-token proposers for speculative decoding.

The PyTorch counterpart of the JAX package's ``engine/drafter.py``.  A
drafter guesses the next ``k`` tokens of a request cheaply; the engine
verifies all k guesses (plus the pending token) in one batched
multi-query pass and accepts the longest matching prefix.

* ``NgramDrafter`` — self-speculative prompt lookup (a copy of the
  reference's): propose the tokens that followed the most recent previous
  occurrence of the request's trailing n-gram in its own history.
* ``DraftModelDrafter`` — a small separate architecture run greedily for
  k autoregressive steps through the port's own ``models.model.forward``.

Both return *exactly* ``k`` proposals (padded if the heuristic runs dry)
so the verify pass has a static shape.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .sampling import sample


class Drafter:
    """Interface: propose ``k`` draft tokens given a request's history."""

    #: analytical label: arch name for model drafters, None for free ones
    draft_arch = None

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        raise NotImplementedError

    def reset(self) -> None:
        """Called when the engine resets (new run); stateless by default."""


class NgramDrafter(Drafter):
    """Prompt-lookup decoding: match the trailing n-gram against the
    request's own history and propose the continuation that followed the
    most recent previous match.  Falls back to shorter n-grams, then to
    repeating the last token (still exactly k proposals)."""

    def __init__(self, n: int = 3):
        if n < 1:
            raise ValueError(f"n-gram order must be >= 1, got {n}")
        self.n = n

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = list(tokens)
        t = len(toks)
        for n in range(min(self.n, t - 1), 0, -1):
            tail = toks[t - n:]
            # rightmost previous occurrence (most recent context wins)
            for i in range(t - n - 1, -1, -1):
                if toks[i:i + n] == tail:
                    cont = toks[i + n:i + n + k]
                    if cont:
                        return (cont + [cont[-1]] * (k - len(cont)))[:k]
                    break
        pad = toks[-1] if toks else 0
        return [pad] * k


class DraftModelDrafter(Drafter):
    """Greedy k-step autoregressive draft with a small separate arch.

    Runs the full (non-paged) forward of ``repro_torch.models`` over the
    request's history per proposed token.  Forward lengths are padded to
    powers of two as in the reference (whose ``jit`` retraces once per
    bucket); causal attention keeps the padding out of the logits read at
    the last real position.
    """

    def __init__(self, cfg, params):
        self.cfg = cfg
        self.params = params
        self.draft_arch = cfg.name

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        from repro_torch.models.model import forward
        toks = list(tokens)
        dev = self.params["embed"].device
        out: List[int] = []
        for _ in range(k):
            t = len(toks)
            pad_t = 1 << (t - 1).bit_length() if t > 1 else 1
            ids = np.zeros((1, pad_t), dtype=np.int64)
            ids[0, :t] = toks
            with torch.no_grad():
                logits, _ = forward(self.cfg, self.params,
                                    torch.from_numpy(ids).to(dev))
            nxt = int(sample(logits[0, t - 1], 0.0,
                             vocab=self.cfg.vocab_size))
            out.append(nxt)
            toks.append(nxt)
        return out


def make_drafter(spec_draft_arch=None, *, ngram_n: int = 3, seed: int = 0,
                 reduce: bool = False, vocab_size=None,
                 device="cuda") -> Drafter:
    """Build the drafter for an engine run: prompt-lookup by default, a
    small draft model (the port's seeded ``init_params`` on ``device``)
    when an arch name is given.  ``reduce`` shrinks the draft arch the
    way the target is shrunk on the CPU (the vocabularies must agree for
    drafts to be target tokens at all)."""
    if spec_draft_arch is None:
        return NgramDrafter(n=ngram_n)
    from repro_torch import configs
    from repro_torch.models import init_params

    cfg = configs.get(spec_draft_arch)
    if reduce:
        over = {"vocab_size": vocab_size} if vocab_size else {}
        cfg = configs.reduced(cfg, **over)
    return DraftModelDrafter(cfg, init_params(cfg, seed, device=device))


__all__ = ["Drafter", "NgramDrafter", "DraftModelDrafter", "make_drafter"]
