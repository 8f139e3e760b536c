"""Model FLOPs: the multiply-adds (two FLOPs each) of the model's own
work, from the configuration's widths and the work's token counts; no
padding, no recomputation, nothing a kernel does twice."""
from __future__ import annotations

from typing import Dict, Iterable

from portbench.counts.k6_fwd import attention_pairs
from portbench.weights import dims, param_count


def layer_matmul_params(conf: Dict) -> int:
    """Weights every token multiplies in one layer (q, k, v, o, gate, up,
    down)."""
    w = dims(conf)
    d, H, Hk, hd, f = w["d"], w["H"], w["Hk"], w["hd"], w["f"]
    return d * H * hd * 2 + d * Hk * hd * 2 + 3 * d * f


def train_flops(conf: Dict, batch: int, seq: int) -> float:
    """One training step: 6 * N per token, plus attention's forward and
    backward (3 x 4*b*H*hd per live causal pair) in every layer (a frozen
    copy of ``chip_smoke.py``'s ``train_flops`` for a dense model, N
    counted from the benchmark's own layout)."""
    w = dims(conf)
    pairs = attention_pairs(seq, seq, True, None, 0)
    return (6 * param_count(conf) * batch * seq
            + 12 * batch * w["H"] * w["hd"] * pairs * w["L"])


def serve_flops(conf: Dict, events: Iterable) -> float:
    """The model FLOPs of an engine's prefill chunks and decode blocks
    (its trace events): per prompt token the layers' products and its
    causal attention, one LM-head row per chunk (the engine's logits are
    the chunk's last); per decoded token of a live slot the same at its
    cursor, and its LM-head row."""
    w = dims(conf)
    L, H, hd, d, V = w["L"], w["H"], w["hd"], w["d"], w["V"]
    per_token = 2 * layer_matmul_params(conf) * L
    head = 2 * d * V
    total = 0.0
    for ev in events:
        if ev.kind == "prefill_chunk":
            pairs = attention_pairs(ev.chunk, ev.past_len + ev.chunk, True,
                                    None, ev.past_len)
            total += per_token * ev.chunk + 4 * H * hd * pairs * L + head
        elif ev.kind == "decode_block":
            for _, pos, budget in ev.slots:
                for i in range(min(budget, ev.n_steps)):
                    total += (per_token + head
                              + 4 * H * hd * (pos + i + 1) * L)
    return total
