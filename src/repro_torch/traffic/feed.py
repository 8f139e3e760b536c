"""Open-loop feed helpers: trace → engine arrival gates and prompts.

The engine's admission gate is ``Request.arrival_step`` — a request may
not admit before that engine step.  :func:`arrival_steps` converts a
trace's arrival seconds into step gates via the engine's measured step
period (``Engine.calibrate_step_period``), which is what makes the feed
*open-loop*: arrivals are scheduled by the trace, not by completions.
When the engine is idle its steps burn almost no wall time, so the step
clock fast-forwards through quiet stretches instead of sleeping — the
queueing structure relative to serving work is preserved, and arrival
timestamps are stamped when each gate opens.

:func:`trace_prompts` materializes deterministic per-request token ids
for a trace (seeded, numpy-only), with an optional shared prefix so
prefix caching stays exercisable under traffic.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .arrivals import TrafficTrace


def arrival_steps(trace: TrafficTrace, step_period_s: float) -> List[int]:
    """Map each arrival time onto the engine step clock.

    ``step_period_s`` is the measured seconds per engine step (post
    -compile); arrivals quantize to ``ceil(arrival_s / period)`` so a
    request never admits *before* its scheduled time.
    """
    if step_period_s <= 0:
        raise ValueError(f"step_period_s must be > 0, got {step_period_s}")
    return [int(np.ceil(r.arrival_s / step_period_s - 1e-9))
            for r in trace.requests]


def trace_prompts(trace: TrafficTrace, vocab_size: int, *, seed: int = 0,
                  shared_prefix_len: int = 0) -> List[np.ndarray]:
    """Deterministic per-request prompt token ids for a trace.

    Each prompt is ``prompt_len`` random ids; the first
    ``min(shared_prefix_len, prompt_len - 1)`` tokens are shared across
    all requests (at least one unique token is kept so every admission
    computes logits), which keeps the radix prefix cache exercisable
    under traffic.
    """
    if vocab_size < 2:
        raise ValueError(f"vocab_size must be >= 2, got {vocab_size}")
    if shared_prefix_len < 0:
        raise ValueError(
            f"shared_prefix_len must be >= 0, got {shared_prefix_len}")
    rng = np.random.default_rng(seed)
    shared_max = max((r.prompt_len for r in trace.requests), default=0)
    shared = rng.integers(0, vocab_size, size=shared_max, dtype=np.int32)
    prompts = []
    for r in trace.requests:
        p = rng.integers(0, vocab_size, size=r.prompt_len, dtype=np.int32)
        k = min(shared_prefix_len, r.prompt_len - 1)
        if k > 0:
            p[:k] = shared[:k]
        prompts.append(p)
    return prompts
