"""SLO metrics over per-request serving timings.

Both sides of the measured-vs-forecast loop reduce to the same record —
``(arrival, admitted, first_token, finished, n_tokens)`` per request —
so the percentile/goodput math lives here once and the engine's
wall-clock results and the simulator's analytical clocks are summarized
identically.

Two TTFT flavors are first-class (the twin historically excluded queue
time while the engine included it — a like-with-like trap):

``ttft``         admission → first token (queue-exclusive: prefill cost)
``ttft_queued``  arrival → first token (queue-inclusive: what a user sees)

Goodput is the fraction of requests meeting a ``(ttft_slo, tpot_slo)``
pair, judged on ``ttft_queued`` (users wait in the queue too) and mean
TPOT.  A missing bound is treated as unbounded.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PERCENTILES = (50, 90, 99)


@dataclasses.dataclass(frozen=True)
class RequestTiming:
    """Minimal per-request record both sides can produce."""
    rid: int
    arrival: float
    admitted: float
    first_token: float
    finished: float
    n_tokens: int

    @property
    def ttft(self) -> float:
        return self.first_token - self.admitted

    @property
    def ttft_queued(self) -> float:
        return self.first_token - self.arrival

    @property
    def queue_time(self) -> float:
        return self.admitted - self.arrival

    @property
    def tpot(self) -> float:
        if self.n_tokens <= 1:
            return 0.0
        return (self.finished - self.first_token) / (self.n_tokens - 1)

    def meets(self, ttft_slo: Optional[float],
              tpot_slo: Optional[float]) -> bool:
        if ttft_slo is not None and self.ttft_queued > ttft_slo:
            return False
        if tpot_slo is not None and self.n_tokens > 1 \
                and self.tpot > tpot_slo:
            return False
        return True


def _summary(xs: Sequence[float]) -> Dict[str, float]:
    """mean/p50/p90/p99 of a sample (deterministic linear interpolation)."""
    if not xs:
        return {"mean": 0.0, **{f"p{q}": 0.0 for q in PERCENTILES}}
    a = np.asarray(xs, dtype=np.float64)
    out = {"mean": float(a.mean())}
    for q in PERCENTILES:
        out[f"p{q}"] = float(np.percentile(a, q))
    return out


@dataclasses.dataclass(frozen=True)
class TrafficStats:
    """SLO summary of one served (or simulated) trace."""
    n_requests: int
    duration_s: float                   # first arrival → last completion
    total_tokens: int
    tps: float                          # generated tokens / duration
    ttft: Dict[str, float]              # queue-exclusive summary
    ttft_queued: Dict[str, float]       # queue-inclusive summary
    tpot: Dict[str, float]
    queue_time: Dict[str, float]
    ttft_slo: Optional[float] = None
    tpot_slo: Optional[float] = None
    goodput: Optional[float] = None     # fraction meeting the SLO pair
    good_qps: Optional[float] = None    # goodput * realized completion rate
    queue_depth_mean: float = 0.0
    queue_depth_max: int = 0

    @classmethod
    def from_timings(cls, timings: Sequence[RequestTiming], *,
                     ttft_slo: Optional[float] = None,
                     tpot_slo: Optional[float] = None,
                     queue_depth: Sequence[Tuple[float, int]] = (),
                     ) -> "TrafficStats":
        ts = list(timings)
        if not ts:
            raise ValueError("no request timings to summarize")
        t0 = min(t.arrival for t in ts)
        t1 = max(t.finished for t in ts)
        dur = max(t1 - t0, 1e-12)
        tokens = sum(t.n_tokens for t in ts)
        goodput = good_qps = None
        if ttft_slo is not None or tpot_slo is not None:
            met = sum(t.meets(ttft_slo, tpot_slo) for t in ts)
            goodput = met / len(ts)
            good_qps = met / dur
        depths = [d for _, d in queue_depth]
        return cls(
            n_requests=len(ts), duration_s=dur, total_tokens=tokens,
            tps=tokens / dur,
            ttft=_summary([t.ttft for t in ts]),
            ttft_queued=_summary([t.ttft_queued for t in ts]),
            tpot=_summary([t.tpot for t in ts if t.n_tokens > 1]),
            queue_time=_summary([t.queue_time for t in ts]),
            ttft_slo=ttft_slo, tpot_slo=tpot_slo,
            goodput=goodput, good_qps=good_qps,
            queue_depth_mean=float(np.mean(depths)) if depths else 0.0,
            queue_depth_max=int(max(depths)) if depths else 0)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}


def timings_from_results(results: Sequence) -> List[RequestTiming]:
    """Adapt engine ``RequestResult`` / simulator records (duck-typed:
    ``rid/arrival/admitted/first_token/finished`` plus either ``tokens``
    or ``n_tokens``) into :class:`RequestTiming`."""
    out = []
    for r in results:
        n = len(r.tokens) if hasattr(r, "tokens") else r.n_tokens
        out.append(RequestTiming(
            rid=r.rid, arrival=r.arrival, admitted=r.admitted,
            first_token=r.first_token, finished=r.finished, n_tokens=n))
    return out
