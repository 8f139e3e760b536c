"""Analytical open-loop queue simulation of the serving engine.

Mirrors the engine's scheduling policy — FIFO admission into free KV
slots at step boundaries, chunked prefill (optionally bucket-batched),
fused decode blocks with per-step budget attrition, slots freed at block
end — but advances a *simulated* clock with a step-cost model's
latencies instead of executing anything.  Feed it the ForecastTwin and a
:class:`TrafficTrace` and "can hardware X serve this traffic within
SLO?" becomes a millisecond-scale analytical query.

The cost model is duck-typed; it needs::

    prefill_chunk_latency(chunk, past_len) -> seconds
    decode_step_latency(past_lens) -> seconds
    prefill_group_latency(((chunk, past_len), ...)) -> seconds
        (only when prefill_batch > 1)

which is exactly ``repro_torch.engine.forecast_twin.ForecastTwin``'s surface,
so this module stays JAX-free and unit-testable with stub costs.

:func:`capacity_search` is the bisection behind ``api.max_qps``: the
largest offered QPS whose simulated goodput still meets a target.  It
relies on the generator property that traces at different QPS from one
seed are time-scalings of the same request population (see
``traffic.arrivals``), which keeps the goodput-vs-QPS curve effectively
monotone and the search deterministic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from .arrivals import TrafficTrace
from .slo import RequestTiming

_EPS = 1e-12


@dataclasses.dataclass
class _SimRequest:
    rid: int
    arrival: float
    prompt_len: int
    gen_len: int
    cached: int = 0
    admitted: float = 0.0
    first_token: float = 0.0
    finished: float = 0.0
    n_tokens: int = 0
    past: int = 0                       # KV cursor once decoding
    remaining: int = 0                  # decode budget left


@dataclasses.dataclass
class TrafficForecast:
    """Simulated serving of one trace: per-request clocks + queue depth."""
    records: List[_SimRequest]
    queue_depth: List[Tuple[float, int]]
    total_time: float
    total_tokens: int
    prefill_time: float

    @property
    def tps(self) -> float:
        return self.total_tokens / max(self.total_time, 1e-30)

    def timings(self) -> List[RequestTiming]:
        return [RequestTiming(rid=r.rid, arrival=r.arrival,
                              admitted=r.admitted,
                              first_token=r.first_token,
                              finished=r.finished, n_tokens=r.n_tokens)
                for r in self.records]


def _suffix_chunks(plen: int, cached: int, chunk_size: int
                   ) -> List[Tuple[int, int]]:
    """(chunk, past_len) pairs of the cache-miss suffix's prefill."""
    out = []
    for off in range(cached, plen, chunk_size):
        out.append((min(chunk_size, plen - off), off))
    return out


def simulate_traffic(costs, trace: TrafficTrace, *, max_slots: int,
                     chunk_size: int, decode_block: int = 8,
                     prefill_batch: int = 1, cached_len: int = 0,
                     max_steps: int = 2_000_000) -> TrafficForecast:
    """Serve ``trace`` analytically under the engine's scheduling policy.

    ``cached_len`` models a shared prompt prefix already resident in the
    block pool: every request after the first admission is charged only
    its cache-miss suffix (clamped so at least one token is computed),
    mirroring the engine's radix-index admission.  ``prefill_batch > 1``
    enables bucketed batched admission: same-bucket FIFO runs (equal
    suffix chunk count) admit together and their chunk dispatches are
    priced as one batched pass via ``costs.prefill_group_latency``.
    """
    if max_slots < 1 or chunk_size < 1 or decode_block < 1:
        raise ValueError("max_slots, chunk_size and decode_block must "
                         "be >= 1")
    if prefill_batch < 1:
        raise ValueError(f"prefill_batch must be >= 1, got {prefill_batch}")
    pending = [
        _SimRequest(rid=r.rid, arrival=r.arrival_s, prompt_len=r.prompt_len,
                    gen_len=r.gen_len)
        for r in trace.requests]
    ready: List[_SimRequest] = []
    running: Dict[int, _SimRequest] = {}
    free = list(range(max_slots))
    records: List[_SimRequest] = []
    queue_depth: List[Tuple[float, int]] = []
    clock = 0.0
    prefill_time = 0.0
    total_tokens = 0
    first_admission = True
    p_i = 0                             # cursor into pending

    def bucket(r: _SimRequest) -> int:
        c = 0 if first_admission else min(cached_len, r.prompt_len - 1)
        return -(-(r.prompt_len - c) // chunk_size)

    steps = 0
    while p_i < len(pending) or ready or running:
        steps += 1
        if steps > max_steps:
            raise RuntimeError("traffic simulation did not drain")
        while p_i < len(pending) and pending[p_i].arrival <= clock + _EPS:
            ready.append(pending[p_i])
            p_i += 1
        if not ready and not running:
            clock = pending[p_i].arrival        # idle: jump to next arrival
            continue
        queue_depth.append((clock, len(ready)))
        # ---- admissions (FIFO, step-start arrivals only) ----
        while free and ready:
            cap = min(len(free), prefill_batch)
            group = [ready.pop(0)]
            key = bucket(group[0])
            while (len(group) < cap and ready
                   and bucket(ready[0]) == key):
                group.append(ready.pop(0))
            t_admit = clock
            member_chunks = []
            for m in group:
                m.cached = (0 if first_admission
                            else min(cached_len, m.prompt_len - 1))
                first_admission = False
                m.admitted = t_admit
                member_chunks.append(
                    _suffix_chunks(m.prompt_len, m.cached, chunk_size))
            n_chunks = max(len(cs) for cs in member_chunks)
            for ci in range(n_chunks):
                live = [(cs[ci], len(cs) - 1 == ci, m)
                        for cs, m in zip(member_chunks, group)
                        if ci < len(cs)]
                if len(live) == 1:
                    dt = costs.prefill_chunk_latency(*live[0][0])
                else:
                    dt = costs.prefill_group_latency(
                        tuple(cp for cp, _, _ in live))
                clock += dt
                prefill_time += dt
                for _, is_last, m in live:
                    if is_last:         # this dispatch yields m's first token
                        m.first_token = clock
                        m.n_tokens = 1
                        total_tokens += 1
            for m in group:
                records.append(m)
                m.past = m.prompt_len
                m.remaining = m.gen_len - 1
                if m.remaining == 0:
                    m.finished = m.first_token
                else:
                    running[free.pop(0)] = m
        # ---- one fused decode block over the active slots ----
        if running:
            for _ in range(decode_block):
                active = [m for m in running.values() if m.remaining > 0]
                if not active:
                    break
                clock += costs.decode_step_latency(
                    [m.past for m in active])
                for m in active:
                    m.n_tokens += 1
                    m.past += 1
                    m.remaining -= 1
                    total_tokens += 1
                    if m.remaining == 0:
                        m.finished = clock
            for slot, m in list(running.items()):
                if m.remaining == 0:
                    del running[slot]
                    free.append(slot)
            free.sort()
    records.sort(key=lambda m: m.rid)
    return TrafficForecast(records=records, queue_depth=queue_depth,
                           total_time=clock, total_tokens=total_tokens,
                           prefill_time=prefill_time)


def capacity_search(goodput_at: Callable[[float], float], *,
                    target: float = 0.99, qps_lo: float = 0.5,
                    qps_hi: Optional[float] = None, rel_tol: float = 0.02,
                    max_doublings: int = 24) -> float:
    """Largest offered QPS whose goodput meets ``target`` (bisection).

    ``goodput_at(qps)`` must be deterministic (seeded traces) and
    effectively non-increasing in QPS.  The bracket grows geometrically
    from ``qps_lo`` until goodput fails (or ``qps_hi`` caps it), then
    geometric bisection narrows to ``rel_tol``.  Returns 0.0 if even
    vanishing load misses the target, and the cap if it never fails.
    """
    if not 0.0 < target <= 1.0:
        raise ValueError(f"target must be in (0, 1], got {target}")
    if qps_lo <= 0:
        raise ValueError(f"qps_lo must be > 0, got {qps_lo}")
    lo = qps_lo
    while goodput_at(lo) < target:
        lo /= 2.0
        if lo < 1e-6:
            return 0.0
    if qps_hi is not None and qps_hi <= lo:
        return lo
    if qps_hi is not None and goodput_at(qps_hi) >= target:
        return qps_hi
    hi = qps_hi
    if hi is None:
        hi = lo * 2.0
        n = 0
        while goodput_at(hi) >= target:
            lo, hi = hi, hi * 2.0
            n += 1
            if n > max_doublings:
                return lo               # never saturates in range
    while hi / lo > 1.0 + rel_tol:
        mid = math.sqrt(lo * hi)
        if goodput_at(mid) >= target:
            lo = mid
        else:
            hi = mid
    return lo
