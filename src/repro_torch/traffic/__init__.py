"""Traffic subsystem: stochastic arrivals, SLO metrics, goodput forecasts.

Production serving is not a static request list — it is a stochastic
arrival stream, and the operative question becomes "can hardware X serve
*this traffic* within SLO?".  This package makes that a forecastable
quantity on both sides of the measured-vs-forecast loop:

``arrivals``
    Seeded arrival-process generators (deterministic rate, Poisson,
    bursty ON/OFF) with configurable per-request prompt/generation
    length distributions, producing a :class:`TrafficTrace` of
    ``(arrival_s, prompt_len, gen_len)`` records with stable JSON/JSONL
    serialization (trace-file replay).
``feed``
    Open-loop feed helpers: convert arrival seconds into engine
    ``arrival_step`` gates via the measured step clock, and materialize
    deterministic per-request prompts for a trace.
``slo``
    SLO metrics over per-request timings: p50/p90/p99 TTFT (queue
    -inclusive and -exclusive) and TPOT, queue-depth-over-time, and
    goodput — the fraction of requests meeting a ``(ttft_slo,
    tpot_slo)`` pair.
``simulate``
    The analytical side: an open-loop queue simulation that mirrors the
    engine's admission/decode policy but advances a simulated clock with
    the ForecastTwin's per-step latencies, plus ``capacity_search`` —
    the bisection behind ``api.max_qps``.

Everything here is pure Python + numpy (no JAX): traces and SLO math
are importable anywhere, and the simulator takes any duck-typed step
-cost model.
"""
from .arrivals import (ARRIVAL_KINDS, LengthDist, TrafficRequest,
                       TrafficTrace, make_trace)
from .feed import arrival_steps, trace_prompts
from .simulate import TrafficForecast, capacity_search, simulate_traffic
from .slo import RequestTiming, TrafficStats, timings_from_results

__all__ = [
    "ARRIVAL_KINDS", "LengthDist", "TrafficRequest", "TrafficTrace",
    "make_trace", "arrival_steps", "trace_prompts", "TrafficForecast",
    "capacity_search", "simulate_traffic", "RequestTiming", "TrafficStats",
    "timings_from_results",
]
