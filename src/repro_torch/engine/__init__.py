"""Continuous-batching serving engine of the port.

Subsystem layout (each module the counterpart of the JAX package's):
    block_pool   — ref-counted global KV block pool + radix prefix index
    kv_cache     — block-paged KV cache buffers (block tables, int8
                   storage, COW block copy, slot reset, the LoRA adapter
                   pool buffers)
    sampling     — KV dtype map, greedy/temperature sampling, saturating
                   int8 KV cast
    decode_loop  — chunked-prefill admission, fused multi-token decode,
                   speculative verify and bucketed batched prefill;
                   attention by gather ("gather") or through the CUDA
                   kernels ("paged", repro_torch.kernels), grouped LoRA
                   deltas per slot
    drafter      — draft-token proposers for speculative decoding
    adapter_pool — ref-counted LRU adapter pool + seeded host adapter store
    scheduler    — request queue, admission with prefix-cache hits,
                   block-pool and adapter backpressure, bucketed groups,
                   speculative steps, mid-flight completion, per-request
                   metrics, trace emission
    forecast_twin — replays the scheduler trace through the analytical
                   WorkloadModel / Forecaster (a copy of the reference's)
"""
from .adapter_pool import (LORA_FACTORS, AdapterPool, AdapterPoolExhausted,
                           AdapterStore)
from .block_pool import BlockPool, PoolExhausted, RadixIndex
from .decode_loop import (ATTN_IMPLS, make_engine_fns, make_prefill_batch_fn,
                          make_verify_fn)
from .drafter import DraftModelDrafter, Drafter, NgramDrafter, make_drafter
from .kv_cache import BlockPagedKVCache, engine_supported
from .sampling import KV_DTYPES, kv_torch_dtype, sample, to_kv
from .scheduler import (Engine, EngineConfig, Request, RequestResult,
                        TraceEvent)
from .forecast_twin import (AUTO, ForecastTwin, RequestForecast,
                            TraceForecast, cold_trace, despeculate_trace,
                            replay_trace)

__all__ = [
    "LORA_FACTORS", "AdapterPool", "AdapterPoolExhausted", "AdapterStore",
    "BlockPool", "PoolExhausted", "RadixIndex", "ATTN_IMPLS",
    "make_engine_fns", "make_prefill_batch_fn", "make_verify_fn",
    "DraftModelDrafter", "Drafter", "NgramDrafter", "make_drafter",
    "BlockPagedKVCache", "engine_supported", "KV_DTYPES", "kv_torch_dtype",
    "sample", "to_kv", "Engine", "EngineConfig", "Request", "RequestResult",
    "TraceEvent", "AUTO", "ForecastTwin", "RequestForecast", "TraceForecast",
    "cold_trace", "despeculate_trace", "replay_trace",
]
