"""Continuous-batching serving engine of the port.

Subsystem layout (each module the counterpart of the JAX package's):
    block_pool  — ref-counted global KV block pool + radix prefix index
    kv_cache    — block-paged KV cache buffers (block tables, int8
                  storage, COW block copy, slot reset)
    sampling    — KV dtype map, greedy/temperature sampling, saturating
                  int8 KV cast
    decode_loop — chunked-prefill admission + fused multi-token decode;
                  attention by gather ("gather") or through the CUDA paged
                  kernels ("paged", repro_torch.kernels.paged_attention)
    scheduler   — request queue, admission with prefix-cache hits and
                  block-pool backpressure, mid-flight completion,
                  per-request metrics, trace emission
"""
from .block_pool import BlockPool, PoolExhausted, RadixIndex
from .decode_loop import ATTN_IMPLS, make_engine_fns
from .kv_cache import BlockPagedKVCache, engine_supported
from .sampling import KV_DTYPES, kv_torch_dtype, sample, to_kv
from .scheduler import (Engine, EngineConfig, Request, RequestResult,
                        TraceEvent)

__all__ = [
    "BlockPool", "PoolExhausted", "RadixIndex", "ATTN_IMPLS",
    "make_engine_fns", "BlockPagedKVCache", "engine_supported", "KV_DTYPES",
    "kv_torch_dtype", "sample", "to_kv", "Engine", "EngineConfig",
    "Request", "RequestResult", "TraceEvent",
]
