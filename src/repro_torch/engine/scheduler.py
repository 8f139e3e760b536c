"""Continuous-batching scheduler: request queue -> slots -> engine steps.

The PyTorch counterpart of the JAX package's ``engine/scheduler.py`` on
its main path (tp = pp = 1, no speculation, no bucketed admission, no
LoRA tenants).  Each ``step`` admits queued prompts into free slots
(chunked prefill of the cache-miss suffix, radix prefix hits, copy-on-write
forks, pool backpressure) and then runs one fused multi-token decode
block over all active slots.  Every step appends a :class:`TraceEvent`,
copied field for field from the reference so a port trace replays through
the reference's analytical twin unchanged.

The host keeps a mirror of the slots' cursors (``pos``), updated from the
same quantities the device applies, so building a step's trace reads no
device memory; the device is synchronised once per admitted request (its
first token) and once per decode block (its tokens).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import DEFAULT_KV_BLOCK_SIZE
from repro_torch.configs.base import ArchConfig

from .block_pool import BlockPool, RadixIndex
from .decode_loop import ATTN_IMPLS, make_engine_fns
from .kv_cache import BlockPagedKVCache
from .sampling import sample


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int                      # concurrent requests
    max_len: int                        # max prompt+budget tokens per request
    chunk_size: int = 32                # chunked-prefill admission chunk
    decode_block: int = 8               # tokens per fused decode dispatch
    block_size: int = DEFAULT_KV_BLOCK_SIZE  # tokens per KV block (paging)
    n_blocks: Optional[int] = None      # pool size (default: slots worth)
    kv_dtype: str = "bf16"              # bf16 | int8 (KV compression §3.3.3)
    attn_impl: str = "gather"           # gather (plain) | paged (CUDA kernels)
    temperature: float = 0.0            # 0 = greedy
    eos_id: Optional[int] = None        # stop token (None: budget only)
    spec_k: int = 0                     # draft tokens/step (not ported yet)
    prefill_batch: int = 1              # bucketed admission (not ported yet)
    seed: int = 0
    lora_tenants: int = 0               # multi-tenant LoRA (not ported yet)

    def __post_init__(self):
        for name in ("max_slots", "max_len", "chunk_size", "decode_block",
                     "block_size", "prefill_batch"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if self.n_blocks is not None and self.n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1 when given, "
                             f"got {self.n_blocks}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                             f"got {self.attn_impl!r}")
        if self.lora_tenants < 0:
            raise ValueError(f"lora_tenants must be >= 0, "
                             f"got {self.lora_tenants}")

    @property
    def blocks_per_seq(self) -> int:
        return -(-self.max_len // self.block_size)

    @property
    def pool_blocks(self) -> int:
        if self.n_blocks is not None:
            return self.n_blocks
        return self.max_slots * self.blocks_per_seq


#: features of the reference engine that the port does not serve yet,
#: with the ROADMAP queue-1 item that ports each
_NOT_PORTED = (
    ("spec_k", lambda ec: ec.spec_k > 0,
     "speculative decoding (ROADMAP queue 1, item 8)"),
    ("prefill_batch", lambda ec: ec.prefill_batch > 1,
     "bucketed batched admission (ROADMAP queue 1, item 9)"),
    ("lora_tenants", lambda ec: ec.lora_tenants > 0,
     "multi-tenant LoRA serving (ROADMAP queue 1, item 10)"),
)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Sequence[int]               # token ids
    max_new: int                        # generation budget
    arrival_step: int = 0               # engine step at which it may admit

    def __post_init__(self):
        if len(self.prompt) == 0:
            raise ValueError(f"request {self.rid}: empty prompt")


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: List[int]                   # generated tokens (incl. first)
    prompt_len: int
    cached_tokens: int = 0              # prompt tokens served from the cache
    # measured wall-clock timestamps (s, engine-relative)
    arrival: float = 0.0
    admitted: float = 0.0               # prefill started (left the queue)
    first_token: float = 0.0            # TTFT reference point
    finished: float = 0.0

    @property
    def queue_time(self) -> float:
        return self.admitted - self.arrival

    @property
    def ttft(self) -> float:
        """Admission -> first token: the prefill cost, queue-exclusive."""
        return self.first_token - self.admitted

    @property
    def ttft_queued(self) -> float:
        """Arrival -> first token, queue-inclusive."""
        return self.first_token - self.arrival

    @property
    def tpot(self) -> float:
        """Mean seconds per output token after the first."""
        n = len(self.tokens)
        if n <= 1:
            return 0.0
        return (self.finished - self.first_token) / (n - 1)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One engine step, hardware-agnostic — the twin's replay unit.

    Copied field for field from the reference's ``TraceEvent`` (see its
    docstring for every kind); the port emits ``"engine"`` (the header),
    ``"prefill_chunk"`` and ``"decode_block"`` events.
    """
    kind: str
    rid: int = -1
    slot: int = -1
    chunk: int = 0
    past_len: int = 0
    cached: int = 0
    last: bool = False
    n_steps: int = 0
    slots: Tuple[Tuple[int, int, int], ...] = ()
    tp: int = 1
    pp: int = 1                         # header only (pipeline degree)
    attn_impl: str = ""                 # header only (twin replay default)
    block_size: int = 0                 # header only
    spec_k: int = 0                     # header + spec_step
    proposed: Tuple[int, ...] = ()      # spec_step: drafts verified per slot
    accepted: Tuple[int, ...] = ()      # spec_step: drafts accepted per slot
    # prefill_batch: (rid, slot, chunk, past_len, cached, last) per member
    members: Tuple[Tuple[int, int, int, int, int, bool], ...] = ()
    # multi-tenant LoRA: per-slot adapter rank (0 = base model)
    adapter_ranks: Tuple[int, ...] = ()
    lora_tenants: int = 0               # header only
    lora_ranks: Tuple[int, ...] = ()    # header only


@dataclasses.dataclass
class _Allocation:
    """Outcome of block accounting for one admission."""
    table: List[int]                    # physical block ids, virtual order
    cached: int                         # prompt tokens mapped from the index
    cow: Optional[Tuple[int, int]]      # (src, dst) partial-block fork


class Engine:
    """Continuous-batching serving engine over a block-paged KV cache."""

    def __init__(self, cfg: ArchConfig, params, ec: EngineConfig, *,
                 device="cuda"):
        for field, asked, what in _NOT_PORTED:
            if asked(ec):
                raise NotImplementedError(
                    f"EngineConfig.{field}={getattr(ec, field)!r}: {what} "
                    f"is not ported to repro_torch yet")
        if ec.chunk_size > ec.max_len:
            raise ValueError("chunk_size exceeds max_len")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.cfg, self.params, self.ec = cfg, params, ec
        self.tp = self.pp = 1
        self.cache = BlockPagedKVCache(
            cfg, ec.max_slots, n_blocks=ec.pool_blocks,
            block_size=ec.block_size,
            max_blocks_per_seq=ec.blocks_per_seq, kv_dtype=ec.kv_dtype)
        self.pool = BlockPool(ec.pool_blocks, ec.block_size)
        self.index = RadixIndex(self.pool)
        self.prefill_fn, self.decode_fn = make_engine_fns(
            cfg, self.cache, chunk_size=ec.chunk_size,
            decode_block=ec.decode_block, temperature=ec.temperature,
            eos_id=ec.eos_id, attn_impl=ec.attn_impl)
        self.state = self.cache.init_state(self.device)
        self._pos = np.zeros((ec.max_slots,), np.int64)  # host mirror
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ec.seed)
        self.queue: Deque[Request] = collections.deque()
        self.free_slots: List[int] = list(range(ec.max_slots))
        self.running: Dict[int, Request] = {}      # slot -> request
        self.results: Dict[int, RequestResult] = {}  # rid -> result
        self.trace: List[TraceEvent] = []
        self.step_idx = 0
        self._t0 = time.perf_counter()
        self._arrivals: Dict[int, Optional[float]] = {}
        # (step_idx, wall_s, arrived-but-waiting) sampled every step
        self.queue_depth: List[Tuple[int, float, int]] = []
        self._slot_blocks: Dict[int, List[int]] = {}   # slot -> owned refs
        # prefix-cache counters over the run
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        self.peak_blocks_in_use = 0

    # ------------------------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def submit(self, req: Request) -> None:
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1 "
                             f"(the first token comes from prefill)")
        if len(req.prompt) + req.max_new > self.ec.max_len:
            raise ValueError(
                f"request {req.rid}: prompt+budget "
                f"{len(req.prompt)}+{req.max_new} exceeds per-request "
                f"capacity {self.ec.max_len}")
        if self._blocks_needed(req) > self.pool.n_blocks:
            raise ValueError(
                f"request {req.rid}: needs {self._blocks_needed(req)} KV "
                f"blocks but the pool only has {self.pool.n_blocks}")
        self.queue.append(req)
        # a deferred request has not "arrived" until its step gate opens
        self._arrivals[req.rid] = (None if req.arrival_step > self.step_idx
                                   else self._now())

    @property
    def done(self) -> bool:
        return not self.queue and not self.running

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of offered prompt tokens served from shared blocks."""
        return self.prefix_hit_tokens / max(self.prompt_tokens, 1)

    # ------------------------------------------------------------------
    # block accounting: prefix match -> evict -> allocate (or stall)
    # ------------------------------------------------------------------
    def _blocks_needed(self, req: Request) -> int:
        # positions written: prompt plus all but the final sampled token
        bs = self.ec.block_size
        return -(-(len(req.prompt) + req.max_new - 1) // bs)

    def _allocate(self, req: Request) -> Optional[_Allocation]:
        """Map the request onto physical blocks, or None (backpressure).

        The longest indexed full-block prefix is mapped read-only; a hit
        that ends mid-block (capped at ``prompt_len - 1``) forks the
        partial block copy-on-write.  If the fork cannot get blocks, the
        hit is aligned down to full blocks and retried before stalling.
        """
        bs = self.ec.block_size
        prompt = [int(t) for t in req.prompt]
        hits = self.index.match(prompt)
        # at least one prompt token must be computed to produce logits
        cached = min(len(hits) * bs, len(prompt) - 1)
        alloc = self._try_allocate(req, hits, cached)
        if alloc is None and cached % bs:
            alloc = self._try_allocate(req, hits, (cached // bs) * bs)
        return alloc

    def _try_allocate(self, req: Request, hits: List[int], cached: int
                      ) -> Optional[_Allocation]:
        bs = self.ec.block_size
        keep, cow_src = hits[:cached // bs], None
        if cached % bs:
            cow_src = hits[cached // bs]
        for b in keep + ([cow_src] if cow_src is not None else []):
            self.pool.incref(b)      # pin against eviction while we build
        n_total = self._blocks_needed(req)
        n_new = n_total - len(keep)
        if self.pool.n_free < n_new:
            self.index.evict(n_new - self.pool.n_free)
        if self.pool.n_free < n_new:
            for b in keep + ([cow_src] if cow_src is not None else []):
                self.pool.decref(b)
            return None              # stall: wait for running requests
        fresh = [self.pool.alloc() for _ in range(n_new)]
        cow = None
        if cow_src is not None:
            cow = (cow_src, fresh[0])
            self.pool.decref(cow_src)   # only the fork is kept in the table
        return _Allocation(table=keep + fresh, cached=cached, cow=cow)

    # ------------------------------------------------------------------
    # admission: chunked prefill of the cache-miss suffix into one slot
    # ------------------------------------------------------------------
    def _admit(self, req: Request, slot: int, alloc: _Allocation) -> None:
        ec = self.ec
        prompt = np.asarray(req.prompt, np.int64)
        n, cached = len(prompt), alloc.cached
        self._slot_blocks[slot] = alloc.table
        self.prefix_hit_tokens += cached
        self.prompt_tokens += n
        if alloc.cow is not None:
            self.state = self.cache.copy_block(self.state, *alloc.cow)
        row = np.zeros((self.cache.max_blocks_per_seq,), np.int32)
        row[:len(alloc.table)] = alloc.table
        self.state["block_tables"][slot] = torch.from_numpy(row)
        self.state["pos"][slot] = cached
        self._pos[slot] = cached
        res = RequestResult(rid=req.rid, tokens=[], prompt_len=n,
                            cached_tokens=cached,
                            arrival=self._arrivals.get(req.rid) or 0.0,
                            admitted=self._now())
        logits = None
        for off in range(cached, n, ec.chunk_size):
            piece = prompt[off:off + ec.chunk_size]
            valid = len(piece)
            if valid < ec.chunk_size:
                piece = np.pad(piece, (0, ec.chunk_size - valid))
            last = off + valid >= n
            tokens = torch.from_numpy(piece[None]).to(self.device)
            logits, self.state = self.prefill_fn(
                self.params, self.state, tokens, slot, off, valid)
            self._pos[slot] += valid
            self.trace.append(TraceEvent(
                kind="prefill_chunk", rid=req.rid, slot=slot,
                chunk=valid, past_len=off, cached=cached, last=last,
                adapter_ranks=(0,)))
        # the prompt's full blocks are now populated and immutable:
        # publish them for future admissions (dedupe keeps first-comer)
        self.index.insert(prompt[:(n // ec.block_size) * ec.block_size],
                          alloc.table[:n // ec.block_size])
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.pool.in_use)
        # the request's first token is sampled from the final prefill logits
        first = int(sample(logits[None], ec.temperature, self._gen)[0])
        now = self._now()
        res.first_token = now
        res.tokens.append(first)
        self.state["tok"][slot] = first
        self.running[slot] = req
        self.results[req.rid] = res
        if req.max_new <= 1 or (ec.eos_id is not None and first == ec.eos_id):
            res.finished = now
            self._free(slot)

    def _free(self, slot: int) -> None:
        del self.running[slot]
        for b in self._slot_blocks.pop(slot):
            self.pool.decref(b)        # index refs keep shared blocks warm
        self.state = self.cache.reset_slot(self.state, slot)
        self._pos[slot] = 0
        self.free_slots.append(slot)

    # ------------------------------------------------------------------
    # one engine step: admissions, then one fused decode block
    # ------------------------------------------------------------------
    def step(self) -> None:
        ec = self.ec
        if not self.trace:
            # header: the engine knobs the twin's replay/cold_trace need
            self.trace.append(TraceEvent(kind="engine", chunk=ec.chunk_size,
                                         n_steps=ec.decode_block,
                                         tp=self.tp, pp=self.pp,
                                         attn_impl=ec.attn_impl,
                                         block_size=ec.block_size,
                                         spec_k=ec.spec_k,
                                         lora_tenants=ec.lora_tenants))
        # deferred (open-loop) requests arrive when their gate opens
        now = self._now()
        waiting = 0
        for r in self.queue:
            if r.arrival_step <= self.step_idx:
                waiting += 1
                if self._arrivals.get(r.rid) is None:
                    self._arrivals[r.rid] = now
        self.queue_depth.append((self.step_idx, now, waiting))
        while (self.free_slots and self.queue
               and self.queue[0].arrival_step <= self.step_idx):
            alloc = self._allocate(self.queue[0])
            if alloc is None:
                break                  # pool exhausted: admission backpressure
            self._admit(self.queue.popleft(), self.free_slots.pop(0), alloc)
        if self.running:
            slots_meta = []
            active = np.zeros((ec.max_slots,), bool)
            remaining = np.zeros((ec.max_slots,), np.int32)
            for slot, req in sorted(self.running.items()):
                budget = req.max_new - len(self.results[req.rid].tokens)
                slots_meta.append((req.rid, int(self._pos[slot]), budget))
                active[slot] = True
                remaining[slot] = budget
            toks, produced, _, self.state = self.decode_fn(
                self.params, self.state, active, remaining, self._gen)
            toks, produced = toks.cpu().numpy(), produced.cpu().numpy()
            self._pos += produced.sum(axis=0)
            self.trace.append(TraceEvent(
                kind="decode_block", n_steps=ec.decode_block,
                slots=tuple(slots_meta),
                adapter_ranks=(0,) * len(slots_meta)))
            self._harvest(toks, produced)
        self.step_idx += 1

    def _harvest(self, toks: np.ndarray, produced: np.ndarray) -> None:
        """Collect the block's sampled tokens; free completed slots."""
        now = self._now()
        for slot, req in list(self.running.items()):
            res = self.results[req.rid]
            for t in range(toks.shape[0]):
                if not produced[t, slot]:
                    break
                res.tokens.append(int(toks[t, slot]))
            hit_eos = (self.ec.eos_id is not None and res.tokens
                       and res.tokens[-1] == self.ec.eos_id)
            if len(res.tokens) >= req.max_new or hit_eos:
                res.finished = now
                self._free(slot)

    # ------------------------------------------------------------------
    def run(self, requests: Optional[Sequence[Request]] = None,
            max_steps: int = 100_000) -> List[RequestResult]:
        """Drain the queue (plus ``requests``) to completion."""
        for r in requests or ():
            self.submit(r)
        steps = 0
        while not self.done:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("engine did not drain (scheduler stuck?)")
        return [self.results[rid] for rid in sorted(self.results)]

    # ------------------------------------------------------------------
    def reset_metrics(self) -> None:
        """Clear results/trace/clock while keeping the cache blocks and the
        prefix index — call after a warm-up run so measured wall-clock
        excludes one-time costs (kernel build, allocator growth)."""
        if not self.done:
            raise RuntimeError("reset_metrics with requests in flight")
        self.results.clear()
        self.trace.clear()
        self._arrivals.clear()
        self.queue_depth.clear()
        self.step_idx = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        self.peak_blocks_in_use = 0
        self._t0 = time.perf_counter()

    def warmup(self) -> None:
        """Run prefill + decode once with a throwaway request."""
        prompt_len = min(self.ec.chunk_size,
                         self.ec.max_len - self.ec.decode_block - 2)
        self.run([Request(rid=-1, prompt=[0] * max(prompt_len, 1),
                          max_new=self.ec.decode_block + 1)])
        # drop the throwaway prompt's index entries so the measured run
        # starts with a cold cache and an empty pool
        self.index.evict(self.pool.n_blocks)
        self.reset_metrics()

    def aggregate_tps(self) -> float:
        """Measured generated-tokens/s over the whole run."""
        finished = [r for r in self.results.values() if r.finished > 0]
        if not finished:
            return 0.0
        total = sum(len(r.tokens) for r in finished)
        span = max(r.finished for r in finished)
        return total / max(span, 1e-9)
