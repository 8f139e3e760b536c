"""Continuous-batching scheduler: request queue -> slots -> engine steps.

The PyTorch counterpart of the JAX package's ``engine/scheduler.py``.
Each ``step`` admits queued prompts into free slots
(chunked prefill of the cache-miss suffix, radix prefix hits, copy-on-write
forks, pool and adapter backpressure; with ``prefill_batch > 1`` one
batched dispatch per chunk index over a same-bucket group) and then runs
one fused multi-token decode block over all active slots, or with
``spec_k > 0`` one speculative draft-verify-accept step.  Requests may
carry a LoRA tenant (``adapter_id``), served from a device adapter pool.
Every step appends a :class:`TraceEvent`, copied field for field from the
reference so a port trace replays through the reference's analytical
twin unchanged.

The host keeps a mirror of the slots' cursors (``pos``), updated from the
same quantities the device applies (a prefill chunk's or a batched
member's ``valid``, a decode block's produced tokens, a speculative
step's emitted tokens), so building a step's trace reads no device
memory; the device is synchronised once per admission (the first tokens),
once per decode block and once per speculative step (the logits).

On a mesh (``Engine(..., mesh=..., policy=...)``, inside a rank started
by ``repro_torch.launch.mesh.spawn``) every rank runs this same host
scheduler on the same tokens (the step functions give every rank the
same logits and tokens), so admissions, prefix hits, copy-on-write forks
and adapter loads agree on every rank and the ranks' collectives stay in
step; each rank holds its shard of the weights, of the block pool and of
the adapter pool.  ``tp``/``pp`` come from the mesh and the trace's
header carries them; a sharded run returns rank 0's results to its
caller (``repro_torch.launch.mesh.spawn``, ``api.measure``).
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
from repro_torch.runtime.sharding import ShardingPolicy, pp_degree, tp_degree

from .adapter_pool import LORA_FACTORS, AdapterPool, AdapterStore
from .block_pool import BlockPool, RadixIndex
from .decode_loop import (ATTN_IMPLS, _check_impl_and_plan, make_engine_fns,
                          make_prefill_batch_fn, make_verify_fn)
from .drafter import make_drafter
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
    prefix_cache: bool = True           # radix prefix caching across requests
    kv_dtype: str = "bf16"              # bf16 | int8 (KV compression §3.3.3)
    attn_impl: str = "gather"           # gather (plain) | paged (CUDA kernels)
    temperature: float = 0.0            # 0 = greedy
    eos_id: Optional[int] = None        # stop token (None: budget only)
    spec_k: int = 0                     # draft tokens/step (0 = no speculation)
    prefill_batch: int = 1              # bucketed batched admission (1 = off)
    seed: int = 0
    # multi-tenant LoRA serving: > 0 enables the device adapter pool;
    # tenant t gets rank lora_ranks[t % len(lora_ranks)].  lora_slots
    # bounds concurrently resident adapters (default: one per engine
    # slot; smaller values exercise LRU eviction and backpressure).
    lora_tenants: int = 0
    lora_ranks: Tuple[int, ...] = ()
    lora_slots: Optional[int] = None

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
        object.__setattr__(self, "lora_ranks",
                           tuple(int(r) for r in self.lora_ranks))
        if self.lora_tenants > 0 and not self.lora_ranks:
            object.__setattr__(self, "lora_ranks", (8,))
        if self.lora_ranks and min(self.lora_ranks) < 1:
            raise ValueError(f"lora_ranks must all be >= 1, "
                             f"got {self.lora_ranks}")
        if self.lora_slots is not None and self.lora_slots < 1:
            raise ValueError(f"lora_slots must be >= 1 when given, "
                             f"got {self.lora_slots}")

    @property
    def adapter_pool_slots(self) -> int:
        """Device adapter-pool size (0 when multi-tenant LoRA is off)."""
        if self.lora_tenants <= 0:
            return 0
        if self.lora_slots is not None:
            return self.lora_slots
        return min(self.max_slots, self.lora_tenants)

    @property
    def blocks_per_seq(self) -> int:
        return -(-self.max_len // self.block_size)

    @property
    def pool_blocks(self) -> int:
        if self.n_blocks is not None:
            return self.n_blocks
        return self.max_slots * self.blocks_per_seq


@dataclasses.dataclass
class Request:
    rid: int
    prompt: Sequence[int]               # token ids
    max_new: int                        # generation budget
    arrival_step: int = 0               # engine step at which it may admit
    adapter_id: Optional[int] = None    # LoRA tenant (None = base model)

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
    docstring for every kind): ``"engine"`` (the header),
    ``"prefill_chunk"``, ``"prefill_batch"``, ``"decode_block"`` and
    ``"spec_step"`` events.
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
                 device="cuda", drafter=None, mesh=None,
                 policy: Optional[ShardingPolicy] = None):
        """``params`` is the whole tree, or on a ``mesh`` (the reference's
        ``Engine(cfg, params, mesh, policy, ec)``) this rank's shard of it
        (``repro_torch.runtime.sharding``); the engine then runs on the
        mesh's device."""
        if ec.chunk_size > ec.max_len:
            raise ValueError("chunk_size exceeds max_len")
        policy = policy if policy is not None else ShardingPolicy()
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        self.cfg, self.params, self.ec = cfg, params, ec
        self.mesh, self.policy = mesh, policy
        _check_impl_and_plan(cfg, mesh, policy, ec.attn_impl)
        self.tp = tp_degree(mesh, policy)
        self.pp = pp_degree(mesh, policy)
        self.adapter_store = self.adapter_pool = None
        if ec.lora_tenants > 0:
            self.adapter_store = AdapterStore(
                cfg, ec.lora_tenants, ec.lora_ranks, seed=ec.seed)
            self.adapter_pool = AdapterPool(ec.adapter_pool_slots)
        self.cache = BlockPagedKVCache(
            cfg, ec.max_slots, n_blocks=ec.pool_blocks,
            block_size=ec.block_size,
            max_blocks_per_seq=ec.blocks_per_seq, kv_dtype=ec.kv_dtype,
            lora_slots=ec.adapter_pool_slots,
            lora_max_rank=(self.adapter_store.max_rank
                           if self.adapter_store else 0),
            tp=self.tp, pp=self.pp,
            tp_rank=mesh.coords[policy.tp_axis] if self.tp > 1 else 0,
            stage=mesh.coords[policy.pp_axis] if self.pp > 1 else 0)
        plan = dict(attn_impl=ec.attn_impl, mesh=mesh, policy=policy)
        self.pool = BlockPool(ec.pool_blocks, ec.block_size)
        self.index = RadixIndex(self.pool) if ec.prefix_cache else None
        self.prefill_fn, self.decode_fn = make_engine_fns(
            cfg, self.cache, chunk_size=ec.chunk_size,
            decode_block=ec.decode_block, temperature=ec.temperature,
            eos_id=ec.eos_id, **plan)
        self.verify_fn = self.drafter = None
        if ec.spec_k > 0:
            self.verify_fn = make_verify_fn(cfg, self.cache, **plan)
            self.drafter = drafter if drafter is not None else make_drafter()
        self.prefill_batch_fn = None
        if ec.prefill_batch > 1:
            self.prefill_batch_fn = make_prefill_batch_fn(
                cfg, self.cache, **plan)
        # speculative acceptance draws: the reference's generator, so the
        # same logits accept the same drafts at temperature > 0
        self._np_rng = np.random.default_rng(ec.seed + 1)
        # speculative-decoding counters over the run
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_steps = 0
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
        self.step_period: Optional[float] = None
        self._slot_blocks: Dict[int, List[int]] = {}   # slot -> owned refs
        self._slot_adapter: Dict[int, int] = {}        # slot -> adapter_id
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
        if req.adapter_id is not None:
            if self.adapter_store is None:
                raise ValueError(
                    f"request {req.rid}: adapter_id={req.adapter_id} but "
                    f"the engine has no tenants (EngineConfig.lora_tenants)")
            self.adapter_store.rank_of(req.adapter_id)  # range check
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
        hits = self.index.match(prompt) if self.index is not None else []
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
        if self.pool.n_free < n_new and self.index is not None:
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
    # multi-tenant LoRA: adapter residency around admission
    # ------------------------------------------------------------------
    def _adapter_admissible(self, req: Request) -> bool:
        """Admission gate: can the request's adapter be pinned now?
        False is backpressure, exactly like KV-pool exhaustion."""
        if self.adapter_pool is None or req.adapter_id is None:
            return True
        return self.adapter_pool.can_acquire(req.adapter_id)

    def _bind_adapter(self, req: Request, slot: int) -> None:
        """Pin the request's adapter and point its engine slot at the
        adapter's pool slot; on a pool miss, copy the tenant's eight
        factors from the host store into the (LRU-evicted) pool slot, in
        place."""
        if self.adapter_pool is None or req.adapter_id is None:
            return
        pslot, loaded = self.adapter_pool.acquire(req.adapter_id)
        if loaded:
            factors = self.adapter_store.factors(req.adapter_id)
            for name in LORA_FACTORS:
                self.state["lora_" + name][:, pslot].copy_(
                    self.cache.shard_factor(name, factors[name]))
        self.state["adapter_slots"][slot] = pslot
        self._slot_adapter[slot] = req.adapter_id

    def _slot_rank(self, slot: int) -> int:
        """Adapter rank slot ``slot`` decodes with (0 = base model)."""
        aid = self._slot_adapter.get(slot)
        return 0 if aid is None else self.adapter_store.rank_of(aid)

    @property
    def adapter_hit_rate(self) -> float:
        """Adapter-pool hit rate over the run (1.0 when LoRA is off)."""
        return 1.0 if self.adapter_pool is None else (
            self.adapter_pool.hit_rate)

    # ------------------------------------------------------------------
    # admission: chunked prefill of the cache-miss suffix into one slot
    # ------------------------------------------------------------------
    def _place(self, req: Request, slot: int, alloc: _Allocation
               ) -> RequestResult:
        """Block table, cursor and adapter of an admitted request."""
        self._slot_blocks[slot] = alloc.table
        self.prefix_hit_tokens += alloc.cached
        self.prompt_tokens += len(req.prompt)
        if alloc.cow is not None:
            self.state = self.cache.copy_block(self.state, *alloc.cow)
        row = np.zeros((self.cache.max_blocks_per_seq,), np.int32)
        row[:len(alloc.table)] = alloc.table
        self.state["block_tables"][slot] = torch.from_numpy(row)
        self.state["pos"][slot] = alloc.cached
        self._pos[slot] = alloc.cached
        self._bind_adapter(req, slot)
        return RequestResult(rid=req.rid, tokens=[],
                             prompt_len=len(req.prompt),
                             cached_tokens=alloc.cached,
                             arrival=self._arrivals.get(req.rid) or 0.0,
                             admitted=self._now())

    def _publish(self, prompt: np.ndarray, table: List[int]) -> None:
        """The prompt's full blocks are now populated and immutable:
        index them for future admissions (dedupe keeps first-comer)."""
        if self.index is not None:
            n, bs = len(prompt), self.ec.block_size
            self.index.insert(prompt[:(n // bs) * bs], table[:n // bs])

    def _start(self, req: Request, slot: int, res: RequestResult,
               logits: torch.Tensor, now: float) -> None:
        """Sample the request's first token from its final prefill logits
        and start decoding it (or finish it at once)."""
        ec = self.ec
        first = sample(logits[None], ec.temperature, self._gen)
        if self.pp > 1:
            # only the last stage samples decode steps, so only its
            # generator is the run's: its first token is everyone's
            first = self.mesh.from_last_stage(first.to(torch.int32))
        first = int(first[0])
        res.first_token = now
        res.tokens.append(first)
        self.state["tok"][slot] = first
        self.running[slot] = req
        self.results[req.rid] = res
        if req.max_new <= 1 or (ec.eos_id is not None and first == ec.eos_id):
            res.finished = now
            self._free(slot)

    def _admit(self, req: Request, slot: int, alloc: _Allocation) -> None:
        ec = self.ec
        prompt = np.asarray(req.prompt, np.int64)
        n, cached = len(prompt), alloc.cached
        res = self._place(req, slot, alloc)
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
                adapter_ranks=(self._slot_rank(slot),)))
        self._publish(prompt, alloc.table)
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.pool.in_use)
        self._start(req, slot, res, logits, self._now())

    # ------------------------------------------------------------------
    # bucketed batched admission: same-bucket FIFO runs prefill together
    # ------------------------------------------------------------------
    def _bucket_chunks(self, req: Request) -> int:
        """Prefill-length bucket: chunk count of the cache-miss suffix.

        A *preview* using the current index state (allocation may later
        align the hit down under pool pressure; the batched dispatch pads
        ragged members, so a rare mismatch only costs padding)."""
        n = len(req.prompt)
        cached = 0
        if self.index is not None:
            hits = self.index.match([int(t) for t in req.prompt])
            cached = min(len(hits) * self.ec.block_size, n - 1)
        return -(-(n - cached) // self.ec.chunk_size)

    def _take_bucket_group(self) -> List[Tuple[Request, int, _Allocation]]:
        """Pop the maximal same-bucket FIFO run that can admit now.

        Only the contiguous queue head is considered (no skipping, so
        bucketing never starves a request), capped by free slots and
        ``prefill_batch``.  Returns [] if even the head cannot allocate
        blocks (backpressure)."""
        group: List[Tuple[Request, int, _Allocation]] = []
        key = self._bucket_chunks(self.queue[0])
        cap = min(len(self.free_slots), self.ec.prefill_batch)
        while (len(group) < cap and self.queue
               and self.queue[0].arrival_step <= self.step_idx
               and self._bucket_chunks(self.queue[0]) == key):
            if not self._adapter_admissible(self.queue[0]):
                break
            alloc = self._allocate(self.queue[0])
            if alloc is None:
                break
            group.append((self.queue.popleft(), self.free_slots.pop(0),
                          alloc))
        return group

    def _admit_batch(self,
                     group: List[Tuple[Request, int, _Allocation]]) -> None:
        """Admit a same-bucket group with batched prefill-and-insert.

        Per-request block accounting and bookkeeping mirror
        :meth:`_admit`; the prefill chunks run as ONE batched dispatch
        per chunk index across the group, padded to ``prefill_batch``
        members with duplicates of the first member's slot (``valid=0``).
        Each member's first token is sampled from its own logits row of
        its final chunk's dispatch, in queue order, so at temperature 0
        the admitted tokens equal unbucketed admission's."""
        ec = self.ec
        pb = ec.prefill_batch
        members = []                    # [req, slot, prompt, cached, res]
        for req, slot, alloc in group:
            res = self._place(req, slot, alloc)
            members.append([req, slot, np.asarray(req.prompt, np.int64),
                            alloc.cached, res])
        n_chunks = max(-(-(len(p) - c) // ec.chunk_size)
                       for _, _, p, c, _ in members)
        first_logits: List[Optional[torch.Tensor]] = [None] * len(members)
        for ci in range(n_chunks):
            qtoks = np.zeros((pb, ec.chunk_size), np.int64)
            slots_arr = np.full((pb,), members[0][1], np.int64)
            valids = np.zeros((pb,), np.int64)
            ev_members, ev_ranks = [], []
            for i, (req, slot, prompt, cached, res) in enumerate(members):
                slots_arr[i] = slot
                off = cached + ci * ec.chunk_size
                n = len(prompt)
                if off >= n:
                    continue            # ragged member: already done
                piece = prompt[off:off + ec.chunk_size]
                valids[i] = len(piece)
                qtoks[i, :len(piece)] = piece
                ev_members.append((req.rid, slot, len(piece), off, cached,
                                   off + len(piece) >= n))
                ev_ranks.append(self._slot_rank(slot))
            logits, self.state = self.prefill_batch_fn(
                self.params, self.state, qtoks, slots_arr, valids)
            for i, (req, slot, prompt, cached, res) in enumerate(members):
                off = cached + ci * ec.chunk_size
                if off < len(prompt) and off + valids[i] >= len(prompt):
                    first_logits[i] = logits[i]
                self._pos[slot] += valids[i]
            self.trace.append(TraceEvent(kind="prefill_batch",
                                         chunk=ec.chunk_size,
                                         members=tuple(ev_members),
                                         adapter_ranks=tuple(ev_ranks)))
        now = self._now()
        for i, (req, slot, prompt, cached, res) in enumerate(members):
            self._publish(prompt, self._slot_blocks[slot])
            self._start(req, slot, res, first_logits[i], now)
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.pool.in_use)

    def _free(self, slot: int) -> None:
        del self.running[slot]
        for b in self._slot_blocks.pop(slot):
            self.pool.decref(b)        # index refs keep shared blocks warm
        aid = self._slot_adapter.pop(slot, None)
        if aid is not None:
            # the adapter stays resident (warm for the tenant's next
            # request) until pool pressure LRU-evicts it
            self.adapter_pool.release(aid)
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
                                         lora_tenants=ec.lora_tenants,
                                         lora_ranks=ec.lora_ranks))
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
            if not self._adapter_admissible(self.queue[0]):
                break                  # all adapter slots pinned: backpressure
            if ec.prefill_batch > 1:
                group = self._take_bucket_group()
                if not group:
                    break              # pool exhausted: admission backpressure
                self._admit_batch(group)
                continue
            alloc = self._allocate(self.queue[0])
            if alloc is None:
                break                  # pool exhausted: admission backpressure
            self._admit(self.queue.popleft(), self.free_slots.pop(0), alloc)
        if self.running and ec.spec_k > 0:
            self._spec_step()
        elif self.running:
            slots_meta, slot_ranks = [], []
            active = np.zeros((ec.max_slots,), bool)
            remaining = np.zeros((ec.max_slots,), np.int32)
            for slot, req in sorted(self.running.items()):
                budget = req.max_new - len(self.results[req.rid].tokens)
                slots_meta.append((req.rid, int(self._pos[slot]), budget))
                slot_ranks.append(self._slot_rank(slot))
                active[slot] = True
                remaining[slot] = budget
            toks, produced, _, self.state = self.decode_fn(
                self.params, self.state, active, remaining, self._gen)
            toks, produced = toks.cpu().numpy(), produced.cpu().numpy()
            self._pos += produced.sum(axis=0)
            self.trace.append(TraceEvent(
                kind="decode_block", n_steps=ec.decode_block,
                slots=tuple(slots_meta), adapter_ranks=tuple(slot_ranks)))
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
    # speculative decoding: draft k, verify k+1 queries, accept a prefix
    # ------------------------------------------------------------------
    def _spec_step(self) -> None:
        """One speculative step: per active slot, propose ``spec_k`` draft
        tokens from the request's own history, verify the pending token
        plus the drafts in ONE batched (k+1)-query pass through the
        block-paged cache, then accept a prefix by rejection sampling.

        The KV cursor only rolls *forward* by the emitted count: the
        rejected tail's K/V stays in the slot's own blocks, causally
        unreachable and overwritten by the next step.  Per-slot
        ``valid_q = 1 + min(k, budget-1)`` caps speculation at the
        generation budget, so no query past the allocated
        ``prompt + max_new - 1`` positions writes K/V.
        """
        ec = self.ec
        k = ec.spec_k
        qtoks = np.zeros((ec.max_slots, k + 1), np.int64)
        active = np.zeros((ec.max_slots,), bool)
        valid_q = np.ones((ec.max_slots,), np.int64)
        drafts: Dict[int, List[int]] = {}
        slots_meta, proposed = [], []
        order = sorted(self.running.items())
        slot_ranks = [self._slot_rank(s) for s, _ in order]
        for slot, req in order:
            res = self.results[req.rid]
            budget = req.max_new - len(res.tokens)
            # history = prompt + everything emitted; the last emitted token
            # is exactly the pending token (in ``tok``, not yet in KV)
            d = self.drafter.propose(
                [int(t) for t in req.prompt] + res.tokens, k)
            drafts[slot] = d
            slots_meta.append((req.rid, int(self._pos[slot]), budget))
            active[slot] = True
            valid_q[slot] = 1 + min(k, budget - 1)
            proposed.append(int(valid_q[slot]) - 1)
            qtoks[slot, 0] = res.tokens[-1]
            qtoks[slot, 1:] = d
        logits, self.state = self.verify_fn(self.params, self.state, qtoks,
                                            active, valid_q)
        logits = logits.float().cpu().numpy()               # (S, k+1, V)
        now = self._now()
        accepted = []
        for slot, req in order:
            res = self.results[req.rid]
            vq = int(valid_q[slot])
            emitted = self._accept(logits[slot, :vq], drafts[slot][:vq - 1])
            accepted.append(len(emitted) - 1)
            if ec.eos_id is not None and ec.eos_id in emitted:
                emitted = emitted[:emitted.index(ec.eos_id) + 1]
            res.tokens.extend(emitted)
            self.state["pos"][slot] += len(emitted)
            self._pos[slot] += len(emitted)
            self.state["tok"][slot] = emitted[-1]
            hit_eos = ec.eos_id is not None and res.tokens[-1] == ec.eos_id
            if len(res.tokens) >= req.max_new or hit_eos:
                res.finished = now
                self._free(slot)
        self.trace.append(TraceEvent(
            kind="spec_step", n_steps=1, slots=tuple(slots_meta),
            spec_k=k, proposed=tuple(proposed), accepted=tuple(accepted),
            adapter_ranks=tuple(slot_ranks)))
        self.spec_proposed += sum(proposed)
        self.spec_accepted += sum(accepted)
        self.spec_steps += 1

    def _accept(self, logits: np.ndarray, drafts: List[int]) -> List[int]:
        """Standard speculative rejection sampling against the verify
        logits (``(vq, V)`` — row i scores the token *after* query i).

        Returns the emitted tokens: the accepted draft prefix plus one —
        the bonus token on full acceptance, or the corrected sample at
        the first rejection.  At temperature 0 it is the longest
        greedy-matching prefix plus the greedy next token, which makes
        speculative decoding token-identical to plain greedy decoding.
        """
        temp = self.ec.temperature
        if temp <= 0.0:
            targets = np.argmax(logits, axis=-1)
            a = 0
            while a < len(drafts) and drafts[a] == int(targets[a]):
                a += 1
            return [int(t) for t in targets[:a + 1]]
        # the n-gram/greedy drafter is a point mass at d: accept with
        # probability p(d); on rejection sample the residual p \ {d}
        x = logits.astype(np.float64) / temp
        x -= x.max(axis=-1, keepdims=True)
        p = np.exp(x)
        p /= p.sum(axis=-1, keepdims=True)
        out: List[int] = []
        for i, d in enumerate(drafts):
            if self._np_rng.random() < p[i, d]:
                out.append(int(d))
                continue
            q = p[i].copy()
            q[d] = 0.0
            s = q.sum()
            if s <= 0.0:               # target IS the point mass: accept
                out.append(int(d))
                continue
            out.append(int(self._np_rng.choice(q.shape[0], p=q / s)))
            return out
        out.append(int(self._np_rng.choice(p.shape[-1], p=p[len(drafts)])))
        return out

    @property
    def spec_acceptance(self) -> float:
        """Measured mean draft-acceptance rate over the run."""
        return self.spec_accepted / max(self.spec_proposed, 1)

    @property
    def spec_tokens_per_step(self) -> float:
        """Measured mean tokens a slot emits per speculative step
        (accepted drafts + the bonus/corrected token)."""
        slot_steps = sum(len(ev.slots) for ev in self.trace
                         if ev.kind == "spec_step")
        if not slot_steps:
            return 0.0
        return self.spec_accepted / slot_steps + 1.0

    # ------------------------------------------------------------------
    def run(self, requests: Optional[Sequence[Request]] = None,
            max_steps: int = 100_000) -> List[RequestResult]:
        """Drain the queue (plus ``requests``) to completion.  On a mesh
        every rank runs the same steps to the same results."""
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
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_steps = 0
        self._t0 = time.perf_counter()

    def warmup(self) -> None:
        """Run prefill + decode once with a throwaway request."""
        prompt_len = min(self.ec.chunk_size,
                         self.ec.max_len - self.ec.decode_block - 2)
        # a multi-tenant engine also warms the adapter-miss path (factor
        # generation + the pool write)
        aid = 0 if self.adapter_pool is not None else None
        self.run([Request(rid=-1, prompt=[0] * max(prompt_len, 1),
                          max_new=self.ec.decode_block + 1,
                          adapter_id=aid)])
        if self.index is not None:
            # drop the throwaway prompt's index entries so the measured
            # run starts with a cold cache and an empty pool
            self.index.evict(self.pool.n_blocks)
        if self.adapter_pool is not None:
            # fresh pool: the throwaway tenant's residency and stats must
            # not leak into the measured run's hit/miss accounting
            self.adapter_pool = AdapterPool(self.adapter_pool.n_slots)
        self.reset_metrics()

    def calibrate_step_period(self, gen_tokens: int = 16) -> float:
        """Measured wall seconds per engine step, after :meth:`warmup`.

        Runs a short throwaway serve, evicts its index entries and resets
        metrics, then stores and returns ``wall / steps`` (the step clock
        an open-loop traffic feed converts arrival seconds with)."""
        if not self.done:
            raise RuntimeError("calibrate_step_period with requests "
                               "in flight")
        prompt_len = max(min(self.ec.chunk_size,
                             self.ec.max_len - self.ec.decode_block - 2), 1)
        gen = max(min(gen_tokens, self.ec.max_len - prompt_len), 1)
        t0 = time.perf_counter()
        self.run([Request(rid=-2, prompt=[0] * prompt_len, max_new=gen)])
        wall = time.perf_counter() - t0
        steps = self.step_idx
        if self.index is not None:
            self.index.evict(self.pool.n_blocks)
        self.reset_metrics()
        self.step_period = wall / max(steps, 1)
        return self.step_period

    def aggregate_tps(self) -> float:
        """Measured generated-tokens/s over the whole run."""
        finished = [r for r in self.results.values() if r.finished > 0]
        if not finished:
            return 0.0
        total = sum(len(r.tokens) for r in finished)
        span = max(r.finished for r in finished)
        return total / max(span, 1e-9)
