"""LIFE analytical twin of the continuous-batching engine.

Replays an engine trace (``Engine.trace``) through the hierarchical
workload model: every ``prefill_chunk`` event becomes an analytical prefill
of (batch=1, chunk, past_len); every ``decode_block`` event becomes
``n_steps`` mixed-batch decode steps whose per-slot KV lengths grow and
whose slots retire as their budgets drain — exactly the schedule the real
engine executed, but costed with ``WorkloadModel`` + ``Forecaster`` on a
target :class:`HardwareSpec`.

Prefix caching is replayed for free: a prefix-hit admission's trace simply
starts its chunks at ``past_len == cached`` (the shared blocks were never
prefilled), so the twin prices only the cache-miss suffix — the same
physics as the engine.  :func:`cold_trace` rewrites a hit trace into its
cache-cold counterfactual, which is how the TTFT savings of prefix reuse
are forecast (``TraceForecast.prefill_time`` hit vs. cold).

This extends the paper's forecasting (single uniform request, Eqs. 1–6) to
mixed continuous-batching traffic: per-request TTFT/TPOT forecasts and an
aggregate forecast TPS for the whole served trace, comparable against the
engine's measured metrics (``benchmarks/engine_throughput.py``).

Scope note: the twin costs the *useful* work of the schedule — only the
slots active at each step and only the valid tokens of each chunk.  The
executable engine, being jit-compiled with static shapes, additionally
burns compute on masked-out slots and padded chunk tails — an
implementation artifact the forecast-vs-measured delta includes.  The
engine's attention read path IS priced when ``attn_impl`` is set:
``"gather"`` adds the per-layer page rematerialization of gathering each
slot's blocks into a contiguous virtual sequence (at the useful KV span —
the static-shape engine actually remats the full padded virtual width),
``"paged"`` prices the paged flash kernels that elide the page
buffer and the score/prob intermediates.  Left unset, neither is priced
(the pre-kernel analytical scenario).
TTFT semantics match the engine's: ``ttft`` is admission → first token
(queue-exclusive, the prefill cost) on BOTH sides, and ``ttft_queued``
is arrival → first token.  Trace replay has no arrival information, so
its ``ttft_queued`` equals ``ttft``; the traffic simulator
(``repro_torch.traffic.simulate``) models the queue and fills in the real
queue-inclusive figure.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ArchConfig, Variant
from repro_torch.core.forecast import Forecaster
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.workload import ShardingPlan, WorkloadModel

from .scheduler import TraceEvent

#: constructor sentinel: resolve ``attn_impl`` (and the paging block size)
#: from the trace's ``"engine"`` header at replay time — the header records
#: what the engine actually ran, so out-of-band plumbing is only needed to
#: OVERRIDE it (pass an explicit impl) or to suppress pricing (pass None)
AUTO = "auto"


@dataclasses.dataclass
class RequestForecast:
    rid: int
    ttft: float = 0.0           # s, admission → first token (queue excluded)
    ttft_queued: float = 0.0    # s, arrival → first token (== ttft when the
                                # trace carries no queueing information)
    finished: float = 0.0       # s, simulated clock at completion
    n_tokens: int = 0
    cached_tokens: int = 0      # prompt tokens served from shared blocks
    _admitted_at: float = 0.0
    _first_token_at: float = 0.0

    @property
    def tpot(self) -> float:
        if self.n_tokens <= 1:
            return 0.0
        return (self.finished - self.first_token_at) / (self.n_tokens - 1)

    @property
    def first_token_at(self) -> float:
        return self._first_token_at


@dataclasses.dataclass
class TraceForecast:
    total_time: float           # s, simulated clock at trace end
    total_tokens: int
    requests: Dict[int, RequestForecast]
    prefill_time: float = 0.0   # s spent in prefill chunks (TTFT work)
    cached_tokens: int = 0      # prompt tokens the schedule served from cache
    prompt_tokens: int = 0      # prompt tokens offered (cached + prefilled)

    @property
    def tps(self) -> float:
        """Aggregate generated-tokens/s forecast for the served trace."""
        if self.total_tokens == 0:
            return 0.0
        return self.total_tokens / max(self.total_time, 1e-30)

    @property
    def mean_ttft(self) -> float:
        rs = self.requests.values()
        if not rs:
            return 0.0
        return sum(r.ttft for r in rs) / len(rs)

    @property
    def mean_ttft_queued(self) -> float:
        rs = self.requests.values()
        if not rs:
            return 0.0
        return sum(r.ttft_queued for r in rs) / len(rs)

    @property
    def mean_tpot(self) -> float:
        rs = [r for r in self.requests.values() if r.n_tokens > 1]
        if not rs:
            return 0.0
        return sum(r.tpot for r in rs) / len(rs)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of offered prompt tokens served from shared blocks."""
        if self.prompt_tokens == 0:
            return 0.0
        return self.cached_tokens / self.prompt_tokens


def cold_trace(trace: Sequence[TraceEvent]) -> List[TraceEvent]:
    """Rewrite a (possibly prefix-hit) trace into its cache-cold twin.

    Every admission whose chunks start at ``past_len == cached > 0`` gains
    leading chunks covering ``[0, cached)`` and all its events drop to
    ``cached = 0``.  Backfill granularity is the engine's ``chunk_size``
    recorded in the trace's ``"engine"`` header event.  Traces predating
    the header fall back to the largest chunk observed anywhere — a wrong
    estimate when every admission is a warm hit with a small tail suffix
    (a warm admission's own chunks can be tail remainders as small as one
    token), which is exactly why the header exists.  Replaying the result
    forecasts the same schedule without prefix caching; by construction
    its prefill work is a superset of the hit trace's, which grounds the
    TTFT-savings forecast.
    """
    step = next((ev.chunk for ev in trace if ev.kind == "engine"), 0)
    if step < 1:
        step = max((ev.chunk for ev in trace if ev.kind == "prefill_chunk"),
                   default=1)
    step = max(step, 1)
    out: List[TraceEvent] = []
    for ev in trace:
        if ev.kind == "prefill_batch":
            # degrade the group to per-member chunks: a cold run would
            # bucket differently anyway, and standalone members are a
            # conservative superset of the batched dispatch's work
            mranks = ev.adapter_ranks or ()
            for i, (rid, slot, chunk, past, cached, last) in enumerate(
                    ev.members):
                r = (mranks[i],) if i < len(mranks) else ()
                if past == cached and cached > 0:
                    for off in range(0, cached, step):
                        out.append(TraceEvent(
                            kind="prefill_chunk", rid=rid, slot=slot,
                            chunk=min(step, cached - off), past_len=off,
                            cached=0, last=False, adapter_ranks=r))
                out.append(TraceEvent(kind="prefill_chunk", rid=rid,
                                      slot=slot, chunk=chunk, past_len=past,
                                      cached=0, last=last,
                                      adapter_ranks=r))
            continue
        if ev.kind != "prefill_chunk" or ev.cached == 0:
            out.append(ev)
            continue
        if ev.past_len == ev.cached:
            # admission start: backfill the cached region in chunk steps
            for off in range(0, ev.cached, step):
                out.append(dataclasses.replace(
                    ev, chunk=min(step, ev.cached - off), past_len=off,
                    cached=0, last=False))
        out.append(dataclasses.replace(ev, cached=0))
    return out


class ForecastTwin:
    """Forecasts engine traces on a target hardware spec.

    ``block_size`` (optional) prices the block-paged cache's table reads:
    each chunk/step adds the block-table gather overhead modeled by
    ``WorkloadModel.block_table_reads``.  Left ``None`` (default), replay
    reproduces the pre-paging analytical numbers bit-for-bit.

    ``attn_impl`` (optional) additionally prices the engine's attention
    read path: ``"gather"`` adds the page-rematerialization traffic of the
    gather (each layer re-reads the KV span and writes it back as a
    contiguous page), ``"paged"`` prices the paged flash kernels
    (score/prob intermediates and the page buffer elided; block-table id
    reads kept).  See ``WorkloadModel``; left ``None``, neither is priced
    (the numbers without attention-impl pricing, bit-for-bit).

    ``plan`` (optional ``ShardingPlan``) replays the trace against the
    PER-CHIP workload of a tensor-parallel deployment: every chunk and
    step is priced with its ops/bytes divided over ``plan.tp`` chips plus
    the plan's collective wire time on ``hw.interconnect_GBps`` — the
    forecast side of the engine's own ``model=tp`` mesh.  A plan with
    ``pp > 1`` additionally prices the inter-stage activation hops the
    staged layer scan incurs (``WorkloadModel`` records them per scenario method);
    the engine's pipeline stages execute *sequentially* within each
    synchronous jitted step, so replay sums the full stack plus hop wire
    rather than applying any bubble overlap — that pipelining benefit is
    a throughput-phase property modeled by ``Forecaster.pipeline_phase``,
    not a property of this trace's lockstep schedule.  Left ``None``
    (single chip), replay reproduces the unsharded numbers bit-for-bit.

    ``attn_impl`` defaults to :data:`AUTO`: :meth:`replay` reads the
    impl (and, if ``block_size`` wasn't given, the paging block size)
    from the trace's ``"engine"`` header and prices accordingly — the
    explicit constructor arg stays as an override, and explicit ``None``
    keeps the pre-engine "price neither" behavior.  Direct method calls
    (``decode_step_latency`` etc.) on an AUTO twin price like ``None``
    since there is no trace to resolve from.

    ``draft_arch`` (optional, name or ``ArchConfig``) prices speculative
    ``spec_step`` events as k draft-model decode steps plus the verify
    pass; left ``None``, drafting is free (the self-speculative n-gram
    drafter runs on the host off the critical accelerator path).

    Multi-tenant LoRA: trace events carry ``adapter_ranks`` (the per-slot
    adapter ranks of each dispatch), which replay prices via
    ``WorkloadModel.lora_step`` at the pool-padded rank — resolved from
    the trace's ``"engine"`` header (``lora_ranks``) in AUTO mode, or
    pinned with ``lora_max_rank``.  ``lora_mix`` gives direct method
    calls (the traffic simulator's surface has no events) a default
    per-slot rank mix: slot ``i`` serves rank ``lora_mix[i % len]``.
    Left empty with no event ranks, nothing is priced (bit-for-bit
    pre-LoRA numbers).
    """

    def __init__(self, arch: ArchConfig, hw: HardwareSpec,
                 variant: Optional[Variant] = None, *,
                 ec: Optional[float] = None, em: float = 1.0,
                 prefill_ec: float = 1.0, prefill_em: float = 1.0,
                 block_size: Optional[int] = None,
                 attn_impl: Optional[str] = AUTO,
                 plan: Optional["ShardingPlan"] = None,
                 draft_arch=None,
                 lora_mix: Sequence[int] = (),
                 lora_max_rank: int = 0):
        self._attn_auto = attn_impl == AUTO
        if self._attn_auto:
            attn_impl = None
        elif attn_impl is not None and block_size is None:
            from repro_torch.core.workload import DEFAULT_KV_BLOCK_SIZE
            block_size = DEFAULT_KV_BLOCK_SIZE
        self.wm = WorkloadModel(arch, variant, attn_impl=attn_impl,
                                plan=plan)
        self.plan = self.wm.plan
        self.fc = Forecaster(hw)
        self.ec, self.em = ec, em
        self.prefill_ec, self.prefill_em = prefill_ec, prefill_em
        self.block_size = block_size
        self.attn_impl = attn_impl
        self.draft_arch = draft_arch
        self._draft_wm = None
        if draft_arch is not None:
            from repro_torch import configs
            dcfg = (configs.get(draft_arch) if isinstance(draft_arch, str)
                    else draft_arch)
            self._draft_wm = WorkloadModel(dcfg)
        self.lora_mix = tuple(int(r) for r in lora_mix)
        self.lora_max_rank = int(lora_max_rank)
        self._prefill_memo: Dict[tuple, float] = {}
        self._group_memo: Dict[tuple, float] = {}
        self._decode_memo: Dict[tuple, float] = {}
        self._verify_memo: Dict[tuple, float] = {}
        self._draft_memo: Dict[tuple, float] = {}
        self._lora_memo: Dict[tuple, object] = {}
        self._auto_twins: Dict[tuple, "ForecastTwin"] = {}

    # ------------------------------------------------------------------
    def _default_ranks(self, n: int) -> Tuple[int, ...]:
        """Per-slot rank mix for direct (trace-less) pricing calls."""
        if not self.lora_mix:
            return ()
        return tuple(self.lora_mix[i % len(self.lora_mix)]
                     for i in range(n))

    def _lora_totals(self, ranks: Tuple[int, ...], q_len: int = 1):
        """Grouped-LoRA work of one dispatch (None when nothing to price).

        Priced at the pool-padded rank ``max(lora_max_rank, ranks)`` —
        both executable impls compute and DMA the padded lanes."""
        if not ranks:
            return None
        R = max(self.lora_max_rank, max(ranks))
        if R == 0:
            # all-base mix on a LoRA-less engine (rank 0 = no adapter):
            # nothing executes, so nothing is priced
            return None
        key = (tuple(sorted(ranks)), q_len, R)
        if key not in self._lora_memo:
            self._lora_memo[key] = self.wm.lora_step(
                list(ranks), q_len=q_len,
                max_rank=R or None).totals("lora_step")
        return self._lora_memo[key]

    # ------------------------------------------------------------------
    def prefill_chunk_latency(self, chunk: int, past_len: int,
                              adapter_ranks: Optional[Sequence[int]] = None
                              ) -> float:
        ranks = (self._default_ranks(1) if adapter_ranks is None
                 else tuple(int(r) for r in adapter_ranks))
        key = (chunk, past_len, ranks)
        if key not in self._prefill_memo:
            db = self.wm.prefill(1, chunk, past_len=past_len)
            if self.block_size:
                self.wm.block_table_reads(db, 1, past_len + chunk,
                                          self.block_size)
            totals = db.totals("prefill")
            lt = self._lora_totals(ranks, q_len=chunk)
            if lt is not None:
                totals = totals.plus(lt)
            self._prefill_memo[key] = self.fc.phase(
                totals, ec=self.prefill_ec,
                em=self.prefill_em).latency
        return self._prefill_memo[key]

    def prefill_group_latency(
            self, members: Sequence[Tuple[int, int]],
            adapter_ranks: Optional[Sequence[int]] = None) -> float:
        """One batched prefill-and-insert dispatch over ``(chunk,
        past_len)`` members, priced via the affine-in-batch identity of
        :meth:`WorkloadModel.prefill_group_totals` (weight reads are
        shared across the group, per-token work is not)."""
        members = tuple(members)
        ranks = (self._default_ranks(len(members)) if adapter_ranks is None
                 else tuple(int(r) for r in adapter_ranks))
        if len(members) == 1:
            return self.prefill_chunk_latency(*members[0],
                                              adapter_ranks=ranks)
        order = tuple(sorted(zip(members, ranks or (0,) * len(members))))
        key = (order, bool(ranks))
        if key not in self._group_memo:
            totals = self.wm.prefill_group_totals(
                tuple(m for m, _ in order))
            if self.block_size:
                for (chunk, past), _r in order:
                    totals = totals.plus(self.wm.block_table_totals(
                        1, past + chunk, self.block_size))
            if ranks:
                for (chunk, _past), r in order:
                    lt = self._lora_totals((r,), q_len=chunk)
                    if lt is not None:
                        totals = totals.plus(lt)
            self._group_memo[key] = self.fc.phase(
                totals, ec=self.prefill_ec, em=self.prefill_em).latency
        return self._group_memo[key]

    def _decode_memo_key(self, past_lens: Sequence[int]) -> tuple:
        """Exact memo key of one mixed decode step.

        ``WorkloadModel.decode_totals_mixed`` is affine in the sum of the
        *effective* per-slot KV lengths for a fixed batch size (documented
        identity), so the step latency is fully determined by
        ``(B, Σ eff)`` — plus, when table reads are priced, the total
        block-table entries ``Σ ceil((p+1)/bs)`` (a step function of the
        individual lengths, not of their sum).
        """
        eff = self.wm.effective_kv_lens(past_lens)
        key = (len(eff), sum(eff))
        if self.block_size:
            key += (sum(-(-(p + 1) // self.block_size) for p in past_lens),)
        return key

    def decode_step_latency(self, past_lens: Sequence[int],
                            adapter_ranks: Optional[Sequence[int]] = None
                            ) -> float:
        ranks = (self._default_ranks(len(past_lens))
                 if adapter_ranks is None
                 else tuple(int(r) for r in adapter_ranks))
        key = self._decode_memo_key(past_lens) + (tuple(sorted(ranks)),)
        if key not in self._decode_memo:
            totals = self.wm.decode_totals_mixed(past_lens)
            if self.block_size:
                for p in past_lens:
                    totals = totals.plus(self.wm.block_table_totals(
                        1, p + 1, self.block_size))
            lt = self._lora_totals(ranks)
            if lt is not None:
                totals = totals.plus(lt)
            self._decode_memo[key] = self.fc.step_latency(
                totals, em=self.em, ec=self.ec)
        return self._decode_memo[key]

    def verify_step_latency(self, past_lens: Sequence[int], k: int,
                            adapter_ranks: Optional[Sequence[int]] = None
                            ) -> float:
        """One speculative step: k draft steps (zero-cost without a
        ``draft_arch``) + one (k+1)-query verify pass over the mixed
        batch, weight reads amortized across queries by construction of
        ``WorkloadModel.verify_totals_mixed``."""
        if k == 0:
            return self.decode_step_latency(past_lens,
                                            adapter_ranks=adapter_ranks)
        ranks = (self._default_ranks(len(past_lens))
                 if adapter_ranks is None
                 else tuple(int(r) for r in adapter_ranks))
        eff = self.wm.effective_kv_lens(past_lens, q_len=k + 1)
        key = (len(eff), sum(eff), k, tuple(sorted(ranks)))
        if self.block_size:
            key += (sum(-(-(p + k + 1) // self.block_size)
                        for p in past_lens),)
        if key not in self._verify_memo:
            totals = self.wm.verify_totals_mixed(past_lens, k)
            if self.block_size:
                for p in past_lens:
                    totals = totals.plus(self.wm.block_table_totals(
                        1, p + k + 1, self.block_size))
            lt = self._lora_totals(ranks, q_len=k + 1)
            if lt is not None:
                totals = totals.plus(lt)
            t = self.fc.step_latency(totals, em=self.em, ec=self.ec)
            if self._draft_wm is not None:
                t += k * self._draft_step_latency(past_lens)
            self._verify_memo[key] = t
        return self._verify_memo[key]

    def _draft_step_latency(self, past_lens: Sequence[int]) -> float:
        eff = self._draft_wm.effective_kv_lens(past_lens)
        key = (len(eff), sum(eff))
        if key not in self._draft_memo:
            self._draft_memo[key] = self.fc.step_latency(
                self._draft_wm.decode_totals_mixed(past_lens),
                em=self.em, ec=self.ec)
        return self._draft_memo[key]

    # ------------------------------------------------------------------
    def _resolved_twin(self, header: TraceEvent) -> "ForecastTwin":
        """AUTO mode: the twin re-parameterized from the trace header."""
        lora_R = (self.lora_max_rank
                  or max(header.lora_ranks, default=0))
        key = (header.attn_impl,
               self.block_size or header.block_size or None,
               lora_R)
        if key not in self._auto_twins:
            self._auto_twins[key] = ForecastTwin(
                self.wm.arch, self.fc.hw, self.wm.variant,
                ec=self.ec, em=self.em, prefill_ec=self.prefill_ec,
                prefill_em=self.prefill_em, block_size=key[1],
                attn_impl=key[0], plan=self.plan,
                draft_arch=self.draft_arch,
                lora_mix=self.lora_mix, lora_max_rank=lora_R)
        return self._auto_twins[key]

    def replay(self, trace: Sequence[TraceEvent]) -> TraceForecast:
        header = next((ev for ev in trace if ev.kind == "engine"), None)
        if self._attn_auto and header is not None and header.attn_impl:
            # the header knows what the engine ran: price that
            return self._resolved_twin(header).replay(trace)
        clock = 0.0
        requests: Dict[int, RequestForecast] = {}
        total_tokens = 0
        prefill_time = 0.0
        cached_tokens = 0
        prompt_tokens = 0
        for ev in trace:
            if ev.kind == "engine":
                continue            # config header: zero workload
            if ev.kind == "prefill_chunk":
                rf = requests.setdefault(ev.rid, RequestForecast(rid=ev.rid))
                if ev.past_len == ev.cached:
                    # admission start (cache-hit tokens were never chunked)
                    rf._admitted_at = clock
                    rf.cached_tokens = ev.cached
                    cached_tokens += ev.cached
                    prompt_tokens += ev.cached
                dt = self.prefill_chunk_latency(
                    ev.chunk, ev.past_len,
                    adapter_ranks=ev.adapter_ranks)
                clock += dt
                prefill_time += dt
                prompt_tokens += ev.chunk
                if ev.last:
                    # admission ends: the first token comes from these logits
                    rf.ttft = clock - rf._admitted_at
                    rf.ttft_queued = rf.ttft
                    rf._first_token_at = clock
                    rf.n_tokens += 1
                    rf.finished = clock
                    total_tokens += 1
            elif ev.kind == "prefill_batch":
                # one bucketed prefill-and-insert dispatch; members are
                # (rid, slot, chunk, past_len, cached, last) tuples
                for rid, _slot, chunk, past, cached, _last in ev.members:
                    rf = requests.setdefault(rid, RequestForecast(rid=rid))
                    if past == cached:
                        rf._admitted_at = clock
                        rf.cached_tokens = cached
                        cached_tokens += cached
                        prompt_tokens += cached
                    prompt_tokens += chunk
                dt = self.prefill_group_latency(
                    tuple((m[2], m[3]) for m in ev.members),
                    adapter_ranks=ev.adapter_ranks)
                clock += dt
                prefill_time += dt
                for rid, _slot, _chunk, _past, _cached, last in ev.members:
                    if last:
                        rf = requests[rid]
                        rf.ttft = clock - rf._admitted_at
                        rf.ttft_queued = rf.ttft
                        rf._first_token_at = clock
                        rf.n_tokens += 1
                        rf.finished = clock
                        total_tokens += 1
            elif ev.kind == "decode_block":
                # per-slot (rid, past_len, remaining) at block start; replay
                # each fused step with budget attrition (EOS is not
                # forecastable and is ignored — the engine's trace already
                # reflects the blocks it actually ran)
                ranks = ev.adapter_ranks or ()
                live = [list(s) + [ranks[i] if i < len(ranks) else 0]
                        for i, s in enumerate(ev.slots)]
                for step in range(ev.n_steps):
                    active = [s for s in live if s[2] > 0]
                    if not active:
                        break
                    clock += self.decode_step_latency(
                        [s[1] for s in active],
                        adapter_ranks=(tuple(s[3] for s in active)
                                       if ranks else ()))
                    for s in active:
                        rf = requests.setdefault(
                            s[0], RequestForecast(rid=s[0]))
                        rf.n_tokens += 1
                        rf.finished = clock
                        s[1] += 1       # KV grew by the token just written
                        s[2] -= 1       # budget drained by the token sampled
                        total_tokens += 1
            elif ev.kind == "spec_step":
                # one batched verify over the active slots; per-slot
                # emitted tokens come from the MEASURED accepted counts
                # the trace recorded, so replay reproduces the engine's
                # realized acceptance rather than an assumed α
                clock += self.verify_step_latency(
                    [s[1] for s in ev.slots], ev.spec_k,
                    adapter_ranks=ev.adapter_ranks)
                for s, a in zip(ev.slots, ev.accepted):
                    emit = min(a + 1, s[2])
                    rf = requests.setdefault(s[0],
                                             RequestForecast(rid=s[0]))
                    rf.n_tokens += emit
                    rf.finished = clock
                    total_tokens += emit
            else:
                raise ValueError(f"unknown trace event kind {ev.kind!r}")
        return TraceForecast(total_time=clock, total_tokens=total_tokens,
                             requests=requests, prefill_time=prefill_time,
                             cached_tokens=cached_tokens,
                             prompt_tokens=prompt_tokens)


def despeculate_trace(trace: Sequence[TraceEvent]) -> List[TraceEvent]:
    """Rewrite ``spec_step`` events into the plain decode blocks that
    would have emitted the same tokens: a step whose slots accepted
    ``a_i`` drafts each becomes a ``decode_block`` of ``max(a_i + 1)``
    steps with per-slot budgets ``a_i + 1`` (budget attrition retires
    the luckier slots' peers at the right step).  Replaying the result
    against the original prices the measured schedule with and without
    speculation on the same hardware — the trace-grounded speedup that
    validates the assumed-α forecast.
    """
    out: List[TraceEvent] = []
    for ev in trace:
        if ev.kind == "engine":
            out.append(dataclasses.replace(ev, spec_k=0))
            continue
        if ev.kind != "spec_step":
            out.append(ev)
            continue
        emits = [min(a + 1, s[2]) for a, s in zip(ev.accepted, ev.slots)]
        slots = tuple((s[0], s[1], e) for s, e in zip(ev.slots, emits))
        out.append(TraceEvent(kind="decode_block",
                              n_steps=max(emits, default=0), slots=slots,
                              adapter_ranks=ev.adapter_ranks))
    return out


def replay_trace(arch: ArchConfig, hw: HardwareSpec,
                 trace: Sequence[TraceEvent],
                 variant: Optional[Variant] = None, *,
                 em: float = 1.0, ec: Optional[float] = None
                 ) -> TraceForecast:
    """One-shot convenience wrapper around :class:`ForecastTwin`."""
    return ForecastTwin(arch, hw, variant, em=em, ec=ec).replay(trace)
