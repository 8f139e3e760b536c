"""Analytical LLM workload model (paper Fig. 2-B/D/E).

``WorkloadModel`` builds the hierarchical analytical model of a full LLM from
an :class:`repro_torch.configs.base.ArchConfig` + :class:`Variant`, and simulates
inference scenarios — prefill (optionally chunked), auto-regressive decode
timelines, LoRA updates — accumulating the statistics database (Fig. 2-F).

The same ``ArchConfig`` drives the executable model in ``repro_torch.models``,
making this the analytical *twin* of every framework model.

Sharding is a first-class input: a :class:`ShardingPlan` with ``tp > 1``
divides every operator's FLOPs/bytes across chips (per-chip view) and
records the collective traffic (Megatron-style all-reduces, MoE
all-to-alls) as ``wire_bytes`` operator records, priced by the
``Forecaster`` against ``HardwareSpec.interconnect_GBps``.  ``tp == 1``
is bit-for-bit identical to the unsharded model.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from . import derived as D
from . import operators as F
from . import dtypes
from .stats import StatsDB, Totals

from repro_torch.configs.base import ArchConfig, Variant


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Logical parallelism degrees for analytical prediction.

    ``tp`` is the per-replica model (tensor-parallel) degree — the axis
    the serving engine shards KV heads and weights over; it divides every
    operator's per-chip work and adds Megatron-style collective traffic.
    ``pp`` is the pipeline-parallel degree — it partitions the layer stack
    into ``pp`` contiguous stages; each stage holds its layers' weights
    and KV, and the activation crossing every stage boundary is recorded
    as ``wire_bytes`` (a point-to-point hop, priced against the same
    interconnect as collectives).  Unlike ``tp``, ``pp`` does NOT divide
    per-operator work: the full layer stack still runs once per token —
    pipelining only overlaps *microbatches* across stages, which is the
    :class:`Forecaster`'s job (bubble model), not the workload's.
    ``ep`` maps MoE expert parallelism onto the same model axis (it adds
    all-to-all wire but no extra division).  ``dp``/``sp``/``fsdp``
    describe replica-level scale-out for the training/dry-run path
    (:mod:`repro_torch.core.distributed`); they never change per-chip inference
    workloads.
    """
    dp: int = 1          # data parallel ways (pod × data axes)
    tp: int = 1          # tensor parallel ways (model axis)
    ep: int = 1          # expert parallel ways (MoE; maps onto model axis)
    sp: int = 1          # sequence parallel ways (long-context)
    pp: int = 1          # pipeline parallel ways (stage axis)
    fsdp: bool = False   # params/opt-state sharded over dp (ZeRO-3 style)

    def __post_init__(self):
        for name in ("dp", "tp", "ep", "sp", "pp"):
            if getattr(self, name) < 1:
                raise ValueError(f"ShardingPlan.{name} must be >= 1, "
                                 f"got {getattr(self, name)}")

    @property
    def n_chips(self) -> int:
        return self.dp * self.tp * self.sp * self.pp

#: default tokens per KV block of the paged cache — shared by the engine
#: (``EngineConfig.block_size``) and the analytical side
#: (``Scenario.engine_block_size``), and kept here so the pure analytical
#: path never has to import the engine (and with it torch) to read it
DEFAULT_KV_BLOCK_SIZE = 16


@dataclasses.dataclass
class TimelinePoint:
    step: int                 # decode step index (0 = first generated token)
    past_len: int             # KV length before this token
    totals: Totals            # per-token workload


#: attention read paths of the block-paged serving engine the model can
#: price: ``"gather"`` (page rematerialization per layer pass) or
#: ``"paged"`` (paged flash kernel — attention core fused, no page
#: buffer).  ``None`` prices neither (pre-engine analytical scenario).
ENGINE_ATTN_IMPLS = (None, "gather", "paged")


class WorkloadModel:
    """Analytical twin of one (architecture × variant × sharding plan).

    ``attn_impl`` selects the serving engine's attention read path to
    price (see :data:`ENGINE_ATTN_IMPLS`): ``"gather"`` adds the
    page-rematerialization traffic of gathering each slot's KV blocks
    into a contiguous buffer per attention layer, ``"paged"`` prices the
    attention core as fused (flash: score/prob intermediates and the
    dequant buffer elided) — the paper's §3.2.1 operator-fusion example
    applied to paged KV.  The default ``None`` reproduces the paper's
    plain analytical model bit-for-bit.  Block-table id reads are priced
    separately (:meth:`block_table_totals`) since they need the block
    size and are shared by both impls.

    ``plan`` (default: the single-chip plan) makes every scenario method
    emit the PER-CHIP workload: operator FLOPs/bytes divide by ``plan.tp``
    and each layer's tensor-parallel all-reduces (plus MoE all-to-alls
    under ``plan.ep``) are recorded as ``wire_bytes``.  ``tp == 1``
    reproduces the unsharded model bit-for-bit (no division applied, no
    collective records emitted).
    """

    def __init__(self, arch: ArchConfig, variant: Optional[Variant] = None,
                 attn_impl: Optional[str] = None,
                 plan: Optional[ShardingPlan] = None):
        if attn_impl not in ENGINE_ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of "
                             f"{ENGINE_ATTN_IMPLS}, got {attn_impl!r}")
        self.arch = arch
        self.variant = variant or Variant()
        self.attn_impl = attn_impl
        self.plan = plan or ShardingPlan()
        n_layers = len(arch.block_kinds())
        if self.plan.pp > n_layers:
            raise ValueError(f"pp={self.plan.pp} exceeds the {n_layers} "
                             f"layers of {arch.name} — nothing to stage")
        if self.variant.use_mla and arch.mla is None:
            # MHA→MLA conversion (paper §3.3.2): attach default MLA geometry
            from repro_torch.configs.base import MLAConfig
            self.arch = dataclasses.replace(arch, mla=MLAConfig())

    # ------------------------------------------------------------------
    # scenario methods
    # ------------------------------------------------------------------
    def prefill(self, batch: int, seq: int, db: Optional[StatsDB] = None,
                past_len: int = 0) -> StatsDB:
        """Process ``seq`` new tokens on top of ``past_len`` cached tokens."""
        db = db or StatsDB()
        db.set_phase("prefill")
        a, v = self.arch, self.variant
        ntok = batch * seq
        with db.scope("model"), db.sharded(self.plan.tp):
            if a.family == "encdec" and past_len == 0:
                self._encoder(db, batch)
            if a.family == "vlm" and past_len == 0 and a.vision_prefix_len:
                # stub frontend: patch embeddings arrive precomputed; project
                F.linear(db, batch * a.vision_prefix_len, a.d_model, a.d_model,
                         dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                         group_size=v.group_size, name="vision_projector")
            F.embedding(db, ntok, a.vocab_size, a.d_model, dtype=v.dtype_act)
            self._collective(db, ntok)   # vocab-parallel embedding all-reduce
            for i, kind in enumerate(a.block_kinds()):
                with db.scope(f"layer{i}"):
                    self._block(db, kind, batch, q_len=seq,
                                kv_len=past_len + seq, decode=False)
                    self._stage_hop(db, i, ntok)
            D.norm(db, ntok, a.d_model, kind=a.norm_kind,
                   dtype=v.dtype_act, fused=v.fused)
            # LM head over all positions (paper Table 4 convention)
            F.linear(db, ntok, a.d_model, a.vocab_size,
                     dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                     group_size=v.group_size, name="lm_head")
        return db

    def chunked_prefill(self, batch: int, seq: int, chunk: int,
                        db: Optional[StatsDB] = None) -> StatsDB:
        """§3.3.4: split the prompt into equal chunks, reusing the KV cache."""
        db = db or StatsDB()
        done = 0
        while done < seq:
            step = min(chunk, seq - done)
            self.prefill(batch, step, db=db, past_len=done)
            done += step
        return db

    def prefill_cached(self, batch: int, seq: int, cached: int,
                       chunk: Optional[int] = None,
                       block_size: Optional[int] = None,
                       db: Optional[StatsDB] = None) -> StatsDB:
        """Prefix-reuse prefill (block-paged cache): only the
        cache-miss suffix ``seq - cached`` is computed, on top of
        ``cached`` tokens already materialized in shared KV blocks.

        ``cached == 0`` reduces exactly to :meth:`prefill` /
        :meth:`chunked_prefill`.  ``block_size`` adds the block-table
        gather overhead of addressing the paged cache (one int32 id per
        ``block_size`` KV positions per attention layer per chunk).
        """
        if not 0 <= cached < seq:
            raise ValueError(f"cached must be in [0, seq), got "
                             f"{cached} of {seq}")
        db = db or StatsDB()
        done, suffix = 0, seq - cached
        step = chunk or suffix
        while done < suffix:
            c = min(step, suffix - done)
            self.prefill(batch, c, db=db, past_len=cached + done)
            if block_size:
                self.block_table_reads(db, batch, cached + done + c,
                                       block_size)
            done += c
        return db

    def prefill_group_totals(self, chunks: Sequence[Tuple[int, int]]
                             ) -> Totals:
        """Workload of ONE bucket-batched prefill-and-insert dispatch.

        ``chunks[i] = (chunk, past_len)`` is member ``i``'s prompt chunk
        — the engine's batched admission (``EngineConfig.prefill_batch``)
        runs all members as a single dispatch set, so per-token work sums
        across members while per-pass fixed work (weight reads, dispatch
        launches) is paid once.  Exploits that :meth:`prefill` is affine
        in the batch dimension for fixed ``(chunk, past)``:

            T(B, c, p) = B · T1 − (B − 1) · dup,   dup = 2·T1 − T2

        where ``dup`` is exactly the duplicated per-pass fixed cost of
        pricing a member standalone (its weight reads and dispatches).
        For a uniform group this reproduces ``prefill(B, c, p)``'s totals
        record-for-record (tested); mixed members subtract each member's
        own ``dup``, which keeps dispatches collapsed to one member's and
        never double-counts weight traffic.
        """
        if not chunks:
            raise ValueError("prefill_group_totals needs >= 1 member")
        if not hasattr(self, "_group_cache"):
            self._group_cache = {}
        total: Optional[Totals] = None
        for c, p in chunks:
            if c < 1 or p < 0:
                raise ValueError(f"bad group member (chunk={c}, past={p})")
            key = (c, p)
            if key not in self._group_cache:
                t1 = self.prefill(1, c, past_len=p).totals("prefill")
                t2 = self.prefill(2, c, past_len=p).totals("prefill")
                dup = t1.scaled(2.0).minus(t2)
                self._group_cache[key] = (t1, dup)
            t1, dup = self._group_cache[key]
            total = t1 if total is None else total.plus(t1).minus(dup)
        return total

    def block_table_totals(self, batch: int, kv_len: int,
                           block_size: int) -> Totals:
        """Block-table gather overhead of one paged-attention pass: per
        attention layer, read the int32 block ids covering ``kv_len``
        positions.  Tiny by design — it is the price of paging."""
        n_attn = sum(1 for k in self.arch.block_kinds() if k == "attn")
        entries = -(-kv_len // block_size)
        return Totals(mem_rd=float(batch * n_attn * entries * 4))

    def block_table_reads(self, db: StatsDB, batch: int, kv_len: int,
                          block_size: int) -> None:
        """Record :meth:`block_table_totals` into ``db`` (current phase)."""
        t = self.block_table_totals(batch, kv_len, block_size)
        db.record("block_table", mem_rd=t.mem_rd, dispatches=0,
                  op_class="gather")

    def decode_step(self, batch: int, past_len: int,
                    db: Optional[StatsDB] = None) -> StatsDB:
        """One auto-regressively generated token with ``past_len`` cached."""
        db = db or StatsDB()
        db.set_phase("decode")
        a, v = self.arch, self.variant
        with db.scope("model"), db.sharded(self.plan.tp):
            F.embedding(db, batch, a.vocab_size, a.d_model, dtype=v.dtype_act)
            self._collective(db, batch)  # vocab-parallel embedding all-reduce
            for i, kind in enumerate(a.block_kinds()):
                with db.scope(f"layer{i}"):
                    self._block(db, kind, batch, q_len=1,
                                kv_len=past_len + 1, decode=True)
                    self._stage_hop(db, i, batch)
            D.norm(db, batch, a.d_model, kind=a.norm_kind,
                   dtype=v.dtype_act, fused=v.fused)
            F.linear(db, batch, a.d_model, a.vocab_size,
                     dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                     group_size=v.group_size, name="lm_head")
            # greedy/top-k sampling pass over logits
            F.elemw(db, batch * a.vocab_size, n_operands=1, ops_per_el=1.0,
                    dtype=v.dtype_act, write_output=False, name="sampling",
                    dispatches=0)
        return db

    def verify_step(self, batch: int, past_len: int, k: int,
                    db: Optional[StatsDB] = None) -> StatsDB:
        """One speculative-verify pass: ``k + 1`` queries per sequence (the
        pending token plus ``k`` draft tokens) scored in a single batched
        dispatch with ``past_len`` cached.

        This is where speculation pays analytically: the pass reads the
        weights ONCE for all ``k + 1`` queries (amortized, like prefill)
        while a plain decode step re-reads them per token — in the
        memory-bound decode regime the verify step costs barely more than
        one token's step but can emit up to ``k + 1`` tokens.
        ``k == 0`` reproduces :meth:`decode_step` record-for-record.
        """
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
        db = db or StatsDB()
        db.set_phase("decode")
        a, v = self.arch, self.variant
        ntok = batch * (k + 1)
        with db.scope("model"), db.sharded(self.plan.tp):
            F.embedding(db, ntok, a.vocab_size, a.d_model, dtype=v.dtype_act)
            self._collective(db, ntok)   # vocab-parallel embedding all-reduce
            for i, kind in enumerate(a.block_kinds()):
                with db.scope(f"layer{i}"):
                    self._block(db, kind, batch, q_len=k + 1,
                                kv_len=past_len + k + 1, decode=True)
                    self._stage_hop(db, i, ntok)
            D.norm(db, ntok, a.d_model, kind=a.norm_kind,
                   dtype=v.dtype_act, fused=v.fused)
            F.linear(db, ntok, a.d_model, a.vocab_size,
                     dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                     group_size=v.group_size, name="lm_head")
            # acceptance test / sampling reads every query's logits row
            F.elemw(db, ntok * a.vocab_size, n_operands=1, ops_per_el=1.0,
                    dtype=v.dtype_act, write_output=False, name="sampling",
                    dispatches=0)
        return db

    def decode_totals_mixed(self, past_lens: Sequence[int]) -> Totals:
        """Workload of ONE decode step for a continuous-batching batch.

        ``past_lens[i]`` is the KV length already cached for slot ``i`` —
        unlike :meth:`decode_step`, the requests need not share a past
        length.  This is the scenario the serving engine produces (slots
        admitted at different times) and the paper only models for a
        uniform batch.

        Exploits that the per-step workload is affine in ``past_len`` for a
        fixed batch size B (attention BMM ops, KV reads and softmax scale
        linearly with KV length; every other operator is independent of it):

            T(B, {p_i}) = T(B, 0) + slope · Σ_i p_i

        where ``slope`` is the per-slot, per-cached-token increment.  The
        identity ``decode_totals_mixed([p]*B) == decode_step(B, p)`` holds
        exactly (tested), so uniform batches reduce to the paper's model.
        ``pad_to`` (§3.2.2) and local windows break affinity at the slot
        level; both are applied per slot before the affine evaluation
        (:meth:`effective_kv_lens`).  The ``attn_impl`` pricing modes
        preserve affinity by construction: fusion elision and page
        rematerialization are both linear in the KV length.
        """
        eff = self.effective_kv_lens(past_lens)
        B = len(eff)
        key = B
        if not hasattr(self, "_mixed_cache"):
            self._mixed_cache = {}
        if key not in self._mixed_cache:
            base_v = dataclasses.replace(self.variant, pad_to=1)
            base_wm = WorkloadModel(self.arch, base_v,
                                    attn_impl=self.attn_impl,
                                    plan=self.plan)
            t0 = base_wm.decode_step(B, 0).totals("decode")
            t1 = base_wm.decode_step(B, 1).totals("decode")
            slope = t1.minus(t0).scaled(1.0 / B)   # per slot, per cached tok
            self._mixed_cache[key] = (t0, slope)
        t0, slope = self._mixed_cache[key]
        return t0.plus(slope, factor=float(sum(eff)))

    def verify_totals_mixed(self, past_lens: Sequence[int],
                            k: int) -> Totals:
        """Workload of ONE speculative-verify step for a mixed-length
        batch — :meth:`decode_totals_mixed` generalized to ``k + 1``
        queries per slot.  Affinity in Σ past holds for fixed ``(B, k)``
        exactly as for plain decode (everything attention reads beyond
        the per-slot candidate window scales linearly with past length);
        ``verify_totals_mixed(pls, 0) == decode_totals_mixed(pls)``
        (tested)."""
        if k == 0:
            return self.decode_totals_mixed(past_lens)
        eff = self.effective_kv_lens(past_lens, q_len=k + 1)
        B = len(eff)
        key = (B, k)
        if not hasattr(self, "_verify_cache"):
            self._verify_cache = {}
        if key not in self._verify_cache:
            base_v = dataclasses.replace(self.variant, pad_to=1)
            base_wm = WorkloadModel(self.arch, base_v,
                                    attn_impl=self.attn_impl,
                                    plan=self.plan)
            t0 = base_wm.verify_step(B, 0, k).totals("decode")
            t1 = base_wm.verify_step(B, 1, k).totals("decode")
            slope = t1.minus(t0).scaled(1.0 / B)
            self._verify_cache[key] = (t0, slope)
        t0, slope = self._verify_cache[key]
        return t0.plus(slope, factor=float(sum(eff)))

    # ------------------------------------------------------------------
    # pipeline stages (plan.pp)
    # ------------------------------------------------------------------
    def stage_spans(self) -> List[Tuple[int, int]]:
        """Contiguous ``[start, stop)`` layer ranges of each pipeline
        stage — ``plan.pp`` near-equal partitions of the layer stack, the
        first ``n_layers % pp`` stages one layer deeper (GPipe-style
        balanced split)."""
        n = len(self.arch.block_kinds())
        pp = self.plan.pp
        base, rem = divmod(n, pp)
        spans: List[Tuple[int, int]] = []
        start = 0
        for s in range(pp):
            size = base + (1 if s < rem else 0)
            spans.append((start, start + size))
            start += size
        return spans

    def hop_wire_bytes(self, ntok: int) -> float:
        """Bytes of the (ntok, d_model) activation crossing ONE stage
        boundary — a point-to-point send, not a ring collective, so the
        full tensor crosses once regardless of ``tp`` (Megatron keeps
        activations replicated across the tp group at block exits)."""
        el = dtypes.get(self.variant.dtype_act).bytes_per_el
        return float(ntok) * self.arch.d_model * el

    def stage_totals(self, db: StatsDB,
                     phase: Optional[str] = None) -> List[Totals]:
        """Partition a scenario method's records into per-pipeline-stage Totals.

        Every record lands in exactly one stage (the sum over stages
        reproduces ``db.totals(phase)`` bit-for-bit, tested):

        * ``layer{i}`` scopes → the stage owning layer ``i`` (inter-stage
          hop records sit in the sending layer's scope, so each stage's
          Totals already carry its outbound hop wire);
        * the encoder / vision frontend, the embedding gather and the
          vocab-parallel embedding all-reduce → stage 0 (they feed the
          first decoder layer);
        * everything else (final norm, lm_head, sampling, block-table
          reads) → the last stage, which owns the model head.
        """
        spans = self.stage_spans()
        pp = len(spans)
        stage_of = {}
        for s, (lo, hi) in enumerate(spans):
            for i in range(lo, hi):
                stage_of[i] = s
        out = [Totals() for _ in range(pp)]
        for r in db.records:
            if phase is not None and r.phase != phase:
                continue
            stage = pp - 1
            placed = False
            for seg in r.scope.split("/"):
                if seg.startswith("layer") and seg[5:].isdigit():
                    stage = stage_of[int(seg[5:])]
                    placed = True
                    break
                if seg == "encoder":
                    stage = 0
                    placed = True
                    break
            # the only unplaced all_reduce is the vocab-parallel embedding
            # combine (layer all-reduces carry layer{i} scopes)
            if not placed and r.op in ("embedding", "vision_projector",
                                       "all_reduce"):
                stage = 0
            out[stage].add(r)
        return out

    def wire_bytes_by_op(self, db: StatsDB,
                         phase: Optional[str] = None) -> dict:
        """Per-op wire-byte totals of the ``collective`` records in ``db``
        (``all_reduce`` / ``all_to_all`` / ``stage_hop``) — the analytical
        side of the static auditor's collective cross-check against the
        per-chip HLO wire bytes of :func:`repro_torch.core.hlo.analyze`."""
        out: dict = {}
        for r in db.records:
            if r.op_class != "collective":
                continue
            if phase is not None and r.phase != phase:
                continue
            out[r.op] = out.get(r.op, 0.0) + r.wire_bytes
        return out

    def decode_stage_totals_mixed(self, past_lens: Sequence[int]
                                  ) -> List[Totals]:
        """Per-stage Totals of ONE mixed-length decode step — the
        stage-resolved :meth:`decode_totals_mixed`.  The affine-in-Σpast
        identity holds per stage because each stage's records are a fixed
        subset of the step's records; ``sum(stages) == mixed`` and the
        single-stage case reproduces ``[decode_totals_mixed(...)]``
        (tested)."""
        eff = self.effective_kv_lens(past_lens)
        B = len(eff)
        if not hasattr(self, "_mixed_stage_cache"):
            self._mixed_stage_cache = {}
        if B not in self._mixed_stage_cache:
            base_v = dataclasses.replace(self.variant, pad_to=1)
            base_wm = WorkloadModel(self.arch, base_v,
                                    attn_impl=self.attn_impl,
                                    plan=self.plan)
            st0 = base_wm.stage_totals(base_wm.decode_step(B, 0), "decode")
            st1 = base_wm.stage_totals(base_wm.decode_step(B, 1), "decode")
            pairs = [(t0, t1.minus(t0).scaled(1.0 / B))
                     for t0, t1 in zip(st0, st1)]
            self._mixed_stage_cache[B] = pairs
        s = float(sum(eff))
        return [t0.plus(slope, factor=s)
                for t0, slope in self._mixed_stage_cache[B]]

    def effective_kv_lens(self, past_lens: Sequence[int],
                          q_len: int = 1) -> List[int]:
        """Per-slot effective past lengths after ``pad_to`` / local-window
        adjustment — the quantities :meth:`decode_totals_mixed` /
        :meth:`verify_totals_mixed` are affine in (exposed so callers can
        memoize on ``(B, Σ eff)``).  ``q_len`` is the new tokens the step
        scores on top of the past (1 for plain decode, ``k + 1`` for a
        speculative verify)."""
        a, v = self.arch, self.variant
        eff = []
        for p in past_lens:
            kv = p + q_len
            if v.pad_to > 1:
                kv = -(-kv // v.pad_to) * v.pad_to
            if a.local_window:
                kv = min(kv, a.local_window)
            eff.append(kv - q_len)
        return eff

    def generate_timeline(self, batch: int, prompt_len: int, n_new: int,
                          sample_every: int = 1) -> List[TimelinePoint]:
        """Decode timeline (paper Fig. 7): per-token workload vs. KV growth."""
        points: List[TimelinePoint] = []
        for step in range(0, n_new, sample_every):
            past = prompt_len + step
            db = self.decode_step(batch, past)
            points.append(TimelinePoint(step=step, past_len=past,
                                        totals=db.totals("decode")))
        return points

    def lora_update(self, rank: Optional[int] = None,
                    db: Optional[StatsDB] = None) -> StatsDB:
        """One-time full-model adapter merge (paper Eq. 7 / Table 12)."""
        db = db or StatsDB()
        db.set_phase("lora_update")
        a, v = self.arch, self.variant
        r = rank or v.lora_rank or 16
        with db.sharded(self.plan.tp):
            for k, n, name in self._linear_shapes():
                with db.scope(name):
                    F.lora_merge(db, k, n, r, dtype_w=v.dtype_w)
        return db

    def lora_step(self, mix: Sequence[int], q_len: int = 1,
                  max_rank: Optional[int] = None,
                  db: Optional[StatsDB] = None,
                  dtype_lora: str = "bf16",
                  phase: str = "lora_step") -> StatsDB:
        """Per-step grouped-LoRA surcharge of ONE multi-tenant engine step.

        ``mix[i]`` is the adapter rank live slot ``i`` decodes with
        (0 = base model), ``q_len`` the queries each slot scores (1 for
        decode, ``k + 1`` for a speculative verify, the chunk length for
        a prefill chunk).  Prices what the engine actually runs per
        attention layer: the scalar-prefetched adapter-index gather, then
        per live slot the two low-rank GEMMs ``(x @ A[idx]) @ B[idx]``
        over q/k/v/o at the *pool-padded* rank ``max_rank`` (adapters are
        stored zero-padded to the pool-wide max rank — pad lanes cost MXU
        cycles and DMA bytes in the fused kernel AND in the gathered XLA
        reference, so the analytical model charges them too; default: the
        mix's own max).  Factor reads are charged per slot, not per
        distinct tenant, matching the kernel's per-grid-step DMA.  An
        empty/all-zero mix prices only the index gather.  Work divides by
        ``plan.tp`` (the rank axis shards; the delta's psum merges into
        the projection all-reduce already priced by the base step).
        """
        db = db or StatsDB()
        db.set_phase(phase)
        a, v = self.arch, self.variant
        mix = [int(r) for r in mix]
        if any(r < 0 for r in mix) or q_len < 1:
            raise ValueError(f"lora_step needs ranks >= 0 and q_len >= 1, "
                             f"got mix={mix}, q_len={q_len}")
        live = [r for r in mix if r > 0]
        R = max_rank if max_rank is not None else (max(live) if live else 0)
        if live and R < max(live):
            raise ValueError(f"max_rank={R} below the mix's max {max(live)}")
        n_attn = sum(1 for k in a.block_kinds() if k == "attn")
        act_b = dtypes.get(v.dtype_act).bytes_per_el
        lora_b = dtypes.get(dtype_lora).bytes_per_el
        d, H, Hk, hd = a.d_model, a.n_heads, a.n_kv_heads, (a.head_dim or 0)
        projs = (("q", d, H * hd), ("k", d, Hk * hd), ("v", d, Hk * hd),
                 ("o", H * hd, d))
        S_live, T = len(live), q_len
        with db.scope("model"), db.sharded(self.plan.tp):
            # per-slot adapter pool indices, prefetched by every layer
            db.record("adapter_table", mem_rd=float(n_attn * len(mix) * 4),
                      dispatches=0, op_class="gather")
            if not live:
                return db
            for name, k, n in projs:
                ops = S_live * (2.0 * T * k * R + 2.0 * T * R * n)
                param = S_live * (k * R + R * n) * lora_b
                acts_rd = S_live * T * (k + R) * act_b
                acts_wr = S_live * T * (R + n) * act_b
                db.record(f"grouped_lora_{name}",
                          ops=float(n_attn * ops),
                          mem_rd=float(n_attn * (param + acts_rd)),
                          mem_wr=float(n_attn * acts_wr),
                          dispatches=n_attn, op_class="gemm")
        return db

    # ------------------------------------------------------------------
    # static size accounting
    # ------------------------------------------------------------------
    def weight_bytes(self) -> float:
        a, v = self.arch, self.variant
        wdt = dtypes.get(v.dtype_w)
        adt = dtypes.get(v.dtype_act)
        lin = sum(k * n for k, n, _ in self._linear_shapes())
        emb = a.vocab_size * a.d_model  # embeddings stay high-precision
        other = a.param_count() - lin - emb - (
            0 if a.tie_embeddings else a.vocab_size * a.d_model)
        head = 0 if a.tie_embeddings else a.vocab_size * a.d_model
        return (wdt.storage_bytes(int(lin + head), v.group_size)
                + (emb + max(other, 0)) * adt.bytes_per_el)

    def kv_cache_bytes(self, seq: int, batch: int = 1) -> float:
        a, v = self.arch, self.variant
        qdt = dtypes.get(v.kv_dtype)
        n_el_tok = 0.0
        for kind in a.block_kinds():
            if kind != "attn":
                continue
            if a.mla is not None:
                n_el_tok += a.mla.kv_lora_rank + a.mla.qk_rope_head_dim
            else:
                n_el_tok += 2 * a.n_kv_heads * (a.head_dim or 0)
        span = seq if not a.local_window else min(seq, a.local_window)
        total_el = batch * span * n_el_tok
        # recurrent state: fp32 SSM/LRU state + bf16 conv tails (matches
        # models.init_decode_state dtypes exactly)
        state = 0.0
        for kind in a.block_kinds():
            if kind == "ssm":
                di = a.ssm_expand * a.d_model
                state += batch * (di * a.ssm_d_state * 4.0
                                  + di * (a.ssm_conv_kernel - 1) * 2.0)
            elif kind == "rglru":
                w = a.lru_width or a.d_model
                state += batch * (w * 4.0 + w * (a.ssm_conv_kernel - 1) * 2.0)
        return qdt.storage_bytes(int(total_el), v.group_size) + state

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _linear_shapes(self) -> Sequence[tuple]:
        """(k, n, name) of every weight GEMM (for LoRA merge & quant size)."""
        a = self.arch
        out = []
        d, hd = a.d_model, (a.head_dim or 0)
        for i, kind in enumerate(a.block_kinds()):
            if kind == "attn":
                if a.mla is not None:
                    m = a.mla
                    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                    out += [(d, m.q_lora_rank, f"l{i}.q_down"),
                            (m.q_lora_rank, a.n_heads * qk, f"l{i}.q_up"),
                            (d, m.kv_lora_rank + m.qk_rope_head_dim, f"l{i}.kv_down"),
                            (m.kv_lora_rank, a.n_heads * (m.qk_nope_head_dim + m.v_head_dim), f"l{i}.kv_up"),
                            (a.n_heads * m.v_head_dim, d, f"l{i}.o_proj")]
                else:
                    out += [(d, a.n_heads * hd, f"l{i}.q_proj"),
                            (d, a.n_kv_heads * hd, f"l{i}.k_proj"),
                            (d, a.n_kv_heads * hd, f"l{i}.v_proj"),
                            (a.n_heads * hd, d, f"l{i}.o_proj")]
                if a.n_encoder_layers:  # decoder cross-attention
                    out += [(d, d, f"l{i}.xattn_{p}") for p in "qkvo"]
            elif kind == "ssm":
                di = a.ssm_expand * d
                dtr = a.ssm_dt_rank or max(1, d // 16)
                out += [(d, 2 * di, f"l{i}.in_proj"),
                        (di, dtr + 2 * a.ssm_d_state, f"l{i}.x_proj"),
                        (dtr, di, f"l{i}.dt_proj"),
                        (di, d, f"l{i}.out_proj")]
            elif kind == "rglru":
                w = a.lru_width or d
                out += [(d, w, f"l{i}.linear_x"), (d, w, f"l{i}.linear_y"),
                        (w, d, f"l{i}.linear_out")]
            if a.family == "moe":
                out += [(d, a.n_experts, f"l{i}.router")]
                for e in range(a.n_experts + a.n_shared_experts):
                    out += [(d, a.d_ff_expert, f"l{i}.e{e}.gate"),
                            (d, a.d_ff_expert, f"l{i}.e{e}.up"),
                            (a.d_ff_expert, d, f"l{i}.e{e}.down")]
            elif kind != "ssm" and a.d_ff:
                if a.gated_mlp:
                    out += [(d, a.d_ff, f"l{i}.gate_proj")]
                out += [(d, a.d_ff, f"l{i}.up_proj"),
                        (a.d_ff, d, f"l{i}.down_proj")]
        for i in range(a.n_encoder_layers):
            out += [(d, d, f"enc{i}.{p}_proj") for p in "qkvo"]
            out += [(d, a.d_ff, f"enc{i}.up_proj"), (a.d_ff, d, f"enc{i}.down_proj")]
        return out

    def _act_wire_bytes(self, ntok: int) -> float:
        """Per-chip ring all-reduce wire bytes of one (ntok, d_model)
        activation under the plan: 2·(tp−1)/tp of the tensor crosses each
        chip's links (reduce-scatter + all-gather)."""
        a, v = self.arch, self.plan
        el = dtypes.get(self.variant.dtype_act).bytes_per_el
        return ntok * a.d_model * el * 2.0 * (v.tp - 1) / v.tp

    def _collective(self, db: StatsDB, ntok: int) -> None:
        """One Megatron-style all-reduce of an (ntok, d_model) activation:
        after a row-sharded projection (attention o_proj / MLP down_proj)
        or combining the masked partial lookups of the vocab-parallel
        embedding table."""
        if self.plan.tp <= 1:
            return
        db.record("all_reduce", wire_bytes=self._act_wire_bytes(ntok),
                  dispatches=1, op_class="collective")

    def _stage_hop(self, db: StatsDB, layer: int, ntok: int) -> None:
        """Inter-stage activation send after ``layer`` when it closes a
        non-final pipeline stage.  Recorded inside the layer's scope so
        :meth:`stage_totals` attributes the hop to the SENDING stage.
        ``pp == 1`` emits nothing (bit-for-bit with the unstaged model)."""
        if self.plan.pp <= 1:
            return
        if any(layer == hi - 1 for (lo, hi) in self.stage_spans()[:-1]):
            db.record("stage_hop", wire_bytes=self.hop_wire_bytes(ntok),
                      dispatches=1, op_class="collective")

    def _moe_a2a(self, db: StatsDB, ntok: int) -> None:
        """MoE token dispatch + combine all-to-alls under expert
        parallelism, top_k-weighted."""
        a, p = self.arch, self.plan
        if p.ep <= 1 or a.family != "moe":
            return
        el = dtypes.get(self.variant.dtype_act).bytes_per_el
        wire = ntok * a.d_model * el * a.top_k * (p.ep - 1) / p.ep
        db.record("all_to_all", wire_bytes=2.0 * wire, dispatches=2,
                  op_class="collective")

    def _encoder(self, db: StatsDB, batch: int) -> None:
        """Whisper-style encoder over precomputed (stub) frame embeddings."""
        a, v = self.arch, self.variant
        frames = a.encoder_len
        ntok = batch * frames
        with db.scope("encoder"):
            for i in range(a.n_encoder_layers):
                with db.scope(f"enc{i}"):
                    D.norm(db, ntok, a.d_model, kind=a.norm_kind,
                           dtype=v.dtype_act, fused=v.fused)
                    D.mha_block(db, batch, frames, frames, a.d_model,
                                a.n_heads, a.n_heads, a.head_dim or 64,
                                dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                                group_size=v.group_size, kv_dtype="bf16",
                                fused=v.fused)
                    self._collective(db, ntok)
                    D.residual_add(db, ntok, a.d_model, dtype=v.dtype_act,
                                   fused=v.fused)
                    D.norm(db, ntok, a.d_model, kind=a.norm_kind,
                           dtype=v.dtype_act, fused=v.fused)
                    D.mlp(db, ntok, a.d_model, a.d_ff, gated=a.gated_mlp,
                          dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                          group_size=v.group_size, fused=v.fused,
                          actfn_algo=v.actfn_algo)
                    self._collective(db, ntok)
                    D.residual_add(db, ntok, a.d_model, dtype=v.dtype_act,
                                   fused=v.fused)

    def _block(self, db: StatsDB, kind: str, batch: int, q_len: int,
               kv_len: int, decode: bool) -> None:
        a, v = self.arch, self.variant
        ntok = batch * q_len
        lora = v.lora_rank if v.lora_inline else None
        D.norm(db, ntok, a.d_model, kind=a.norm_kind, dtype=v.dtype_act,
               fused=v.fused)
        if kind == "attn":
            pad = v.pad_to if decode else 1
            if a.mla is not None:
                D.mla_block(db, batch, q_len, kv_len, a.d_model, a.n_heads,
                            q_lora_rank=a.mla.q_lora_rank,
                            kv_lora_rank=a.mla.kv_lora_rank,
                            qk_nope_head_dim=a.mla.qk_nope_head_dim,
                            qk_rope_head_dim=a.mla.qk_rope_head_dim,
                            v_head_dim=a.mla.v_head_dim,
                            dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                            group_size=v.group_size, kv_dtype=v.kv_dtype,
                            fused=v.fused, rope_table=a.max_position)
            else:
                D.mha_block(db, batch, q_len, kv_len, a.d_model, a.n_heads,
                            a.n_kv_heads, a.head_dim or 0,
                            dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                            group_size=v.group_size, kv_dtype=v.kv_dtype,
                            qkv_bias=a.qkv_bias, fused=v.fused, pad_to=pad,
                            rope_table=a.max_position, lora_rank=lora,
                            window=a.local_window or None,
                            attn_fused=(True if self.attn_impl == "paged"
                                        else None))
                if self.attn_impl == "gather":
                    span = (min(kv_len, a.local_window) if a.local_window
                            else kv_len)
                    D.page_rematerialization(
                        db, batch, span, a.n_kv_heads, a.head_dim or 0,
                        kv_dtype=v.kv_dtype, group_size=v.group_size)
            if a.n_encoder_layers:  # decoder cross-attention over encoder KV
                D.residual_add(db, ntok, a.d_model, dtype=v.dtype_act,
                               fused=v.fused)
                D.norm(db, ntok, a.d_model, kind=a.norm_kind,
                       dtype=v.dtype_act, fused=v.fused)
                D.cross_attention_block(
                    db, batch, q_len, a.encoder_len, a.d_model, a.n_heads,
                    a.n_heads, a.head_dim or 64,
                    compute_enc_kv=not decode and kv_len == q_len,
                    dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                    group_size=v.group_size, kv_dtype=v.kv_dtype, fused=v.fused)
                self._collective(db, ntok)   # cross-attn o_proj all-reduce
        elif kind == "ssm":
            D.ssm_block(db, batch, q_len, a.d_model, d_state=a.ssm_d_state,
                        expand=a.ssm_expand, conv_kernel=a.ssm_conv_kernel,
                        dt_rank=a.ssm_dt_rank or None, dtype_act=v.dtype_act,
                        dtype_w=v.dtype_w, group_size=v.group_size,
                        fused=v.fused)
        elif kind == "rglru":
            D.rglru_block(db, batch, q_len, a.d_model,
                          lru_width=a.lru_width or None,
                          conv_kernel=a.ssm_conv_kernel,
                          dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                          group_size=v.group_size, fused=v.fused)
        self._collective(db, ntok)   # token-mixer out_proj all-reduce
        D.residual_add(db, ntok, a.d_model, dtype=v.dtype_act, fused=v.fused)
        # channel mixer (mamba folds it into the ssm block)
        if kind != "ssm" and (a.d_ff or a.family == "moe"):
            D.norm(db, ntok, a.d_model, kind=a.norm_kind, dtype=v.dtype_act,
                   fused=v.fused)
            if a.family == "moe":
                self._moe_a2a(db, ntok)   # expert dispatch a2a (ep axis)
                D.moe_layer(db, ntok, a.d_model, a.d_ff_expert, a.n_experts,
                            a.top_k, n_shared=a.n_shared_experts,
                            dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                            group_size=v.group_size, fused=v.fused,
                            actfn_algo=v.actfn_algo)
            else:
                D.mlp(db, ntok, a.d_model, a.d_ff, gated=a.gated_mlp,
                      dtype_act=v.dtype_act, dtype_w=v.dtype_w,
                      group_size=v.group_size, bias=False,
                      actfn_algo=v.actfn_algo, fused=v.fused, lora_rank=lora)
            self._collective(db, ntok)   # channel-mixer down_proj all-reduce
        D.residual_add(db, ntok, a.d_model, dtype=v.dtype_act, fused=v.fused)
