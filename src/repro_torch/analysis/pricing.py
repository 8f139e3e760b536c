"""Pricing cross-check: the counted work of the port's engine steps vs the
analytical WorkloadModel (the PyTorch counterpart of the JAX package's
``analysis/pricing.py``).

The reference jit-lowers and compiles its engine's hot paths and reads
XLA's module; the port compiles nothing, so the audit *executes* each
hot path once — one prompt-chunk prefill, one fused decode step, one
batched speculative-verify step, under both attention impls and
representative tp/pp plans — inside :func:`repro_torch.core.counts.
count_work` on the caller's device, then reconciles what ran against
what the analytical twin prices for the identical geometry, check for
check and with the reference's tolerances:

* **matmul FLOPs** (the load-bearing check): counted ``dot`` FLOPs
  (``FlopCounterMode``'s products plus each hand-written kernel's cost
  function) vs the analytical ``gemm`` + ``bmm`` operator classes.
  Both count 2·m·k·n, so this check is tight (default 15 %) and carries
  the mutation gate;
* **memory bytes** (sanity net): the counted per-op boundary bytes vs
  the analytical memory totals inside a wide ratio window (the port runs
  unfused, so every elementwise op reads and writes its tensors);
* **collective wire bytes**: per-rank ring-convention wire of the
  collectives the rank issued vs the ``wire_bytes`` records of the
  sharded plan, at the serving dtype;
* **unpriced work**: every op family carrying a non-trivial share of the
  counted FLOPs or bytes must map to an analytical operator class
  present in the record stream.

Geometry: the engine attends a slot's whole virtual sequence ``L_virt =
max_blocks_per_seq × block_size`` (the paged kernels' grids cover every
table entry), and each step here runs with its cursors at ``L_virt``
minus its queries, so every comparator is evaluated at ``kv_len =
L_virt`` exactly as the reference's.  The prefill reads logits at one
position; the comparator subtracts the LM head's other positions.

A sharded target (``tp·pp > 1``) runs on ranks from
``launch.mesh.spawn``: gloo on the CPU; on the card one rank per card,
or ranks sharing the card when the caller asks for it
(``share_device``).  The busiest rank's count (the most dot FLOPs) is
reconciled: the reference's per-chip view of one SPMD module, where the
port's pipeline stages differ (the last holds the LM head).  A target
whose ranks cannot be had is skipped with the reference's
``pricing.target_skipped`` info finding.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, Variant
from repro_torch.core import counts, dtypes
from repro_torch.core.stats import StatsDB
from repro_torch.core.workload import ShardingPlan, WorkloadModel

from .findings import Finding, Severity


#: the seed of the random weights every target runs with
SEED = 0


@dataclasses.dataclass(frozen=True)
class PricingTarget:
    """One engine entry point to execute, count and reconcile.

    ``lora_rank > 0`` runs the target with a grouped-LoRA adapter pool of
    that rank (every slot live on an adapter) and adds the matching
    ``WorkloadModel.lora_step`` records to the comparator."""
    kind: str                   # "prefill" | "decode" | "verify"
    attn_impl: str              # "gather" | "paged"
    tp: int = 1
    pp: int = 1
    lora_rank: int = 0

    @property
    def name(self) -> str:
        plan = f"/tp{self.tp}pp{self.pp}" if self.tp * self.pp > 1 else ""
        lora = f"/lora{self.lora_rank}" if self.lora_rank else ""
        return f"{self.kind}/{self.attn_impl}{plan}{lora}"


#: single-device coverage of every entry point × both attention impls;
#: the audit appends the LoRA and sharded decode targets (see
#: :func:`repro_torch.analysis.audit.default_targets`)
DEFAULT_TARGETS: Tuple[PricingTarget, ...] = tuple(
    PricingTarget(kind, impl)
    for kind in ("prefill", "decode", "verify")
    for impl in ("gather", "paged"))


@dataclasses.dataclass(frozen=True)
class Tolerances:
    """Knobs of the reconciliation checks (audit CLI flags)."""
    matmul_rtol: float = 0.15          # dot vs gemm+bmm relative tolerance
    bytes_window: Tuple[float, float] = (0.05, 20.0)  # counted/analytical
    wire_rtol: float = 0.5             # collective wire relative tolerance
    unpriced_share: float = 0.02       # flops/bytes share that needs pricing


@dataclasses.dataclass(frozen=True)
class AuditGeometry:
    """Small static shapes shared by every target."""
    max_slots: int = 2
    block_size: int = 16
    max_blocks_per_seq: int = 2
    n_blocks: int = 8
    chunk_size: int = 32               # == L_virt: prefill fills the span
    spec_k: int = 1                    # verify runs k+1 = 2 queries/slot

    @property
    def l_virt(self) -> int:
        return self.max_blocks_per_seq * self.block_size


@dataclasses.dataclass
class PoolCheck:
    """What the hygiene pass reads of one executed step's KV pool."""
    pool_shape: Tuple[int, ...]
    pool_bytes: int                    # one pool buffer (cache_k)
    kept_storage: bool                 # K and V kept their storage
    #: tensors the step made of a pool buffer's shape or of one layer's
    pool_copies: int
    largest_alloc_bytes: float         # the largest tensor the step made
    #: the step's ``max_memory_allocated`` rise on the card (None on the
    #: CPU)
    rise_bytes: Optional[int] = None


@dataclasses.dataclass
class CompiledTarget:
    """One executed target with both cost views attached (the reference's
    name: here nothing is compiled, the step ran once)."""
    target: PricingTarget
    module_cost: counts.ModuleCost
    db: StatsDB                        # analytical records, same geometry
    wm: WorkloadModel
    phase: str                         # StatsDB phase of the comparator
    run_s: float                       # the counted step's seconds
    batch: int                         # sequences in the dispatch
    q_len: int                         # new tokens per sequence
    pool: PoolCheck
    device: str = "cpu"
    #: a sharded target's dot FLOPs on each rank (rank order)
    rank_dot_flops: Optional[List[float]] = None


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _shape(target: PricingTarget, geom: AuditGeometry
           ) -> Tuple[int, int, str]:
    """(sequences, queries per sequence, StatsDB phase) of a target."""
    if target.kind == "prefill":
        return 1, geom.chunk_size, "prefill"
    if target.kind == "decode":
        return geom.max_slots, 1, "decode"
    if target.kind == "verify":
        return geom.max_slots, geom.spec_k + 1, "decode"
    raise ValueError(f"unknown pricing target kind {target.kind!r}")


def _run_step(cfg: ArchConfig, params, target: PricingTarget,
              geom: AuditGeometry, device: torch.device, mesh=None
              ) -> Tuple[counts.ModuleCost, PoolCheck, float]:
    """Build the target's step over a fresh ``BlockPagedKVCache`` (this
    rank's, on a mesh), run it once inside ``count_work`` and return the
    count, the pool check and the step's seconds."""
    from repro_torch.engine.decode_loop import make_engine_fns, make_verify_fn
    from repro_torch.engine.kv_cache import BlockPagedKVCache
    from repro_torch.runtime.sharding import ShardingPolicy

    policy = ShardingPolicy()
    tp, pp = target.tp, target.pp
    cache = BlockPagedKVCache(
        cfg, geom.max_slots, n_blocks=geom.n_blocks,
        block_size=geom.block_size,
        max_blocks_per_seq=geom.max_blocks_per_seq, kv_dtype="bf16",
        lora_slots=(geom.max_slots if target.lora_rank else 0),
        lora_max_rank=target.lora_rank, tp=tp, pp=pp,
        tp_rank=mesh.coords["model"] if tp > 1 else 0,
        stage=mesh.stage if pp > 1 else 0)
    state = cache.init_state(device)
    S, nb = geom.max_slots, geom.max_blocks_per_seq
    # each slot its own blocks, as the scheduler hands them out
    state["block_tables"].copy_(torch.arange(
        S * nb, dtype=torch.int32, device=device).reshape(S, nb))
    if target.lora_rank:
        state["adapter_slots"].copy_(torch.arange(
            S, dtype=torch.int32, device=device))
    batch, q_len, _ = _shape(target, geom)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(batch, q_len))
    plan = dict(attn_impl=target.attn_impl, mesh=mesh, policy=policy)
    if target.kind == "verify":
        step_fn = make_verify_fn(cfg, cache, **plan)
        state["pos"].fill_(geom.l_virt - q_len)

        def step():
            return step_fn(params, state, toks, np.ones(S, bool),
                           np.full(S, q_len))
    else:
        prefill_fn, decode_fn = make_engine_fns(
            cfg, cache, chunk_size=geom.chunk_size, decode_block=1,
            temperature=0.0, eos_id=None, **plan)
        if target.kind == "prefill":
            start = geom.l_virt - q_len
            state["pos"][0] = start
            tokens = torch.as_tensor(toks, dtype=torch.long, device=device)

            def step():
                return prefill_fn(params, state, tokens, 0, start, q_len)
        else:
            state["pos"].fill_(geom.l_virt - 1)

            def step():
                return decode_fn(params, state, np.ones(S, bool),
                                 np.ones(S, np.int32))
    ptrs = [state[k].untyped_storage().data_ptr()
            for k in ("cache_k", "cache_v")]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    shape = tuple(state["cache_k"].shape)
    with torch.no_grad(), counts.count_work(
            watch=(shape, shape[1:])) as mc:
        out = step()
    if cuda:
        torch.cuda.synchronize(device)
    run_s = time.perf_counter() - t0
    del out
    pool = PoolCheck(
        pool_shape=shape, pool_bytes=counts.nbytes(state["cache_k"]),
        kept_storage=ptrs == [state[k].untyped_storage().data_ptr()
                              for k in ("cache_k", "cache_v")],
        pool_copies=mc.watched_made,
        largest_alloc_bytes=mc.largest_alloc_bytes,
        rise_bytes=(torch.cuda.max_memory_allocated(device) - base
                    if cuda else None))
    return mc, pool, run_s


def _price_rank(mesh, cfg: ArchConfig, target: PricingTarget,
                geom: AuditGeometry):
    """A rank of a sharded target: its shard of ``init_params(cfg,
    SEED)``, then the step; returns (count, pool check, seconds)."""
    from repro_torch.runtime.sharding import init_shard
    params = init_shard(cfg, SEED, mesh, device=mesh.device)
    return _run_step(cfg, params, target, geom, mesh.device, mesh)


def lower_target(cfg: ArchConfig, target: PricingTarget,
                 geom: AuditGeometry = AuditGeometry(),
                 variant: Optional[Variant] = None, *, device="cuda",
                 params=None, share_device: bool = False
                 ) -> CompiledTarget:
    """Execute one engine entry point once and build its analytical
    comparator (the reference's name; the reference compiles on abstract
    inputs, the port runs the step on ``device`` — the card unless the
    CPU is asked for — with random weights ``init_params(cfg, SEED)``, or
    ``params`` when given, and a fresh KV pool).  A sharded target runs
    on ``tp·pp`` spawned ranks, each with its shard of the same weights
    (``share_device``: ranks may share a card), and the busiest rank's
    count is kept."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    if target.tp * target.pp > 1:
        from repro_torch.launch.mesh import spawn
        ranks = spawn(_price_rank, (cfg, target, geom),
                      model=target.tp, pipe=target.pp, device=dev.type,
                      share_device=share_device)
        # the busiest rank bounds the step: under pp the stages differ
        # (the last holds the LM head), under tp alone they are equal
        mc, pool, run_s = max(ranks, key=lambda r: r[0].dot_flops)
        rank_dot = [r[0].dot_flops for r in ranks]
    else:
        if params is None:
            from repro_torch.models import init_params
            params = init_params(cfg, SEED, device=dev)
        mc, pool, run_s = _run_step(cfg, params, target, geom, dev)
        rank_dot = None

    # analytical comparator at the SAME geometry: the step attends the
    # full virtual span, so past_len tops kv_len up to L_virt exactly
    batch, q_len, phase = _shape(target, geom)
    wm = WorkloadModel(cfg, variant or Variant(), attn_impl=target.attn_impl,
                       plan=ShardingPlan(tp=target.tp, pp=target.pp))
    past = geom.l_virt - q_len
    if target.kind == "prefill":
        db = wm.prefill(batch, q_len, past_len=past)
    elif target.kind == "decode":
        db = wm.decode_step(batch, past)
    else:
        db = wm.verify_step(batch, past, geom.spec_k)
    if target.lora_rank:
        # every slot is live on a rank-R adapter
        wm.lora_step([target.lora_rank] * batch, q_len=q_len,
                     max_rank=target.lora_rank, db=db, phase=phase)
    return CompiledTarget(target=target, module_cost=mc, db=db, wm=wm,
                          phase=phase, run_s=run_s, batch=batch,
                          q_len=q_len, pool=pool, device=dev.type,
                          rank_dot_flops=rank_dot)


# ---------------------------------------------------------------------------
# reconciliation
# ---------------------------------------------------------------------------

#: which analytical op classes can account for each op family (the
#: reference's map, unchanged: the counts file aten ops under its HLO
#: family names); ``None`` marks structural/layout ops the analytical
#: model deliberately never prices as work of their own
_ELEMWISE_CLASSES = ("elemw", "nlf", "softmax", "quant", "scan",
                     "embedding")
_FAMILY_MAP: Dict[str, Optional[Tuple[str, ...]]] = {
    "dot": ("gemm", "bmm"),
    "convolution": ("conv",),
    "fusion": _ELEMWISE_CLASSES,
    "reduce": _ELEMWISE_CLASSES,
    "reduce-window": _ELEMWISE_CLASSES,
    "gather": ("gather", "embedding", "kv"),
    "dynamic-slice": ("gather", "embedding", "kv"),
    "dynamic-update-slice": ("kv",),
    "scatter": ("kv",),
    "all-reduce": ("collective",),
    "all-gather": ("collective",),
    "reduce-scatter": ("collective",),
    "all-to-all": ("collective",),
    "collective-permute": ("collective",),
    # layout engineering / bookkeeping: boundary traffic of these is part
    # of the materialization strategy, not separately priced work
    "copy": None, "transpose": None, "reshape": None, "broadcast": None,
    "iota": None, "slice": None, "concatenate": None, "pad": None,
    "reverse": None, "sort": None, "rng": None, "rng-bit-generator": None,
}


def _family_classes(op: str) -> Optional[Tuple[str, ...]]:
    if op in _FAMILY_MAP:
        return _FAMILY_MAP[op]
    if op in counts.ELEMENTWISE_FAMILIES:
        return _ELEMWISE_CLASSES
    return ("<unmapped>",)


def reconcile(ct: CompiledTarget, tol: Tolerances = Tolerances(),
              perturb: Optional[Dict[str, float]] = None) -> List[Finding]:
    """All pricing checks for one executed target.

    ``perturb`` scales the analytical op-class totals before comparison —
    the mutation-test hook (``--perturb gemm=1.5`` must break the matmul
    reconciliation; a tolerance that survives it is too loose to gate)."""
    out: List[Finding] = []
    t = ct.target
    mc = ct.module_cost
    byc = {k: v.as_dict() for k, v in ct.db.by_op_class(ct.phase).items()}
    for cls, factor in (perturb or {}).items():
        if cls in byc:
            byc[cls] = {k: v * factor for k, v in byc[cls].items()}
    totals = ct.db.totals(ct.phase)

    if mc.unknown_trip_loops:
        out.append(Finding(
            "pricing", "pricing.unknown_trip_loop", Severity.WARNING,
            f"[{t.name}] {mc.unknown_trip_loops} loop(s) lack a known "
            f"trip count — counted costs are lower bounds",
            {"target": t.name, "loops": mc.unknown_trip_loops}))

    # ---- matmul FLOPs (tight; carries the mutation gate) ---------------
    ana_matmul = sum(byc.get(c, {}).get("ops", 0.0) for c in ("gemm", "bmm"))
    if t.kind == "prefill":
        # engine reads logits at ONE position; the analytical convention
        # prices the LM head over all chunk positions — subtract the known
        # difference instead of loosening the tolerance
        lm = sum(r.ops for r in ct.db.records
                 if r.op == "lm_head" and r.phase == ct.phase)
        lm *= (perturb or {}).get("gemm", 1.0)
        ntok = ct.batch * ct.q_len
        ana_matmul -= lm * (ntok - 1) / ntok
    counted = mc.dot_flops
    # per-rank views: the analytical side is per-chip in tp (sharded
    # division) but NOT in pp — a rank holds one stage's matmuls (1/pp);
    # pp == 1 collapses the window to the plain tolerance band
    lo = ana_matmul / t.pp * (1.0 - tol.matmul_rtol)
    hi = ana_matmul * (1.0 + tol.matmul_rtol)
    detail = {
        "target": t.name, "counted_dot_flops": counted,
        "analytical_matmul_ops": ana_matmul,
        "ratio": counted / ana_matmul if ana_matmul else float("inf"),
        "rtol": tol.matmul_rtol, "perturb": dict(perturb or {}),
        "counted_flops": mc.flops,
        "rank_dot_flops": ct.rank_dot_flops,
    }
    if not (lo <= counted <= hi):
        classes = sorted(set(perturb or {}) & {"gemm", "bmm"}) or \
            ["gemm", "bmm"]
        out.append(Finding(
            "pricing", "pricing.matmul_mismatch", Severity.ERROR,
            f"[{t.name}] counted dot FLOPs {counted:.4g} disagree "
            f"with the analytical {'+'.join(classes)} operator-class "
            f"total {ana_matmul:.4g} beyond ±{tol.matmul_rtol:.0%} "
            f"(ratio {detail['ratio']:.3f})", detail))
    else:
        out.append(Finding(
            "pricing", "pricing.matmul_ok", Severity.INFO,
            f"[{t.name}] dot FLOPs reconcile: counted {counted:.4g} vs "
            f"analytical {ana_matmul:.4g} "
            f"(ratio {detail['ratio']:.3f})", detail))

    # ---- aggregate bytes (wide sanity window) --------------------------
    ana_mem = totals.mem_total
    ratio = mc.bytes / ana_mem if ana_mem else float("inf")
    if not (tol.bytes_window[0] <= ratio <= tol.bytes_window[1]):
        out.append(Finding(
            "pricing", "pricing.bytes_out_of_window", Severity.ERROR,
            f"[{t.name}] counted boundary bytes {mc.bytes:.4g} are "
            f"{ratio:.2g}× the analytical memory total {ana_mem:.4g} — "
            f"outside the sanity window {tol.bytes_window}",
            {"target": t.name, "counted_bytes": mc.bytes,
             "analytical_mem": ana_mem, "ratio": ratio,
             "window": list(tol.bytes_window)}))

    # ---- collective wire bytes -----------------------------------------
    # compared at the SERVING dtype: ring-convention wire ELEMENTS ×
    # serving bytes/element (the reference's rule; the port's wire dtype
    # is the activations' anyway)
    ana_wire = ct.wm.wire_bytes_by_op(ct.db, ct.phase)
    ana_total = sum(ana_wire.values())
    act_el = dtypes.get(ct.wm.variant.dtype_act).bytes_per_el
    counted_wire = (mc.wire_elements * act_el if mc.wire_elements
                    else mc.wire_bytes)
    wire_detail = {"target": t.name, "counted_wire": mc.collective_wire,
                   "counted_wire_elements": mc.collective_wire_elements,
                   "counted_wire_at_serving_dtype": counted_wire,
                   "counted_counts": mc.collective_counts,
                   "analytical_wire": ana_wire}
    if ana_total == 0.0 and counted_wire > 0.0:
        out.append(Finding(
            "pricing", "pricing.unpriced_collectives", Severity.ERROR,
            f"[{t.name}] the step moves {counted_wire:.4g} collective "
            f"wire bytes but the analytical plan records none",
            wire_detail))
    elif ana_total > 0.0:
        rel = abs(counted_wire - ana_total) / ana_total
        wire_detail["rel_err"] = rel
        if rel > tol.wire_rtol:
            # pure-tp plans map 1:1 onto the Megatron collectives the model
            # prices, so a mismatch is an error; pp>1 plans also carry the
            # stage hops, which the analytical model does not price
            sev = Severity.ERROR if t.pp == 1 else Severity.INFO
            out.append(Finding(
                "pricing", "pricing.wire_mismatch", sev,
                f"[{t.name}] collective wire bytes (at serving dtype) "
                f"disagree: counted {counted_wire:.4g} vs analytical "
                f"{ana_total:.4g} (rel err {rel:.0%} > {tol.wire_rtol:.0%})"
                + ("" if t.pp == 1 else
                   " — expected for pp>1: stage hops are an unpriced "
                   "modeling gap"), wire_detail))
        else:
            out.append(Finding(
                "pricing", "pricing.wire_ok", Severity.INFO,
                f"[{t.name}] collective wire reconciles at serving dtype: "
                f"counted {counted_wire:.4g} vs analytical {ana_total:.4g} "
                f"(rel err {rel:.0%})", wire_detail))

    # ---- unpriced op families ------------------------------------------
    tot_f = sum(mc.flops_by_op.values()) or 1.0
    tot_b = sum(mc.bytes_by_op.values()) or 1.0
    families = set(mc.flops_by_op) | set(mc.bytes_by_op)
    present = {c for c, d in byc.items()
               if any(v for v in d.values())}
    for fam in sorted(families):
        f_share = mc.flops_by_op.get(fam, 0.0) / tot_f
        b_share = mc.bytes_by_op.get(fam, 0.0) / tot_b
        if max(f_share, b_share) < tol.unpriced_share:
            continue
        classes = _family_classes(fam)
        if classes is None:
            continue                       # structural: exempt by design
        if not present.intersection(classes):
            out.append(Finding(
                "pricing", "pricing.unpriced_op_family", Severity.WARNING,
                f"[{t.name}] op family {fam!r} carries "
                f"{f_share:.1%} of counted FLOPs / {b_share:.1%} of bytes "
                f"but no analytical counterpart class "
                f"({', '.join(classes)}) appears in the record stream",
                {"target": t.name, "family": fam,
                 "flops_share": f_share, "bytes_share": b_share,
                 "expected_classes": list(classes),
                 "present_classes": sorted(present)}))
    return out


def ranks_available(need: int, device, share_device: bool = False
                    ) -> Tuple[bool, int]:
    """Whether ``need`` ranks can be had on ``device`` (always on the
    CPU: gloo ranks are processes; on the card one card per rank, or
    ranks sharing the cards when ``share_device``), and the devices
    visible."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return True, need
    n = torch.cuda.device_count()
    return (n >= need or (share_device and n >= 1)), n


def run_pricing(cfg: ArchConfig, targets=DEFAULT_TARGETS,
                tol: Tolerances = Tolerances(),
                perturb: Optional[Dict[str, float]] = None,
                geom: AuditGeometry = AuditGeometry(), *, device="cuda",
                share_device: bool = False
                ) -> Tuple[List[Finding], List[CompiledTarget]]:
    """Execute and reconcile every target; a target whose ranks cannot be
    had is skipped with an info finding.  The single-device targets share
    one weight tree, dropped before any sharded target's ranks start."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    findings: List[Finding] = []
    compiled: List[CompiledTarget] = []
    params = None
    order = sorted(targets, key=lambda t: t.tp * t.pp > 1)   # stable
    for target in order:
        need = target.tp * target.pp
        ok, have = ranks_available(need, dev, share_device)
        if not ok:
            findings.append(Finding(
                "pricing", "pricing.target_skipped", Severity.INFO,
                f"[{target.name}] needs {need} devices, host exposes "
                f"{have} — skipped",
                {"target": target.name, "devices_needed": need,
                 "devices": have}))
            continue
        if need == 1 and params is None:
            from repro_torch.models import init_params
            params = init_params(cfg, SEED, device=dev)
        elif need > 1:
            params = None
        ct = lower_target(cfg, target, geom, device=dev, params=params,
                          share_device=share_device)
        compiled.append(ct)
        findings.extend(reconcile(ct, tol, perturb))
    return findings, compiled
