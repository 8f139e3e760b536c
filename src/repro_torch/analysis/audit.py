"""Audit orchestrator: lint + pricing cross-check + engine hygiene (the
PyTorch counterpart of the JAX package's ``analysis/audit.py``).

``run_audit`` is what ``python -m repro_torch audit`` calls: it builds
the default target matrix, runs the three passes and returns one
:class:`AuditReport`.  A clean tree emits only info-severity findings;
``--strict`` (the CI mode) also fails on warnings.  The pricing and
hygiene passes execute the engine on ``AuditConfig.device``: the card
unless the CPU is asked for.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch import configs
from repro_torch.configs.base import Variant
from repro_torch.core.operators import OP_CLASSES
from repro_torch.core.workload import ShardingPlan, WorkloadModel

from . import hygiene, lint, pricing
from .findings import AuditReport, Severity


@dataclasses.dataclass
class AuditConfig:
    arch: str = "qwen2-7b"
    reduced: bool = True               # small config (audit default)
    variant: str = "bf16-bf16"
    tol: pricing.Tolerances = dataclasses.field(
        default_factory=pricing.Tolerances)
    geom: pricing.AuditGeometry = dataclasses.field(
        default_factory=pricing.AuditGeometry)
    #: analytical op-class scale factors applied before reconciliation —
    #: the mutation-test hook; a non-empty dict MUST produce an error
    perturb: Dict[str, float] = dataclasses.field(default_factory=dict)
    targets: Optional[Sequence[pricing.PricingTarget]] = None
    run_engine: bool = True            # execution-based rebuild pass
    #: sharded plan to audit when its ranks can be had
    sharded_tp: int = 2
    sharded_pp: int = 2
    #: where the engine runs: the card unless "cpu" is asked for
    device: str = "cuda"
    #: let a sharded target's ranks share the visible cards
    share_device: bool = False


def default_targets(cfg: AuditConfig) -> List[pricing.PricingTarget]:
    """Single-device matrix plus the LoRA decode target and the sharded
    decode targets (each skipped by the pricing pass when its ranks
    cannot be had)."""
    targets = list(pricing.DEFAULT_TARGETS)
    # grouped-LoRA decode: the multi-tenant adapter pool's low-rank GEMMs
    # must reconcile against WorkloadModel.lora_step (gather impl = plain
    # products, so dot FLOPs are exactly comparable); rank 64 so the
    # adapter GEMMs carry a super-tolerance share of the step's dot FLOPs
    # at audit scale — dropping the lora_step records from the comparator
    # must break the reconciliation, not hide in the matmul_rtol band
    targets.append(pricing.PricingTarget("decode", "gather", lora_rank=64))
    # pure-tp plan: the only sharded case where collective wire bytes are
    # strictly gated (pp>1 adds the unpriced stage hops)
    if cfg.sharded_tp > 1:
        targets.append(pricing.PricingTarget(
            "decode", "gather", tp=cfg.sharded_tp, pp=1))
    if cfg.sharded_tp * cfg.sharded_pp > 1 and cfg.sharded_pp > 1:
        targets.append(pricing.PricingTarget(
            "decode", "gather", tp=cfg.sharded_tp, pp=cfg.sharded_pp))
    return targets


def run_audit(cfg: Optional[AuditConfig] = None) -> AuditReport:
    cfg = cfg or AuditConfig()
    for cls in cfg.perturb:
        if cls not in OP_CLASSES:
            raise ValueError(f"--perturb class {cls!r} is not an operator "
                             f"class; known: {sorted(OP_CLASSES)}")
    arch = configs.get(cfg.arch)
    if cfg.reduced:
        arch = configs.reduced(arch)
    variant = configs.PAPER_VARIANTS.get(cfg.variant, Variant())
    report = AuditReport(meta={
        "arch": cfg.arch, "reduced": cfg.reduced, "device": cfg.device,
        "perturb": dict(cfg.perturb),
        "tolerances": dataclasses.asdict(cfg.tol)})

    # ---- pass 1: operator-DSL lint (pure analytical) -------------------
    wm = WorkloadModel(arch, variant)
    db = wm.prefill(1, cfg.geom.chunk_size)
    wm.decode_step(2, cfg.geom.l_virt - 1, db=db)
    report.extend(lint.lint_model(wm, db, phase=None))
    # stage conservation under an actual multi-stage plan
    pp = min(cfg.sharded_pp, len(arch.block_kinds()))
    wm_pp = WorkloadModel(arch, variant, plan=ShardingPlan(pp=pp))
    db_pp = wm_pp.decode_step(2, cfg.geom.l_virt - 1)
    report.extend(lint.lint_stage_conservation(wm_pp, db_pp, "decode"))

    # ---- pass 2: pricing cross-check (execute once, count) -------------
    targets = (list(cfg.targets) if cfg.targets is not None
               else default_targets(cfg))
    price_findings, compiled = pricing.run_pricing(
        arch, targets, tol=cfg.tol, perturb=cfg.perturb, geom=cfg.geom,
        device=cfg.device, share_device=cfg.share_device)
    report.extend(price_findings)
    report.meta["targets"] = [ct.target.name for ct in compiled]
    report.meta["run_s"] = round(sum(ct.run_s for ct in compiled), 2)
    # each executed step's count (the busiest rank's for a sharded one)
    report.meta["counted"] = {ct.target.name: {
        "dot_flops": ct.module_cost.dot_flops,
        "bytes": ct.module_cost.bytes,
        "analytical_mem": ct.db.totals(ct.phase).mem_total,
        "wire_bytes": ct.module_cost.wire_bytes,
        "kernel_launches": ct.module_cost.kernel_launches,
        "run_s": ct.run_s} for ct in compiled}

    # ---- pass 3: engine hygiene ----------------------------------------
    for ct in compiled:
        report.extend(hygiene.audit_donation(ct))
    if cfg.run_engine:
        report.extend(hygiene.audit_retrace(arch, device=cfg.device))
    return report


def format_report(report: AuditReport, verbose: bool = False) -> str:
    """Human-readable rendering (the non-``--json`` CLI output)."""
    lines: List[str] = []
    meta = report.meta
    lines.append(
        f"audit: {meta.get('arch')}"
        f"{' (reduced)' if meta.get('reduced') else ''} on "
        f"{meta.get('device')} — "
        f"{len(meta.get('targets', []))} executed targets in "
        f"{meta.get('run_s', 0)} s")
    if meta.get("perturb"):
        lines.append(f"  perturbed classes: {meta['perturb']}")
    counts = report.counts()
    for f in report.findings:
        if f.severity == Severity.INFO and not verbose:
            continue
        lines.append(f"  [{f.severity}] {f.code}: {f.message}")
    lines.append(
        f"  {counts['error']} error(s), {counts['warning']} warning(s), "
        f"{counts['info']} info")
    return "\n".join(lines)
