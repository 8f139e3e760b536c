"""Operator-DSL linter: declarative rules over analytical OpRecord streams
(a copy of the JAX package's ``analysis/lint.py``, which imports no JAX,
rewired to the port's ``core``).

The analytical model is a DSL — scenario drivers emit :class:`OpRecord`
streams that every downstream consumer (forecaster, twin, tables) trusts
blindly.  These rules make the DSL's implicit contracts explicit and
machine-checked, so a new derived operator that, say, forgets its
``op_class`` or records KV traffic outside the memory totals fails the
audit instead of silently skewing every forecast:

* closed ``op_class`` vocabulary
  (:data:`repro_torch.core.operators.OP_CLASSES`);
* non-negative ops/bytes/wire/dispatches per record;
* KV traffic is a *subset* of memory traffic (``kv_rd <= mem_rd``,
  ``kv_wr <= mem_wr``) per record;
* wire bytes appear only on ``collective`` records, and collective
  records carry no compute;
* pipeline-stage conservation: :meth:`WorkloadModel.stage_totals`
  partitions a driver's records — the per-stage sum must reproduce the
  phase totals exactly, and every ``layer{i}`` scope must resolve to
  exactly one stage of :meth:`WorkloadModel.stage_spans`;
* tensor-parallel divisibility: a ``plan.tp`` that does not divide the
  head counts the engine shards over (what the real engine refuses);
* dtype-byte consistency: every variant dtype resolves in
  :mod:`repro_torch.core.dtypes` with positive storage width;
* the affine-in-Σpast decode identity the mixed-batch fast paths rely
  on, held numerically at three collinear points plus the
  ``decode_totals_mixed([p]*B) == decode_step(B, p)`` reduction.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

from repro_torch.core import dtypes
from repro_torch.core.operators import OP_CLASSES
from repro_torch.core.stats import OpRecord, StatsDB, Totals
from repro_torch.core.workload import WorkloadModel

from .findings import Finding, Severity

#: numeric tolerance for exact-by-construction identities (conservation,
#: affinity) — pure float addition reordering only
_EXACT_RTOL = 1e-9

_NONNEG_FIELDS = ("ops", "mem_rd", "mem_wr", "kv_rd", "kv_wr",
                  "dispatches", "wire_bytes")


def _rel_close(a: float, b: float, rtol: float = _EXACT_RTOL) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1.0)


def _totals_close(a: Totals, b: Totals, rtol: float = _EXACT_RTOL
                  ) -> List[str]:
    """Names of Totals fields where ``a`` and ``b`` disagree."""
    da, db_ = a.as_dict(), b.as_dict()
    return [k for k in da if not _rel_close(da[k], db_[k], rtol)]


# ---------------------------------------------------------------------------
# per-record rules
# ---------------------------------------------------------------------------

def lint_records(records: Iterable[OpRecord],
                 max_findings_per_rule: int = 8) -> List[Finding]:
    """Run every per-record rule over an OpRecord stream.

    Reports at most ``max_findings_per_rule`` findings per rule (a broken
    derived operator repeats per layer per scenario — one finding per
    instance would bury the signal).
    """
    out: List[Finding] = []
    counts = {"vocab": 0, "neg": 0, "kv": 0, "wire": 0}

    def _emit(rule: str, f: Finding) -> None:
        counts[rule] += 1
        if counts[rule] <= max_findings_per_rule:
            out.append(f)

    for i, r in enumerate(records):
        where = {"index": i, "op": r.op, "scope": r.scope, "phase": r.phase}
        if r.op_class not in OP_CLASSES:
            _emit("vocab", Finding(
                "lint", "lint.op_class_vocabulary", Severity.ERROR,
                f"record {r.op!r} ({r.scope}) has op_class "
                f"{r.op_class!r} outside the closed vocabulary",
                {**where, "op_class": r.op_class,
                 "vocabulary": sorted(OP_CLASSES)}))
        for field in _NONNEG_FIELDS:
            v = getattr(r, field)
            if v < 0:
                _emit("neg", Finding(
                    "lint", "lint.negative_field", Severity.ERROR,
                    f"record {r.op!r} ({r.scope}) has negative "
                    f"{field} = {v!r}", {**where, "field": field,
                                         "value": v}))
        if (r.kv_rd > r.mem_rd * (1 + _EXACT_RTOL)
                or r.kv_wr > r.mem_wr * (1 + _EXACT_RTOL)):
            _emit("kv", Finding(
                "lint", "lint.kv_exceeds_mem", Severity.ERROR,
                f"record {r.op!r} ({r.scope}) reports KV traffic "
                f"exceeding its memory traffic (kv_rd={r.kv_rd:.4g} vs "
                f"mem_rd={r.mem_rd:.4g}, kv_wr={r.kv_wr:.4g} vs "
                f"mem_wr={r.mem_wr:.4g}) — KV bytes must be a subset",
                where))
        if r.op_class == "collective":
            if r.wire_bytes <= 0 or r.ops != 0:
                _emit("wire", Finding(
                    "lint", "lint.malformed_collective", Severity.ERROR,
                    f"collective record {r.op!r} ({r.scope}) must carry "
                    f"positive wire_bytes and zero compute (wire_bytes="
                    f"{r.wire_bytes:.4g}, ops={r.ops:.4g})", where))
        elif r.wire_bytes != 0:
            _emit("wire", Finding(
                "lint", "lint.misplaced_wire", Severity.ERROR,
                f"record {r.op!r} ({r.scope}) of class {r.op_class!r} "
                f"carries wire_bytes={r.wire_bytes:.4g} — interconnect "
                f"traffic must be recorded as op_class='collective'",
                where))
    for rule, code in (("vocab", "lint.op_class_vocabulary"),
                       ("neg", "lint.negative_field"),
                       ("kv", "lint.kv_exceeds_mem"),
                       ("wire", "lint.misplaced_wire")):
        if counts[rule] > max_findings_per_rule:
            out.append(Finding(
                "lint", code, Severity.INFO,
                f"{counts[rule] - max_findings_per_rule} further "
                f"instances of {code} suppressed",
                {"total": counts[rule]}))
    return out


# ---------------------------------------------------------------------------
# model-level rules
# ---------------------------------------------------------------------------

def lint_stage_conservation(wm: WorkloadModel, db: StatsDB,
                            phase: Optional[str] = None) -> List[Finding]:
    """Per-stage partition must conserve the phase totals, and every
    ``layer{i}`` scope must land in exactly one pipeline stage."""
    out: List[Finding] = []
    spans = wm.stage_spans()
    n_layers = len(wm.arch.block_kinds())
    # spans must tile [0, n_layers) exactly once
    covered: List[int] = []
    for lo, hi in spans:
        covered.extend(range(lo, hi))
    if covered != list(range(n_layers)):
        out.append(Finding(
            "lint", "lint.stage_spans", Severity.ERROR,
            f"stage_spans() {spans} do not partition the "
            f"{n_layers}-layer stack", {"spans": spans,
                                        "n_layers": n_layers}))
        return out
    # every layer{i} scope in the records must resolve inside the spans
    bad_layers = set()
    for r in db.records:
        for seg in r.scope.split("/"):
            if seg.startswith("layer") and seg[5:].isdigit():
                if not 0 <= int(seg[5:]) < n_layers:
                    bad_layers.add(int(seg[5:]))
    if bad_layers:
        out.append(Finding(
            "lint", "lint.stage_resolution", Severity.ERROR,
            f"records reference layer scopes {sorted(bad_layers)} outside "
            f"the {n_layers}-layer stack — no pipeline stage owns them",
            {"layers": sorted(bad_layers), "n_layers": n_layers}))
        return out
    stages = wm.stage_totals(db, phase)
    summed = Totals()
    for t in stages:
        summed.merge(t)
    bad = _totals_close(summed, db.totals(phase))
    if bad:
        out.append(Finding(
            "lint", "lint.stage_conservation", Severity.ERROR,
            f"sum over {len(stages)} pipeline stages does not reproduce "
            f"the phase totals (fields {bad}) — records are dropped or "
            f"double-counted by the stage partition",
            {"fields": bad, "pp": wm.plan.pp,
             "stage_sum": summed.as_dict(),
             "totals": db.totals(phase).as_dict()}))
    return out


def lint_plan(wm: WorkloadModel) -> List[Finding]:
    """Sharding divisibility: what the engine enforces at trace time, the
    analytical plan must also respect (fractional per-chip heads price a
    workload no real chip runs)."""
    out: List[Finding] = []
    a, tp = wm.arch, wm.plan.tp
    if tp > 1 and (a.n_heads % tp or a.n_kv_heads % tp):
        out.append(Finding(
            "lint", "lint.tp_divisibility", Severity.ERROR,
            f"plan tp={tp} does not divide n_heads={a.n_heads} / "
            f"n_kv_heads={a.n_kv_heads} of {a.name!r} — the engine "
            f"refuses this plan, the analytical model must not price it",
            {"tp": tp, "n_heads": a.n_heads, "n_kv_heads": a.n_kv_heads,
             "arch": a.name}))
    if tp > 1 and a.d_ff and a.d_ff % tp:
        out.append(Finding(
            "lint", "lint.tp_divisibility", Severity.WARNING,
            f"plan tp={tp} does not divide d_ff={a.d_ff} of {a.name!r} — "
            f"column-sharded MLP shards would be ragged",
            {"tp": tp, "d_ff": a.d_ff, "arch": a.name}))
    return out


def lint_dtypes(wm: WorkloadModel) -> List[Finding]:
    """Every variant dtype must resolve in the registry with a positive
    per-element storage width — an unknown name would raise deep inside a
    scenario driver; a non-positive width silently zeroes memory terms."""
    out: List[Finding] = []
    v = wm.variant
    for field in ("dtype_act", "dtype_w", "kv_dtype"):
        name = getattr(v, field)
        try:
            dt = dtypes.get(name)
        except KeyError:
            out.append(Finding(
                "lint", "lint.dtype_unknown", Severity.ERROR,
                f"variant {field}={name!r} is not in the dtype registry",
                {"field": field, "dtype": name}))
            continue
        if dt.bytes_per_el <= 0:
            out.append(Finding(
                "lint", "lint.dtype_bytes", Severity.ERROR,
                f"dtype {name!r} ({field}) has non-positive bytes_per_el "
                f"= {dt.bytes_per_el}", {"field": field, "dtype": name,
                                         "bytes_per_el": dt.bytes_per_el}))
    return out


def lint_affine_decode(wm: WorkloadModel, batch: int = 2,
                       points: tuple = (0, 8, 16)) -> List[Finding]:
    """The mixed-batch fast paths assume the per-step decode workload is
    affine in Σ past length.  Hold it at three collinear points (second
    difference must vanish field-by-field) and through the
    ``decode_totals_mixed([p]*B) == decode_step(B, p)`` reduction."""
    out: List[Finding] = []
    p0, p1, p2 = points
    # base model with pad_to=1: padding quantizes kv_len per slot, which
    # intentionally breaks token-level affinity (handled upstream by
    # effective_kv_lens) — the identity under test is the unpadded one
    base = WorkloadModel(
        wm.arch, dataclasses.replace(wm.variant, pad_to=1),
        attn_impl=wm.attn_impl, plan=wm.plan)
    t = {p: base.decode_step(batch, p).totals("decode")
         for p in points}
    lhs = t[p2].minus(t[p1])
    rhs = t[p1].minus(t[p0])
    # second difference scaled to the step width ratio (points need not be
    # equally spaced)
    lhs = lhs.scaled(1.0 / (p2 - p1))
    rhs = rhs.scaled(1.0 / (p1 - p0))
    bad = _totals_close(lhs, rhs, rtol=1e-6)
    if bad:
        out.append(Finding(
            "lint", "lint.affine_decode", Severity.ERROR,
            f"decode workload of {wm.arch.name!r} is not affine in past "
            f"length (fields {bad} curve between past={points}) — "
            f"decode_totals_mixed would misprice mixed batches",
            {"fields": bad, "points": list(points), "batch": batch,
             "slope_hi": lhs.as_dict(), "slope_lo": rhs.as_dict()}))
    uniform = wm.decode_totals_mixed([p1] * batch)
    direct = wm.decode_step(batch, p1).totals("decode")
    bad = _totals_close(uniform, direct, rtol=1e-6)
    if bad:
        out.append(Finding(
            "lint", "lint.affine_decode_identity", Severity.ERROR,
            f"decode_totals_mixed([{p1}]*{batch}) does not reduce to "
            f"decode_step({batch}, {p1}) for {wm.arch.name!r} "
            f"(fields {bad})",
            {"fields": bad, "past": p1, "batch": batch,
             "mixed": uniform.as_dict(), "direct": direct.as_dict()}))
    return out


def lint_model(wm: WorkloadModel, db: Optional[StatsDB] = None,
               phase: Optional[str] = None) -> List[Finding]:
    """All model-level rules plus (when ``db`` is given) the per-record
    rules and stage conservation over that driver output."""
    out: List[Finding] = []
    out.extend(lint_plan(wm))
    out.extend(lint_dtypes(wm))
    out.extend(lint_affine_decode(wm))
    if db is not None:
        out.extend(lint_records(db.records))
        out.extend(lint_stage_conservation(wm, db, phase))
    return out
