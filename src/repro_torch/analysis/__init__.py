"""Audit subsystem: does the executed engine match its analytical twin,
and is the analytical DSL internally consistent?  (The PyTorch
counterpart of the JAX package's ``analysis``.)

Three passes over the SAME source of truth the forecaster prices:

* :mod:`repro_torch.analysis.lint` — declarative rules over the
  analytical OpRecord DSL (closed op-class vocabulary, conservation
  laws, the affine-decode identity);
* :mod:`repro_torch.analysis.pricing` — execute the engine's hot paths
  once inside a work count (``repro_torch.core.counts``) and reconcile
  the counted FLOPs / bytes / collective wire against the matching
  ``WorkloadModel`` records;
* :mod:`repro_torch.analysis.hygiene` — the KV pool updated in place,
  and kernel libraries built and loaded once over a mixed-length engine
  run.

Entry points: :func:`run_audit` (library),
``python -m repro_torch audit [--json] [--strict] [--device cpu]`` (CLI).
"""
from .findings import AuditReport, Finding, Severity
from .audit import AuditConfig, default_targets, format_report, run_audit
from .pricing import (AuditGeometry, CompiledTarget, PricingTarget,
                      Tolerances, lower_target, reconcile, run_pricing)
from .lint import (lint_affine_decode, lint_dtypes, lint_model, lint_plan,
                   lint_records, lint_stage_conservation)
from .hygiene import audit_donation, audit_retrace

__all__ = [
    "AuditConfig", "AuditGeometry", "AuditReport", "CompiledTarget",
    "Finding", "PricingTarget", "Severity", "Tolerances",
    "audit_donation", "audit_retrace", "default_targets", "format_report",
    "lint_affine_decode", "lint_dtypes", "lint_model", "lint_plan",
    "lint_records", "lint_stage_conservation", "lower_target",
    "reconcile", "run_audit", "run_pricing",
]
