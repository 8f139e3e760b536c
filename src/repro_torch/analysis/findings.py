"""Structured findings of the audit subsystem (a copy of the JAX
package's ``analysis/findings.py``).

Every audit pass (operator-DSL lint, counted-work pricing cross-check,
engine hygiene) reports through the same vocabulary: a
:class:`Finding` names the pass, a stable machine-readable code, a
severity, a human sentence and a details dict; an :class:`AuditReport`
aggregates them and decides the process exit code.

Severity policy:

* ``info``    — benign observations worth surfacing (per-target
  reconciliation ratios, skipped targets); never fatal.
* ``warning`` — suspicious but tolerated on a default run; fatal under
  ``--strict`` (the CI gate), so a clean tree must emit none.
* ``error``   — a broken invariant (unpriced operator class, pricing
  mismatch beyond tolerance, non-donated KV pool, retrace); always fatal.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error", not "Severity.ERROR"
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str               # "lint" | "pricing" | "hygiene"
    code: str                    # stable id, e.g. "pricing.matmul_mismatch"
    severity: Severity
    message: str                 # one human-readable sentence
    details: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, object]:
        return {"pass": self.pass_name, "code": self.code,
                "severity": str(self.severity), "message": self.message,
                "details": dict(self.details)}


@dataclasses.dataclass
class AuditReport:
    findings: List[Finding] = dataclasses.field(default_factory=list)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def extend(self, findings: List[Finding]) -> None:
        self.findings.extend(findings)

    def counts(self) -> Dict[str, int]:
        out = {str(s): 0 for s in Severity}
        for f in self.findings:
            out[str(f.severity)] += 1
        return out

    def worst(self) -> Optional[Severity]:
        return max((f.severity for f in self.findings), default=None)

    def by_severity(self, severity: Severity) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    def exit_code(self, strict: bool = False) -> int:
        """0 when acceptable, 1 otherwise: errors are always fatal,
        warnings only under ``strict`` (info never)."""
        bar = Severity.WARNING if strict else Severity.ERROR
        return 1 if any(f.severity >= bar for f in self.findings) else 0

    def to_dict(self) -> Dict[str, object]:
        return {"meta": dict(self.meta), "counts": self.counts(),
                "findings": [f.to_dict() for f in self.findings]}
