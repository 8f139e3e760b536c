"""The unified result schema of the Scenario→Report pipeline.

One frozen :class:`Report` for both sides of the paper's loop — the
analytical forecast (:func:`repro_torch.api.forecast`) and the measured engine
run (:func:`repro_torch.api.measure`) — so forecast-vs-measured deltas are a
:func:`compare` call instead of ad-hoc dict plumbing.  Reports round-trip
through JSON via :meth:`Report.to_dict` / :meth:`Report.from_dict`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.stats import Totals

#: bump when the to_dict layout changes incompatibly
SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class PhaseStats:
    """Hardware-agnostic workload totals of one phase (Fig. 2-F reduction).

    Totals are PER CHIP: a sharded Scenario (``tp > 1``) divides operator
    ops/bytes across chips and carries the collective traffic of the plan
    in ``wire_bytes`` (0.0 for single-chip scenarios).
    """
    ops: float = 0.0            # compute operations (MACs*2 convention)
    mem_rd: float = 0.0         # bytes read
    mem_wr: float = 0.0         # bytes written
    kv_rd: float = 0.0          # KV-cache bytes read (subset of mem_rd)
    kv_wr: float = 0.0          # KV-cache bytes written (subset of mem_wr)
    dispatches: int = 0         # kernel dispatch calls
    wire_bytes: float = 0.0     # collective bytes over the interconnect

    @property
    def mem_total(self) -> float:
        return self.mem_rd + self.mem_wr

    @classmethod
    def from_totals(cls, t: Totals) -> "PhaseStats":
        return cls(ops=t.ops, mem_rd=t.mem_rd, mem_wr=t.mem_wr,
                   kv_rd=t.kv_rd, kv_wr=t.kv_wr, dispatches=t.dispatches,
                   wire_bytes=t.wire_bytes)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "PhaseStats":
        # wire_bytes is absent from pre-sharding report JSONs (schema 1)
        return cls(**{f.name: d.get(f.name, 0.0) if f.name == "wire_bytes"
                      else d[f.name] for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class Report:
    """TTFT/TPOT/TPS for one Scenario on one hardware target.

    ``source`` is ``"forecast"`` (analytical path, Eqs. 1–6) or
    ``"measured"`` (real engine / legacy lockstep server).  ``phases`` holds
    the hardware-agnostic workload totals per phase (``"prefill"``,
    ``"decode"``, optionally ``"lora_update"``) — identical between the two
    sources for the same Scenario, because the workload is analytical either
    way; only the timings differ.

    ``trace`` is a runtime-only attachment (the engine's scheduler trace on
    measured reports, replayable via ``forecast(..., trace=...)``); it is
    excluded from equality and from the JSON form.
    """
    source: str                       # "forecast" | "measured"
    model: str
    variant: str
    hardware: str                     # spec name, or "host" for measured runs
    ttft_s: float                     # time to first token (s)
    tpot_s: float                     # mean time per output token (s)
    tps: float                        # aggregate generated tokens / s
    ttft_bound: str = ""              # "compute" | "memory" (forecast only)
    tpot_bound: str = ""
    ec: float = 1.0                   # compute efficiency knob used
    em: float = 1.0                   # memory efficiency knob used
    phases: Mapping[str, PhaseStats] = dataclasses.field(default_factory=dict)
    scenario: Mapping[str, object] = dataclasses.field(default_factory=dict)
    extras: Mapping[str, object] = dataclasses.field(default_factory=dict)
    trace: Optional[Tuple] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.source not in ("forecast", "measured"):
            raise ValueError(f"source must be 'forecast' or 'measured', "
                             f"got {self.source!r}")

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "source": self.source,
            "model": self.model,
            "variant": self.variant,
            "hardware": self.hardware,
            "ttft_s": self.ttft_s,
            "tpot_s": self.tpot_s,
            "tps": self.tps,
            "ttft_bound": self.ttft_bound,
            "tpot_bound": self.tpot_bound,
            "ec": self.ec,
            "em": self.em,
            "phases": {k: v.to_dict() for k, v in self.phases.items()},
            "scenario": dict(self.scenario),
            "extras": dict(self.extras),
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "Report":
        schema = d.get("schema", SCHEMA_VERSION)
        if schema > SCHEMA_VERSION:
            raise ValueError(f"report schema {schema} is newer than "
                             f"supported {SCHEMA_VERSION}")
        return cls(
            source=d["source"], model=d["model"], variant=d["variant"],
            hardware=d["hardware"], ttft_s=d["ttft_s"], tpot_s=d["tpot_s"],
            tps=d["tps"], ttft_bound=d.get("ttft_bound", ""),
            tpot_bound=d.get("tpot_bound", ""),
            ec=d.get("ec", 1.0), em=d.get("em", 1.0),
            phases={k: PhaseStats.from_dict(v)
                    for k, v in d.get("phases", {}).items()},
            scenario=dict(d.get("scenario", {})),
            extras=dict(d.get("extras", {})))

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "Report":
        return cls.from_dict(json.loads(text))


# ---------------------------------------------------------------------------
# forecast vs measured diff
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MetricDelta:
    """One metric seen by both sides; ratio > 1 ⇒ forecast larger."""
    forecast: float
    measured: float

    @property
    def ratio(self) -> float:
        return self.forecast / self.measured if self.measured else float("inf")

    @property
    def rel_err(self) -> float:
        """(forecast − measured) / measured."""
        if not self.measured:
            return float("inf")
        return (self.forecast - self.measured) / self.measured

    def to_dict(self) -> dict:
        return {"forecast": self.forecast, "measured": self.measured,
                "ratio": self.ratio, "rel_err": self.rel_err}


@dataclasses.dataclass(frozen=True)
class ReportDelta:
    """Forecast-vs-measured diff of two Reports for the same Scenario."""
    model: str
    variant: str
    forecast_hw: str
    measured_hw: str
    ttft: MetricDelta
    tpot: MetricDelta
    tps: MetricDelta

    @property
    def forecast_error(self) -> Dict[str, float]:
        """Signed relative forecast error per metric — the paper's
        accuracy quantity ((forecast − measured) / measured), tracked
        per-setting in BENCH_history and gated in CI."""
        return {"ttft": self.ttft.rel_err, "tpot": self.tpot.rel_err,
                "tps": self.tps.rel_err}

    @property
    def worst_abs_error(self) -> float:
        """Largest |relative error| across the three metrics — the scalar
        the CI regression gate compares between runs."""
        finite = [abs(e) for e in self.forecast_error.values()
                  if e == e and abs(e) != float("inf")]
        return max(finite) if finite else float("inf")

    def to_dict(self) -> dict:
        return {
            "model": self.model, "variant": self.variant,
            "forecast_hw": self.forecast_hw, "measured_hw": self.measured_hw,
            "ttft": self.ttft.to_dict(), "tpot": self.tpot.to_dict(),
            "tps": self.tps.to_dict(),
            "forecast_error": self.forecast_error,
            "worst_abs_error": self.worst_abs_error,
        }


def compare(forecast: Report, measured: Report) -> ReportDelta:
    """Diff a forecast Report against a measured one (paper's §5 loop).

    Both arguments are plain Reports; by convention the first is the
    forecast side.  Mismatched models/variants raise — a delta across
    different workloads is meaningless.
    """
    if (forecast.model, forecast.variant) != (measured.model, measured.variant):
        raise ValueError(
            f"cannot compare reports of different workloads: "
            f"{forecast.model}/{forecast.variant} vs "
            f"{measured.model}/{measured.variant}")
    return ReportDelta(
        model=forecast.model, variant=forecast.variant,
        forecast_hw=forecast.hardware, measured_hw=measured.hardware,
        ttft=MetricDelta(forecast.ttft_s, measured.ttft_s),
        tpot=MetricDelta(forecast.tpot_s, measured.tpot_s),
        tps=MetricDelta(forecast.tps, measured.tps))
