"""Mesh-aware roofline reporting over the UNIFIED sharded forecast stack.

The former standalone ``DistributedForecaster`` (its own collective-byte
formulas, reachable only from ``launch/dryrun.py``) was folded into the
main ``WorkloadModel``/``Forecaster`` path: a :class:`ShardingPlan` on
``WorkloadModel`` now divides per-chip FLOPs/bytes per operator and
records collective ``wire_bytes``, and ``Forecaster`` prices them against
``HardwareSpec.interconnect_GBps``.  What remains here is the thin
roofline-report layer the dry-run grades against:

* **LIFE-predicted** — :func:`predict_phase` / the deprecated
  :class:`DistributedForecaster` alias (analytical workload + plan).
* **XLA-measured**  — from the JAX package's compiled dry-run
  (``cost_analysis()`` per-chip FLOPs/bytes + its ``core.hlo``
  collective parser's wire bytes) via :func:`roofline`; the port has no
  dry-run yet (ROADMAP queue 1, item 6), but :func:`roofline` takes any
  measured per-chip totals.

Roofline terms (grading convention):

    compute    = FLOPs_per_chip   / peak_FLOP/s
    memory     = bytes_per_chip   / HBM_bw
    collective = wire_bytes_per_chip / ICI_link_bw
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .hardware import HardwareSpec, TPU_V5E
from .stats import Totals
from .workload import ShardingPlan, WorkloadModel

__all__ = ["ShardingPlan", "RooflineTerms", "roofline", "model_flops",
           "predict_phase", "DistributedForecaster"]


@dataclasses.dataclass
class RooflineTerms:
    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Useful-time fraction: dominant / sum (1.0 = perfectly balanced on
        one roof; low = badly skewed by a non-compute term)."""
        s = self.t_compute + self.t_memory + self.t_collective
        return self.t_compute / s if s else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"t_compute": self.t_compute, "t_memory": self.t_memory,
                "t_collective": self.t_collective, "dominant": self.dominant}


def roofline(flops_per_chip: float, bytes_per_chip: float,
             wire_bytes_per_chip: float,
             hw: HardwareSpec = TPU_V5E) -> RooflineTerms:
    return RooflineTerms(
        t_compute=flops_per_chip / hw.flops,
        t_memory=bytes_per_chip / hw.bw,
        t_collective=wire_bytes_per_chip / max(hw.ici_bw(), 1e-30),
    )


def model_flops(arch, n_tokens: int, *, training: bool = False) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); 2·N·D for inference.

    ``D`` is tokens processed; training multiplies by 3 (fwd + bwd)."""
    n = arch.active_param_count()
    per_tok = 6.0 * n if training else 2.0 * n
    return per_tok * n_tokens


def _terms(t: Totals, plan: ShardingPlan, hw: HardwareSpec, *,
           mult: float = 1.0, extra_wire: float = 0.0) -> RooflineTerms:
    """Per-chip roofline of sharded-model Totals.

    The Totals already carry the tp division and tp/ep collective wire
    (``WorkloadModel`` with a plan); replica-level scale-out (dp·sp)
    divides all three terms here — per-chip work AND per-chip collective
    traffic scale with the per-replica token share."""
    rep = plan.dp * plan.sp
    return roofline(mult * t.ops / rep, mult * t.mem_total / rep,
                    mult * t.wire_bytes / rep + extra_wire, hw)


def predict_phase(wm: WorkloadModel, phase_totals: Totals,
                  hw: HardwareSpec = TPU_V5E) -> RooflineTerms:
    """Roofline terms of any phase Totals produced by a sharded ``wm``."""
    return _terms(phase_totals, wm.plan, hw)


class DistributedForecaster:
    """DEPRECATED thin alias over the unified sharded forecast stack.

    Migration: build ``WorkloadModel(arch, variant, plan=plan)`` and price
    its phase Totals with ``Forecaster`` (serving metrics, via
    ``repro_torch.api.forecast(Scenario(tp=...), hw)``) or :func:`predict_phase`
    (roofline terms).  This wrapper only re-derives the train-step
    gradient traffic the unified inference path has no business modeling.
    """

    def __init__(self, wm: WorkloadModel, plan: ShardingPlan,
                 hw: HardwareSpec = TPU_V5E):
        # fold the plan into the workload model: per-operator tp division
        # + collective wire records now come from the unified path
        self.wm = WorkloadModel(wm.arch, wm.variant, attn_impl=wm.attn_impl,
                                plan=plan)
        self.plan = plan
        self.hw = hw

    def _fsdp_gather_wire(self) -> float:
        """Per-chip wire of all-gathering the dp-sharded params once."""
        p = self.plan
        if not p.fsdp:
            return 0.0
        return (self.wm.weight_bytes() / p.tp) * (p.dp - 1) / p.dp

    # -- public -------------------------------------------------------------
    def predict_prefill(self, batch: int, seq: int) -> RooflineTerms:
        t = self.wm.prefill(batch, seq).totals("prefill")
        return _terms(t, self.plan, self.hw,
                      extra_wire=self._fsdp_gather_wire())

    def predict_decode(self, batch: int, past_len: int) -> RooflineTerms:
        t = self.wm.decode_step(batch, past_len).totals("decode")
        return _terms(t, self.plan, self.hw,
                      extra_wire=self._fsdp_gather_wire())

    def predict_train_step(self, global_batch: int, seq: int) -> RooflineTerms:
        p = self.plan
        t = self.wm.prefill(global_batch, seq).totals("prefill")
        grad = self.wm.weight_bytes() / p.tp
        if p.fsdp:
            # fwd + bwd param all-gathers, reduce-scatter of grads
            extra = 2.0 * self._fsdp_gather_wire()
            extra += grad * (p.dp - 1) / p.dp
        else:
            extra = grad * 2.0 * (p.dp - 1) / p.dp    # grad all-reduce
        # fwd+bwd ≈ 3× fwd compute/bytes; TP collectives run fwd and bwd
        rep = p.dp * p.sp
        return roofline(3.0 * t.ops / rep, 3.0 * t.mem_total / rep,
                        2.0 * t.wire_bytes / rep + extra, self.hw)
