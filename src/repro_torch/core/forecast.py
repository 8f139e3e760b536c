"""Performance forecasting & efficiency analysis (paper §4.2.2, Eqs. 1–7).

Implements:
* TTFT = max(t_c, t_m)         (Eq. 1–3)
* TPOT = MEM/(BW·em) + t_disp  (Eq. 4–5; dimensionally corrected — see
                                DESIGN.md §8: the printed equation inverts
                                the ratio but the paper's own Table 10
                                numbers follow this form)
* TPS  = 1/TPOT                (Eq. 6)
* LoRA merge time              (Eq. 7)
* efficiency-grid sweeps       (Figs. 4, 5)
* BMM tile-padding efficiency sawtooth (Fig. 8) — on TPU the MXU imposes
  128-multiples (DESIGN.md §3.4)
* decode timeline TPS decay    (Fig. 7 / §5.3.2)
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

from .hardware import HardwareSpec
from .stats import StatsDB, Totals
from .workload import WorkloadModel


@dataclasses.dataclass
class PhaseForecast:
    t_compute: float          # Eq. 1 (s)
    t_memory: float           # Eq. 2 (s)
    t_dispatch: float         # Σ dispatch latency (s)
    latency: float            # max(t_c, t_m) + t_collective + t_dispatch (s)
    t_collective: float = 0.0  # Σ wire_bytes / interconnect bw (s)

    @property
    def bound(self) -> str:
        if self.t_collective > max(self.t_compute, self.t_memory):
            return "collective"
        return "compute" if self.t_compute > self.t_memory else "memory"

    @property
    def ratio(self) -> float:
        """t_c/t_m — >1 ⇒ compute bound (paper Fig. 4)."""
        return self.t_compute / max(self.t_memory, 1e-30)


class Forecaster:
    """Analysis scripts (paper Fig. 2-G): workload metrics × hardware → perf.

    Sharding-aware: Totals produced by a ``WorkloadModel`` with a
    ``ShardingPlan`` carry per-chip ops/bytes plus collective
    ``wire_bytes``; the collective term is priced against
    ``HardwareSpec.interconnect_GBps`` and added serially to the phase
    latency (collectives on the layer critical path do not overlap the
    roofline terms in this model).  Unsharded Totals (``wire_bytes == 0``)
    reproduce the paper's two-term forecasts bit-for-bit.
    """

    def __init__(self, hw: HardwareSpec):
        self.hw = hw

    def collective_time(self, totals: Totals) -> float:
        """Wire time of the Totals' collective traffic on this hardware."""
        if not totals.wire_bytes:
            return 0.0
        ici = self.hw.ici_bw()
        if ici <= 0.0:
            raise ValueError(
                f"{self.hw.name} has no interconnect (interconnect_GBps=0) "
                f"but the workload carries collective traffic — forecast a "
                f"multi-chip target or use a tp=1 plan")
        return totals.wire_bytes / ici

    # -- Eq. 1–3 -----------------------------------------------------------
    def phase(self, totals: Totals, *, ec: float = 1.0, em: float = 1.0,
              include_dispatch: bool = True) -> PhaseForecast:
        t_c = totals.ops / (ec * self.hw.flops)
        t_m = totals.mem_total / (em * self.hw.bw)
        t_x = self.collective_time(totals)
        t_d = (totals.dispatches * self.hw.dispatch_latency_s
               if include_dispatch else 0.0)
        return PhaseForecast(t_compute=t_c, t_memory=t_m, t_dispatch=t_d,
                             t_collective=t_x,
                             latency=max(t_c, t_m) + t_x + t_d)

    def ttft(self, prefill_db: StatsDB, *, ec: float = 1.0,
             em: float = 1.0) -> PhaseForecast:
        return self.phase(prefill_db.totals("prefill"), ec=ec, em=em)

    # -- pipeline parallelism (GPipe-style microbatch pipelining) ----------
    @staticmethod
    def pipeline_bubble_fraction(pp: int, microbatches: int) -> float:
        """Idle fraction of a ``pp``-stage pipeline fed ``m`` microbatches
        with balanced stages: ``(pp − 1) / (m + pp − 1)`` — the classic
        GPipe fill/drain bubble.  Monotone ↑ in ``pp``, ↓ in ``m``."""
        if pp < 1 or microbatches < 1:
            raise ValueError(f"pp and microbatches must be >= 1, got "
                             f"pp={pp} m={microbatches}")
        return (pp - 1) / (microbatches + pp - 1)

    def pipeline_phase(self, stage_totals: Sequence[Totals],
                       microbatches: int, *, ec: float = 1.0,
                       em: float = 1.0,
                       include_dispatch: bool = True) -> PhaseForecast:
        """Latency of one pipelined phase (prefill) over ``m`` microbatches.

        ``stage_totals[s]`` is stage ``s``'s workload for the WHOLE phase
        (all microbatches), its outbound hop wire included
        (:meth:`WorkloadModel.stage_totals`).  With per-microbatch stage
        latency ``t_s / m``, the pipeline completes in

            T = Σ_s t_s / m  +  (m − 1) · max_s (t_s / m)

        — one microbatch traverses every stage, then the slowest stage
        drains the remaining ``m − 1``.  Balanced stages reduce to
        ``Σ t_s · (1 + bubble·(pp−1)/…)`` i.e. the ``(pp−1)/(m+pp−1)``
        bubble over the ideal ``Σ t_s / pp`` per-stage span; a single
        stage returns :meth:`phase` unchanged (bit-for-bit pp=1 path).
        Reported components (t_compute/t_memory/…) are the phase-wide
        sums, so ``bound`` still reflects the aggregate regime.
        """
        stages = [self.phase(t, ec=ec, em=em,
                             include_dispatch=include_dispatch)
                  for t in stage_totals]
        if len(stages) == 1:
            return stages[0]
        m = microbatches
        if m < 1:
            raise ValueError(f"microbatches must be >= 1, got {m}")
        lat = (sum(p.latency for p in stages) / m
               + (m - 1) * max(p.latency for p in stages) / m)
        return PhaseForecast(
            t_compute=sum(p.t_compute for p in stages),
            t_memory=sum(p.t_memory for p in stages),
            t_dispatch=sum(p.t_dispatch for p in stages),
            t_collective=sum(p.t_collective for p in stages),
            latency=lat)

    def pipeline_step_latency(self, stage_totals: Sequence[Totals], *,
                              em: float = 1.0,
                              ec: Optional[float] = None) -> float:
        """Steady-state decode TPOT of a ``pp``-stage pipeline: stages
        work on consecutive tokens concurrently, so the token period is
        the SLOWEST stage's step latency — each stage's Totals already
        carry its outbound hop wire, so this is "slowest stage + hop".
        A single stage reduces to :meth:`step_latency` exactly."""
        return max(self.step_latency(t, em=em, ec=ec)
                   for t in stage_totals)

    # -- Eq. 4–6 -----------------------------------------------------------
    def step_latency(self, totals: Totals, *, em: float = 1.0,
                     ec: Optional[float] = None) -> float:
        """Latency of one decode step from its Totals (TPOT-style).

        The paper defines TPOT as purely memory-bound (t_c << t_m during
        decode for all studied conditions).  Passing ``ec`` adds the compute
        term as max(t_c, t_m) for robustness on very fast-memory hardware.
        Shared by :meth:`tpot` and the continuous-batching twin
        (``repro_torch.engine.forecast_twin``), which forecasts steps whose Totals
        come from ``WorkloadModel.decode_totals_mixed`` rather than a StatsDB.
        Per-chip Totals of a sharded plan add their collective wire time
        serially (tp=1: exact zero, bit-for-bit with the two-term form).
        """
        t_m = totals.mem_total / (em * self.hw.bw)
        t_x = self.collective_time(totals)
        t_d = totals.dispatches * self.hw.dispatch_latency_s
        if ec is not None:
            t_c = totals.ops / (ec * self.hw.flops)
            return max(t_c, t_m) + t_x + t_d
        return t_m + t_x + t_d

    def tpot(self, decode_db: StatsDB, *, em: float = 1.0,
             ec: Optional[float] = None) -> float:
        """Seconds per output token (see :meth:`step_latency`)."""
        return self.step_latency(decode_db.totals("decode"), em=em, ec=ec)

    def tps(self, decode_db: StatsDB, *, em: float = 1.0,
            ec: Optional[float] = None) -> float:
        return 1.0 / self.tpot(decode_db, em=em, ec=ec)

    # -- speculative decoding ----------------------------------------------
    @staticmethod
    def spec_expected_tokens(k: int, alpha: float) -> float:
        """Expected tokens emitted per speculative step at per-draft
        acceptance rate ``alpha``: Σ_{i=0..k} α^i — the accepted-prefix
        geometric series plus the always-emitted bonus/corrected token
        (Leviathan et al.'s E[#tokens] for i.i.d. acceptance)."""
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if alpha == 1.0:
            return float(k + 1)
        return (1.0 - alpha ** (k + 1)) / (1.0 - alpha)

    def spec_step_latency(self, verify_totals: Totals, k: int, *,
                          draft_totals: Optional[Totals] = None,
                          em: float = 1.0,
                          ec: Optional[float] = None) -> float:
        """Latency of one speculative step: k drafter steps (zero for the
        self-speculative n-gram drafter — ``draft_totals=None``) plus one
        (k+1)-query verify pass priced like a decode step."""
        t = self.step_latency(verify_totals, em=em, ec=ec)
        if draft_totals is not None:
            t += k * self.step_latency(draft_totals, em=em, ec=ec)
        return t

    def spec_tpot(self, verify_totals: Totals, k: int, alpha: float, *,
                  draft_totals: Optional[Totals] = None, em: float = 1.0,
                  ec: Optional[float] = None) -> float:
        """Expected seconds per output token under speculation: step
        latency divided by expected emitted tokens (Eq. 4 analog)."""
        step = self.spec_step_latency(verify_totals, k,
                                      draft_totals=draft_totals,
                                      em=em, ec=ec)
        return step / self.spec_expected_tokens(k, alpha)

    def spec_speedup(self, base_totals: Totals, verify_totals: Totals,
                     k: int, alpha: float, *,
                     draft_totals: Optional[Totals] = None,
                     em: float = 1.0, ec: Optional[float] = None) -> float:
        """TPOT(plain) / TPOT(speculative) at acceptance ``alpha``."""
        base = self.step_latency(base_totals, em=em, ec=ec)
        return base / self.spec_tpot(verify_totals, k, alpha,
                                     draft_totals=draft_totals,
                                     em=em, ec=ec)

    def spec_speedup_curve(self, base_totals: Totals,
                           verify_totals: Totals, k: int,
                           alphas: Sequence[float], *,
                           draft_totals: Optional[Totals] = None,
                           em: float = 1.0,
                           ec: Optional[float] = None) -> List[tuple]:
        """(alpha, speedup) samples of the TPOT speedup over acceptance —
        the curve whose crossing of 1.0 is the hardware's break-even α."""
        return [(a, self.spec_speedup(base_totals, verify_totals, k, a,
                                      draft_totals=draft_totals,
                                      em=em, ec=ec))
                for a in alphas]

    def spec_breakeven_acceptance(self, base_totals: Totals,
                                  verify_totals: Totals, k: int, *,
                                  draft_totals: Optional[Totals] = None,
                                  em: float = 1.0,
                                  ec: Optional[float] = None
                                  ) -> Optional[float]:
        """Acceptance rate α* where speculation stops losing: the α with
        E[tokens/step] = spec_step / plain_step.  Returns 0.0 when the
        spec step is no slower than a plain step (speculation can never
        lose — e.g. a free drafter in a fully weight-bound regime), and
        ``None`` when even α=1 cannot pay for the step (cost ratio above
        k+1: speculation never wins on this hardware).  Hardware enters
        through both step latencies, which is what makes break-even a
        per-target forecast quantity."""
        base = self.step_latency(base_totals, em=em, ec=ec)
        step = self.spec_step_latency(verify_totals, k,
                                      draft_totals=draft_totals,
                                      em=em, ec=ec)
        ratio = step / base
        if ratio <= 1.0:
            return 0.0
        if ratio >= self.spec_expected_tokens(k, 1.0):
            return None
        lo, hi = 0.0, 1.0
        for _ in range(60):              # E is monotone in α: bisect
            mid = 0.5 * (lo + hi)
            if self.spec_expected_tokens(k, mid) < ratio:
                lo = mid
            else:
                hi = mid
        return 0.5 * (lo + hi)

    # -- Eq. 7 --------------------------------------------------------------
    def lora_update_time(self, lora_db: StatsDB, *, ec: float = 1.0,
                         em: float = 1.0) -> PhaseForecast:
        return self.phase(lora_db.totals("lora_update"), ec=ec, em=em)

    # -- Fig. 4/5: efficiency grids -----------------------------------------
    def efficiency_grid(self, totals: Totals,
                        ec_values: Sequence[float],
                        em_values: Sequence[float]) -> List[List[float]]:
        """Grid of t_c/t_m ratios across (ec, em) operating efficiencies."""
        return [[self.phase(totals, ec=ec, em=em).ratio for em in em_values]
                for ec in ec_values]

    def hardware_grid(self, totals: Totals,
                      tops_values: Sequence[float],
                      bw_values: Sequence[float],
                      *, ec: float = 1.0, em: float = 1.0) -> List[List[float]]:
        """Grid of t_c/t_m across hardware configs (paper's 10×10 TOPS×BW)."""
        out = []
        for tops in tops_values:
            row = []
            for bw in bw_values:
                t_c = totals.ops / (ec * tops * 1e12)
                t_m = totals.mem_total / (em * bw * 1e9)
                row.append(t_c / max(t_m, 1e-30))
            out.append(row)
        return out

    # -- Fig. 7: decode timeline ---------------------------------------------
    def tps_timeline(self, wm: WorkloadModel, batch: int, prompt_len: int,
                     n_new: int, *, em: float = 1.0,
                     sample_every: int = 100) -> List[tuple]:
        """(step, mem_bytes, tps) along a generation (paper §5.3.2)."""
        out = []
        for pt in wm.generate_timeline(batch, prompt_len, n_new,
                                       sample_every=sample_every):
            t_m = pt.totals.mem_total / (em * self.hw.bw)
            t_x = self.collective_time(pt.totals)
            t_d = pt.totals.dispatches * self.hw.dispatch_latency_s
            out.append((pt.step, pt.totals.mem_total,
                        1.0 / (t_m + t_x + t_d)))
        return out


# ---------------------------------------------------------------------------
# Fig. 8: BMM tile-padding efficiency (decode KV-growth sawtooth)
# ---------------------------------------------------------------------------

def bmm_tile_efficiency(seq_len: int, tile: int) -> float:
    """Useful fraction of a tiled BMM whose inner dim is padded to ``tile``."""
    padded = ((seq_len + tile - 1) // tile) * tile
    return seq_len / padded


def bmm_sawtooth(seq_lens: Iterable[int], tile: int) -> List[tuple]:
    """(seq_len, ideal_ops_fraction, padded_ops_fraction=1) per point."""
    return [(s, bmm_tile_efficiency(s, tile)) for s in seq_lens]


def bmm_asymptotic_efficiency(prompt_len: int, n_new: int, tile: int) -> float:
    """Average tile efficiency across a decode of ``n_new`` tokens (§5.4.1).

    The sawtooth's mean approaches an asymptote as KV grows; this is the
    average BMM efficiency LIFE plugs into long-generation TPS forecasts.
    """
    total = 0.0
    for i in range(n_new):
        total += bmm_tile_efficiency(prompt_len + i + 1, tile)
    return total / max(n_new, 1)


# ---------------------------------------------------------------------------
# Efficiency extrapolation (paper §4.2.2: "expects efficiency of operator for
# specific shapes and extrapolates to other shapes")
# ---------------------------------------------------------------------------

def extrapolate_efficiency(measured: Sequence[tuple], target_size: float) -> float:
    """Log-linear interpolation of (size, efficiency) measurements."""
    import math
    pts = sorted(measured)
    if not pts:
        return 1.0
    if target_size <= pts[0][0]:
        return pts[0][1]
    if target_size >= pts[-1][0]:
        return pts[-1][1]
    for (s0, e0), (s1, e1) in zip(pts, pts[1:]):
        if s0 <= target_size <= s1:
            f = (math.log(target_size) - math.log(s0)) / (math.log(s1) - math.log(s0))
            return e0 + f * (e1 - e0)
    return pts[-1][1]
