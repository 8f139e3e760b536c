"""LIFE core: the paper's analytical framework as a first-class feature.

A copy of the JAX package's ``core`` (which imports no JAX) under the
port's import names.  ``hlo`` (XLA HLO text parsing for the compile-time
audit) has no copy, since the port never produces HLO: ``counts``
counts the work a step executes instead.

Public API:
    WorkloadModel   — analytical twin of an (arch × variant × ShardingPlan)
    ShardingPlan    — tensor/expert/data parallel degrees (tp=1: paper model)
    Forecaster      — Eqs. 1–7 + collective term: TTFT / TPOT / TPS
    StatsDB         — the statistics database (Fig. 2-F)
    hardware        — device registry (Ryzen CPU/NPU/iGPU, V100, TPU v5e,
                      H100)
    distributed     — roofline-report layer over the unified sharded stack
"""
from . import dtypes, hardware
from .stats import StatsDB, Totals, OpRecord
from .workload import WorkloadModel, TimelinePoint, ShardingPlan
from .forecast import (Forecaster, PhaseForecast, bmm_tile_efficiency,
                       bmm_sawtooth, bmm_asymptotic_efficiency,
                       extrapolate_efficiency)
from .distributed import (RooflineTerms, roofline, model_flops,
                          predict_phase, DistributedForecaster)

__all__ = [
    "dtypes", "hardware", "StatsDB", "Totals", "OpRecord",
    "WorkloadModel", "TimelinePoint", "Forecaster", "PhaseForecast",
    "bmm_tile_efficiency", "bmm_sawtooth", "bmm_asymptotic_efficiency",
    "extrapolate_efficiency", "ShardingPlan", "RooflineTerms", "roofline",
    "model_flops", "predict_phase", "DistributedForecaster",
]
