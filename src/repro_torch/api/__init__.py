"""repro_torch.api — the unified Scenario→Report forecasting front door.

The paper's modular pipeline (Fig. 2: model × variant × scenario ×
hardware → TTFT/TPOT/TPS) as one declarative surface shared by the
analytical model and the measured engine:

    from repro_torch import api

    scn = api.Scenario(model="llama2-7b", variant="bf16-int4-kv4",
                       prompt_len=2048, gen_len=256)
    fc  = api.forecast(scn, "nvidia-h100")         # analytical (Eqs. 1-6)
    ms  = api.measure(scn)                         # the engine on the card
    api.compare(fc, ms).tps.ratio                  # forecast/measured delta

    api.sweep(scn, ["cpu", "v100", "v5e"])         # hardware what-ifs
    api.sweep(scn, tops=[10, 100], bw=[100, 800])  # synthetic TOPS×BW grid

Also available as a CLI: ``python -m repro_torch {forecast,measure,sweep,
capacity,compare,hardware}``.

Internals: ``repro_torch.core`` (WorkloadModel / Forecaster / StatsDB) implements
the analytical path, ``repro_torch.engine`` the measured one; both remain public
for power users, but new callers should start here.
"""
from .scenario import Scenario
from .report import (Report, PhaseStats, MetricDelta, ReportDelta, compare,
                     SCHEMA_VERSION)
from .run import forecast, max_qps, measure, sweep

__all__ = [
    "Scenario", "Report", "PhaseStats", "MetricDelta", "ReportDelta",
    "compare", "forecast", "max_qps", "measure", "sweep", "SCHEMA_VERSION",
]
