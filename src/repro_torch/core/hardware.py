"""Hardware specification registry (paper Fig. 2-H).

LIFE needs only peak compute (TOPS), memory bandwidth (GB/s) and optional
dispatch latency to forecast.  We keep the paper's verification devices
(Ryzen CPU / NPU / iGPU, V100) so Tables 6/10 reproduce, and add the TPU v5e
target with pod-level interconnect for the distributed extension
(DESIGN.md §3).  The port's copy adds the card it runs on, the NVIDIA
H100 SXM, so forecasts for it sit beside measurements taken on it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Union


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    tops: float                      # peak compute, Tera-ops/s (dtype-matched)
    bw_gbps: float                   # peak HBM/DRAM bandwidth, GB/s
    dispatch_latency_s: float = 5e-6 # per kernel-dispatch overhead
    onchip_bytes: float = 8 * 2**20  # SRAM/VMEM working-set capacity
    # --- multi-chip extensions -------------------------------------------
    #: chip-to-chip interconnect bandwidth per chip, GB/s — what collective
    #: traffic of a ShardingPlan with tp>1 is priced against (NVLink for
    #: GPUs, ICI for TPUs, PCIe/fabric for host parts).  0 ⇒ single-chip
    #: part: sharded forecasts on it raise rather than divide by zero.
    interconnect_GBps: float = 0.0
    ici_links: int = 0               # links per chip (e.g. v5e 2D torus: 4)
    hbm_bytes: float = 0.0           # HBM capacity per chip

    def __post_init__(self):
        """Reject physically meaningless specs at construction.

        A zero/negative peak rate silently turns every roofline forecast
        into 0 or ∞, which then propagates through sweeps and BENCH
        artifacts — fail here instead, with the offending field named.
        """
        if not isinstance(self.name, str) or not self.name.strip():
            raise ValueError("HardwareSpec.name must be a non-empty string")
        for field in ("tops", "bw_gbps"):
            v = getattr(self, field)
            if v is None or not v > 0:
                raise ValueError(
                    f"HardwareSpec.{field} must be > 0, got {v!r} "
                    f"(spec {self.name!r})")
        for field in ("dispatch_latency_s", "onchip_bytes",
                      "interconnect_GBps", "ici_links", "hbm_bytes"):
            v = getattr(self, field)
            if v is None or v < 0:
                raise ValueError(
                    f"HardwareSpec.{field} must be >= 0, got {v!r} "
                    f"(spec {self.name!r})")

    @property
    def flops(self) -> float:
        return self.tops * 1e12

    @property
    def bw(self) -> float:
        return self.bw_gbps * 1e9

    def ici_bw(self) -> float:
        """Interconnect bandwidth per chip (bytes/s)."""
        return self.interconnect_GBps * 1e9


REGISTRY: Dict[str, HardwareSpec] = {}


def _reg(h: HardwareSpec) -> HardwareSpec:
    REGISTRY[h.name] = h
    return h


# ---- paper §4.4 verification setups --------------------------------------
# interconnect_GBps defaults: host parts expose their PCIe-gen5-x16-class
# fabric (a tp>1 what-if on them is a multi-socket/eGPU thought experiment),
# V100 its NVLink2 aggregate, v5e the per-chip ICI figure the distributed
# roofline always used (grading constant below).
RYZEN_9_HX370_CPU = _reg(HardwareSpec(
    name="ryzen-9-hx370-cpu", tops=0.3264, bw_gbps=240.0,
    dispatch_latency_s=2e-6, onchip_bytes=24 * 2**20,
    interconnect_GBps=64.0))

RYZEN_AI_MAX_395_NPU = _reg(HardwareSpec(
    name="ryzen-ai-max-395-npu", tops=50.0, bw_gbps=256.0,
    dispatch_latency_s=10e-6, onchip_bytes=32 * 2**20,
    interconnect_GBps=64.0))

RYZEN_AI_MAX_395_IGPU = _reg(HardwareSpec(
    name="ryzen-ai-max-395-igpu", tops=76.0, bw_gbps=256.0,
    dispatch_latency_s=8e-6, onchip_bytes=16 * 2**20,
    interconnect_GBps=64.0))

NVIDIA_V100 = _reg(HardwareSpec(
    name="nvidia-v100", tops=126.0, bw_gbps=900.0,
    dispatch_latency_s=5e-6, onchip_bytes=20 * 2**20,
    interconnect_GBps=300.0))          # NVLink2: 6 links × 50 GB/s

# ---- TPU target (grading constants: 197 TFLOP/s bf16, 819 GB/s, 50 GB/s ICI)
TPU_V5E = _reg(HardwareSpec(
    name="tpu-v5e", tops=197.0, bw_gbps=819.0,
    dispatch_latency_s=2e-6, onchip_bytes=128 * 2**20,   # ~128 MiB VMEM
    interconnect_GBps=50.0, ici_links=4, hbm_bytes=16 * 2**30))

# ---- the port's card: NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU
# data sheet: 989 TFLOP/s dense bf16 tensor core, 3.35 TB/s HBM3, 900 GB/s
# NVLink, 80 GB HBM3; 50 MB L2 per the Hopper architecture white paper).
# Dispatch latency is the registry's default (not measured for this entry).
NVIDIA_H100 = _reg(HardwareSpec(
    name="nvidia-h100", tops=989.0, bw_gbps=3350.0,
    onchip_bytes=50 * 2**20,
    interconnect_GBps=900.0, hbm_bytes=80e9))


#: Short aliases accepted by :func:`get` (case-insensitive, like names).
ALIASES: Dict[str, str] = {
    "cpu": "ryzen-9-hx370-cpu",
    "npu": "ryzen-ai-max-395-npu",
    "igpu": "ryzen-ai-max-395-igpu",
    "v100": "nvidia-v100",
    "h100": "nvidia-h100",
    "v5e": "tpu-v5e",
    "tpu": "tpu-v5e",
}


def register(spec: HardwareSpec) -> HardwareSpec:
    """Register (or replace) a spec under its name.

    The entry point for *calibrated* specs — e.g.
    ``benchmarks/calibrate_host.py`` micro-benchmarks the local machine's
    effective GEMM throughput, memory bandwidth and dispatch overhead and
    registers the result as ``"host-cpu"``, after which forecasts can
    target the actual host instead of a datasheet part.
    """
    REGISTRY[spec.name] = spec
    return spec


def names() -> List[str]:
    """Sorted names of every registered hardware spec."""
    return sorted(REGISTRY)


def get(name: Union[str, HardwareSpec]) -> HardwareSpec:
    """Resolve a hardware target uniformly.

    Accepts a registered name (case-insensitive), a short alias
    (``"v100"`` → ``"nvidia-v100"``), or an already-resolved
    :class:`HardwareSpec` (returned as-is, so callers can thread either
    form through without branching).
    """
    if isinstance(name, HardwareSpec):
        return name
    key = str(name).strip().lower()
    key = ALIASES.get(key, key)
    try:
        return REGISTRY[key]
    except KeyError:
        raise KeyError(f"unknown hardware {name!r}; known: {sorted(REGISTRY)}"
                       f" (aliases: {sorted(ALIASES)})") from None


# public registry-listing alias; kept LAST so the builtin `list` is never
# shadowed inside this module's own code above
list = names
