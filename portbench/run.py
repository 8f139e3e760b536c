"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
and its metrics are found by name through ``BENCHMARK.json``.  The run
makes its weights and inputs from ``--seed``, warms up every shape it
uses, measures a window of ``--seconds``, checks what the window
produced against the plain reference and prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``: each number the check compared,
beside its limit.  Those numbers are also the last lines of standard
error.

It exits non-zero and prints no result where there is no CUDA card or
fewer cards than the cell asks for, where the program cannot be
imported, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Sequence  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the CUDA driver's cache, at a fixed path inside the checkout (the
#: program builds its kernels into ``build/repro_torch`` there itself)
CACHES = {"CUDA_CACHE_PATH": "build/portbench/cuda"}


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared whole (``repro_torch`` is not
    ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What the window left for the per-layer metrics' readers."""

    def __init__(self, window_s: float, peak_bytes: int, **kw):
        self.window_s = window_s
        self.peak_bytes = peak_bytes
        self.events = kw.pop("events", [])
        self.ttft_s = kw.pop("ttft_s", [])
        self.spans = kw.pop("spans", {})
        self.steps = kw.pop("steps", 0)
        self.model_flops = kw.pop("model_flops", 0.0)
        if kw:
            raise TypeError(f"unknown fields {sorted(kw)}")
        self.traced = None          # trace.summarize's record
        self.least_ms: Dict[str, float] = {}

    def add_trace(self, prof, probes, names) -> None:
        """The trace's record of ``names`` and the probes' ranges, and the
        probes' least times."""
        from portbench.trace import summarize
        self.traced = summarize(prof, set(names) | set(probes.names))
        self.least_ms = probes.least_ms()

    def range_ms(self, name: str) -> Optional[float]:
        """The device milliseconds inside the range ``name``; None where
        it left no span on the device or was not traced."""
        return (None if self.traced is None
                else self.traced["range_ms"].get(name))

    def roofline(self, kernel: str) -> Optional[float]:
        """The least time of the calls counted by
        ``portbench/counts/<kernel>.py`` over the device time inside
        their ranges, in percent; None where either is missing."""
        ms, least = self.range_ms(kernel), self.least_ms.get(kernel)
        return 100 * least / ms if ms and least else None


class Context:
    """A cell's inputs, the run's clock and device, and the profiler
    ranges its per-layer readers read (``ranges``)."""

    def __init__(self, *, arch, conf, traffic, seed, seconds, trace, device,
                 t0=None, ranges=()):
        import torch
        self.arch, self.conf, self.traffic = arch, conf, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.on_card = torch.device(device).type == "cuda"
        self.t0 = T0 if t0 is None else t0
        self.ranges = tuple(ranges)

    def log(self, msg: str) -> None:
        log(msg)

    def sync(self) -> None:
        import torch
        if self.on_card:
            torch.cuda.synchronize()

    def free(self) -> None:
        import torch
        gc.collect()
        if self.on_card:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def peak_bytes(self) -> int:
        import torch
        return int(torch.cuda.max_memory_allocated()) if self.on_card else 0

    def event(self):
        """A point on the device's stream (a CUDA event), or on the host
        clock off the card."""
        import torch
        if self.on_card:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return _HostEvent()

    def elapsed(self, a, b) -> float:
        """Seconds from event a to event b."""
        if self.on_card:
            return a.elapsed_time(b) / 1e3
        return b.t - a.t

    def record(self, **kw) -> Run:
        return Run(**kw)


class _HostEvent:
    """A point on the host clock, for runs off the card."""

    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass


def arch_config(conf: Dict):
    """The program's ``ArchConfig`` for a dense GQA decoder's config file.
    Refuses a file that states what the port cannot run: another
    activation or norm epsilon, or Granite's multipliers at other values
    than the ones that leave the usual decoder."""
    from repro_torch.configs.base import ArchConfig
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    hd = conf.get("head_dim") or d // H
    neutral = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
               "logits_scaling": 1.0, "attention_multiplier": hd ** -0.5,
               "rms_norm_eps": 1e-6, "hidden_act": "silu",
               "attention_dropout": 0.0}
    for key, want in neutral.items():
        if key in conf and conf[key] != want:
            raise ValueError(f"{conf['name']}: {key} = {conf[key]!r}; the "
                             f"port runs {want!r}")
    return ArchConfig(name=conf["name"], family="dense",
                      n_layers=conf["num_hidden_layers"], d_model=d,
                      n_heads=H, n_kv_heads=conf["num_key_value_heads"],
                      d_ff=conf["intermediate_size"],
                      vocab_size=conf["vocab_size"], head_dim=hd,
                      qkv_bias=bool(conf.get("attention_bias")),
                      tie_embeddings=bool(conf["tie_word_embeddings"]),
                      rope_theta=float(conf["rope_theta"]),
                      max_position=conf["max_position_embeddings"])


def run_cell(conf: Dict, traffic: Dict, limits: Dict, *, seed: int,
             seconds: float, trace: bool, device: str, t0=None,
             readers: Sequence[str] = ()) -> Dict:
    """Set up, measure and check one cell; returns the kind's outcome
    with ``correct`` and the compared numbers beside their limits.  A
    traced run records the profiler ranges that the per-layer metrics
    ``readers`` (``portbench/metrics/<name>.py``) name."""
    from portbench.check import verdict
    from portbench.manifest import load_reader
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    ranges = sorted({r for name in readers
                     for r in getattr(load_reader(name), "RANGES", ())})
    ctx = Context(arch=arch_config(conf), conf=conf, traffic=traffic,
                  seed=seed, seconds=seconds, trace=trace, device=device,
                  t0=t0, ranges=ranges)
    out = kind.run(ctx)
    out["verdict"] = verdict(out["compared"], limits)
    seen = {k: v for k, v in out["compared"].items() if k not in limits}
    if seen:
        log(f"read, not compared: {seen}")
    out["correct"] = (all(v["ok"] for v in out["verdict"].values())
                      and out["failed"] == 0 and out["attempted"] > 0)
    return out


def device_record(out: Dict, chips: int, trace: bool) -> Dict:
    import torch
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": chips, "memory_peak_bytes": out["run"].peak_bytes}
    if trace:
        rec["busy_s"] = out["run"].traced["busy_s"]
        rec["window_s"] = out["run"].window_s
    return rec


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
        (ROOT / rel).mkdir(parents=True, exist_ok=True)

    from portbench.manifest import Manifest, load_reader
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"cuda available: {torch.cuda.is_available()}, cards: "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        importlib.import_module("repro_torch")
    except ImportError as e:
        log(f"the program (src/repro_torch) cannot be imported: {e}")
        return 3
    log(f"{cell.name} seed {args.seed} on {power_limit()}")
    per_layer = manifest.per_layer_for(cell)
    out = run_cell(manifest.config(cell), manifest.traffic(cell),
                   manifest.limits(cell), seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   device="cuda", readers=[m.name for m in per_layer])
    loaded = forbidden_modules()
    if loaded:
        log(f"modules that may not be loaded were: {loaded}")
        return 4

    if args.trace:
        metrics = {}
        for m in per_layer:
            value = load_reader(m.name).read(out["run"])
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        metrics = {m.name: {"value": out["metrics"][m.name], "unit": m.unit}
                   for m in manifest.end_to_end_for(cell)}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_record(out, cell.chips, bool(args.trace))}
    if args.trace:
        line["breakdown"] = out["run"].traced["breakdown"]
    # a number that is not finite (no request to check) fails and is
    # printed as null, which JSON can hold
    finite = lambda x: x if x == x and abs(x) != float("inf") else None
    line["compared"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                        for k, v in out["verdict"].items()}
    for k, v in out["verdict"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
