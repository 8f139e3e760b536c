"""Seeded arrival-process generators and the :class:`TrafficTrace`.

A traffic trace is the hardware-agnostic unit of serving load: a sorted
sequence of ``(arrival_s, prompt_len, gen_len)`` records.  The same
trace feeds the real engine (open-loop, via ``traffic.feed``) and the
analytical queue simulator (``traffic.simulate``), which is what makes
SLO goodput a measured-vs-forecast comparison rather than two unrelated
experiments.

Generators are fully seeded (``numpy.random.default_rng``) and never
read the wall clock.  All inter-arrival draws are made at unit rate and
scaled by ``1/qps``, so traces generated at different QPS from the same
seed are *time-scalings of each other* — offered load sweeps (and the
``capacity_search`` bisection) compare the same request population under
compressed arrivals instead of resampling a new population per probe.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Tuple, Union

import numpy as np

#: known arrival processes (``"replay"`` marks a trace loaded from file)
ARRIVAL_KINDS = ("deterministic", "poisson", "bursty")


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """Per-request length distribution, parseable from a compact spec.

    Specs: ``"constant:32"`` (or just ``"32"``), ``"uniform:16:64"``
    (inclusive integer bounds), ``"lognormal:32:0.5"`` (median, sigma of
    the underlying normal; samples clipped to >= 1).  Sampling draws
    from a caller-provided rng so the whole trace stays seeded.
    """
    kind: str
    a: float
    b: float = 0.0

    KINDS = ("constant", "uniform", "lognormal")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"length dist kind must be one of "
                             f"{self.KINDS}, got {self.kind!r}")
        if self.kind == "constant" and self.a < 1:
            raise ValueError(f"constant length must be >= 1, got {self.a}")
        if self.kind == "uniform" and not 1 <= self.a <= self.b:
            raise ValueError(f"uniform length bounds must satisfy "
                             f"1 <= lo <= hi, got {self.a}:{self.b}")
        if self.kind == "lognormal" and (self.a < 1 or self.b < 0):
            raise ValueError(f"lognormal needs median >= 1 and sigma >= 0, "
                             f"got {self.a}:{self.b}")

    @classmethod
    def parse(cls, spec: Union[str, int, "LengthDist"]) -> "LengthDist":
        if isinstance(spec, LengthDist):
            return spec
        if isinstance(spec, int):
            return cls("constant", spec)
        parts = str(spec).split(":")
        if len(parts) == 1:
            return cls("constant", float(parts[0]))
        try:
            args = [float(p) for p in parts[1:]]
        except ValueError:
            raise ValueError(f"bad length dist spec {spec!r}: numeric "
                             f"arguments expected after {parts[0]!r}")
        if len(args) == 1:
            args.append(0.0)
        if len(args) != 2:
            raise ValueError(f"bad length dist spec {spec!r}: expected "
                             f"kind:arg or kind:arg:arg")
        return cls(parts[0], *args)

    def sample(self, rng: np.random.Generator) -> int:
        if self.kind == "constant":
            return max(int(self.a), 1)
        if self.kind == "uniform":
            return int(rng.integers(int(self.a), int(self.b) + 1))
        # lognormal: median a, sigma b on the log scale
        return max(int(round(self.a * np.exp(self.b * rng.standard_normal()))),
                   1)

    @property
    def spec(self) -> str:
        if self.kind == "constant":
            return f"constant:{int(self.a)}"
        if self.kind == "uniform":
            return f"uniform:{int(self.a)}:{int(self.b)}"
        return f"lognormal:{self.a:g}:{self.b:g}"


@dataclasses.dataclass(frozen=True)
class TrafficRequest:
    """One arrival: when it lands and how much work it carries."""
    rid: int
    arrival_s: float
    prompt_len: int
    gen_len: int

    def to_dict(self) -> Dict:
        return {"rid": self.rid, "arrival_s": self.arrival_s,
                "prompt_len": self.prompt_len, "gen_len": self.gen_len}


@dataclasses.dataclass(frozen=True)
class TrafficTrace:
    """A sorted arrival trace plus the metadata that generated it."""
    requests: Tuple[TrafficRequest, ...]
    arrival: str = "replay"             # generator kind (or "replay")
    qps: float = 0.0                    # nominal offered rate (0: unknown)
    seed: int = 0

    def __post_init__(self):
        last = -float("inf")
        for r in self.requests:
            if r.arrival_s < last:
                raise ValueError("trace arrivals must be sorted "
                                 "non-decreasing")
            if r.prompt_len < 1 or r.gen_len < 1:
                raise ValueError(f"request {r.rid}: prompt_len and gen_len "
                                 f"must be >= 1")
            last = r.arrival_s

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    @property
    def duration_s(self) -> float:
        """Span from first to last arrival."""
        if not self.requests:
            return 0.0
        return self.requests[-1].arrival_s - self.requests[0].arrival_s

    @property
    def offered_qps(self) -> float:
        """Realized arrival rate over the trace span."""
        if len(self.requests) < 2:
            return 0.0
        return (len(self.requests) - 1) / max(self.duration_s, 1e-12)

    # ------------------------------------------------------------ JSON
    def to_dict(self) -> Dict:
        return {"traffic_trace": 1, "arrival": self.arrival,
                "qps": self.qps, "seed": self.seed,
                "requests": [r.to_dict() for r in self.requests]}

    @classmethod
    def from_dict(cls, d: Dict) -> "TrafficTrace":
        reqs = tuple(TrafficRequest(**r) for r in d.get("requests", ()))
        return cls(requests=reqs, arrival=d.get("arrival", "replay"),
                   qps=float(d.get("qps", 0.0)), seed=int(d.get("seed", 0)))

    def to_jsonl(self) -> str:
        """Stable one-record-per-line form: a header line, then one line
        per request — append-friendly and diff-friendly."""
        head = {"traffic_trace": 1, "arrival": self.arrival,
                "qps": self.qps, "seed": self.seed,
                "n_requests": len(self.requests)}
        lines = [json.dumps(head, sort_keys=True)]
        lines += [json.dumps(r.to_dict(), sort_keys=True)
                  for r in self.requests]
        return "\n".join(lines) + "\n"

    @classmethod
    def from_jsonl(cls, text: str) -> "TrafficTrace":
        head: Dict = {}
        reqs: List[TrafficRequest] = []
        for i, line in enumerate(text.splitlines()):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if d.get("traffic_trace") and "requests" not in d:
                head = d
                continue
            if "requests" in d:             # whole-trace JSON on one line
                return cls.from_dict(d)
            reqs.append(TrafficRequest(
                rid=int(d.get("rid", len(reqs))),
                arrival_s=float(d["arrival_s"]),
                prompt_len=int(d["prompt_len"]),
                gen_len=int(d["gen_len"])))
        return cls(requests=tuple(reqs),
                   arrival=head.get("arrival", "replay"),
                   qps=float(head.get("qps", 0.0)),
                   seed=int(head.get("seed", 0)))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_jsonl())

    @classmethod
    def load(cls, path: str) -> "TrafficTrace":
        with open(path) as f:
            return cls.from_jsonl(f.read())


def _unit_rate_gaps(kind: str, n: int, rng: np.random.Generator, *,
                    burst: float, burst_len: int) -> Iterable[float]:
    """Inter-arrival gaps at unit mean rate (first arrival at t=0)."""
    if kind == "deterministic":
        return [0.0] + [1.0] * (n - 1)
    if kind == "poisson":
        return [0.0] + list(rng.exponential(1.0, size=max(n - 1, 0)))
    if kind == "bursty":
        # ON/OFF: bursts of ~burst_len arrivals at rate ``burst`` (>1)
        # separated by OFF gaps sized so the long-run mean rate stays 1:
        #   E[gap] = 1/burst + (1/burst_len) * burst_len*(burst-1)/burst = 1
        if burst <= 1.0:
            raise ValueError(f"burst factor must be > 1, got {burst}")
        if burst_len < 1:
            raise ValueError(f"burst_len must be >= 1, got {burst_len}")
        off_scale = burst_len * (burst - 1.0) / burst
        gaps = [0.0]
        for i in range(1, n):
            g = rng.exponential(1.0 / burst)
            if i % burst_len == 0:
                g += rng.exponential(off_scale)
            gaps.append(g)
        return gaps
    raise ValueError(f"arrival must be one of {ARRIVAL_KINDS}, got {kind!r}")


def make_trace(arrival: str, qps: float, n_requests: int, *,
               prompt_lens: Union[str, int, LengthDist],
               gen_lens: Union[str, int, LengthDist],
               seed: int = 0, burst: float = 4.0,
               burst_len: int = 8) -> TrafficTrace:
    """Generate a seeded :class:`TrafficTrace`.

    ``arrival`` picks the process (``deterministic`` — evenly spaced at
    ``1/qps``; ``poisson`` — exponential inter-arrivals; ``bursty`` —
    ON/OFF bursts of ``burst_len`` requests at ``burst``x the mean rate
    with compensating idle gaps).  Lengths are drawn per request from
    :class:`LengthDist` specs.  Deterministic: same arguments, same
    trace — and the same seed at a different ``qps`` yields the same
    requests under time-scaled arrivals.
    """
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    pdist = LengthDist.parse(prompt_lens)
    gdist = LengthDist.parse(gen_lens)
    rng = np.random.default_rng(seed)
    gaps = _unit_rate_gaps(arrival, n_requests, rng,
                           burst=burst, burst_len=burst_len)
    t = 0.0
    reqs = []
    for i, g in enumerate(gaps):
        t += g / qps
        reqs.append(TrafficRequest(rid=i, arrival_s=t,
                                   prompt_len=pdist.sample(rng),
                                   gen_len=gdist.sample(rng)))
    return TrafficTrace(requests=tuple(reqs), arrival=arrival,
                        qps=qps, seed=seed)
