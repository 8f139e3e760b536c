"""What a ``--trace 1`` run reads from torch.profiler's trace of its
window: the device's busy time, the device time inside the benchmark's
named ranges, the operations that took most time and the longest idle
gaps by what the host was doing."""
from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Tuple

import torch
from torch.autograd import DeviceType

#: the range around the whole window
WINDOW = "portbench.window"


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False,
                   profile_memory=False)


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class _Innermost:
    """The innermost named host range at a time (ranges of one name do
    not overlap; ranges of different names nest)."""

    def __init__(self, ranges: Dict[str, List[Tuple[float, float]]]):
        self.by_name = {n: sorted(r) for n, r in ranges.items() if r}
        self.starts = {n: [a for a, _ in r] for n, r in self.by_name.items()}

    def at(self, t: float) -> str:
        best, best_start = "none", float("-inf")
        for n, starts in self.starts.items():
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0:
                a, b = self.by_name[n][i]
                if b >= t and a > best_start:
                    best, best_start = n, a
        return best


class _Busy:
    """Merged kernel intervals, with the busy time inside any span."""

    def __init__(self, intervals: List[Tuple[float, float]]):
        self.iv = _merge(intervals)
        self.starts = [a for a, _ in self.iv]
        self.cum = [0.0]
        for a, b in self.iv:
            self.cum.append(self.cum[-1] + b - a)

    def within(self, a: float, b: float) -> float:
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0.0
        total = self.cum[j] - self.cum[i]
        s0, e0 = self.iv[i]
        total -= min(max(a - s0, 0.0), e0 - s0)          # before a
        s1, e1 = self.iv[j - 1]
        total -= min(max(e1 - b, 0.0), e1 - s1)          # after b
        return total


def summarize(prof, names: Iterable[str]) -> Dict:
    """The window's device busy seconds, the device milliseconds and
    entries of each named range, the ten device operations with most
    time and the ten idle-gap totals by innermost named range.

    Read from the profiler's raw events, without building its tree of
    function events (minutes for a window of a million events).  A
    range's device time is the kernels' busy time inside its spans on
    the device's timeline (the profiler's device-side copy of each user
    range); None where the range left no such span.  User ranges are
    never counted as device operations."""
    names = set(names) | {WINDOW}
    kernels: List[Tuple[float, float]] = []
    by_op: Dict[str, float] = {}
    ranges: Dict[str, List[Tuple[float, float]]] = {n: [] for n in names}
    spans: Dict[str, List[Tuple[float, float]]] = {n: [] for n in names}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = e.device_type() == DeviceType.CUDA
        if on_device and not e.is_user_annotation():
            a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
            if b > a:
                kernels.append((a, b))
                by_op[name] = by_op.get(name, 0.0) + (b - a)
        elif name in names:
            (spans if on_device else ranges)[name].append(
                (e.start_ns() / 1e3, e.end_ns() / 1e3))
    if not ranges[WINDOW]:
        raise RuntimeError("the trace holds no window range")
    w0 = min(a for a, _ in ranges[WINDOW])
    w1 = max(b for _, b in ranges[WINDOW])
    everything = _Busy(kernels)
    busy = _merge([(max(a, w0), min(b, w1)) for a, b in everything.iv
                   if b > w0 and a < w1])
    range_ms = {n: (sum(everything.within(a, b) for a, b in spans[n]) / 1e3
                    if spans[n] else None) for n in names}
    host = _Innermost({n: r for n, r in ranges.items() if n != WINDOW})
    gaps: Dict[str, float] = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            who = host.at((a + b) / 2)
            gaps[who] = gaps.get(who, 0.0) + (b - a)
    top = lambda d: [[_short(k), v / 1e6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "traced_s": (w1 - w0) / 1e6,
            "range_ms": range_ms,
            "range_calls": {n: len(ranges[n]) for n in names},
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(gaps)}}


def record(name: str):
    return torch.profiler.record_function(name)
