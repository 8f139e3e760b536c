"""The benchmark's own spans and ranges around the program's calls, put
in place for a ``--trace 1`` run's window only.

Each file ``portbench/counts/<kernel>.py`` names one entry point of the
port (``ENTRY``: its module and function) and counts one call's least
time.  For every such file that the cell's per-layer readers name among
their ``RANGES``, each call of the entry point opens a profiler range
named after the file and leaves what its count needs, so that a
kernel's roofline share is the least time its calls' shapes need over
the device time inside its ranges, whatever kernel a later change puts
behind the entry point.  A new kernel's count is a new file, never an
edit here.  Around ``Engine.prefill_fn`` and ``Engine.decode_fn`` a
call is timed by the host clock between two synchronisations.
"""
from __future__ import annotations

import importlib
import inspect
import time
from typing import Dict, Iterable, List

import torch

from portbench.manifest import HERE, load_file
from portbench.trace import record


class _Kept:
    """A device copy of an index tensor, read back after the window."""

    def __init__(self, key, t: torch.Tensor):
        self.key, self.copy, self.held = key, t.clone(), t


class KernelProbes:
    """While entered, every call of each counted entry point runs inside
    the range named after its count file and appends what the count
    needs to ``calls[name]``."""

    def __init__(self, names: Iterable[str]):
        self.counts = {n: load_file("counts", n) for n in sorted(set(names))
                       if (HERE / "counts" / f"{n}.py").is_file()}
        self.calls: Dict[str, List[Dict]] = {n: [] for n in self.counts}
        self._saved = []
        self._kept: Dict = {}

    @property
    def names(self) -> List[str]:
        return list(self.counts)

    @staticmethod
    def meta(t: torch.Tensor) -> torch.Tensor:
        """The tensor's shape and type, without its data."""
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def keep(self, t: torch.Tensor) -> _Kept:
        """One device copy of an index tensor per version of it (the
        layers of a decode step share their tables and cursors).  The
        tensor itself is held too, so that its address is not reused
        by a later tensor while the key stands."""
        key = (t.data_ptr(), t._version, tuple(t.shape))
        if key not in self._kept:
            self._kept[key] = _Kept(key, t)
        return self._kept[key]

    def _wrap(self, name: str, count, real):
        sig = inspect.signature(real)

        def probed(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            self.calls[name].append(count.shapes(bound.arguments, self))
            with record(name):
                return real(*args, **kw)
        return probed

    def __enter__(self):
        for name, count in self.counts.items():
            module, attr = count.ENTRY
            mod = importlib.import_module(module)
            real = getattr(mod, attr)
            self._saved.append((mod, attr, real))
            setattr(mod, attr, self._wrap(name, count, real))
        return self

    def __exit__(self, *exc):
        for mod, attr, real in reversed(self._saved):
            setattr(mod, attr, real)
        self._saved.clear()

    def least_ms(self) -> Dict[str, float]:
        """The summed least time of each range's calls (after the window:
        the kept index copies are read back here, and calls alike are
        counted once)."""
        host = {k.key: k.copy.cpu() for k in self._kept.values()}
        out = {}
        for name, count in self.counts.items():
            memo: Dict = {}
            total = 0.0
            for call in self.calls[name]:
                key = _fingerprint(call)
                if key not in memo:
                    memo[key] = count.least_ms(
                        {k: host[v.key] if isinstance(v, _Kept) else v
                         for k, v in call.items()})
                total += memo[key]
            out[name] = total
        return out


def _fingerprint(call: Dict):
    def fp(v):
        if isinstance(v, _Kept):
            return ("kept", v.key)
        if isinstance(v, torch.Tensor):
            return ("tensor", tuple(v.shape), str(v.dtype))
        return v
    return tuple(sorted((k, fp(v)) for k, v in call.items()))


class Spans:
    """Host-clock spans of calls, each between two synchronisations:
    name -> [(seconds, amount)]."""

    def __init__(self, device):
        self.device = device
        self.spans: Dict[str, List] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, name: str, fn, amount):
        """``fn`` timed under ``name``; ``amount(args)`` is the work the
        call does (tokens, steps)."""
        def timed(*args, **kw):
            self._sync()
            t0 = time.perf_counter()
            with record(name):
                out = fn(*args, **kw)
                self._sync()
            self.spans.setdefault(name, []).append(
                (time.perf_counter() - t0, amount(args)))
            return out
        return timed
