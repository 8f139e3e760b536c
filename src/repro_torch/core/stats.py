"""Statistics database (paper Fig. 2-F).

Accumulates hardware-agnostic workload metrics per operator invocation:
compute ops, memory read/write bytes, KV-cache read/write bytes, dispatch
calls.  Supports hierarchical scopes (layer/op nesting), phase tagging
(prefill/decode), and grouped reductions used by the analysis scripts.
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Callable, Dict, Iterable, List, Optional


@dataclasses.dataclass
class OpRecord:
    op: str                    # operator name, e.g. "gemm", "bmm", "softmax"
    scope: str                 # hierarchical scope, e.g. "layer/attn/q_proj"
    phase: str                 # "prefill" | "decode" | "lora_update" | ...
    ops: float = 0.0           # compute operations (MACs*2 convention, paper)
    mem_rd: float = 0.0        # bytes read (activations + params)
    mem_wr: float = 0.0        # bytes written
    kv_rd: float = 0.0         # bytes read from KV cache (subset of mem_rd)
    kv_wr: float = 0.0         # bytes written to KV cache (subset of mem_wr)
    dispatches: int = 0        # kernel dispatch calls
    wire_bytes: float = 0.0    # collective bytes over the interconnect
    # optional classification for Table-4-style distribution reports
    op_class: str = ""         # "gemm" | "bmm" | "softmax" | "elemw" | ...

    def scaled(self, factor: float) -> "OpRecord":
        return dataclasses.replace(
            self,
            ops=self.ops * factor,
            mem_rd=self.mem_rd * factor,
            mem_wr=self.mem_wr * factor,
            kv_rd=self.kv_rd * factor,
            kv_wr=self.kv_wr * factor,
            dispatches=int(round(self.dispatches * factor)),
            wire_bytes=self.wire_bytes * factor,
        )


@dataclasses.dataclass
class Totals:
    ops: float = 0.0
    mem_rd: float = 0.0
    mem_wr: float = 0.0
    kv_rd: float = 0.0
    kv_wr: float = 0.0
    dispatches: int = 0
    wire_bytes: float = 0.0

    @property
    def mem_total(self) -> float:
        return self.mem_rd + self.mem_wr

    def add(self, r: OpRecord) -> None:
        self.ops += r.ops
        self.mem_rd += r.mem_rd
        self.mem_wr += r.mem_wr
        self.kv_rd += r.kv_rd
        self.kv_wr += r.kv_wr
        self.dispatches += r.dispatches
        self.wire_bytes += r.wire_bytes

    def merge(self, other: "Totals") -> None:
        self.ops += other.ops
        self.mem_rd += other.mem_rd
        self.mem_wr += other.mem_wr
        self.kv_rd += other.kv_rd
        self.kv_wr += other.kv_wr
        self.dispatches += other.dispatches
        self.wire_bytes += other.wire_bytes

    def scaled(self, factor: float) -> "Totals":
        return Totals(ops=self.ops * factor,
                      mem_rd=self.mem_rd * factor,
                      mem_wr=self.mem_wr * factor,
                      kv_rd=self.kv_rd * factor,
                      kv_wr=self.kv_wr * factor,
                      dispatches=int(round(self.dispatches * factor)),
                      wire_bytes=self.wire_bytes * factor)

    def plus(self, other: "Totals", factor: float = 1.0) -> "Totals":
        """self + factor·other as a new Totals (dispatch count rounded)."""
        return Totals(ops=self.ops + factor * other.ops,
                      mem_rd=self.mem_rd + factor * other.mem_rd,
                      mem_wr=self.mem_wr + factor * other.mem_wr,
                      kv_rd=self.kv_rd + factor * other.kv_rd,
                      kv_wr=self.kv_wr + factor * other.kv_wr,
                      dispatches=int(round(self.dispatches
                                           + factor * other.dispatches)),
                      wire_bytes=self.wire_bytes + factor * other.wire_bytes)

    def minus(self, other: "Totals") -> "Totals":
        return self.plus(other, factor=-1.0)

    def as_dict(self) -> Dict[str, float]:
        return {
            "ops": self.ops,
            "mem_rd": self.mem_rd,
            "mem_wr": self.mem_wr,
            "mem_total": self.mem_total,
            "kv_rd": self.kv_rd,
            "kv_wr": self.kv_wr,
            "dispatches": self.dispatches,
            "wire_bytes": self.wire_bytes,
        }


class StatsDB:
    """Append-only operator-record store with grouped reductions."""

    def __init__(self) -> None:
        self.records: List[OpRecord] = []
        self._scope_stack: List[str] = []
        self._phase: str = "prefill"
        self._shard_div: float = 1.0

    # -- scoping ----------------------------------------------------------
    def push_scope(self, name: str) -> None:
        self._scope_stack.append(name)

    def pop_scope(self) -> None:
        self._scope_stack.pop()

    class _Scope:
        def __init__(self, db: "StatsDB", name: str) -> None:
            self.db, self.name = db, name

        def __enter__(self):
            self.db.push_scope(self.name)
            return self.db

        def __exit__(self, *exc):
            self.db.pop_scope()
            return False

    def scope(self, name: str) -> "StatsDB._Scope":
        return StatsDB._Scope(self, name)

    class _Sharded:
        """Divide recorded per-operator ops/bytes by ``div`` (per-chip view).

        Dispatches and wire bytes are NOT divided: every chip of an SPMD
        program launches every kernel, and wire bytes are recorded per chip
        already.  ``div == 1`` is an exact no-op (bit-for-bit)."""

        def __init__(self, db: "StatsDB", div: float) -> None:
            self.db, self.div = db, float(div)

        def __enter__(self):
            self.prev = self.db._shard_div
            self.db._shard_div = self.div
            return self.db

        def __exit__(self, *exc):
            self.db._shard_div = self.prev
            return False

    def sharded(self, div: float) -> "StatsDB._Sharded":
        return StatsDB._Sharded(self, div)

    def set_phase(self, phase: str) -> None:
        self._phase = phase

    @property
    def phase(self) -> str:
        return self._phase

    # -- recording --------------------------------------------------------
    def record(
        self,
        op: str,
        *,
        ops: float = 0.0,
        mem_rd: float = 0.0,
        mem_wr: float = 0.0,
        kv_rd: float = 0.0,
        kv_wr: float = 0.0,
        dispatches: int = 1,
        wire_bytes: float = 0.0,
        op_class: str = "",
    ) -> OpRecord:
        if self._shard_div != 1.0:
            # per-chip view under an active sharding scope: each operator's
            # FLOPs/bytes divide across chips; dispatches and wire do not
            d = self._shard_div
            ops, mem_rd, mem_wr = ops / d, mem_rd / d, mem_wr / d
            kv_rd, kv_wr = kv_rd / d, kv_wr / d
        rec = OpRecord(
            op=op,
            scope="/".join(self._scope_stack),
            phase=self._phase,
            ops=ops,
            mem_rd=mem_rd,
            mem_wr=mem_wr,
            kv_rd=kv_rd,
            kv_wr=kv_wr,
            dispatches=dispatches,
            wire_bytes=wire_bytes,
            op_class=op_class or op,
        )
        self.records.append(rec)
        return rec

    def extend(self, records: Iterable[OpRecord]) -> None:
        self.records.extend(records)

    # -- reductions -------------------------------------------------------
    def totals(
        self,
        phase: Optional[str] = None,
        pred: Optional[Callable[[OpRecord], bool]] = None,
    ) -> Totals:
        t = Totals()
        for r in self.records:
            if phase is not None and r.phase != phase:
                continue
            if pred is not None and not pred(r):
                continue
            t.add(r)
        return t

    def by_op_class(self, phase: Optional[str] = None) -> Dict[str, Totals]:
        out: Dict[str, Totals] = collections.defaultdict(Totals)
        for r in self.records:
            if phase is not None and r.phase != phase:
                continue
            out[r.op_class].add(r)
        return dict(out)

    def by_scope_prefix(self, depth: int = 1, phase: Optional[str] = None) -> Dict[str, Totals]:
        out: Dict[str, Totals] = collections.defaultdict(Totals)
        for r in self.records:
            if phase is not None and r.phase != phase:
                continue
            key = "/".join(r.scope.split("/")[:depth])
            out[key].add(r)
        return dict(out)

    def dispatch_calls(self, phase: Optional[str] = None) -> int:
        return self.totals(phase).dispatches

    # -- persistence ------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(r) for r in self.records])

    @classmethod
    def from_json(cls, text: str) -> "StatsDB":
        db = cls()
        db.records = [OpRecord(**d) for d in json.loads(text)]
        return db

    def clear(self) -> None:
        self.records.clear()
