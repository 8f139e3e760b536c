"""Counts of the work a step executes (the port's counterpart of the JAX
package's ``core/hlo.py``).

XLA hands the reference a compiled module, whose text ``hlo.analyze``
reads for per-chip FLOPs, boundary bytes and collective wire bytes.  The
port compiles nothing: it runs eagerly, one aten op after another, so it
counts its own work as it runs.  :func:`count_work` is a context
manager that yields a :class:`ModuleCost` with the fields the audit's
reconciliation and the dry-run read, filled when the block exits:

* **matmul FLOPs** from ``torch.utils.flop_counter.FlopCounterMode``
  (2·m·k·n for ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and convolution),
  filed under the HLO family ``dot`` (``convolution`` for a convolution);
* **elementwise FLOPs**, one per output element of each elementwise or
  reduction op, as ``hlo.analyze`` counts them;
* **bytes**, per aten op: its inputs plus its outputs (the port runs
  unfused, so this is the honest counterpart of XLA's post-fusion
  boundary bytes).  A view moves nothing; a gather is charged twice its
  result and a scatter (``index_put_``, ``index_add_``, ...) twice its
  values, as ``hlo.analyze`` charges them, so an indexed read or write
  of the KV pool is not charged the whole pool.  Each op is filed under
  the HLO family of the reference (``_FAMILIES``: ``mm`` → ``dot``,
  ``index`` → ``gather``, ``index_put_`` → ``scatter``, ``add`` →
  ``add``, ...), so the pricing pass's family map applies unchanged;
* **collectives**, reported by the port's collective helpers
  (``core.collectives.all_reduce`` and ``broadcast``) through
  :func:`report_collective`: the op the port issues, its element count
  and dtype and its group size, under the ring convention of
  ``hlo.parse_collectives``;
* **hand-written kernels**, reported by their wrappers through
  :func:`report_kernel` (the dispatcher never sees a ``ctypes`` launch):
  each kernel's FLOPs and bytes from its cost function, computed from
  the shapes.  On the CPU a wrapper runs its plain version, which the
  modes above count, and reports nothing.

With no count active, :data:`ACTIVE` is None and every hook costs the
caller one ``None`` check.  Counts do not nest.

A count also keeps the peak of the bytes of live tensors the block
allocates (``ModuleCost.peak_live_bytes``) and the largest single one
(``largest_alloc_bytes``): each new storage is added when an op makes it
and taken off by a finalizer when it dies, so it works on the meta
device, where nothing is allocated (the dry-run's temporaries).

Not counted, as nothing in the port has them: XLA's while-loop trip
folding (``unknown_trip_loops`` stays 0) and its unfolded
``cost_analysis``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, Iterator, NamedTuple, Optional

import torch

#: the collective kinds of ``hlo.parse_collectives``
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_factor(op: str, group_size: int) -> float:
    """Wire bytes per result byte of one collective over ``group_size``
    ranks, under the ring convention of ``hlo.parse_collectives``."""
    g = group_size
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op in ("all-gather", "all-to-all"):
        return (g - 1) / g
    if op == "reduce-scatter":
        return float(g - 1)
    if op == "collective-permute":
        return 1.0
    raise ValueError(f"unknown collective {op!r}")


@dataclasses.dataclass
class ModuleCost:
    """The counted work of one block (the fields of ``hlo.ModuleCost``)."""
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    collective_wire: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    #: always 0: nothing is trip-folded in an eager run
    unknown_trip_loops: int = 0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_wire_elements: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    #: hand-written kernel launches reported, by kernel
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: peak bytes of the live tensors the block made, and the largest
    #: single storage it made
    peak_live_bytes: float = 0.0
    largest_alloc_bytes: float = 0.0
    #: tensors the block made of one of ``count_work``'s ``watch`` shapes
    watched_made: int = 0

    @property
    def wire_elements(self) -> float:
        return sum(self.collective_wire_elements.values())

    @property
    def dot_flops(self) -> float:
        """FLOPs of the matmul family (``dot`` + ``convolution``)."""
        return (self.flops_by_op.get("dot", 0.0)
                + self.flops_by_op.get("convolution", 0.0))

    def as_dict(self):
        return {"flops": self.flops, "bytes": self.bytes,
                "wire_bytes": self.wire_bytes,
                "collective_wire": self.collective_wire,
                "collective_counts": self.collective_counts,
                "unknown_trip_loops": self.unknown_trip_loops,
                "flops_by_op": self.flops_by_op,
                "bytes_by_op": self.bytes_by_op,
                "collective_wire_elements": self.collective_wire_elements,
                "kernel_launches": self.kernel_launches,
                "peak_live_bytes": self.peak_live_bytes,
                "largest_alloc_bytes": self.largest_alloc_bytes,
                "watched_made": self.watched_made}


# ---------------------------------------------------------------------------
# aten op -> HLO family
# ---------------------------------------------------------------------------

#: aten op names (in-place ``_`` dropped) -> the HLO family whose role
#: they play; an op not listed keeps its own name (an unmapped family)
_FAMILIES: Dict[str, str] = {
    **dict.fromkeys(("mm", "addmm", "bmm", "baddbmm", "dot", "mv", "addmv",
                     "_scaled_mm", "_scaled_dot_product_efficient_attention",
                     "_scaled_dot_product_flash_attention",
                     "_scaled_dot_product_cudnn_attention"), "dot"),
    **dict.fromkeys(("convolution", "_convolution"), "convolution"),
    **dict.fromkeys(("index", "_unsafe_index", "index_select", "gather",
                     "embedding", "take"), "gather"),
    **dict.fromkeys(("index_put", "_index_put_impl", "scatter", "scatter_add",
                     "scatter_reduce", "index_add", "index_copy",
                     "index_fill", "masked_scatter"), "scatter"),
    **dict.fromkeys(("sum", "mean", "amax", "amin", "aminmax", "max", "min",
                     "var", "var_mean", "std", "prod", "argmax", "argmin",
                     "any", "all", "norm", "linalg_vector_norm",
                     "logsumexp"), "reduce"),
    **dict.fromkeys(("cumsum", "cumprod"), "reduce-window"),
    **dict.fromkeys(("_softmax", "_log_softmax", "softmax", "log_softmax",
                     "_softmax_backward_data", "_log_softmax_backward_data",
                     "silu", "gelu", "silu_backward", "gelu_backward",
                     "sigmoid_backward", "tanh_backward", "threshold_backward",
                     "softplus", "softplus_backward", "erf", "lerp", "addcmul",
                     "addcdiv", "nll_loss_forward", "nll_loss_backward",
                     "masked_fill", "round", "trunc", "ceil", "reciprocal",
                     "expm1", "log1p", "exp2", "fmod", "remainder",
                     "floor_divide", "isnan", "isinf", "logical_not",
                     "bitwise_not", "nan_to_num", "_foreach_add",
                     "_foreach_mul"), "fusion"),
    "add": "add", "sub": "subtract", "rsub": "subtract", "mul": "multiply",
    "div": "divide", "maximum": "maximum", "clamp_min": "maximum",
    "minimum": "minimum", "clamp_max": "minimum", "exp": "exponential",
    "tanh": "tanh", "sigmoid": "logistic", "rsqrt": "rsqrt", "sqrt": "sqrt",
    "pow": "power", "square": "multiply", "neg": "negate", "eq": "compare",
    "ne": "compare", "lt": "compare", "le": "compare", "gt": "compare",
    "ge": "compare", "where": "select", "log": "log", "floor": "floor",
    "clamp": "clamp", "abs": "abs", "sign": "sign", "cos": "cosine",
    "sin": "sine", "logical_and": "and", "bitwise_and": "and",
    "logical_or": "or", "bitwise_or": "or", "logical_xor": "xor",
    "bitwise_xor": "xor",
    **dict.fromkeys(("clone", "copy", "contiguous", "_copy_from",
                     "_copy_from_and_resize", "lift_fresh_copy"), "copy"),
    **dict.fromkeys(("cat", "stack"), "concatenate"),
    **dict.fromkeys(("constant_pad_nd", "pad"), "pad"),
    **dict.fromkeys(("sort", "topk", "argsort", "kthvalue"), "sort"),
    **dict.fromkeys(("normal", "uniform", "bernoulli", "multinomial",
                     "randint", "rand", "randn", "exponential"), "rng"),
    "arange": "iota",
    **dict.fromkeys(("zeros", "ones", "full", "fill", "zero", "new_zeros",
                     "new_ones", "new_full", "zeros_like", "ones_like",
                     "full_like", "repeat", "scalar_tensor"), "broadcast"),
    "flip": "reverse",
    **dict.fromkeys(("slice_scatter", "select_scatter"),
                    "dynamic-update-slice"),
}

#: ops that move no data of their own (allocation without a write, host
#: reads, metadata)
_FREE = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "resize", "_local_scalar_dense", "set", "detach", "alias",
    "is_same_size", "_has_compatible_shallow_copy_type",
    "record_stream", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "_unsafe_view", "lift_fresh", "equal"))

#: families whose output elements count one FLOP each (``hlo.analyze``'s
#: elementwise and reduction ops)
ELEMENTWISE_FAMILIES = frozenset((
    "add", "multiply", "subtract", "divide", "maximum", "minimum",
    "exponential", "tanh", "logistic", "rsqrt", "sqrt", "power", "negate",
    "compare", "select", "convert", "and", "or", "xor", "log", "floor",
    "clamp", "abs", "sign", "cosine", "sine", "reduce", "fusion"))

#: families charged twice their result (a gather's indexed read) or twice
#: their values (a scatter's indexed write), as ``hlo.analyze`` does
_GATHERS = frozenset(("gather",))
_SCATTERS = frozenset(("scatter", "dynamic-update-slice"))


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def family_of(func, args) -> Optional[str]:
    """The HLO family of one aten op, or None for an op that moves
    nothing (a view, an allocation without a write, a host read)."""
    if func.namespace != "aten" or func.is_view:
        return None
    name = func.overloadpacket.__name__
    base = name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name
    if name in _FREE or base in _FREE:
        return None
    if base == "_to_copy":
        return "convert"            # a copy when the dtype is kept (op())
    return _FAMILIES.get(base, _FAMILIES.get(name, name))


class _Count:
    """The running sums of one :func:`count_work` block."""

    def __init__(self, watch=()):
        self.flops_by_op: Dict[str, float] = {}
        self.bytes_by_op: Dict[str, float] = {}
        self.wire = {k: 0.0 for k in COLLECTIVES}
        self.counts = {k: 0 for k in COLLECTIVES}
        self.welems: Dict[str, float] = {}
        self.kernels: Dict[str, int] = {}
        self.live = [0, 0]                      # bytes now, peak
        self.largest = 0                        # largest storage made
        self.watch = frozenset(tuple(w) for w in watch)
        self.watched = 0                        # tensors of a watched shape

    def _add(self, d: Dict[str, float], key: str, v: float) -> None:
        d[key] = d.get(key, 0.0) + v

    def op(self, func, args, kwargs, out) -> None:
        outs = list(_tensors(out))
        if not func.is_view and not func._schema.is_mutable:
            for t in outs:
                self._made(t)
                if tuple(t.shape) in self.watch:
                    self.watched += 1
        fam = family_of(func, args)
        if fam is None:
            return
        if fam == "convert" and outs and args and isinstance(
                args[0], torch.Tensor) and outs[0].dtype == args[0].dtype:
            fam = "copy"
        if fam in _GATHERS:
            b = 2.0 * sum(nbytes(t) for t in outs)
        elif fam in _SCATTERS:
            # the written values: the operands of the buffer's dtype
            vals = [t for t in _tensors((args[1:], kwargs))
                    if t.dtype == args[0].dtype] or list(_tensors(args[1:]))
            b = 2.0 * (max(nbytes(t) for t in vals) if vals else 0)
        elif func.overloadpacket.__name__ == "copy_":
            b = float(nbytes(args[0]) + nbytes(args[1]))
        else:
            b = float(sum(nbytes(t) for t in _tensors((args, kwargs)))
                      + sum(nbytes(t) for t in outs))
        self._add(self.bytes_by_op, fam, b)
        if fam in ELEMENTWISE_FAMILIES and outs:
            self._add(self.flops_by_op, fam, float(outs[0].numel()))

    def _made(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        n = s.nbytes()
        live = self.live
        live[0] += n
        live[1] = max(live[1], live[0])
        self.largest = max(self.largest, n)

        def gone(n=n, live=live):
            live[0] -= n
        weakref.finalize(s, gone)

    def collective(self, op: str, x: torch.Tensor, group_size: int) -> None:
        if group_size <= 1:
            return
        nb, ne = float(nbytes(x)), float(x.numel())
        ring = ring_factor(op, group_size)
        self.wire[op] += nb * ring
        self._add(self.welems, op, ne * ring)
        self.counts[op] += 1
        self._add(self.bytes_by_op, op, 2.0 * nb)

    def kernel(self, name: str, flops: float, nbytes_: float) -> None:
        self._add(self.flops_by_op, "dot", float(flops))
        self._add(self.bytes_by_op, "dot", float(nbytes_))
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def finish(self, cost: ModuleCost, matmul: Dict[str, float]) -> None:
        fby = dict(self.flops_by_op)
        for fam, f in matmul.items():
            self._add(fby, fam, f)
        cost.flops_by_op = fby
        cost.bytes_by_op = dict(self.bytes_by_op)
        cost.flops = sum(fby.values())
        cost.bytes = sum(self.bytes_by_op.values())
        cost.collective_wire = dict(self.wire)
        cost.collective_counts = dict(self.counts)
        cost.collective_wire_elements = dict(self.welems)
        cost.wire_bytes = sum(self.wire.values())
        cost.kernel_launches = dict(self.kernels)
        cost.peak_live_bytes = float(self.live[1])
        cost.largest_alloc_bytes = float(self.largest)
        cost.watched_made = self.watched


#: the running count, or None (every hook's one check)
ACTIVE: Optional[_Count] = None


def report_collective(op: str, x: torch.Tensor, group_size: int) -> None:
    """One collective of ``x`` over ``group_size`` ranks into the active
    count (nothing without one)."""
    if ACTIVE is not None:
        ACTIVE.collective(op, x, group_size)


class KernelCost(NamedTuple):
    """One kernel launch's work, from its cost function: FLOPs (2 per
    multiply-add of its products) and bytes (each input read once, each
    output written once)."""
    flops: float
    bytes: float


def report_kernel(name: str, cost: KernelCost) -> None:
    """One hand-written kernel launch's work into the active count, under
    the matmul family ``dot`` (every kernel of the port is a product)."""
    if ACTIVE is not None:
        ACTIVE.kernel(name, cost.flops, cost.bytes)


def _dispatch_mode(count: _Count):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _WorkMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            count.op(func, args, kwargs, out)
            return out
    return _WorkMode()


#: ``FlopCounterMode``'s ops -> the HLO family they are filed under
_MATMUL_FAMILY = {"convolution": "convolution",
                  "_convolution": "convolution",
                  "convolution_backward": "convolution"}


@contextlib.contextmanager
def count_work(watch=()) -> Iterator[ModuleCost]:
    """Count the work run inside the block; yields the
    :class:`ModuleCost`, filled when the block exits.  ``watch`` is a
    collection of shapes: the tensors the block makes of one of them are
    counted (``ModuleCost.watched_made``)."""
    global ACTIVE
    from torch.utils.flop_counter import FlopCounterMode
    if ACTIVE is not None:
        raise RuntimeError("count_work blocks do not nest")
    count = _Count(watch)
    cost = ModuleCost()
    flops = FlopCounterMode(display=False)
    ACTIVE = count
    try:
        with flops, _dispatch_mode(count):
            yield cost
    finally:
        ACTIVE = None
        matmul: Dict[str, float] = {}
        for op, n in flops.get_flop_counts().get("Global", {}).items():
            fam = _MATMUL_FAMILY.get(getattr(op, "__name__", str(op)),
                                     "dot")
            matmul[fam] = matmul.get(fam, 0.0) + float(n)
        count.finish(cost, matmul)


__all__ = ["ACTIVE", "COLLECTIVES", "ELEMENTWISE_FAMILIES", "KernelCost",
           "ModuleCost",
           "count_work", "family_of", "nbytes", "report_collective",
           "report_kernel", "ring_factor"]
