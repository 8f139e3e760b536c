"""Engine hygiene: the KV pool updated in place, and nothing rebuilt per
request length (the PyTorch counterpart of the JAX package's
``analysis/hygiene.py``).

Two failure modes silently wreck serving throughput without changing a
single output token:

* **A copied pool** — the reference donates its KV state into every
  jitted step and checks that XLA aliases the pool buffers to the
  outputs.  The port writes the pool in place; a refactor that rebuilds
  it (an out-of-place update, a dtype round trip) would copy the whole
  pool every step.  :func:`audit_donation` reads the pricing pass's
  executed step: the K and V pools must keep their storage, and the step
  must make no tensor of a pool buffer's shape, nor of one layer's (a
  copy made by an out-of-place update).  The step's largest tensor and,
  on the card, its ``max_memory_allocated`` rise are reported beside the
  pool's bytes; neither gates, since at the audit's small pool a
  full-width step's own activations (and the LoRA target's gathered
  factors) outweigh a pool buffer.
* **Rebuild churn** — the reference's compiled entry points must compile
  once over a mixed-length run.  The port's counterpart of a compiled
  entry is a kernel library built with ``nvcc`` and loaded with
  ``ctypes`` (``kernels/build.py``, each ``ops.load_library``):
  :func:`audit_retrace` scripts the reference's mixed-length engine run
  and checks that each library is loaded at most once and that ``nvcc``
  never runs after the first engine step.  On the CPU nothing is
  compiled, and the pass says so with an info finding of its own.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ArchConfig

from .findings import Finding, Severity
from .pricing import SEED, CompiledTarget


# ---------------------------------------------------------------------------
# the pool updated in place (reads the pricing pass's executed step)
# ---------------------------------------------------------------------------

def audit_donation(ct: CompiledTarget) -> List[Finding]:
    """The KV pool buffers of one executed engine step must be updated in
    place: both keep their storage, and the step makes no tensor of a
    pool buffer's shape ``(n_layers, n_blocks, block_size, n_kv_heads,
    head_dim)`` (this rank's, on a mesh) or of one layer's."""
    t, pool = ct.target, ct.pool
    detail = {"target": t.name, "pool_shape": list(pool.pool_shape),
              "pool_bytes": pool.pool_bytes,
              "pool_copies": pool.pool_copies,
              "largest_alloc_bytes": pool.largest_alloc_bytes,
              "memory_rise_bytes": pool.rise_bytes}
    if not pool.kept_storage:
        return [Finding(
            "hygiene", "hygiene.no_aliasing", Severity.ERROR,
            f"[{t.name}] the step replaced the KV pool's storage — the "
            f"pool is rebuilt every engine step", detail)]
    if pool.pool_copies:
        return [Finding(
            "hygiene", "hygiene.kv_pool_not_donated", Severity.ERROR,
            f"[{t.name}] the step made {pool.pool_copies} tensor(s) of a "
            f"KV pool buffer's shape {tuple(pool.pool_shape)} or of one "
            f"layer's — a pool copied per step", detail)]
    rise = ("" if pool.rise_bytes is None else
            f"; memory rise {pool.rise_bytes} B")
    return [Finding(
        "hygiene", "hygiene.donation_ok", Severity.INFO,
        f"[{t.name}] KV pool updated in place: both buffers kept their "
        f"storage and no tensor of a pool's shape was made (pool buffer "
        f"{pool.pool_bytes} B, largest tensor made "
        f"{pool.largest_alloc_bytes:.4g} B{rise})", detail)]


# ---------------------------------------------------------------------------
# rebuild detector (the audit's engine run)
# ---------------------------------------------------------------------------

def audit_retrace(cfg: ArchConfig, attn_impl: str = "gather", *,
                  device="cuda") -> List[Finding]:
    """Run the reference's tiny mixed-length serving workload and assert
    that each kernel library was built and loaded once, before the first
    engine step ended.

    Prompts of three lengths (spanning chunk boundaries) and three
    generation budgets feed every shape the scheduler hands the steps; a
    library rebuilt or reloaded for a length would show as a second load
    or an ``nvcc`` run after the first step.  This pass executes real
    (the caller's config) compute."""
    from repro_torch import resolve_device
    from repro_torch.engine.scheduler import Engine, EngineConfig, Request
    from repro_torch.kernels import build
    from repro_torch.models import init_params

    dev = resolve_device(device)
    ec = EngineConfig(max_slots=2, max_len=64, chunk_size=16,
                      decode_block=4, block_size=16, attn_impl=attn_impl)
    eng = Engine(cfg, init_params(cfg, SEED, device=dev), ec, device=dev)
    # mixed lengths: short, chunk-straddling, long; mixed budgets
    for rid, (plen, new) in enumerate([(5, 3), (17, 6), (33, 4)]):
        eng.submit(Request(rid=rid, prompt=list(range(1, plen + 1)),
                           max_new=new))
    before = dict(build.NVCC_RUNS)
    steps, after_first = 0, None
    while not eng.done and steps < 200:
        eng.step()
        steps += 1
        if after_first is None:
            after_first = dict(build.NVCC_RUNS)
    out: List[Finding] = []
    if not eng.done:
        out.append(Finding(
            "hygiene", "hygiene.engine_stalled", Severity.ERROR,
            f"retrace-audit engine run did not drain in {steps} steps",
            {"steps": steps, "attn_impl": attn_impl}))
        return out
    loads = dict(build.LOADS)
    runs = dict(build.NVCC_RUNS)
    if not loads:
        out.append(Finding(
            "hygiene", "hygiene.nothing_compiled", Severity.INFO,
            f"the {attn_impl} engine run on {dev.type} loaded no kernel "
            f"library: nothing is compiled, so nothing can be rebuilt",
            {"attn_impl": attn_impl, "device": dev.type, "steps": steps}))
        return out
    for name in sorted(loads):
        late = runs.get(name, 0) - (after_first or {}).get(name, 0)
        detail = {"library": name, "loads": loads[name],
                  "nvcc_runs": runs.get(name, 0),
                  "nvcc_runs_before_run": before.get(name, 0),
                  "nvcc_runs_after_first_step": late,
                  "attn_impl": attn_impl, "budget": 1}
        if loads[name] > 1 or late > 0:
            out.append(Finding(
                "hygiene", "hygiene.retrace", Severity.ERROR,
                f"kernel library {name} was loaded {loads[name]} times and "
                f"built {late} times after the first engine step over a "
                f"mixed-length run (expected once, before it)", detail))
        else:
            out.append(Finding(
                "hygiene", "hygiene.retrace_ok", Severity.INFO,
                f"kernel library {name} loaded once across mixed lengths",
                detail))
    return out
