"""The port's audit (``repro_torch.analysis``, ``core.counts``) against the
JAX package's (``repro.analysis``) on the same reduced configs.

* lint: finding codes and severities equal, one arch per family;
* pricing: ``python -m repro_torch audit --device cpu`` and ``python -m
  repro audit`` on reduced qwen2-7b (both CLIs run once, side by side):
  the counted dot FLOPs of the gather targets equal the reference's HLO
  dot FLOPs within 1 %; every target's finding codes and severities are
  equal, ``decode/gather/tp2pp1``'s among them (its ranks cut the
  vocabulary as the reference's do), except one pinned difference
  (ROADMAP.md queue 3): ``decode/gather/tp2pp2``'s wire check passes on
  the port where the reference's GSPMD stage resharding fails it (info
  at pp > 1 on both);
* the mutation gate, a seeded pool copy, the kernels' cost functions
  against ``FlopCounterMode`` on their plain versions, the count's
  collective hooks.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as tconfigs
from repro_torch.analysis import (PricingTarget, Severity, audit_donation,
                                  lower_target, reconcile)
from repro_torch.core import collectives, counts

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _codes(findings):
    return [(f["code"], f["severity"]) for f in findings]


def _by_target(report):
    out = {}
    for f in report["findings"]:
        t = f["details"].get("target")
        if t is not None:
            out.setdefault(t, []).append(f)
    return out


# ---------------------------------------------------------------------------
# lint: the same findings as the reference, family by family
# ---------------------------------------------------------------------------

def _lint_pass(configs, analysis, core, arch_name):
    """The audit's pass 1 (``run_audit``'s lint), on one reduced arch."""
    arch = configs.reduced(configs.get(arch_name))
    geom = analysis.AuditGeometry()
    wm = core.WorkloadModel(arch, configs.Variant())
    db = wm.prefill(1, geom.chunk_size)
    wm.decode_step(2, geom.l_virt - 1, db=db)
    out = analysis.lint_model(wm, db, phase=None)
    pp = min(2, len(arch.block_kinds()))
    wm_pp = core.WorkloadModel(arch, configs.Variant(),
                               plan=core.ShardingPlan(pp=pp))
    out += analysis.lint_stage_conservation(
        wm_pp, wm_pp.decode_step(2, geom.l_virt - 1), "decode")
    for tp in (2, 3):
        out += analysis.lint_plan(core.WorkloadModel(
            arch, configs.Variant(), plan=core.ShardingPlan(tp=tp)))
    return [(f.code, str(f.severity), f.message) for f in out]


@pytest.mark.parametrize("arch", [
    "qwen2-7b", "qwen2-moe-a2.7b", "recurrentgemma-2b", "falcon-mamba-7b",
    "whisper-base", "internvl2-26b", "llama2-7b-mla"])
def test_lint_findings_equal_reference(arch):
    from repro import analysis as ra, configs as rc, core as rcore
    from repro_torch import analysis as ta, core as tcore
    assert _lint_pass(tconfigs, ta, tcore, arch) == \
        _lint_pass(rc, ra, rcore, arch)


def test_lint_records_flags_the_same_bad_records():
    """A record outside the vocabulary, a negative field, KV above memory
    and misplaced wire: the same findings on both sides."""
    from repro.analysis import lint_records as ref_lint
    from repro.core.stats import OpRecord as RefRecord
    from repro_torch.analysis import lint_records
    from repro_torch.core.stats import OpRecord
    at = dict(scope="layer0/attn", phase="decode")
    rows = [dict(op="x", op_class="bogus", ops=1.0, **at),
            dict(op="y", op_class="gemm", ops=-1.0, **at),
            dict(op="z", op_class="kv", mem_rd=1.0, kv_rd=2.0, **at),
            dict(op="w", op_class="gemm", wire_bytes=3.0, **at)]
    mine = lint_records([OpRecord(**r) for r in rows])
    ref = ref_lint([RefRecord(**r) for r in rows])
    assert [(f.code, str(f.severity), f.message) for f in mine] == \
        [(f.code, str(f.severity), f.message) for f in ref]
    assert len(mine) == 4


# ---------------------------------------------------------------------------
# pricing and hygiene: the two CLIs, side by side
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_reports():
    """``audit --json --verbose`` of both packages on reduced qwen2-7b
    (the port on the CPU, its sharded targets on gloo ranks; the
    reference with four host devices), run at the same time."""
    runs = {
        "port": [sys.executable, "-m", "repro_torch", "audit", "--device",
                 "cpu", "--json", "--verbose"],
        "ref": [sys.executable, "-m", "repro", "audit", "--json",
                "--verbose"]}
    procs = {k: subprocess.Popen(cmd, env=_env(), cwd=ROOT,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, cmd in runs.items()}
    out = {}
    for k, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert stdout.strip(), stderr
        out[k] = (p.returncode, json.loads(stdout))
    return out


GATHER_TARGETS = ["prefill/gather", "decode/gather", "verify/gather",
                  "decode/gather/lora64"]
SINGLE_TARGETS = GATHER_TARGETS + ["prefill/paged", "decode/paged",
                                   "verify/paged"]


def test_cli_runs_every_reference_target(cli_reports):
    _, port = cli_reports["port"]
    _, ref = cli_reports["ref"]
    assert port["meta"]["targets"] == ref["meta"]["targets"]
    assert len(port["meta"]["targets"]) == 9


@pytest.mark.parametrize("target", GATHER_TARGETS)
def test_gather_dot_flops_equal_reference(cli_reports, target):
    """Tolerance: 1 % (both count 2·m·k·n of the same products; the
    gather impl runs plain matmuls on both sides)."""
    port = [f for f in _by_target(cli_reports["port"][1])[target]
            if f["code"] == "pricing.matmul_ok"][0]["details"]
    ref = [f for f in _by_target(cli_reports["ref"][1])[target]
           if f["code"] == "pricing.matmul_ok"][0]["details"]
    assert port["counted_dot_flops"] == pytest.approx(
        ref["hlo_dot_flops"], rel=0.01)


@pytest.mark.parametrize("target", SINGLE_TARGETS)
def test_single_device_findings_equal_reference(cli_reports, target):
    port = _by_target(cli_reports["port"][1])[target]
    ref = _by_target(cli_reports["ref"][1])[target]
    assert _codes(port) == _codes(ref)
    assert ("hygiene.donation_ok", "info") in _codes(port)


def test_tp2_findings_equal_reference(cli_reports):
    """The port's tp ranks cut ``embed`` and ``lm_head`` over the
    vocabulary as the reference's spec does (the lookup a masked one
    plus the plan's one all-reduce, the head the rank's block of the
    logits), so at tp = 2 its findings are the reference's and its
    matmul ratio is inside the 15 % tolerance."""
    port = _by_target(cli_reports["port"][1])["decode/gather/tp2pp1"]
    ref = _by_target(cli_reports["ref"][1])["decode/gather/tp2pp1"]
    assert _codes(port) == _codes(ref) == [
        ("pricing.matmul_ok", "info"), ("pricing.wire_ok", "info"),
        ("hygiene.donation_ok", "info")]
    detail = [f for f in port if f["code"] == "pricing.matmul_ok"][0][
        "details"]
    assert abs(detail["ratio"] - 1.0) <= 0.15


def test_tp2_collective_counts_equal_reference(cli_reports):
    """At tp = 2 the port's step makes the collectives the reference's
    compiled step does, op by op: the row-parallel sums and the
    vocab-cut lookup's as all-reduces, and greedy sampling's two
    all-gathers (each rank's max in f32 and its index in int32, where
    GSPMD gathers ``argmax``'s f32 values and s32 indices)."""
    wire = lambda r, key: [f for f in _by_target(cli_reports[r][1])[
        "decode/gather/tp2pp1"] if f["code"] == "pricing.wire_ok"][0][
        "details"][key]
    port, ref = wire("port", "counted_counts"), wire("ref", "hlo_counts")
    assert port == ref
    assert port["all-gather"] == 2 and port["reduce-scatter"] == 0


def test_pinned_pp2_stage_wire_difference(cli_reports):
    """ROADMAP queue 3 (by design): at pp = 2 the port moves only the
    carried activation and the sampled tokens between stages, inside the
    wire tolerance of the plan's records, where the reference's GSPMD
    resharding moves ~170x them; the reference's finding is info at
    pp > 1, so both audits pass this target."""
    port = _codes(_by_target(cli_reports["port"][1])["decode/gather/tp2pp2"])
    ref = _codes(_by_target(cli_reports["ref"][1])["decode/gather/tp2pp2"])
    assert ref == [("pricing.matmul_ok", "info"),
                   ("pricing.wire_mismatch", "info"),
                   ("hygiene.donation_ok", "info")]
    assert port == [("pricing.matmul_ok", "info"), ("pricing.wire_ok", "info"),
                    ("hygiene.donation_ok", "info")]


def test_hygiene_and_lint_findings_of_the_clis(cli_reports):
    """Everything outside the targets: lint equal; the rebuild pass says
    on the CPU that nothing is compiled (info), where the reference's
    jit entries compile once each (info, both)."""
    def untargeted(report):
        return [(f["code"], f["severity"]) for f in report["findings"]
                if "target" not in f["details"]]
    port, ref = (untargeted(cli_reports[k][1]) for k in ("port", "ref"))
    assert [c for c in port if c[0].startswith("lint.")] == \
        [c for c in ref if c[0].startswith("lint.")]
    assert [c for c in port if c[0].startswith("hygiene.")] == \
        [("hygiene.nothing_compiled", "info")]
    assert [c for c in ref if c[0].startswith("hygiene.")] == \
        [("hygiene.retrace_ok", "info")] * 2
    # the exit codes: both audits pass, with no error finding
    assert cli_reports["ref"][0] == 0
    assert cli_reports["port"][0] == 0
    errors = [f["details"].get("target") for f in
              cli_reports["port"][1]["findings"] if f["severity"] == "error"]
    assert errors == []


# ---------------------------------------------------------------------------
# the mutation gate and the pool check, in-process
# ---------------------------------------------------------------------------

ARCH = tconfigs.reduced(tconfigs.get("qwen2-7b"))


@pytest.fixture(scope="module")
def decode_target():
    return lower_target(ARCH, PricingTarget("decode", "gather"),
                        device="cpu")


@pytest.mark.parametrize("factor,fails", [(1.5, True), (1.05, False)])
def test_mutation_gate_equals_reference(decode_target, factor, fails):
    """``gemm=1.5`` must break the matmul check and ``gemm=1.05`` must not
    (the reference's ``tests/test_analysis_pricing.py``), on both."""
    from repro import configs as rc
    from repro.analysis import (PricingTarget as RefTarget,
                                lower_target as ref_lower,
                                reconcile as ref_reconcile)
    mine = reconcile(decode_target, perturb={"gemm": factor})
    ref = ref_reconcile(ref_lower(rc.reduced(rc.get("qwen2-7b")),
                                  RefTarget("decode", "gather")),
                        perturb={"gemm": factor})
    assert [(f.code, f.severity) for f in mine] == \
        [(f.code, f.severity) for f in ref]
    bad = [f for f in mine if f.code == "pricing.matmul_mismatch"]
    assert bool(bad) == fails
    if fails:
        assert bad[0].severity == Severity.ERROR and "gemm" in \
            bad[0].message


def test_cli_perturbed_audit_exits_nonzero():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch", "audit", "--device", "cpu",
         "--perturb", "gemm=1.5", "--no-multidevice", "--skip-engine"],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1, out.stderr
    assert "pricing.matmul_mismatch" in out.stdout


def test_audit_cli_help_and_device_rule():
    out = subprocess.run([sys.executable, "-m", "repro_torch", "audit",
                          "--help"], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    assert "--strict" in out.stdout and "--perturb" in out.stdout
    assert "--device" in out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch", "audit", "--skip-engine"],
            env=_env(), cwd=ROOT, capture_output=True, text=True,
            timeout=120)
        assert out.returncode != 0
        assert "torch.cuda.is_available() is False" in out.stderr


@pytest.mark.parametrize("fault,code", [
    ("copy", "hygiene.kv_pool_not_donated"),
    ("replace", "hygiene.no_aliasing")])
def test_seeded_pool_copy_is_flagged(monkeypatch, fault, code):
    """A step that copies a layer's pool out of place (``copy``), or
    swaps the state's pool for a new one (``replace``), fails the
    in-place check."""
    from repro_torch.engine import decode_loop
    write = decode_loop._write_kv

    def copying(cache, dst, new):
        if fault == "copy":
            cache = cache.clone()          # the pool copied per step
        write(cache, dst, new)
    monkeypatch.setattr(decode_loop, "_write_kv", copying)
    if fault == "replace":
        make = decode_loop.make_engine_fns

        def replacing(*a, **k):
            prefill, decode = make(*a, **k)

            def decode_fresh(params, state, *rest):
                state["cache_k"] = state["cache_k"].clone()
                return decode(params, state, *rest)
            return prefill, decode_fresh
        monkeypatch.setattr(decode_loop, "make_engine_fns", replacing)
    ct = lower_target(ARCH, PricingTarget("decode", "gather"), device="cpu")
    assert [f.code for f in audit_donation(ct)] == [code]


def test_clean_pool_is_updated_in_place(decode_target):
    findings = audit_donation(decode_target)
    assert [f.code for f in findings] == ["hygiene.donation_ok"]
    assert decode_target.pool.pool_copies == 0


# ---------------------------------------------------------------------------
# the kernels' cost functions and the count's hooks
# ---------------------------------------------------------------------------

def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _kernel_cases(small: bool):
    """(name, plain-version call, cost) of K1-K6 at one shape."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.grouped_lora import ops as gl
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.quant_matmul import ops as qm
    g = torch.Generator().manual_seed(0 if small else 1)
    r = lambda *s: torch.randn(*s, generator=g)
    S, Hk, G, d, N, bs, nb = (2, 2, 2, 16, 8, 4, 3) if small else \
        (3, 4, 7, 32, 16, 16, 4)
    ck, cv = r(N, bs, Hk, d), r(N, bs, Hk, d)
    bt = torch.randint(0, N, (S, nb), generator=g, dtype=torch.int32)
    pos = torch.full((S,), nb * bs - 2, dtype=torch.int32)
    q1, qv, qp = r(S, Hk, G, d), r(S, 3, Hk, G, d), r(5, Hk, G, d)
    x, A, B = r(S, 4, 24), r(5, 24, 8), r(5, 8, 40)
    idx = torch.tensor([0, -1, 2][:S], dtype=torch.int32)
    b, s, H, Hkf = (1, 6, 4, 2) if small else (2, 9, 6, 3)
    qf = r(b, s, H, d).requires_grad_()
    kf, vf = r(b, s, Hkf, d).requires_grad_(), r(b, s, Hkf, d).requires_grad_()
    wq, sc, z = qm.quantize_ref(r(256, 48), 128)
    xm = r(4 if small else 9, 256)
    fwd = {}

    def flash_forward():
        fwd["o"] = fa.flash_attention(qf, kf, vf)
    return [
        ("paged_decode", lambda: pa.paged_decode(q1, ck, cv, bt, pos),
         pa.paged_decode_cost(q1, ck, bt)),
        ("paged_prefill", lambda: pa.paged_prefill(qp, ck, cv, bt[0], 3, 4),
         pa.paged_prefill_cost(qp, ck, bt[0])),
        ("paged_verify", lambda: pa.paged_verify(qv, ck, cv, bt, pos - 2),
         pa.paged_verify_cost(qv, ck, bt)),
        ("grouped_lora", lambda: gl.grouped_lora(x, A, B, idx),
         gl.grouped_lora_cost(x, [(A, B)])),
        ("grouped_lora_qkv",
         lambda: gl.grouped_lora_qkv(x, (A, B), (A, B), (A, B), idx),
         gl.grouped_lora_cost(x, [(A, B)] * 3)),
        ("quant_matmul", lambda: qm.quant_matmul(xm, wq, sc, z),
         qm.quant_matmul_cost(xm, wq, sc)),
        ("flash_fwd", flash_forward, fa.flash_fwd_cost(qf, kf, vf)),
        ("flash_bwd", lambda: fwd["o"].float().sum().backward(),
         fa.flash_bwd_cost(qf, kf, vf)),
    ]


@pytest.mark.parametrize("small", [True, False])
def test_kernel_costs_equal_flop_counter_of_plain_versions(small):
    """K1-K6's cost functions (what each wrapper reports on the card)
    equal ``FlopCounterMode``'s count of the plain version the wrapper
    runs on the CPU, exactly, at two shapes each."""
    for name, run, cost in _kernel_cases(small):
        assert _flops(run) == cost.flops, name
        assert cost.bytes > 0, name


#: one call of each collective helper on bf16[4, 8] over a counted group,
#: and the HLO line the reference's compiled step carries for it
_HELPER_CASES = {
    "all_reduce": (lambda x, G: collectives.all_reduce(x, G(4)),
                   "bf16[4,8]{1,0} all-reduce(%a), replica_groups=[1,4]<=[4],"
                   " to_apply=%add"),
    "broadcast": (lambda x, G: collectives.broadcast(x, 0, G(2)),
                  "bf16[4,8]{1,0} collective-permute(%a), "
                  "source_target_pairs={{0,1}}"),
    "all_gather": (lambda x, G: collectives.all_gather(x, 1, G(4)),
                   "bf16[4,32]{1,0} all-gather(%a), replica_groups=[1,4]<=[4],"
                   " dimensions={1}"),
    "reduce_scatter": (lambda x, G: collectives.reduce_scatter(x, 1, G(4)),
                       "bf16[4,2]{1,0} reduce-scatter(%a), "
                       "replica_groups=[1,4]<=[4], dimensions={1}, "
                       "to_apply=%add"),
}


@pytest.mark.parametrize("helper", list(_HELPER_CASES))
def test_counted_collectives_follow_the_ring_convention(helper):
    """Each collective helper reports to an active count (a CountedGroup
    moves nothing) the op, count, wire bytes and wire elements that the
    reference's ``hlo.analyze`` gives its HLO line (the ring convention;
    a group of one rank adds nothing); with no count active, nothing is
    recorded."""
    from repro.core import hlo
    from repro_torch.core.collectives import CountedGroup
    call, line = _HELPER_CASES[helper]
    x = torch.zeros(4, 8, dtype=torch.bfloat16)
    with counts.count_work() as mc:
        out = call(x, CountedGroup)
        call(x, lambda g: CountedGroup(1))        # one rank: no wire
    ref = hlo.analyze("HloModule m\n\nENTRY %main (a: bf16[4,8]) -> "
                      "bf16[4,8] {\n  %a = bf16[4,8]{1,0} parameter(0)\n"
                      f"  ROOT %c = {line}\n}}\n", 4)
    assert tuple(out.shape) == tuple(int(n) for n in
                                     line.split("[")[1].split("]")[0]
                                     .split(","))
    assert mc.collective_counts == ref.collective_counts
    assert mc.collective_wire == ref.collective_wire
    assert mc.collective_wire_elements == ref.collective_wire_elements
    assert sum(mc.collective_counts.values()) == 1
    assert counts.ACTIVE is None
    counts.report_collective("all-reduce", x, 4)   # no count: nothing
    assert counts.ACTIVE is None


def test_counted_families_and_bytes():
    """Matmuls under ``dot``, an indexed read twice its result, an
    indexed write twice its values, a view nothing."""
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    pool = torch.zeros(10, 4)
    with counts.count_work() as mc:
        c = a @ b
        pool[torch.tensor([1, 3])] = c[:2]
        _ = pool[torch.tensor([0, 2, 4])]
        _ = c.t()
    assert mc.dot_flops == 2 * 8 * 16 * 4
    assert mc.bytes_by_op["scatter"] == 2 * 2 * 4 * 4
    assert mc.bytes_by_op["gather"] == 2 * 3 * 4 * 4
    assert "transpose" not in mc.bytes_by_op
