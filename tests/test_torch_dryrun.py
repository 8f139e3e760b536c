"""The port's dry-run (``repro_torch.launch.{specs,dryrun}``, the meta
device, the ``"dots"`` remat policies) against the JAX package's.

* ``input_specs`` equals the reference's shapes and dtypes for all 40
  (arch × shape) cells;
* a cell's count on the meta device equals, exactly, the count of the
  same step executed on CPU tensors (reduced configs, a 1×1 mesh);
* the production meshes' rank view: counted collectives, no device;
* ``"dots"`` and ``"dots_no_batch"`` give ``"full"``'s gradients;
* ``python -m repro_torch.launch.dryrun --arch granite-3-2b --shape
  decode_32k`` writes the reference's record fields.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.core import counts
from repro_torch.launch import specs
from repro_torch.core.collectives import CountedGroup
from repro_torch.launch.mesh import Mesh, make_production_mesh

ROOT = Path(__file__).resolve().parents[1]

CELLS = [(a, s) for a in configs.ASSIGNED for s in configs.SHAPES]


def test_assigned_and_shapes_equal_reference():
    from repro import configs as rc
    assert configs.ASSIGNED == rc.ASSIGNED
    assert configs.SHAPES == rc.SHAPES


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference(arch, shape):
    from repro.launch import specs as ref_specs
    mine = specs.input_specs(arch, shape)
    ref = ref_specs.input_specs(arch, shape)
    assert sorted(mine) == sorted(ref)
    for k, v in ref.items():
        assert tuple(mine[k].shape) == tuple(v.shape), k
        assert str(mine[k].dtype).replace("torch.", "") == str(v.dtype), k
        assert mine[k].device.type == "meta"
    assert specs.cell_is_skipped(arch, shape) == \
        ref_specs.cell_is_skipped(arch, shape)


def _one_rank_mesh():
    return Mesh({"data": 1, "model": 1}, {"data": 0, "model": 0}, 0,
                torch.device("meta"),
                groups={"data": CountedGroup(1), "model": CountedGroup(1),
                        "pipe": None})


def _materialize(tree, gen):
    """CPU tensors of the meta tree's shapes and dtypes (small values)."""
    if isinstance(tree, dict):
        return {k: _materialize(v, gen) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_materialize(v, gen) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialize(v, gen) for v in tree)
    if isinstance(tree, torch.Tensor):
        if tree.dtype.is_floating_point:
            return (0.02 * torch.randn(tree.shape, generator=gen)).to(
                tree.dtype)
        return torch.randint(0, 7, tree.shape, generator=gen).to(tree.dtype)
    return tree


@pytest.mark.parametrize("arch,shape", [
    ("granite-3-2b", "tiny_decode"), ("granite-3-2b", "tiny_prefill"),
    ("granite-3-2b", "tiny_train"), ("qwen2-moe-a2.7b", "tiny_prefill")])
def test_meta_count_equals_cpu_count(monkeypatch, arch, shape):
    """Rank 0's step counted on the meta device and the same step on CPU
    tensors count the same work, op family by op family, exactly.

    One known difference, torch's own: ``F.one_hot`` (the MoE router's
    dispatch masks) runs a range check (``aminmax``), ``zeros`` and
    ``scatter_`` on the CPU, and ``arange``, ``eq`` and ``_to_copy`` on
    the meta device; so an MoE cell's counts of those families differ,
    and its matmuls and every other family are equal."""
    monkeypatch.setitem(configs.SHAPES, "tiny_decode", (64, 2, "decode"))
    monkeypatch.setitem(configs.SHAPES, "tiny_prefill", (16, 2, "prefill"))
    monkeypatch.setitem(configs.SHAPES, "tiny_train", (16, 4, "train"))
    cfg = configs.reduced(configs.get(arch))
    mesh = _one_rank_mesh()
    out = []
    for device in ("meta", "cpu"):
        cell = specs.build_cell(arch, shape, mesh, cfg=cfg)
        args = cell.args if device == "meta" else _materialize(
            cell.args, torch.Generator().manual_seed(0))
        with counts.count_work() as mc:
            cell.fn(*args)
        out.append(mc)
    meta, cpu = out
    assert meta.dot_flops > 0
    one_hot = ({"reduce", "broadcast", "scatter", "iota", "compare",
                "convert"} if cfg.family == "moe" else set())
    for fam in set(meta.flops_by_op) | set(cpu.flops_by_op):
        if fam not in one_hot:
            assert meta.flops_by_op.get(fam) == cpu.flops_by_op.get(fam), fam
    for fam in set(meta.bytes_by_op) | set(cpu.bytes_by_op):
        if fam not in one_hot:
            assert meta.bytes_by_op.get(fam) == cpu.bytes_by_op.get(fam), fam
    if one_hot:
        assert meta.flops_by_op["compare"] > cpu.flops_by_op.get(
            "compare", 0.0)
    assert meta.collective_wire == cpu.collective_wire


def test_production_meshes_are_counted_views():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.shape == {"data": 16, "model": 16} and one.size == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert two.groups["data"] == CountedGroup(32)
    assert one.device.type == "meta"
    assert all(isinstance(g, CountedGroup) for a, g in one.groups.items()
               if a != "pipe")


def test_decode_cell_on_the_pod_counts_its_collectives():
    """granite-3-2b's decode on 16×16: every layer's two row-parallel
    sums over the 16 tp ranks; no tensor leaves the meta device."""
    mesh = make_production_mesh()
    cell = specs.build_cell("granite-3-2b", "decode_32k", mesh)
    leaves = [t for t in cell.args[1].values() if isinstance(t, torch.Tensor)]
    assert all(t.device.type == "meta" for t in leaves)
    with counts.count_work() as mc:
        logits, _ = cell.fn(*cell.args)
    assert logits.device.type == "meta"
    assert mc.collective_counts["all-reduce"] == 2 * 40
    assert mc.wire_bytes > 0


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_remat_policies_give_full_gradients(policy):
    """Tolerance: 1e-6 absolute in f32 (the same products, saved or
    recomputed)."""
    from repro_torch.models import forward, init_params
    cfg = configs.reduced(configs.get("granite-3-2b"))
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0))

    def grads(pol):
        leaves = []

        def req(t):
            if isinstance(t, dict):
                return {k: req(v) for k, v in t.items()}
            t = t.detach().clone().requires_grad_()
            leaves.append(t)
            return t
        logits, _ = forward(cfg, req(params), tok, remat=True,
                            remat_policy=pol)
        logits.square().mean().backward()
        return [t.grad for t in leaves]
    for a, b in zip(grads("full"), grads(policy)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_dryrun_cli_writes_the_reference_fields(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-3-2b", "--shape", "decode_32k", "--out", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads((tmp_path / "pod16x16" /
                      "granite-3-2b__decode_32k.json").read_text())
    assert rec["status"] == "OK"
    for k in ("life_forecast", "per_chip", "memory_analysis", "roofline",
              "model_flops", "model_flops_per_chip", "useful_flops_ratio",
              "tokens", "lower_s", "compile_s"):
        assert k in rec, k
    for k in ("flops", "bytes", "collective_wire_bytes",
              "collective_wire_by_op", "collective_counts",
              "unknown_trip_loops", "xla_cost_analysis_flops_unfolded",
              "xla_cost_analysis_bytes_unfolded"):
        assert k in rec["per_chip"], k
    assert rec["roofline"]["dominant"] == "memory"
    assert rec["roofline"]["hardware"] == "nvidia-h100"
    assert rec["per_chip"]["collective_wire_bytes"] > 0
    assert rec["per_chip"]["unknown_trip_loops"] is None
    assert "unknown_trip_loops" in " ".join(rec["null_reasons"])
    assert 0 < rec["useful_flops_ratio"] <= 1
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
