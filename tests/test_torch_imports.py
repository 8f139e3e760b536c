"""The port stands alone: it (and its examples and tools) imports
neither JAX nor the JAX package, its entry points refuse to fall back to
the CPU, and its launcher runs."""
import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro[ .])",
                       re.M)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_port_modules_cover_the_slice():
    names = set(_port_modules())
    for mod in ("repro_torch.bridge", "repro_torch.configs.base",
                "repro_torch.models.layers", "repro_torch.models.attention",
                "repro_torch.models.blocks", "repro_torch.models.model",
                "repro_torch.engine.sampling", "repro_torch.engine.block_pool",
                "repro_torch.engine.kv_cache", "repro_torch.engine.decode_loop",
                "repro_torch.engine.scheduler",
                "repro_torch.engine.drafter",
                "repro_torch.engine.adapter_pool",
                "repro_torch.kernels.build",
                "repro_torch.kernels.paged_attention.ref",
                "repro_torch.kernels.paged_attention.ops",
                "repro_torch.kernels.grouped_lora.ref",
                "repro_torch.kernels.grouped_lora.ops",
                "repro_torch.kernels.flash_attention.ref",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.optim.adamw", "repro_torch.data.pipeline",
                "repro_torch.checkpoint.manager", "repro_torch.runtime.train",
                "repro_torch.runtime.serve",
                "repro_torch.launch.serve", "repro_torch.launch.train",
                "repro_torch.kernels.quant_matmul.ref",
                "repro_torch.kernels.quant_matmul.ops",
                "repro_torch.quant.weights", "repro_torch.lora.adapters",
                "repro_torch.core.dtypes", "repro_torch.core.stats",
                "repro_torch.core.operators", "repro_torch.core.derived",
                "repro_torch.core.workload", "repro_torch.core.forecast",
                "repro_torch.core.hardware", "repro_torch.core.distributed",
                "repro_torch.traffic.arrivals", "repro_torch.traffic.feed",
                "repro_torch.traffic.simulate", "repro_torch.traffic.slo",
                "repro_torch.engine.forecast_twin",
                "repro_torch.api.scenario", "repro_torch.api.report",
                "repro_torch.api.run", "repro_torch.__main__",
                "repro_torch.launch.mesh", "repro_torch.runtime.sharding",
                "repro_torch.models.act_sharding",
                # the audit and the dry-run
                "repro_torch.analysis", "repro_torch.analysis.findings",
                "repro_torch.analysis.lint", "repro_torch.analysis.pricing",
                "repro_torch.analysis.hygiene", "repro_torch.analysis.audit",
                "repro_torch.core.counts", "repro_torch.core.collectives",
                "repro_torch.launch.specs",
                "repro_torch.launch.dryrun"):
        assert mod in names
    # the lockstep slice's model functions
    from repro_torch import models
    from repro_torch.models import attention, blocks
    for fn in ("step", "init_decode_state", "forward", "init_params"):
        assert callable(getattr(models, fn))
    for fn in ("cached_attention", "mla_cached_attention", "cross_attention",
               "encode_cross_kv", "lockstep_blockwise"):
        assert callable(getattr(attention, fn))
    for fn in ("mamba_forward", "mamba_step", "rglru_forward", "rglru_step"):
        assert callable(getattr(blocks, fn))
    # the audit slice's entry points
    from repro_torch import analysis
    from repro_torch.launch import dryrun, specs
    for fn in ("run_audit", "lower_target", "reconcile", "run_pricing",
               "audit_donation", "audit_retrace", "lint_model"):
        assert callable(getattr(analysis, fn))
    assert callable(dryrun.run_cell) and callable(specs.build_cell)
    assert callable(models.abstract_params)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py", "examples/serve_batched_torch.py",
       "examples/train_100m_torch.py", "tools/measure_shared_card.py",
       "tools/measure_rglru_backward.py", "tools/sweep_flash_wide.py",
       "tools/sweep_flash_wide_bwd.py"]))
def test_no_jax_or_reference_import_statement(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path


def test_importing_the_port_leaves_jax_out():
    """Import every port module and chip_smoke.py's own imports in a
    fresh interpreter: neither ``jax`` nor ``repro`` may be loaded."""
    code = (
        "import importlib, pkgutil, sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 22
    assert res["bad"] == []


def loaded_reference_modules(mesh):
    """What a spawned rank finds loaded of JAX and the JAX package."""
    return sorted(k for k in sys.modules if k == "jax"
                  or k.startswith("jax.") or k == "repro"
                  or k.startswith("repro."))


def test_a_spawned_rank_leaves_jax_out():
    """A rank of a mesh (``repro_torch.launch.mesh.spawn``, gloo on the
    CPU) has neither ``jax`` nor ``repro`` in ``sys.modules``, though the
    process that starts it may have both."""
    import jax  # noqa: F401  (the parent has it; the ranks must not)
    from repro_torch.launch.mesh import spawn
    assert spawn(loaded_reference_modules, model=2,
                 device="cpu") == [[], []]


def trained_reference_modules(mesh):
    """One training step of a reduced model on a dp = 2 FSDP mesh; then
    what the rank finds loaded of JAX and the JAX package."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.optim import AdamW
    from repro_torch.runtime import ShardingPolicy, make_train_step
    from repro_torch.runtime.sharding import init_shard
    cfg = configs.reduced(configs.get("qwen2-moe-a2.7b"))
    policy = ShardingPolicy(fsdp=True)
    params = init_shard(cfg, 0, mesh, policy, device="cpu")
    opt = AdamW()
    step = make_train_step(cfg, opt, mesh, policy, use_flash=True)
    batch = SyntheticTokens(cfg, DataConfig(4, 16), device="cpu").batch(0)
    step(params, opt.init(params), batch)
    return loaded_reference_modules(mesh)


def test_spawned_training_ranks_leave_jax_out():
    """Ranks of a data-parallel FSDP training mesh, after a step of the
    MoE model (its aux loss all-reduced over the ranks), have neither
    ``jax`` nor ``repro`` in ``sys.modules``."""
    import jax  # noqa: F401  (the parent has it; the ranks must not)
    from repro_torch.launch.mesh import spawn
    assert spawn(trained_reference_modules, data=2,
                 device="cpu") == [[], []]


@pytest.fixture
def gpu_less():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal path is not reachable")


def test_entry_points_raise_without_gpu(gpu_less):
    import numpy as np
    from repro_torch import bridge, configs, resolve_device
    from repro_torch.engine import BlockPagedKVCache, Engine, EngineConfig
    from repro_torch.models import init_params

    cfg = configs.reduced(configs.get("llama2-7b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_numpy({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockPagedKVCache(cfg, 1, 4, 16, 4).init_state()
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, EngineConfig(max_slots=1, max_len=32))
    # and the explicit CPU request works
    assert resolve_device("cpu").type == "cpu"


def test_launcher_without_device_raises(gpu_less):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-7b", "--reduced", "--requests", "1"], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr


def test_launcher_smoke_reduced_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama2-7b", "--reduced", "--device", "cpu", "--requests", "3",
         "--max-slots", "2", "--prompt-len", "16", "--new-tokens", "6",
         "--chunk", "8", "--decode-block", "2", "--attn-impl", "paged",
         "--kv-dtype", "int8"], env=_env(), cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout[out.stdout.index("{"):])
    assert summary["requests"] == 3 and summary["device"] == "cpu"
    assert summary["tps"] > 0 and summary["ttft_p50_ms"] > 0
    assert out.stdout.count(" 6 toks ") == 3


def test_launcher_features_reduced_cpu():
    """Speculative decoding, bucketed admission and LoRA tenants through
    the launcher: tenants round-robin, the last request on the base
    model, and the summary carries each feature's measured rate."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-7b", "--reduced", "--device", "cpu", "--requests", "3",
         "--max-slots", "2", "--prompt-len", "16", "--new-tokens", "6",
         "--chunk", "8", "--spec-k", "2", "--prefill-batch", "2",
         "--lora-tenants", "2", "--lora-ranks", "4,8", "--lora-slots", "2"],
        env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout[out.stdout.index("{"):])
    assert out.stdout.count(" 6 toks ") == 3
    assert 0.0 <= summary["spec_acceptance"] <= 1.0
    assert summary["spec_tokens_per_step"] >= 1.0
    assert summary["adapter_hit_rate"] == 0.0      # two tenants, two misses


def test_measure_shared_card_reduced_cpu():
    """``tools/measure_shared_card.py`` serves a reduced llama2-7b on two
    gloo ranks of the CPU (a radix hit and a fork among its 4 requests)
    and prints one JSON line naming the package it imported."""
    out = subprocess.run(
        [sys.executable, "tools/measure_shared_card.py", "--device", "cpu",
         "--reduced"], env=_env(), cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["src"] == str(ROOT / "src")
    assert rec["tokens"] == 32 and rec["card"] is None
    assert rec["tpot_p50_ms"] > 0 and rec["ttft_p50_ms"] > 0


def test_chip_smoke_refuses_without_gpu(gpu_less):
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
