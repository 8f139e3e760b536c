"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points refuse to fall back to the CPU, and its launcher runs."""
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
                "repro_torch.api.run", "repro_torch.__main__"):
        assert mod in names


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
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


def test_chip_smoke_refuses_without_gpu(gpu_less):
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
