"""The port's lockstep ``Server`` against the JAX package's: greedy
tokens of ``Server.generate`` (chunked prefill, the first chunk carrying
a VLM's vision embeddings or an encoder-decoder's frames) for one model
of every family the reference serves, with bf16 and int8 KV; the
launcher's route to the ``Server`` for the families the engine does not
serve; and the refusal without a GPU.  Reduced configs, f32 weights drawn by the
reference and carried across by the bridge
(``test_torch_families.weights``).  Tokens must be identical."""
import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.mesh import make_host_mesh
from repro.runtime import Server as JaxServer
from repro.runtime import ServeConfig as JaxServeConfig
from repro.runtime import ShardingPolicy
from repro_torch import api
from repro_torch.models import init_decode_state
from repro_torch.runtime import ServeConfig, Server
from test_torch_families import weights
from test_torch_imports import ROOT, _env
from test_torch_lockstep import SERVED, _extra


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("arch", SERVED)
def test_server_tokens_match_reference(arch, kv, mesh):
    """``Server.generate`` (chunked prefill, greedy) gives the reference
    ``Server``'s tokens, on a single-device mesh as
    ``tests/test_engine.py`` builds it."""
    cfg, jp, tp = weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
    extra, jextra = _extra(cfg, 2, seed=3)
    sc = dict(batch=2, max_len=32, chunk_size=8, kv_dtype=kv)
    with mesh:
        want, jstats = JaxServer(jcfg, jp, mesh, ShardingPolicy(),
                                 JaxServeConfig(**sc)).generate(
            jnp.asarray(prompts), 6, extra=jextra)
    got, stats = Server(cfg, tp, ServeConfig(**sc), device="cpu").generate(
        prompts, 6, extra=extra)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == jstats



def _launch(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "falcon-mamba-7b", "--reduced", "--batch", "2", "--prompt-len", "16",
         "--new-tokens", "4", *args], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=300)


def test_launcher_routes_the_lockstep_families_to_the_server():
    """As the reference's launcher: a family the engine does not serve
    goes to the lockstep ``Server`` with a note (``--legacy`` asks for it
    outright), and the summary is the reference's legacy one."""
    out = _launch("--device", "cpu", "--chunk", "8")
    assert out.returncode == 0, out.stderr
    assert "family not engine-supported; using legacy lockstep path" in \
        out.stdout
    summary = json.loads(out.stdout[out.stdout.index("{"):])
    assert summary["mode"] == "legacy" and summary["device"] == "cpu"
    assert summary["shape"] == [2, 4] and summary["final_pos"] == 16 + 3
    assert len(summary["generated"]) == 4


def test_server_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the refusal path is not reachable")
    cfg, _, tp = weights("falcon-mamba-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(cfg, tp, ServeConfig(batch=1, max_len=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_decode_state(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.measure(api.Scenario(model="falcon-mamba-7b", reduced=True,
                                 batch=1, prompt_len=8, gen_len=2))
    out = _launch("--legacy")
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
