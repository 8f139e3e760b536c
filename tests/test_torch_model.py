"""Dense model of the port against the JAX package: configs, layers and
full-forward logits on the same weights (converted by the bridge)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import layers as jlayers
from repro_torch import bridge, configs
from repro_torch.models import forward
from repro_torch.models import layers

ARCHS = ["llama2-7b", "qwen2-7b", "granite-3-2b"]
#: f32: both sides run the same f32 arithmetic in another order;
#: bf16: the two frameworks round intermediates at other places, so the
#: logits (|logit| < 1 here) may differ by a few bf16 ulps (2**-8 each)
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=0, atol=5e-2)}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for make in (lambda m, a: m.get(a),
                 lambda m, a: m.reduced(m.get(a)),
                 lambda m, a: m.reduced(m.get(a), n_layers=3)):
        ref = dataclasses.asdict(make(jconfigs, arch))
        got = dataclasses.asdict(make(configs, arch))
        assert got == ref
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.kv_bytes_per_token(1) == jcfg.kv_bytes_per_token(1)
    assert configs.DEFAULT_KV_BLOCK_SIZE == 16


def _weights(arch, dtype, seed=0):
    """Shared weights: the reference's init (biases made non-zero so the
    qkv-bias path is exercised), as JAX arrays and as port tensors."""
    cfg = jconfigs.reduced(jconfigs.get(arch))
    tree = jax_init_params(cfg, jax.random.PRNGKey(seed))
    if dtype == "f32":
        tree = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    attn = np_tree["layers"]["attn"]
    rng = np.random.default_rng(seed)
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = (rng.standard_normal(attn[b].shape) * 0.1).astype(
                attn[b].dtype)
    jax_tree = jax.tree_util.tree_map(jnp.asarray, np_tree)
    return cfg, jax_tree, bridge.params_from_numpy(np_tree, device="cpu")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, dtype):
    cfg, jtree, ttree = _weights(arch, dtype)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    ref, _ = jax_forward(cfg, jtree, jnp.asarray(toks, jnp.int32))
    got, aux = forward(configs.reduced(configs.get(arch)), ttree,
                       torch.from_numpy(toks))
    assert float(aux) == 0.0
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


def test_tied_lm_head_matches_reference():
    jcfg = jconfigs.reduced(jconfigs.get("llama2-7b"), tie_embeddings=True)
    cfg = configs.reduced(configs.get("llama2-7b"), tie_embeddings=True)
    tree = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32),
        jax_init_params(jcfg, jax.random.PRNGKey(2)))
    assert "lm_head" not in tree
    ttree = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 9))
    ref, _ = jax_forward(jcfg, tree, jnp.asarray(toks, jnp.int32))
    got, _ = forward(cfg, ttree, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL["f32"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_and_rope_match_reference(dtype):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32) * 3
    gamma = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 900, (2, 7)).astype(np.int32)
    jx = jnp.asarray(x, jdt)
    tx = bridge.tensor_from_numpy(np.asarray(jx), device="cpu")
    tg = bridge.tensor_from_numpy(np.asarray(jnp.asarray(gamma, jdt)),
                                  device="cpu")
    norm_ref = jlayers.rmsnorm(jx, jnp.asarray(gamma, jdt))
    norm = layers.rmsnorm(tx, tg)
    rope_ref = jlayers.apply_rope(jx, jnp.asarray(pos), 10000.0)
    rope = layers.apply_rope(tx, torch.from_numpy(pos), 10000.0)
    # f32: identical math up to rounding; bf16: one ulp of |x| < 16
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else dict(rtol=0,
                                                                  atol=0.125)
    for got, ref in ((norm, norm_ref), (rope, rope_ref)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **tol)


def test_silu_gelu_match_reference():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    for name in ("silu", "gelu"):
        ref = np.asarray(jlayers.ACTIVATIONS[name](jnp.asarray(x)))
        got = layers.ACTIVATIONS[name](torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_blockwise_length_is_refused():
    """Sequences of ``BLOCKWISE_THRESHOLD`` tokens and more are no longer
    refused: they take the blockwise path, as in the reference, and the
    logits match the reference's."""
    from repro_torch.models.attention import BLOCKWISE_THRESHOLD
    jcfg, jtree, ttree = _weights("llama2-7b", "f32")
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                             (1, BLOCKWISE_THRESHOLD))
    ref, _ = jax_forward(jcfg, jtree, jnp.asarray(toks, jnp.int32))
    got, _ = forward(configs.reduced(configs.get("llama2-7b")), ttree,
                     torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL["f32"])
