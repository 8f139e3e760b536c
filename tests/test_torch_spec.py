"""Speculative decoding pieces of the port against the JAX package: the
plain version of the paged-verify kernel (what its wrapper computes for
CPU tensors) against the reference's oracle and its Pallas kernel in
interpret mode on the reference tests' cases, and the drafters' proposals.
The CUDA kernel is held to the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.engine.drafter import DraftModelDrafter as JDraftModelDrafter
from repro.engine.drafter import NgramDrafter as JNgramDrafter
from repro.kernels.paged_attention import paged_verify as pallas_verify
from repro.kernels.paged_attention.ref import paged_verify_ref as jax_verify_ref
from repro.models import init_params as jax_init_params
from repro_torch import bridge, configs
from repro_torch.engine import (DraftModelDrafter, NgramDrafter,
                                make_drafter)
from repro_torch.kernels.paged_attention import paged_decode, paged_verify

KV_DTYPES = ["f32", "bf16", "int8"]
_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}

VERIFY_CASES = [
    # (S, Q, Hk, G, d, N, bs, nb, cursors) — the reference's cases
    (2, 5, 2, 2, 32, 16, 8, 5, (3, 17)),          # GQA, mid-block
    (3, 3, 1, 4, 32, 18, 8, 4, (0, 8, 23)),       # MQA, seam + fresh slot
    (2, 4, 4, 1, 64, 12, 16, 3, (16, 29)),        # MHA, aligned + near-end
]


def _pool(rng, N, bs, Hk, d, kv):
    if kv == "int8":
        mk = lambda: rng.integers(-40, 40, (N, bs, Hk, d)).astype(np.int8)
    else:
        mk = lambda: np.array(jnp.asarray(
            rng.standard_normal((N, bs, Hk, d)), _JNP[kv]))
    return mk(), mk()


def _t(a):
    return bridge.tensor_from_numpy(np.asarray(a), device="cpu")


def _tol(cv):
    """Both sides compute in f32 from the same inputs, in another order
    (and the kernel with an online softmax): 1e-5 of max|v|, the scale of
    every output."""
    return 1e-5 * max(1.0, float(np.abs(np.asarray(cv, np.float32)).max()))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=tol)


@pytest.mark.parametrize("case", VERIFY_CASES,
                         ids=[str(c) for c in VERIFY_CASES])
@pytest.mark.parametrize("kv", KV_DTYPES)
def test_verify_ref_matches_jax_ref_and_pallas(case, kv):
    S, Q, Hk, G, d, N, bs, nb, cursors = case
    rng = np.random.default_rng(23)
    q = rng.standard_normal((S, Q, Hk, G, d)).astype(np.float32)
    ck, cv = _pool(rng, N, bs, Hk, d, kv)
    bt = rng.permutation(N)[:S * nb].reshape(S, nb).astype(np.int32)
    pos = np.asarray(cursors, np.int32)
    got = paged_verify(_t(q), _t(ck), _t(cv), _t(bt), _t(pos))
    assert got.dtype == torch.float32 and got.shape == (S, Q, Hk, G, d)
    jargs = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
             jnp.asarray(bt), jnp.asarray(pos))
    tol = _tol(cv)
    _close(got.numpy(), jax_verify_ref(*jargs), tol)
    _close(got.numpy(), pallas_verify(*jargs), tol)


def test_verify_q1_is_decode():
    """A 1-query verify is a decode step (the k=0 degeneracy)."""
    S, Hk, G, d, N, bs, nb = 2, 2, 2, 32, 12, 8, 4
    rng = np.random.default_rng(5)
    q = rng.standard_normal((S, Hk, G, d)).astype(np.float32)
    ck, cv = _pool(rng, N, bs, Hk, d, "f32")
    bt = rng.permutation(N)[:S * nb].reshape(S, nb).astype(np.int32)
    pos = np.asarray((5, 19), np.int32)
    one = paged_verify(_t(q[:, None]), _t(ck), _t(cv), _t(bt), _t(pos))[:, 0]
    dec = paged_decode(_t(q), _t(ck), _t(cv), _t(bt), _t(pos))
    _close(one.numpy(), dec.numpy(), 1e-5)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_verify_padded_chunk_past_the_table(kv):
    """A bucketed admission's padded last chunk: the padding rows sit at
    ``pos + Q - 1`` beyond the table's ``nb * bs`` positions.  They attend
    every key of the table, as the reference's oracle and its Pallas grid
    (which never leaves the table) do; the live rows are unaffected."""
    S, Q, Hk, G, d, N, bs, nb = 2, 16, 2, 3, 32, 12, 8, 3
    rng = np.random.default_rng(9)
    q = rng.standard_normal((S, Q, Hk, G, d)).astype(np.float32)
    ck, cv = _pool(rng, N, bs, Hk, d, kv)
    bt = rng.permutation(N)[:S * nb].reshape(S, nb).astype(np.int32)
    pos = np.asarray((20, 13), np.int32)          # 20 + 15 >= 24 = nb*bs
    assert pos.max() + Q - 1 >= nb * bs
    got = paged_verify(_t(q), _t(ck), _t(cv), _t(bt), _t(pos))
    jargs = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
             jnp.asarray(bt), jnp.asarray(pos))
    tol = _tol(cv)
    _close(got.numpy(), jax_verify_ref(*jargs), tol)
    _close(got.numpy(), pallas_verify(*jargs), tol)


@pytest.mark.parametrize("seed", range(4))
def test_ngram_drafter_matches_reference(seed):
    """Same proposals as the reference's on random histories with
    repeats (small vocabularies make n-gram matches common)."""
    rng = np.random.default_rng(seed)
    for n in (1, 2, 3):
        ours, ref = NgramDrafter(n=n), JNgramDrafter(n=n)
        for _ in range(25):
            toks = rng.integers(0, 6, rng.integers(1, 30)).tolist()
            k = int(rng.integers(1, 7))
            assert ours.propose(toks, k) == ref.propose(toks, k)
    with pytest.raises(ValueError, match="n-gram order"):
        NgramDrafter(n=0)
    assert make_drafter().propose([5, 9, 2, 7] * 4, 6) == [5, 9, 2, 7, 7, 7]


def test_draft_model_drafter_matches_reference():
    """A reduced qwen2-7b draft model with f32 weights proposes the same
    greedy tokens through the port's forward as through the reference's,
    over histories whose lengths cross power-of-two buckets."""
    jcfg = jconfigs.reduced(jconfigs.get("qwen2-7b"))
    cfg = configs.reduced(configs.get("qwen2-7b"))
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)),
        jax_init_params(jcfg, jax.random.PRNGKey(4)))
    ours = DraftModelDrafter(cfg, bridge.params_from_numpy(tree,
                                                           device="cpu"))
    ref = JDraftModelDrafter(jcfg, jax.tree_util.tree_map(jnp.asarray, tree))
    assert ours.draft_arch == ref.draft_arch == cfg.name
    rng = np.random.default_rng(2)
    for t in (1, 3, 8, 13):
        toks = rng.integers(0, cfg.vocab_size, t).tolist()
        assert ours.propose(toks, 4) == ref.propose(toks, 4)
    small = make_drafter("qwen2-7b", reduce=True,
                         vocab_size=cfg.vocab_size, device="cpu")
    assert small.draft_arch == cfg.name
    assert len(small.propose([1, 2, 3, 4], 3)) == 3
