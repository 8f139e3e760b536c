"""Flash attention of the port against the JAX package's: the port's
``flash_attention`` (its CPU path, the plain version) and ``attention_ref``
against the reference kernel (Pallas, interpret mode on the CPU, as
``tests/test_kernels.py`` runs it) and its oracle, forward and gradients,
on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import (LAUNCHES, attention_ref,
                                                 flash_attention)

# the reference's kernel cases (tests/test_kernels.py FA_CASES):
# (b, s, L, H, Hk, d, causal, window, q_offset)
FA_CASES = [
    (1, 128, 128, 4, 4, 64, True, None, 0),      # MHA
    (2, 256, 256, 8, 2, 128, True, None, 0),     # GQA 4:1
    (1, 256, 256, 4, 1, 64, True, None, 0),      # MQA
    (1, 100, 100, 4, 2, 64, True, None, 0),      # unaligned seq
    (1, 1, 384, 4, 2, 64, True, None, 383),      # decode step w/ offset
    (2, 192, 192, 4, 4, 64, True, 64, 0),        # local window
    (1, 64, 64, 4, 4, 128, False, None, 0),      # bidirectional (encoder)
    (1, 128, 128, 2, 2, 256, True, None, 0),     # big head_dim (rg-gemma)
]
IDS = [str(c) for c in FA_CASES]
#: f32 on both sides; the two frameworks sum the same products in other
#: orders, so outputs and gradients agree to f32 rounding
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(case, seed=0):
    b, s, L, H, Hk, d = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, H, d)).astype(np.float32)
    k = rng.standard_normal((b, L, Hk, d)).astype(np.float32)
    v = rng.standard_normal((b, L, Hk, d)).astype(np.float32)
    g = rng.standard_normal((b, s, H, d)).astype(np.float32)
    return q, k, v, g


def _kw(case):
    return dict(causal=case[6], window=case[7], q_offset=case[8])


@pytest.mark.parametrize("case", FA_CASES, ids=IDS)
def test_forward_matches_reference(case):
    q, k, v, _ = _inputs(case)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=64, block_k=64, **_kw(case)))
    oracle = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **_kw(case)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = dict(LAUNCHES)
    got = flash_attention(tq, tk, tv, **_kw(case)).numpy()
    assert LAUNCHES == before            # the CPU path launches nothing
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(attention_ref(tq, tk, tv, **_kw(case)).numpy(),
                               oracle, **TOL)


@pytest.mark.parametrize("case", FA_CASES, ids=IDS)
def test_gradients_match_reference(case):
    """``jax.vjp`` of the reference's differentiable ``flash_attention``
    (its custom VJP recomputes through the oracle) against
    ``torch.autograd.grad`` through the port's, with one upstream
    gradient."""
    q, k, v, g = _inputs(case, seed=1)
    fn = lambda q_, k_, v_: jax_flash(q_, k_, v_, block_q=64, block_k=64,
                                      **_kw(case))
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, **_kw(case))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip("qkv", got, ref):
        np.testing.assert_allclose(a.numpy(), b, err_msg=f"d{name}", **TOL)


def test_bf16_forward_matches_reference():
    """bf16 inputs: both sides compute in f32 and round the output once,
    so they differ by at most one bf16 ulp (2**-7 relative)."""
    case = FA_CASES[1]
    q, k, v, _ = _inputs(case, seed=2)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_flash(jq, jk, jv, block_q=64, block_k=64,
                               **_kw(case)), np.float32)
    from repro_torch.bridge import tensor_from_numpy
    tq, tk, tv = (tensor_from_numpy(np.asarray(a), device="cpu")
                  for a in (jq, jk, jv))
    got = flash_attention(tq, tk, tv, **_kw(case))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7,
                               atol=1e-3)


def test_fully_masked_row_is_a_known_difference():
    """A row with no live key (window 64, queries past the keys): the
    reference kernel, like the port's CUDA kernel, writes 0 there, while
    both oracles, and so the port's CPU path, give the mean of v.  No
    training shape has such a row; this records the difference and holds
    the port's plain version to the reference's oracle."""
    case = (1, 4, 384, 4, 2, 64, True, 64, 1000)
    q, k, v, _ = _inputs(case, seed=3)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    kernel = np.asarray(jax_flash(jq, jk, jv, block_q=64, block_k=64,
                                  **_kw(case)))
    oracle = np.asarray(jax_ref(jq, jk, jv, **_kw(case)))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          **_kw(case)).numpy()
    assert np.all(kernel == 0.0)
    mean_v = np.repeat(v.mean(axis=1), 2, axis=1)          # (b, H, d)
    np.testing.assert_allclose(oracle, np.broadcast_to(
        mean_v[:, None], oracle.shape), **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


def test_wrapper_refuses_what_the_kernels_do_not_take():
    q = torch.zeros((1, 8, 4, 64))
    k = v = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA kernels"):
        ops.flash_bwd(q, k, v, q, torch.zeros((1, 4, 8)), q)
    with pytest.raises(ValueError, match="block sizes"):
        flash_attention(q, k, v, block_q=0)
    with pytest.raises(TypeError, match="f32 or bf16"):
        ops._check(q.half(), k.half(), v.half(), None, 0)
    with pytest.raises(ValueError, match="H % Hk"):
        ops._check(q, torch.zeros((1, 8, 3, 64)), torch.zeros((1, 8, 3, 64)),
                   None, 0)
    with pytest.raises(ValueError, match="d <= 256"):
        big = torch.zeros((1, 8, 2, 512))
        ops._check(torch.zeros((1, 8, 4, 512)), big, big, None, 0)
    with pytest.raises(ValueError, match="window"):
        ops._check(q, k, v, 0, 0)
    with pytest.raises(ValueError, match="q_offset"):
        ops._check(q, k, v, None, -1)
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                   None, 0)
    assert ops._check(q, k, v, 64, 3) == (1, 8, 8, 4, 2, 64)
