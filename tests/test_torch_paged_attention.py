"""Paged attention of the port: the plain versions (what the wrappers
compute for CPU tensors) against the JAX package's oracles and its Pallas
kernels in interpret mode, on the reference tests' cases.  The CUDA
kernels are held to the plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_decode as pallas_decode
from repro.kernels.paged_attention import paged_prefill as pallas_prefill
from repro.kernels.paged_attention.ref import (paged_decode_ref as jax_decode_ref,
                                               paged_prefill_ref as jax_prefill_ref)
from repro_torch import bridge
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import (paged_decode, paged_decode_ref,
                                                 paged_prefill, paged_prefill_ref)

KV_DTYPES = ["f32", "bf16", "int8"]
_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}

DECODE_CASES = [
    # (S, Hk, G, d, N, bs, nb, cursors): block starts, mid-block cursors,
    # a fresh slot (pos 0), around a block seam — the reference's cases
    (3, 2, 2, 32, 16, 8, 5, (0, 17, 39)),
    (2, 4, 1, 64, 12, 16, 3, (16, 31)),
    (4, 1, 4, 32, 18, 8, 4, (7, 8, 9, 30)),
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
    (and the kernel with an online softmax): 1e-5 relative to max|v|, the
    scale of every output (int8 values reach 40, so the int8 cases are
    held relatively, not to the reference tests' fixed 1e-4)."""
    return 1e-5 * max(1.0, float(np.abs(np.asarray(cv, np.float32)).max()))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=tol)


@pytest.mark.parametrize("case", DECODE_CASES, ids=[str(c) for c in DECODE_CASES])
@pytest.mark.parametrize("kv", KV_DTYPES)
def test_decode_ref_matches_jax_ref_and_pallas(case, kv):
    S, Hk, G, d, N, bs, nb, cursors = case
    rng = np.random.default_rng(7)
    q = rng.standard_normal((S, Hk, G, d)).astype(np.float32)
    ck, cv = _pool(rng, N, bs, Hk, d, kv)
    bt = rng.permutation(N)[:S * nb].reshape(S, nb).astype(np.int32)
    pos = np.asarray(cursors, np.int32)
    got = paged_decode(_t(q), _t(ck), _t(cv), _t(bt), _t(pos))
    assert got.dtype == torch.float32 and got.shape == (S, Hk, G, d)
    jargs = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
             jnp.asarray(bt), jnp.asarray(pos))
    tol = _tol(cv)
    _close(got.numpy(), jax_decode_ref(*jargs), tol)
    _close(got.numpy(), pallas_decode(*jargs), tol)


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("start,valid", [(0, 16), (10, 13), (24, 5)])
def test_prefill_ref_matches_jax_ref_and_pallas(kv, start, valid):
    """Chunks at absolute positions: admission start, a mid-block chunk
    on top of cached history, a short tail chunk (rows >= valid are
    padding and not compared)."""
    C, Hk, G, d = 16, 2, 2, 32
    N, bs, nb = 16, 8, 5
    rng = np.random.default_rng(11)
    q = rng.standard_normal((C, Hk, G, d)).astype(np.float32)
    ck, cv = _pool(rng, N, bs, Hk, d, kv)
    table = rng.permutation(N)[:nb].astype(np.int32)
    got = paged_prefill(_t(q), _t(ck), _t(cv), _t(table), start, valid)
    assert got.shape == (C, Hk, G, d)
    jargs = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
             jnp.asarray(table))
    tol = _tol(cv)
    _close(got[:valid].numpy(),
           jax_prefill_ref(*jargs, start, valid)[:valid], tol)
    _close(got[:valid].numpy(),
           pallas_prefill(*jargs, jnp.int32(start), jnp.int32(valid))[:valid],
           tol)


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_decode_shared_prefix_and_cow_tables(kv):
    """Two slots map the same physical prefix blocks (radix hit) and a
    third holds a copy-on-write fork of the shared tail block: reading
    through the fork equals reading the original while it is a copy."""
    Hk, G, d, bs, N = 2, 2, 32, 8, 12
    rng = np.random.default_rng(13)
    ck, cv = _pool(rng, N, bs, Hk, d, kv)
    ck[6], cv[6] = ck[1], cv[1]                  # the fork of block 1
    bt = np.asarray([[0, 1, 2, 3], [0, 1, 4, 5], [0, 6, 7, 8]], np.int32)
    q = rng.standard_normal((3, Hk, G, d)).astype(np.float32)
    pos = np.asarray([25, 20, 12], np.int32)
    got = paged_decode(_t(q), _t(ck), _t(cv), _t(bt), _t(pos))
    jargs = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
             jnp.asarray(bt), jnp.asarray(pos))
    tol = _tol(cv)
    _close(got.numpy(), jax_decode_ref(*jargs), tol)
    _close(got.numpy(), pallas_decode(*jargs), tol)
    one = torch.tensor([12], dtype=torch.int32)
    orig = paged_decode(_t(q[:1]), _t(ck), _t(cv), _t(bt[:1, :2]), one)
    fork = paged_decode(_t(q[:1]), _t(ck), _t(cv), _t(bt[2:3, :2]), one)
    assert torch.equal(orig, fork)


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 2, 1, 16)).astype(np.float32))
    ck = torch.from_numpy(rng.standard_normal((6, 4, 2, 16)).astype(np.float32))
    bt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    pos = torch.tensor([3, 6], dtype=torch.int32)
    before = dict(ops.LAUNCHES)
    assert torch.equal(paged_decode(q, ck, ck, bt, pos),
                       paged_decode_ref(q, ck, ck, bt, pos))
    qp = q.repeat(2, 1, 1, 1)
    assert torch.equal(paged_prefill(qp, ck, ck, bt[0], 2, 3),
                       paged_prefill_ref(qp, ck, ck, bt[0], 2, 3))
    assert ops.LAUNCHES == before
    assert ops._lib is None                 # nothing was built or loaded


def test_padding_rows_do_not_change_live_rows():
    """Rows at or past ``valid`` are padding: whatever they hold, the
    live rows' outputs are the same."""
    rng = np.random.default_rng(17)
    q = torch.from_numpy(rng.standard_normal((8, 2, 2, 16)).astype(np.float32))
    ck = torch.from_numpy(rng.standard_normal((6, 4, 2, 16)).astype(np.float32))
    table = torch.tensor([4, 0, 5, 2], dtype=torch.int32)
    a = paged_prefill_ref(q, ck, ck, table, 5, 3)
    q2 = q.clone()
    q2[3:] = 1e3
    b = paged_prefill_ref(q2, ck, ck, table, 5, 3)
    assert torch.equal(a[:3], b[:3])


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_kernel_tolerance_admits_rounding_and_flags_a_skipped_block(kv,
                                                                    q_dtype):
    """The limit the CUDA kernels are held to on the card: a difference
    of one unit in the output's last place passes; an output that left
    out one middle KV block, or is off by 2**-6 of itself, does not.
    Deep cursors as on the main path (small outputs: softmax over
    hundreds of keys)."""
    from repro_torch.kernels.paged_attention.ref import kernel_tolerance
    rng = np.random.default_rng(5)
    N, bs, Hk, d, nb = 48, 16, 2, 128, 37
    ck, cv = (_t(a) for a in _pool(rng, N, bs, Hk, d, kv))
    bt = torch.from_numpy(rng.permutation(N)[:nb].astype(np.int32))[None]
    pos = torch.tensor([547], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((1, Hk, 1, d)).astype(
        np.float32)).to(q_dtype)
    ref = paged_decode_ref(q, ck, cv, bt, pos)
    lim = kernel_tolerance(ref, cv)
    # one unit in the last place of every element (another rounding)
    _, e = torch.frexp(ref.float())
    mant = 8 if q_dtype == torch.bfloat16 else 24
    ulp = torch.ldexp(torch.ones_like(lim), e - mant)
    assert bool((ref != 0).all()) and bool((ulp <= lim).all())
    # the same attention with one middle block left out: the one that
    # holds the most weight (int8 scores are so wide that the softmax
    # is nearly one-hot, and leaving out a light block changes nothing)
    pk = ck[bt[0].long()].reshape(nb * bs, Hk, d).float()
    pv = cv[bt[0].long()].reshape(nb * bs, Hk, d).float()
    k_pos = torch.arange(nb * bs)
    sc = torch.einsum("kgd,lkd->kgl", q[0].float(), pk) * d ** -0.5
    sc = sc.masked_fill(k_pos > int(pos[0]), float("-inf"))
    mass = sc.softmax(-1).sum((0, 1)).reshape(nb, bs).sum(1)
    blk = 1 + int(mass[1:int(pos[0]) // bs].argmax())
    sc = sc.masked_fill(k_pos // bs == blk, float("-inf"))
    skipped = torch.einsum("kgl,lkd->kgd", sc.softmax(-1), pv)[None]
    assert bool(((skipped.to(q_dtype).float() - ref.float()).abs()
                 > lim).any())
    # a scale error of 2**-6 (two bf16 ulps)
    assert bool(((ref.float() * (1 + 2.0 ** -6) - ref.float()).abs()
                 > lim).any())
