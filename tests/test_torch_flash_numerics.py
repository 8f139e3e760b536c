"""The arithmetic of K6's tensor-core bodies (flash attention forward and
backward), emulated on the CPU and held to the limits the card's checks
use.

A CUDA kernel cannot run here, so each ``mma`` body's rounding is
emulated in PyTorch.  The forward: query tiles of ``mma_tiles(d).fwd_rows``
rows walk the key tiles of ``key_tile_range`` (64 keys each), scores are
f32 sums of exact bf16 products, the online softmax is f32 (in base 2,
as the kernel folds log2(e) into the scale), and P.V runs as two bf16
products, ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``.  The backward:
``P = exp(S - lse)`` and ``dS = P * (dP - D)`` in f32, with ``D =
rowsum(dO * O)`` over the bf16 output; dV, dK and dQ take P and dS as
one bf16 rounding each (``BWD_ROUNDING``), dK/dV per key tile over the
query tiles of ``query_tile_range`` and all G query heads of the group,
dQ per query tile over ``key_tile_range``.

The forward is held to ``kernel_tolerance`` (one bf16 ulp of each output
plus 1e-3 of the mean magnitude), against the port's plain version and
the JAX package's ``flash_attention`` (its Pallas kernel in interpret
mode, as its own tests run it on the CPU); one case shows that a single
bf16 rounding of P exceeds that limit, the finding K3's body rests on.
The gradients are held to a relative norm of 2e-2, the limit of the
card's bf16 checks, against autograd through the plain version and
``jax.vjp`` of the JAX package's function; the same cases with P and dS
split hi/lo show what the single rounding costs, which decides the
design.  ``flash_body`` and the tile plan are pure functions, tested
here; ``tests/test_torch_gpu.py`` holds the bodies themselves on the
card.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention.ref import kernel_tolerance

NEG_INF = -1e30
LOG2E = 1.4426950408889634
#: the card's limit on each gradient's relative norm in bf16
GRAD_LIMIT = 2e-2
#: the backward body's roundings of P (into dV) and dS (into dK, dQ):
#: one bf16 rounding each, as test_bwd_single_rounding_* decides
BWD_ROUNDING = dict(p="bf16", ds="bf16")

#: (b, s, L, H, Hk, d, causal, window, q_offset): the train shape's GQA
#: 32/8 and head dim 64 cut to 8/2 heads and 512 positions; a window; a
#: query block at an offset; llama2-7b's head dim 128 (MQA); a ragged,
#: bidirectional one at d = 48 (zero-padded to 64 in the kernel);
#: recurrentgemma-2b's local layers (d = 256, MQA, a window) cut to 4
#: heads and 256 positions (the wide bodies, forward and backward)
CASES = {
    "causal": (1, 512, 512, 8, 2, 64, True, None, 0),
    "window": (1, 512, 512, 8, 2, 64, True, 128, 0),
    "q_offset": (1, 128, 512, 8, 2, 64, True, None, 384),
    "d128": (1, 256, 256, 4, 1, 128, True, None, 0),
    "ragged": (1, 100, 100, 4, 2, 48, False, None, 0),
    "d256": (1, 256, 256, 4, 1, 256, True, 128, 0),
}
#: the cases whose backward runs on the ``mma`` body
BWD_CASES = [n for n, c in CASES.items()
             if fa_ops.flash_body("flash_bwd", torch.bfloat16, c[5]) == "mma"]


def _inputs(case, seed=0):
    """bf16 q, k, v and upstream gradient, from numpy."""
    b, s, L, H, Hk, d = case[:6]
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).bfloat16()
    return mk(b, s, H, d), mk(b, L, Hk, d), mk(b, L, Hk, d), mk(b, s, H, d)


def _kw(case):
    return dict(causal=case[6], window=case[7], q_offset=case[8])


def _bf16(t: torch.Tensor):
    """A bf16 tensor as the same bf16 values in JAX."""
    return jnp.asarray(t.float().numpy().astype(ml_dtypes.bfloat16))


def _from_jax(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def _ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |out - ref| over ``kernel_tolerance`` of ref."""
    diff = (out.float() - ref.float()).abs()
    return float((diff / kernel_tolerance(ref, ref)).max())


def _rel(a: torch.Tensor, r: torch.Tensor) -> float:
    return float((a.float() - r.float()).norm() / r.float().norm())


def _live(qpos, kpos, L, causal, window):
    """(rows, keys) bool: the kernel's mask."""
    live = (kpos[None, :] < L).expand(len(qpos), len(kpos)).clone()
    if causal:
        live &= kpos[None, :] <= qpos[:, None]
    if window:
        live &= kpos[None, :] > qpos[:, None] - window
    return live


def _heads(x, G):
    """(b, n, Hx, d) -> (b, Hx * G, n, d) f32, each KV head repeated for
    its G query heads (the kernels read KV head h // G)."""
    return x.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)


def _bf(x):
    return x.bfloat16().float()


def fwd_mma(q, k, v, *, causal, window, q_offset, hi_lo=True):
    """The forward body, tile for tile: (o in bf16 (b, s, H, d), lse f32
    (b, H, s)); ``hi_lo`` off takes P.V on bf16(P) alone."""
    b, s, H, d = q.shape
    L, Hk = k.shape[1], k.shape[2]
    tiles = fa_ops.mma_tiles(d)
    scale2 = d ** -0.5 * LOG2E
    qf, kf, vf = _heads(q, 1), _heads(k, H // Hk), _heads(v, H // Hk)
    out = torch.zeros((b, H, s, d))
    lse = torch.zeros((b, H, s))
    for i0 in range(0, s, tiles.fwd_rows):
        rows = torch.arange(i0, min(i0 + tiles.fwd_rows, s))
        m = torch.full((b, H, len(rows)), NEG_INF)
        l = torch.zeros((b, H, len(rows)))
        acc = torch.zeros((b, H, len(rows), d))
        for t0 in fa_ops.key_tile_range(i0, tiles.fwd_rows, s, L,
                                        causal=causal, window=window,
                                        q_offset=q_offset,
                                        tile=tiles.fwd_keys):
            keys = torch.arange(t0, min(t0 + tiles.fwd_keys, L))
            live = _live(q_offset + rows, keys, L, causal, window)
            sc = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            sc = torch.where(live, sc * scale2, torch.tensor(NEG_INF))
            mn = torch.maximum(m, sc.max(-1).values)
            alpha = torch.exp2(m - mn)
            p = torch.where(live, torch.exp2(sc - mn[..., None]),
                            torch.tensor(0.0))
            l = l * alpha + p.sum(-1)
            p_hi = _bf(p)
            pv = p_hi @ vf[:, :, keys]
            if hi_lo:
                pv = pv + _bf(p - p_hi) @ vf[:, :, keys]
            acc = acc * alpha[..., None] + pv
            m = mn
        den = torch.clamp(l, min=1e-30)
        out[:, :, rows] = acc / den[..., None]
        lse[:, :, rows] = (m + torch.log2(den)) / LOG2E
    return out.permute(0, 2, 1, 3).bfloat16(), lse


def _round(x, how):
    """One bf16 rounding, or the hi/lo pair summed (what two products on
    bf16(x) and bf16(x - bf16(x)) give)."""
    hi = _bf(x)
    return hi if how == "bf16" else hi + _bf(x - hi)


def bwd_mma(q, k, v, o, lse, do, *, causal, window, q_offset,
            p="bf16", ds="bf16"):
    """The backward body: (dq, dk, dv) in bf16.  dK/dV per key tile,
    over the visited query tiles of every query head of the group; dQ
    per query tile over the visited key tiles; ``p`` and ``ds`` name the
    rounding of P and dS into the tensor cores ("bf16" or "hi_lo")."""
    b, s, H, d = q.shape
    L, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    tiles = fa_ops.mma_tiles(d)
    scale = d ** -0.5
    qf, dof = _heads(q, 1), _heads(do, 1)
    kf, vf = _heads(k, G), _heads(v, G)
    delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1)   # (b, H, s)
    lse2 = lse * LOG2E
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def p_ds(rows, keys):
        live = _live(q_offset + rows, keys, L, causal, window)
        sc = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
        pr = torch.where(live, torch.exp2(sc * (scale * LOG2E)
                                          - lse2[:, :, rows, None]),
                         torch.tensor(0.0))
        dp = dof[:, :, rows] @ vf[:, :, keys].transpose(-1, -2)
        return pr, pr * (dp - delta[:, :, rows, None])

    dk = torch.zeros((b, H, L, d))
    dv = torch.zeros((b, H, L, d))
    for t0 in range(0, L, tiles.dkdv_keys):
        keys = torch.arange(t0, min(t0 + tiles.dkdv_keys, L))
        for i0 in fa_ops.query_tile_range(t0, tiles.dkdv_keys, s, L,
                                          tile=tiles.dkdv_rows, **kw):
            rows = torch.arange(i0, min(i0 + tiles.dkdv_rows, s))
            pr, dsc = p_ds(rows, keys)
            dv[:, :, keys] += _round(pr, p).transpose(-1, -2) @ dof[:, :, rows]
            dk[:, :, keys] += (_round(dsc, ds).transpose(-1, -2)
                               @ qf[:, :, rows])
    dq = torch.zeros((b, H, s, d))
    for i0 in range(0, s, tiles.dq_rows):
        rows = torch.arange(i0, min(i0 + tiles.dq_rows, s))
        for t0 in fa_ops.key_tile_range(i0, tiles.dq_rows, s, L,
                                        tile=tiles.dq_keys, **kw):
            keys = torch.arange(t0, min(t0 + tiles.dq_keys, L))
            _, dsc = p_ds(rows, keys)
            dq[:, :, rows] += _round(dsc, ds) @ kf[:, :, keys]
    # the GQA sum over the group, inside one dK/dV block on the card
    group = lambda x: x.reshape(b, Hk, G, L, d).sum(2).permute(0, 2, 1, 3)
    return ((dq * scale).permute(0, 2, 1, 3).bfloat16(),
            (group(dk) * scale).bfloat16(), group(dv).bfloat16())


def _plain_grads(q, k, v, do, kw):
    """Autograd through the port's plain version (f32 inside, bf16
    leaves), as the card's checks take it."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention_ref(*leaves, **kw)
    return out.detach(), torch.autograd.grad(out, leaves, do)


def _jax_grads(q, k, v, do, kw):
    """jax.vjp of the JAX package's flash_attention (kernel in interpret
    mode forward, its oracle's VJP backward) on the same bf16 values."""
    fn = lambda q_, k_, v_: jax_flash(q_, k_, v_, block_q=64, block_k=64,
                                      **kw)
    out, vjp = jax.vjp(fn, _bf16(q), _bf16(k), _bf16(v))
    return _from_jax(out), [_from_jax(g) for g in vjp(_bf16(do))]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_fwd_hi_lo_within_tolerance_of_plain_version(name):
    case = CASES[name]
    q, k, v, _ = _inputs(case, seed=len(name))
    got, _ = fwd_mma(q, k, v, **_kw(case))
    want = fa_ops.flash_attention(q, k, v, **_kw(case))   # the CPU path
    assert _ratio(got, want) <= 1.0


@pytest.mark.parametrize("name", ["causal", "window", "q_offset", "ragged",
                                  "d256"])
def test_fwd_hi_lo_within_tolerance_of_jax_kernel(name):
    case = CASES[name]
    q, k, v, do = _inputs(case, seed=len(name))
    got, _ = fwd_mma(q, k, v, **_kw(case))
    want, _ = _jax_grads(q, k, v, do, _kw(case))
    assert _ratio(got, want) <= 1.0


def test_fwd_lse_matches_the_rows_log_sum_exp():
    """The forward's lse (what the backward recomputes P from) is the
    natural-log log-sum-exp of each row's scaled, masked scores."""
    case = CASES["window"]
    q, k, v, _ = _inputs(case)
    _, lse = fwd_mma(q, k, v, **_kw(case))
    b, s, H, d = q.shape
    sc = (_heads(q, 1) @ _heads(k, 4).transpose(-1, -2)) * d ** -0.5
    pos = torch.arange(s)
    live = _live(pos, pos, s, True, case[7])
    want = torch.logsumexp(torch.where(live, sc, torch.tensor(NEG_INF)), -1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)


def test_fwd_single_bf16_p_exceeds_the_limit():
    """P rounded once to bf16 keeps 8 of its bits; over 512 keys of the
    train shape's head dim the output moves by several times the limit,
    where the hi/lo split stays inside it."""
    case = CASES["causal"]
    q, k, v, _ = _inputs(case)
    want = fa_ops.flash_attention(q, k, v, **_kw(case))
    single, _ = fwd_mma(q, k, v, hi_lo=False, **_kw(case))
    split, _ = fwd_mma(q, k, v, **_kw(case))
    assert _ratio(single, want) > 2.0
    assert _ratio(split, want) <= 1.0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _bwd(case, seed, **rounding):
    q, k, v, do = _inputs(case, seed=seed)
    o, lse = fwd_mma(q, k, v, **_kw(case))
    return (q, k, v, do), bwd_mma(q, k, v, o, lse, do, **_kw(case),
                                  **rounding)


@pytest.mark.parametrize("name", BWD_CASES)
def test_bwd_single_rounding_within_limit_of_plain_version(name):
    case = CASES[name]
    (q, k, v, do), grads = _bwd(case, len(name), **BWD_ROUNDING)
    _, want = _plain_grads(q, k, v, do, _kw(case))
    rel = [_rel(a, r) for a, r in zip(grads, want)]
    assert max(rel) <= GRAD_LIMIT, rel


@pytest.mark.parametrize("name", ["causal", "window", "q_offset", "d256"])
def test_bwd_single_rounding_within_limit_of_jax_function(name):
    case = CASES[name]
    (q, k, v, do), grads = _bwd(case, len(name), **BWD_ROUNDING)
    _, want = _jax_grads(q, k, v, do, _kw(case))
    rel = [_rel(a, r) for a, r in zip(grads, want)]
    assert max(rel) <= GRAD_LIMIT, rel


def test_bwd_single_rounding_costs_little_against_hi_lo():
    """The decision: with P and dS split hi/lo the gradients sit at the
    floor set by their own bf16 outputs; one rounding each adds little to
    that and stays at a fraction of the limit, so the body takes one
    product per operand (the hi/lo split would double the backward's
    tensor-core work for nothing the limit asks)."""
    case = CASES["causal"]
    (q, k, v, do), single = _bwd(case, 0, p="bf16", ds="bf16")
    _, split = _bwd(case, 0, p="hi_lo", ds="hi_lo")
    _, want = _plain_grads(q, k, v, do, _kw(case))
    rel_single = [_rel(a, r) for a, r in zip(single, want)]
    rel_split = [_rel(a, r) for a, r in zip(split, want)]
    assert max(rel_single) <= GRAD_LIMIT / 4, rel_single
    assert max(rel_split) <= max(rel_single), (rel_split, rel_single)


def test_tile_ranges_skip_only_dead_tiles():
    """Every (query tile, key tile) pair outside ``key_tile_range`` /
    ``query_tile_range`` is masked wholly, and every pair inside holds at
    least one live (query, key), for causal, windowed and offset masks,
    ragged s and L."""
    for s, L, causal, window, q_offset in [
            (512, 512, True, None, 0), (512, 512, True, 128, 0),
            (128, 512, True, None, 384), (100, 100, False, None, 0),
            (200, 300, True, 64, 100), (1, 384, True, None, 383)]:
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        for rows, keys in ((64, 64), (64, 32), (32, 64)):
            for i0 in range(0, s, rows):
                qpos = q_offset + torch.arange(i0, min(i0 + rows, s))
                visited = set(fa_ops.key_tile_range(i0, rows, s, L, tile=keys,
                                                    **kw))
                for t0 in range(0, L, keys):
                    kpos = torch.arange(t0, min(t0 + keys, L))
                    any_live = bool(_live(qpos, kpos, L, causal,
                                          window).any())
                    assert (t0 in visited) == any_live, (s, L, kw, i0, t0)
                    back = fa_ops.query_tile_range(t0, keys, s, L,
                                                   tile=rows, **kw)
                    assert (i0 in back) == any_live, (s, L, kw, i0, t0)


@pytest.mark.parametrize("dtype,d,fwd,bwd", [
    (torch.bfloat16, 64, "mma", "mma"), (torch.bfloat16, 128, "mma", "mma"),
    (torch.bfloat16, 16, "mma", "mma"), (torch.bfloat16, 48, "mma", "mma"),
    (torch.bfloat16, 112, "mma", "mma"), (torch.bfloat16, 256, "mma", "mma"),
    (torch.bfloat16, 144, "mma", "mma"), (torch.bfloat16, 40, "fma", "fma"),
    (torch.bfloat16, 8, "fma", "fma"), (torch.float32, 64, "fma", "fma"),
    (torch.float32, 128, "fma", "fma"), (torch.float16, 64, "fma", "fma"),
    (torch.float32, 256, "fma", "fma"),
])
def test_flash_body_rule(dtype, d, fwd, bwd):
    """Each direction's rule: bf16 at d % 16 == 0 on the tensor cores up
    to 256, forward and backward; f32 always on ``fma``."""
    assert fa_ops.flash_body("flash_fwd", dtype, d) == fwd
    assert fa_ops.flash_body("flash_bwd", dtype, d) == bwd
    with pytest.raises(ValueError, match="wrapper"):
        fa_ops.flash_body("flash", dtype, d)


@pytest.mark.parametrize("d,dp,inner", [(16, 64, 64), (64, 64, 64),
                                        (80, 128, 32), (128, 128, 32),
                                        (144, 256, 64), (256, 256, 64)])
def test_mma_tiles(d, dp, inner):
    """Four warps of 64 query rows (or keys) per block up to dp = 128;
    at dp = 256 eight warps of 128 query rows forward and in dQ, and
    dK/dV blocks of 64 keys over 64-row query tiles."""
    tiles = fa_ops.mma_tiles(d)
    wide = dp == 256
    assert tiles == fa_ops.MmaTiles(dp=dp, fwd_rows=128 if wide else 64,
                                    fwd_keys=64, dkdv_keys=64,
                                    dkdv_rows=inner,
                                    dq_rows=128 if wide else 64,
                                    dq_keys=32 if wide else inner)
    for bad in (40, 264):
        with pytest.raises(ValueError, match="mma body"):
            fa_ops.mma_tiles(bad)


if __name__ == "__main__":
    # the figures behind the design (PERF.md): per case, the forward's
    # err/limit with hi/lo P and with one bf16 P, and the gradients'
    # relative norms with one rounding of P and dS and with hi/lo
    #     PYTHONPATH=src python tests/test_torch_flash_numerics.py
    for name, case in CASES.items():
        q, k, v, do = _inputs(case, seed=len(name))
        want = fa_ops.flash_attention(q, k, v, **_kw(case))
        fwd = [_ratio(fwd_mma(q, k, v, hi_lo=h, **_kw(case))[0], want)
               for h in (True, False)]
        _, plain = _plain_grads(q, k, v, do, _kw(case))
        rel = {how: [_rel(a, r) for a, r in zip(
            _bwd(case, len(name), p=how, ds=how)[1], plain)]
            for how in ("bf16", "hi_lo") if name in BWD_CASES}
        print(f"{name}: forward err/limit hi/lo {fwd[0]:.4f}, one bf16 P "
              f"{fwd[1]:.4f}; dq/dk/dv rel "
              + "; ".join(f"{how} " + "/".join(f"{x:.3e}" for x in r)
                          for how, r in rel.items()))
