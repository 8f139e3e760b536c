"""The arithmetic of the tensor-core bodies of K5 (int4 dequant-matmul) and
K3 and K2 (paged verify and prefill, one body) and of K1's split-KV body
(paged decode), emulated on the CPU and held to ``kernel_tolerance``; the
grid plans of K1 and K4 (grouped LoRA).

A CUDA kernel cannot run here, so each body's rounding is emulated in
PyTorch: K5's zero-point split (``part = x_g . q_g - rowsum(x_g) *
zero_g``, ``acc += scale_g * part``: bf16 operands, exact products, f32
sums) and K3's FlashAttention-2 loop over 64-key tiles with an f32 online
softmax and P.V as two bf16 products, ``P_hi = bf16(P)`` and ``P_lo =
bf16(P - P_hi)``.  Each emulation is held at the main path's shapes to
the port's plain version and to the JAX package's function, at the
tolerance every kernel comparison uses (one bf16 ulp of each output plus
1e-3 of the mean magnitude).  One case per kernel shows that the design
with a single bf16 rounding (the weight dequantized to bf16; P rounded to
bf16) exceeds that limit: the reason the bodies are built as they are.
K1's split body computes in f32 throughout (every product of its bf16,
int8 or f32 operands is exact in f32), so its emulation differs from the
plain version only by where it cuts the sums: per lane group, per warp,
per split, and the combine in split order.
The wrappers' choices of body and grid are pure functions, tested here;
``tests/test_torch_gpu.py`` holds the bodies themselves on the card.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_decode as pallas_decode
from repro.kernels.paged_attention import paged_prefill as pallas_prefill
from repro.kernels.paged_attention import paged_verify as pallas_verify
from repro.kernels.quant_matmul.ref import quant_matmul_ref as jax_qmm_ref
from repro_torch.kernels.grouped_lora import ops as lora_ops
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (kernel_tolerance,
                                                     paged_decode_ref,
                                                     paged_prefill_ref,
                                                     paged_verify_ref)
from repro_torch.kernels.quant_matmul import ops as qmm_ops
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
from repro_torch.quant import quantize_weight

NEG_INF = -1e30
TILE_KEYS = 64


def _bf16(t: torch.Tensor):
    """A bf16 tensor as the same bf16 values in JAX."""
    return jnp.asarray(t.float().numpy().astype(ml_dtypes.bfloat16))


def _ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |out - ref| over the limit, the limit's scale being ref."""
    diff = (out.float() - ref.float()).abs()
    return float((diff / kernel_tolerance(ref, ref)).max())


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def k5_split(x, w_q, scales, zeros, g):
    """The bodies' arithmetic: per group, f32 sums of exact bf16 x int
    products, the f32 row sum times the zero, scaled into an f32 sum."""
    m, k = x.shape
    xf = x.float()
    acc = torch.zeros((m, w_q.shape[1]))
    for gi in range(k // g):
        xg = xf[:, gi * g:(gi + 1) * g]
        part = xg @ w_q[gi * g:(gi + 1) * g].float()
        part = part - xg.sum(1, keepdim=True) * zeros[gi].float()
        acc = acc + scales[gi].float() * part
    return acc.to(x.dtype)


def k5_bf16_weight(x, w_q, scales, zeros, g):
    """The single-rounding design: the weight dequantized to bf16, then a
    bf16 GEMM with f32 sums."""
    k, n = w_q.shape
    w = ((w_q.float().reshape(k // g, g, n) - zeros[:, None].float())
         * scales[:, None].float()).reshape(k, n)
    return (x.float() @ w.bfloat16().float()).to(x.dtype)


def _qmm_case(k, n, m, seed, bits=4, g=128):
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((k, n), generator=gen) * 0.02
    q = quantize_weight(w, group_size=g, bits=bits)
    x = torch.randn((m, k), generator=gen).bfloat16()
    return x, q


#: llama2-7b's linear shapes (k, n), n cut to 512 columns: every column is
#: computed on its own, so a slice has the full shape's per-column sums
QMM_MAIN = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]


@pytest.mark.parametrize("m", [4, 64, 256])
@pytest.mark.parametrize("k,n", QMM_MAIN,
                         ids=[f"{k}x{n}" for k, n in QMM_MAIN])
def test_k5_split_within_tolerance_of_plain_version(k, n, m):
    x, q = _qmm_case(k, 512, m, seed=k + n + m)
    got = k5_split(x, q.w_q, q.scales, q.zeros, 128)
    ref = quant_matmul_ref(x, q.w_q, q.scales, q.zeros, 128)
    assert _ratio(got, ref) <= 1.0


@pytest.mark.parametrize("bits,g", [(4, 128), (8, 128), (4, 64)])
def test_k5_split_within_tolerance_of_jax_reference(bits, g):
    x, q = _qmm_case(4096, 384, 64, seed=bits * g, bits=bits, g=g)
    got = k5_split(x, q.w_q, q.scales, q.zeros, g)
    want = jax_qmm_ref(_bf16(x), jnp.asarray(q.w_q.numpy()),
                       _bf16(q.scales), _bf16(q.zeros), g)
    want = torch.from_numpy(np.asarray(want, np.float32)).bfloat16()
    assert _ratio(got, want) <= 1.0


def test_k5_bf16_weight_exceeds_the_limit():
    """Rounding (q - zero) * scale to bf16 loses 5 of its 13 bits; at a
    256-row chunk through a 4096-deep projection the output moves by
    several times the limit, where the split stays inside it."""
    x, q = _qmm_case(4096, 1024, 256, seed=0)
    ref = quant_matmul_ref(x, q.w_q, q.scales, q.zeros, 128)
    assert _ratio(k5_bf16_weight(x, q.w_q, q.scales, q.zeros, 128), ref) > 2.0
    assert _ratio(k5_split(x, q.w_q, q.scales, q.zeros, 128), ref) <= 1.0


def test_k5_body_rule():
    body = qmm_ops.qmm_body
    threshold = qmm_ops.WGMMA_MIN_ROWS
    assert body(torch.bfloat16, threshold, 4096, 128) == "wgmma"
    assert body(torch.bfloat16, 256, 208, 64) == "wgmma"
    assert body(torch.bfloat16, threshold - 1, 4096, 128) == "splitk"
    assert body(torch.bfloat16, 256, 4096, 48) == "splitk"   # g % 64 != 0
    assert body(torch.bfloat16, 256, 200, 128) == "splitk"   # n % 16 != 0
    assert body(torch.float32, 256, 4096, 128) == "splitk"   # f32 x
    assert body(torch.float32, 4, 4096, 128) == "splitk"


@pytest.mark.parametrize("m,rows", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                    (8, 8), (9, 16), (63, 16)])
def test_splitk_plan_rows_and_scratch(m, rows):
    plan = qmm_ops.splitk_plan(m, 4096, 4096, 128, sm_count=132)
    assert plan.rows == rows
    groups = 4096 // 128
    assert (plan.splits - 1) * plan.groups_per_split < groups \
        <= plan.splits * plan.groups_per_split
    assert plan.scratch == ((plan.splits, m, 4096) if plan.splits > 1
                            else None)


def test_split_plans_fill_the_card():
    """Decode of 4 rows through a 4096 x 4096 projection has 32 column
    tiles: k is split until two blocks per SM are in the grid; lm_head's
    250 tiles need fewer splits, and a wgmma grid of 500 tiles none."""
    plan = qmm_ops.splitk_plan(4, 4096, 4096, 128, sm_count=132)
    assert (plan.splits, plan.groups_per_split) == (8, 4)
    assert plan.scratch == (8, 4, 4096)
    assert qmm_ops.splitk_plan(4, 4096, 32000, 128, 132).splits == 2
    assert qmm_ops.splitk_plan(1, 128, 64, 128, 132) == (1, 1, 1, None)
    assert qmm_ops.wgmma_plan(256, 4096, 32000, 128, 132) == (128, 1, 32,
                                                               None)
    plan = qmm_ops.wgmma_plan(64, 4096, 4096, 128, 132)
    assert (plan.splits, plan.groups_per_split) == (8, 4)
    assert plan.scratch == (8, 64, 4096)


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def k3_mma(q, ck, cv, bt, pos, hi_lo=True, key_end=None):
    """The mma body's arithmetic, block for block: 64-key tiles through the
    slot's table, scores as f32 sums of exact bf16 products, an f32 online
    softmax, P.V as P_hi.V + P_lo.V (or bf16(P).V alone with ``hi_lo``
    off); with ``verify_body``'s four key splits (each 16 keys of every
    tile, merged in split order) when a slot's rows fit one warp tile.
    ``key_end`` cuts the keys every row attends (K2's ``start + valid``);
    None is verify's "no limit past the causal one"."""
    S, Q, Hk, G, d = q.shape
    bs, nb = ck.shape[1], bt.shape[1]
    body, splits = pa_ops.verify_body(q.dtype, ck.dtype, d, Q * G)
    assert body == "mma"
    kw = TILE_KEYS // splits
    out = torch.empty((S, Q, Hk, G, d))
    for s in range(S):
        L = min(nb * bs, int(pos[s]) + Q if key_end is None else key_end)
        qpos = int(pos[s]) + torch.arange(Q * G) // G
        n_keys = min(int(qpos.max()) + 1, L)
        n_tiles = -(-n_keys // TILE_KEYS)
        pad = n_tiles * TILE_KEYS
        keys = torch.zeros((pad, Hk, d))
        vals = torch.zeros((pad, Hk, d))
        keys[:n_keys] = ck[bt[s].long()].reshape(-1, Hk, d)[:n_keys].float()
        vals[:n_keys] = cv[bt[s].long()].reshape(-1, Hk, d)[:n_keys].float()
        for h in range(Hk):
            qs = q[s, :, h].reshape(Q * G, d).float()
            m = torch.full((splits, Q * G), NEG_INF)
            l = torch.zeros((splits, Q * G))
            acc = torch.zeros((splits, Q * G, d))
            for j in range(n_tiles):
                for w in range(splits):
                    kp = j * TILE_KEYS + w * kw + torch.arange(kw)
                    live = (kp[None] <= qpos[:, None]) & (kp[None] < L)
                    sc = (qs @ keys[kp, h].T) * d ** -0.5
                    sc = torch.where(live, sc, torch.tensor(NEG_INF))
                    mn = torch.maximum(m[w], sc.max(1).values)
                    alpha = torch.exp(m[w] - mn)
                    p = torch.where(live, torch.exp(sc - mn[:, None]),
                                    torch.tensor(0.0))
                    l[w] = l[w] * alpha + p.sum(1)
                    p_hi = p.bfloat16().float()
                    pv = p_hi @ vals[kp, h]
                    if hi_lo:
                        pv = pv + (p - p_hi).bfloat16().float() @ vals[kp, h]
                    acc[w] = acc[w] * alpha[:, None] + pv
                    m[w] = mn
            mx = m.max(0).values
            f = torch.exp(m - mx)
            tot_l = (l * f).sum(0)
            tot = (acc * f[:, :, None]).sum(0)
            o = tot / torch.clamp(tot_l, min=1e-30)[:, None]
            out[s, :, h] = o.reshape(Q, G, d)
    return out.to(q.dtype)


def k2_mma(q, ck, cv, table, start, valid, hi_lo=True):
    """K2 on the mma body: one slot's chunk q (C, Hk, G, d) as K3's body
    at S = 1 and pos = start, the keys cut at start + valid."""
    C, Hk, G, d = q.shape
    assert pa_ops.prefill_body(q.dtype, ck.dtype, d, C * G) \
        == pa_ops.verify_body(q.dtype, ck.dtype, d, C * G)
    return k3_mma(q[None], ck, cv, table[None],
                  torch.tensor([start], dtype=torch.int32), hi_lo=hi_lo,
                  key_end=start + valid)[0]


def _verify_case(S, Q, Hk, G, d, cursors, kv=torch.bfloat16, nb=37, bs=16,
                 seed=0):
    gen = torch.Generator().manual_seed(seed)
    N = S * nb + 8
    if kv == torch.int8:
        ck = torch.randint(-40, 41, (N, bs, Hk, d), generator=gen,
                           dtype=torch.int8)
        cv = torch.randint(-40, 41, (N, bs, Hk, d), generator=gen,
                           dtype=torch.int8)
    else:
        ck = torch.randn((N, bs, Hk, d), generator=gen).to(kv)
        cv = torch.randn((N, bs, Hk, d), generator=gen).to(kv)
    bt = torch.randperm(N, generator=gen)[:S * nb].reshape(S, nb).int()
    q = torch.randn((S, Q, Hk, G, d), generator=gen).bfloat16()
    return q, ck, cv, bt, torch.tensor(cursors, dtype=torch.int32)


#: the main path's K3 shapes (llama2-7b: G = 1, d = 128; 4 slots; a table
#: of 37 blocks of 16) with its 32 KV heads cut to 2 (each head is computed
#: on its own): the speculative pass's 5 queries at cursors 540-552, and
#: bucketed admission's 256-row chunks at cursors 0 and 256; then qwen2-7b's
#: G = 7 at 5 queries, and a padded last chunk whose rows leave the table
VERIFY_MAIN = [(5, 1, [540, 544, 548, 552]), (256, 1, [0, 0, 0, 0]),
               (256, 1, [256, 256, 256, 256]), (5, 7, [540, 17, 300, 0]),
               (32, 1, [37 * 16 - 20, 0, 64, 100])]


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Q,G,cursors", VERIFY_MAIN,
                         ids=[f"Q{c[0]}-G{c[1]}-pos{c[2][0]}"
                              for c in VERIFY_MAIN])
def test_k3_hi_lo_within_tolerance_of_plain_version(Q, G, cursors, kv):
    q, ck, cv, bt, pos = _verify_case(4, Q, 2 if G == 1 else 1, G, 128,
                                      cursors, kv=kv, seed=Q + G)
    got = k3_mma(q, ck, cv, bt, pos)
    ref = paged_verify_ref(q, ck, cv, bt, pos)
    assert _ratio(got, ref) <= 1.0


@pytest.mark.parametrize("Q,G,d", [(5, 1, 128), (24, 1, 128), (3, 7, 32)])
def test_k3_hi_lo_within_tolerance_of_jax_kernel(Q, G, d):
    """Against the reference's Pallas kernel in interpret mode, as its
    own tests run it on the CPU."""
    q, ck, cv, bt, pos = _verify_case(2, Q, 1, G, d, [40, 100], nb=8,
                                      seed=d + Q)
    got = k3_mma(q, ck, cv, bt, pos)
    want = pallas_verify(_bf16(q), _bf16(ck), _bf16(cv),
                         jnp.asarray(bt.numpy()), jnp.asarray(pos.numpy()))
    want = torch.from_numpy(np.asarray(want, np.float32)).bfloat16()
    assert _ratio(got, want) <= 1.0


def test_k3_single_bf16_p_exceeds_the_limit():
    """P rounded once to bf16 keeps 8 of its bits; over a 256-row chunk at
    cursor 256 the output moves by several times the limit, where the
    hi/lo split stays inside it."""
    q, ck, cv, bt, pos = _verify_case(2, 256, 2, 1, 128, [256, 256], seed=0)
    ref = paged_verify_ref(q, ck, cv, bt, pos)
    assert _ratio(k3_mma(q, ck, cv, bt, pos, hi_lo=False), ref) > 2.0
    assert _ratio(k3_mma(q, ck, cv, bt, pos), ref) <= 1.0


@pytest.mark.parametrize("q_dtype,kv_dtype,d,rows,want", [
    (torch.bfloat16, torch.bfloat16, 128, 5, ("mma", 4)),
    (torch.bfloat16, torch.bfloat16, 128, 16, ("mma", 4)),
    (torch.bfloat16, torch.int8, 128, 17, ("mma", 1)),
    (torch.bfloat16, torch.bfloat16, 32, 256, ("mma", 1)),
    (torch.bfloat16, torch.bfloat16, 16, 35, ("mma", 1)),
    (torch.float32, torch.bfloat16, 128, 5, ("rows", 1)),
    (torch.float32, torch.float32, 128, 5, ("rows", 1)),
    (torch.bfloat16, torch.float32, 128, 5, ("rows", 1)),
    (torch.bfloat16, torch.bfloat16, 136, 5, ("rows", 1)),
    (torch.bfloat16, torch.bfloat16, 40, 5, ("rows", 1)),
    (torch.bfloat16, torch.bfloat16, 256, 5, ("rows", 1)),
])
def test_verify_body_rule(q_dtype, kv_dtype, d, rows, want):
    assert pa_ops.verify_body(q_dtype, kv_dtype, d, rows) == want


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

#: the chunks chip_smoke.py holds K2 to: an admission chunk, one at start
#: > 0 with valid < C that starts mid-block, and a short tail chunk, whose
#: key limit lies below the causal limit of every padding row
PREFILL_CHUNKS = [(0, 256), (200, 77), (520, 3)]


def _prefill_case(C, Hk, G, d, kv, nb=37, bs=16, seed=0):
    q, ck, cv, bt, _ = _verify_case(1, C, Hk, G, d, [0], kv=kv, nb=nb,
                                    bs=bs, seed=seed)
    return q[0], ck, cv, bt[0]


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("start,valid", PREFILL_CHUNKS)
def test_k2_hi_lo_within_tolerance_of_plain_version(start, valid, G, kv):
    """C = 256 chunks (llama2-7b's G = 1 with its 32 KV heads cut to 2,
    qwen2-7b's G = 7 at one KV head: each head is computed on its own),
    every row held, the padding rows too (they attend every key below
    start + valid, as the reference's do, and stay finite)."""
    q, ck, cv, table = _prefill_case(256, 2 if G == 1 else 1, G, 128, kv,
                                     seed=start + valid + G)
    got = k2_mma(q, ck, cv, table, start, valid)
    ref = paged_prefill_ref(q, ck, cv, table, start, valid)
    assert bool(torch.isfinite(got.float()).all())
    assert _ratio(got, ref) <= 1.0


@pytest.mark.parametrize("G,d", [(1, 128), (7, 32)])
@pytest.mark.parametrize("start,valid", [(0, 24), (13, 9), (40, 3)])
def test_k2_hi_lo_within_tolerance_of_jax_kernel(start, valid, G, d):
    """Against the reference's Pallas kernel in interpret mode (bf16 KV),
    as its own tests run it, on the live rows they compare; C = 24 keeps
    the chunk at one or two 64-row tiles or splits its keys four ways."""
    q, ck, cv, table = _prefill_case(24 if G == 1 else 2, 1, G, d,
                                     torch.bfloat16, nb=8, seed=d + start)
    valid = min(valid, q.shape[0])
    got = k2_mma(q, ck, cv, table, start, valid)
    want = pallas_prefill(_bf16(q), _bf16(ck), _bf16(cv),
                          jnp.asarray(table.numpy()), jnp.int32(start),
                          jnp.int32(valid))
    want = torch.from_numpy(np.asarray(want, np.float32)).bfloat16()
    assert _ratio(got[:valid], want[:valid]) <= 1.0


def test_k2_single_bf16_p_exceeds_the_limit():
    """As for K3: one bf16 rounding of P misses the limit on a 256-row
    chunk at start 256, where hi/lo P stays inside it."""
    q, ck, cv, table = _prefill_case(256, 2, 1, 128, torch.bfloat16, seed=1)
    ref = paged_prefill_ref(q, ck, cv, table, 256, 256)
    assert _ratio(k2_mma(q, ck, cv, table, 256, 256, hi_lo=False), ref) > 2.0
    assert _ratio(k2_mma(q, ck, cv, table, 256, 256), ref) <= 1.0


@pytest.mark.parametrize("q_dtype,kv_dtype,d,rows,want", [
    (torch.bfloat16, torch.bfloat16, 128, 256, ("mma", 1)),
    (torch.bfloat16, torch.int8, 128, 1792, ("mma", 1)),
    (torch.bfloat16, torch.bfloat16, 64, 16, ("mma", 4)),
    (torch.bfloat16, torch.int8, 32, 8, ("mma", 4)),
    (torch.float32, torch.bfloat16, 128, 256, ("rows", 1)),
    (torch.float32, torch.int8, 128, 256, ("rows", 1)),
    (torch.bfloat16, torch.float32, 128, 256, ("rows", 1)),
    (torch.bfloat16, torch.bfloat16, 40, 256, ("rows", 1)),
    (torch.bfloat16, torch.bfloat16, 256, 256, ("rows", 1)),
])
def test_prefill_body_rule(q_dtype, kv_dtype, d, rows, want):
    assert pa_ops.prefill_body(q_dtype, kv_dtype, d, rows) == want


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def _merge(m, l, acc, m_o, l_o, acc_o):
    """Two online-softmax states (max, sum, accumulator) as one."""
    mn = torch.maximum(m, m_o)
    fa, fb = torch.exp(m - mn), torch.exp(m_o - mn)
    return mn, l * fa + l_o * fb, acc * fa[..., None] + acc_o * fb[..., None]


def k1_split(q, ck, cv, bt, pos, Hk_plan=None, sm_count=132):
    """The split body's arithmetic, block for block: the table cut into
    ``decode_split_plan``'s splits; in a split, key i goes to warp
    (i // chunk) % 4, its step i // (4 * chunk), and the lane group i %
    kpr, where a key row takes lpk lanes (kpr = 32 / lpk keys per warp
    load, U of them per lane and step: chunk = kpr * U keys); each lane
    group runs an f32 online softmax over its keys, one update per step;
    the groups of a warp merge pairwise (the shuffle butterfly), the four
    warps in warp order, and the live splits in split order.  ``Hk_plan``
    is the KV head count the plan sees (a test may compute fewer heads:
    each is computed on its own)."""
    S, Hk, G, d = q.shape
    bs, nb = ck.shape[1], bt.shape[1]
    plan = pa_ops.decode_split_plan(S, Hk_plan or Hk, G, nb, bs, sm_count)
    split_keys = plan.split_blocks * bs
    lpk = 1
    while 8 * lpk < d:
        lpk *= 2
    kpr = 32 // lpk
    U = 8 if G <= 2 else 4
    chunk = kpr * U
    neg = torch.tensor(NEG_INF)
    out = torch.empty((S, Hk, G, d))
    for s in range(S):
        key_lim = max(1, min(int(pos[s]) + 1, nb * bs))
        keys = ck[bt[s].long()].reshape(-1, Hk, d)[:key_lim].float()
        vals = cv[bt[s].long()].reshape(-1, Hk, d)[:key_lim].float()
        parts = []
        for k0 in range(0, key_lim, split_keys):
            n = min(split_keys, key_lim - k0)
            steps = -(-n // (4 * chunk))
            pad = steps * 4 * chunk
            live = torch.arange(pad) < n
            sc = torch.einsum("hgd,thd->hgt", q[s].float(),
                              keys[k0:k0 + n]) * d ** -0.5
            sc = torch.cat([sc, torch.zeros((Hk, G, pad - n))], -1)
            v = torch.cat([vals[k0:k0 + n], torch.zeros((pad - n, Hk, d))])
            # key i = ((step * 4 + warp) * U + u) * kpr + kg
            sc = sc.reshape(Hk, G, steps, 4, U, kpr).permute(0, 1, 3, 5, 2, 4)
            live = live.reshape(steps, 4, U, kpr).permute(1, 3, 0, 2)
            v = v.reshape(steps, 4, U, kpr, Hk, d).permute(4, 1, 3, 0, 2, 5)
            m = torch.full((Hk, G, 4, kpr), NEG_INF)
            l = torch.zeros((Hk, G, 4, kpr))
            acc = torch.zeros((Hk, G, 4, kpr, d))
            for t in range(steps):
                st = torch.where(live[:, :, t], sc[..., t, :], neg)
                mx = torch.maximum(m, st.max(-1).values)
                alpha = torch.exp(m - mx)
                p = torch.where(live[:, :, t], torch.exp(st - mx[..., None]),
                                torch.tensor(0.0))
                l = l * alpha + p.sum(-1)
                acc = (acc * alpha[..., None]
                       + torch.einsum("hgwku,hwkud->hgwkd", p, v[:, :, :, t]))
                m = mx
            o = 1
            while o < kpr:                      # the lane groups' butterfly
                perm = torch.arange(kpr) ^ o
                m, l, acc = _merge(m, l, acc, m[..., perm], l[..., perm],
                                   acc[..., perm, :])
                o *= 2
            m, l, acc = m[..., 0], l[..., 0], acc[..., 0, :]
            mw, lw, aw = m[..., 0], l[..., 0], acc[..., 0, :] * 0.0
            mw = m.max(-1).values                  # the warps, in order
            lw = torch.zeros_like(lw)
            for w in range(4):
                f = torch.exp(m[..., w] - mw)
                lw = lw + l[..., w] * f
                aw = aw + acc[..., w, :] * f[..., None]
            parts.append((mw, lw, aw))
        mx = torch.stack([p[0] for p in parts]).max(0).values
        tot_l = torch.zeros((Hk, G))
        tot = torch.zeros((Hk, G, d))
        for mj, lj, aj in parts:                   # the combine, in order
            f = torch.exp(mj - mx)
            tot_l = tot_l + lj * f
            tot = tot + aj * f[..., None]
        out[s] = tot / torch.clamp(tot_l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _decode_case(S, Hk, G, d, cursors, kv, q_dtype=torch.bfloat16, nb=37,
                 bs=16, seed=0):
    q, ck, cv, bt, pos = _verify_case(S, 1, Hk, G, d, cursors, kv=kv, nb=nb,
                                      bs=bs, seed=seed)
    return q[:, 0].to(q_dtype), ck, cv, bt, pos


def _ratio_v(out, ref, cv):
    """Largest |out - ref| over ``kernel_tolerance(ref, cv)``: for f32
    outputs the limit's scale is max|v|, as on the card."""
    diff = (out.float() - ref.float()).abs()
    return float((diff / kernel_tolerance(ref, cv)).max())


#: a fresh slot, both sides of a block seam, deep in the table, and the
#: table's last position: some splits empty, some ending mid-block
DECODE_CURSORS = [0, 15, 16, 300, 37 * 16 - 1]
#: llama2-7b's (Hk, G) = (32, 1) and qwen2-7b's (4, 7) KV heads at d = 128
DECODE_HEADS = [(32, 1), (4, 7)]


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Hk,G", DECODE_HEADS,
                         ids=[f"Hk{h}-G{g}" for h, g in DECODE_HEADS])
def test_k1_split_within_tolerance_of_plain_version(Hk, G, kv, q_dtype):
    q, ck, cv, bt, pos = _decode_case(5, Hk, G, 128, DECODE_CURSORS, kv,
                                      q_dtype, seed=Hk + G)
    got = k1_split(q, ck, cv, bt, pos)
    ref = paged_decode_ref(q, ck, cv, bt, pos)
    assert got.dtype == ref.dtype
    assert _ratio_v(got, ref, cv) <= 1.0


@pytest.mark.parametrize("kv", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("Hk,G", DECODE_HEADS,
                         ids=[f"Hk{h}-G{g}" for h, g in DECODE_HEADS])
def test_k1_split_within_tolerance_of_jax_kernel(Hk, G, kv):
    """Against the reference's Pallas kernel in interpret mode, as its own
    tests run it on the CPU; llama2-7b's 32 KV heads are cut to 2 (each
    head is computed on its own; the split plan still sees 32)."""
    q, ck, cv, bt, pos = _decode_case(5, min(Hk, 4) if G > 1 else 2, G, 128,
                                      DECODE_CURSORS, kv, seed=Hk * G)
    got = k1_split(q, ck, cv, bt, pos, Hk_plan=Hk)
    kvj = _bf16 if kv == torch.bfloat16 else (lambda t: jnp.asarray(t.numpy()))
    want = pallas_decode(_bf16(q), kvj(ck), kvj(cv), jnp.asarray(bt.numpy()),
                         jnp.asarray(pos.numpy()))
    want = torch.from_numpy(np.asarray(want, np.float32)).bfloat16()
    assert _ratio_v(got, want, cv) <= 1.0


@pytest.mark.parametrize("S,Hk,G,nb,bs", [
    (4, 32, 1, 37, 16),      # the main path: llama2-7b, 4 slots
    (4, 4, 7, 37, 16),       # qwen2-7b
    (1, 32, 1, 37, 16),      # one slot
    (4, 2, 16, 37, 16),      # G > 8: two row groups
    (64, 32, 1, 256, 16),    # many slots: the grid is full without splits
    (2, 2, 2, 5, 8),         # a short table
    (4, 8, 4, 2048, 16),     # a long table
])
def test_decode_split_plan(S, Hk, G, nb, bs):
    """Splits cover the table in equal runs of whole blocks (the last may
    be shorter), hold at least 64 keys where the table has them, and fill
    two blocks per SM wherever that still leaves 64 keys a split; the plan
    reads shapes only, never a cursor."""
    plan = pa_ops.decode_split_plan(S, Hk, G, nb, bs, sm_count=132)
    assert (plan.splits - 1) * plan.split_blocks < nb \
        <= plan.splits * plan.split_blocks
    assert plan.split_blocks * bs >= min(64, nb * bs)
    blocks = plan.splits * S * Hk * -(-G // 8)
    if nb * bs >= 64 * -(-2 * 132 // (S * Hk * -(-G // 8))):
        assert blocks >= 2 * 132
    assert "pos" not in pa_ops.decode_split_plan.__code__.co_varnames


def test_decode_split_plan_at_the_main_path():
    """llama2-7b's 4 slots: 128 (slot, head) pairs, 4 splits of 12 blocks
    (512 blocks); qwen2-7b's 16 pairs, 10 splits of 4 blocks (160: two
    per SM would leave splits of 32 keys, which ran slower)."""
    assert pa_ops.decode_split_plan(4, 32, 1, 37, 16, 132) == (4, 12)
    assert pa_ops.decode_split_plan(4, 4, 7, 37, 16, 132) == (10, 4)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,T,k,ns,want", [
    # decode and speculative verify at llama2-7b's 4096: 32 slices
    (4, 1, 4096, [4096], (32, 128, 1)),
    (4, 5, 4096, [4096], (32, 128, 1)),
    # a prefill chunk's q/k/v in one launch, and bucketed admission's o
    (1, 256, 4096, [4096, 4096, 4096], (17, 248, 4)),
    (4, 256, 4096, [4096], (5, 824, 4)),
    # qwen2-7b's q/k/v (3584 -> 3584, 512, 512), and a narrow k
    (1, 256, 3584, [3584, 512, 512], (17, 216, 4)),
    (2, 40, 320, [300], (5, 64, 1)),
])
def test_lora_split_plan(S, T, k, ns, want):
    """Phase 1 fills two blocks per SM where k and the 32-slice cap allow
    (slices of at least 64, a multiple of 8, covering k with none empty);
    phase 2 takes up to four column tiles per block while its grid keeps
    two per SM."""
    plan = lora_ops.split_plan(S, T, k, ns, sm_count=132)
    assert tuple(plan) == want
    assert plan.k_split % 8 == 0
    assert (plan.splits - 1) * plan.k_split < k <= plan.splits * plan.k_split
    assert plan.splits <= 32
