"""Quantized weights and LoRA adapters of the port against the JAX
package's: ``repro_torch.quant`` and ``repro_torch.lora`` beside
``repro.quant`` and ``repro.lora`` on the same numpy inputs, with the
reference's dequant-matmul kernel in interpret mode (as its own tests run
it on the CPU), and the port's copies of every case of
``tests/test_quant_lora.py``."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import lora as jlora
from repro import quant as jquant
from repro.models import init_params as jax_init_params
from repro_torch import bridge, configs
from repro_torch.core import StatsDB, dtypes
from repro_torch.core import operators as F
from repro_torch.kernels.quant_matmul import (LAUNCHES, dequant_ref,
                                              quant_matmul)
from repro_torch.lora import (apply_inline, init_adapter,
                              init_adapters_for_tree, merge, merge_flops)
from repro_torch.quant import (QuantizedTensor, dequantize_weight,
                               quant_dense, quantize_tree, quantize_weight,
                               tree_storage_bytes)

RNG = np.random.default_rng(11)

#: (k, n, group_size): one group, a deep contraction, a ragged n at g=64
QUANT_SHAPES = [(256, 128, 128), (4096, 512, 128), (1024, 200, 64)]
#: both sides compute (w_q - zero) * scale and the product in f32 from the
#: same bits, summing in other orders: agreement to f32 rounding
F32_RTOL = 1e-5


def _np(dtype, arr):
    return arr.astype(ml_dtypes.bfloat16) if dtype == "bf16" else arr


def _jax_q(q) -> dict:
    return {"w_q": np.asarray(q.w_q), "scales": np.asarray(q.scales),
            "zeros": np.asarray(q.zeros), "group_size": q.group_size,
            "bits": q.bits}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint8)


def _assert_same_quantized(port: QuantizedTensor, ref) -> None:
    """Bit for bit: w_q, bf16 scales, bf16 zeros, and the metadata."""
    got = bridge.quantized_to_numpy(port)
    want = _jax_q(ref)
    for name in ("w_q", "scales", "zeros"):
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]),
                                      err_msg=name)
    assert (got["group_size"], got["bits"]) == (want["group_size"],
                                                want["bits"])


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,n,g", QUANT_SHAPES)
def test_quantize_weight_is_bit_exact(k, n, g, dtype, bits):
    w = _np(dtype, RNG.standard_normal((k, n)).astype(np.float32) * 0.05)
    ref = jquant.quantize_weight(jnp.asarray(w), group_size=g, bits=bits)
    port = quantize_weight(bridge.tensor_from_numpy(w, device="cpu"),
                           group_size=g, bits=bits)
    _assert_same_quantized(port, ref)
    assert port.shape == tuple(ref.shape)
    assert port.storage_bytes() == ref.storage_bytes()
    # dequantization is the same f32 arithmetic on the same bits
    np.testing.assert_array_equal(
        dequantize_weight(port, torch.float32).numpy(),
        np.asarray(jquant.dequantize_weight(ref, jnp.float32)))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("lead,k,n,g", [((16,), 256, 128, 128),
                                        ((5,), 1024, 200, 64),
                                        ((2, 3), 256, 384, 128)])
def test_quant_dense_matches_reference_kernel(lead, k, n, g, bits):
    """The port's plain path against the JAX ``quant_dense`` through its
    Pallas kernel in interpret mode, f32, at ``F32_RTOL`` of max|y|."""
    w = RNG.standard_normal((k, n)).astype(np.float32) * 0.05
    x = RNG.standard_normal((*lead, k)).astype(np.float32)
    ref_q = jquant.quantize_weight(jnp.asarray(w), group_size=g, bits=bits)
    want = np.asarray(jquant.quant_dense(jnp.asarray(x), ref_q,
                                         use_kernel=True))
    q = bridge.quantized_from_numpy(_jax_q(ref_q), device="cpu")
    before = dict(LAUNCHES)
    got = quant_dense(torch.from_numpy(x), q).numpy()
    assert LAUNCHES == before            # the CPU path launches nothing
    assert got.shape == want.shape == (*lead, n)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_RTOL * np.abs(want).max())
    plain = quant_dense(torch.from_numpy(x), q, use_kernel=False).numpy()
    np.testing.assert_allclose(plain, np.asarray(jquant.quant_dense(
        jnp.asarray(x), ref_q, use_kernel=False)), rtol=0,
        atol=F32_RTOL * np.abs(want).max())


def test_bf16_quant_dense_matches_reference_kernel():
    """bf16 x: both sides compute in f32 and round y once to bf16, so they
    differ by at most one bf16 ulp (2**-7 relative) plus f32 slack."""
    k, n, g = 512, 256, 128
    w = RNG.standard_normal((k, n)).astype(np.float32) * 0.05
    x = RNG.standard_normal((8, k)).astype(ml_dtypes.bfloat16)
    ref_q = jquant.quantize_weight(jnp.asarray(w), group_size=g)
    want = np.asarray(jquant.quant_dense(jnp.asarray(x), ref_q),
                      np.float32)
    q = bridge.quantized_from_numpy(_jax_q(ref_q), device="cpu")
    got = quant_dense(bridge.tensor_from_numpy(x, device="cpu"), q)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3)


def test_quant_matmul_refuses_bad_shapes():
    x = torch.zeros((4, 256))
    q = quantize_weight(torch.randn((256, 64)), group_size=128)
    with pytest.raises(ValueError, match="does not divide"):
        quant_matmul(x, q.w_q, q.scales, q.zeros, group_size=96)
    with pytest.raises(ValueError, match="disagree on k"):
        quant_matmul(torch.zeros((4, 128)), q.w_q, q.scales, q.zeros)
    with pytest.raises(ValueError, match="scales/zeros"):
        quant_matmul(x, q.w_q, q.scales[:1], q.zeros[:1])
    with pytest.raises(ValueError, match=r"\(m, k\)"):
        quant_matmul(x[None], q.w_q, q.scales, q.zeros)
    with pytest.raises(ValueError, match="group_size"):
        quantize_weight(torch.zeros((100, 8)), group_size=64)
    # dequant_ref is the reference oracle's order: (w_q - zero) * scale
    w = dequant_ref(q.w_q, q.scales, q.zeros, 128)
    first = (q.w_q[:128].float() - q.zeros[0].float()) * q.scales[0].float()
    assert torch.equal(w[:128], first)


def _flat(tree, prefix=""):
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", v


@pytest.mark.parametrize("arch", ["llama2-7b", "qwen2-7b"])
def test_quantize_tree_matches_reference(arch):
    """On reduced trees bridged from the reference's ``init_params``:
    the same leaves are quantized (the stacked layers are not 2-D, so
    exactly ``embed`` and ``lm_head``: the embedding too), bit for bit,
    with the same ``tree_storage_bytes``."""
    cfg = jconfigs.reduced(jconfigs.get(arch))
    tree = jax_init_params(cfg, jax.random.PRNGKey(0))
    ref = jquant.quantize_tree(tree)
    port = quantize_tree(bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu"))
    got = {k: v for k, v in _flat(port) if isinstance(v, QuantizedTensor)}
    assert sorted(got) == ["embed", "lm_head"]
    for key, q in got.items():
        _assert_same_quantized(q, ref[key])
    assert isinstance(ref["embed"], jquant.QuantizedTensor)
    assert tree_storage_bytes(port) == jquant.tree_storage_bytes(ref)
    # everything else crossed untouched
    plain = dict(_flat(bridge.params_to_numpy(
        {k: v for k, v in port.items() if k not in got})))
    want = dict(_flat(jax.tree_util.tree_map(
        np.asarray, {k: v for k, v in tree.items() if k not in got})))
    assert plain.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(_bits(plain[key]), _bits(want[key]))


def test_quantized_bridge_round_trip():
    w = RNG.standard_normal((256, 96)).astype(np.float32)
    ref = jquant.quantize_weight(jnp.asarray(w), bits=8)
    q = bridge.quantized_from_numpy(_jax_q(ref), device="cpu")
    assert q.w_q.dtype == torch.int8 and q.scales.dtype == torch.bfloat16
    back = bridge.quantized_to_numpy(q)
    for name in ("w_q", "scales", "zeros"):
        np.testing.assert_array_equal(_bits(back[name]),
                                      _bits(_jax_q(ref)[name]))


# ---------------------------------------------------------------------------
# the port's copies of tests/test_quant_lora.py
# ---------------------------------------------------------------------------

def test_quant_dense_matches_dequant_matmul():
    x = torch.from_numpy(RNG.standard_normal((16, 256)).astype(np.float32))
    w = torch.from_numpy(RNG.standard_normal((256, 128)).astype(np.float32)
                         * 0.05)
    q = quantize_weight(w, group_size=128, bits=4)
    via_kernel = quant_dense(x, q, use_kernel=True)
    via_dequant = quant_dense(x, q, use_kernel=False)
    np.testing.assert_allclose(via_kernel.numpy(), via_dequant.numpy(),
                               atol=1e-3, rtol=1e-3)
    # int4 over a 256-deep contraction of random gaussians lands around
    # 10% output norm — bound at 15%, as the reference's test does
    exact = x @ w
    rel = float(torch.linalg.norm(via_dequant - exact)
                / torch.linalg.norm(exact))
    assert rel < 0.15


def test_int8_tighter_than_int4():
    w = torch.from_numpy(RNG.standard_normal((512, 64)).astype(np.float32))
    e4 = float((dequantize_weight(quantize_weight(w, bits=4),
                                  torch.float32) - w).abs().max())
    e8 = float((dequantize_weight(quantize_weight(w, bits=8),
                                  torch.float32) - w).abs().max())
    assert e8 < e4


def test_quantize_tree_storage_matches_life_model():
    """Real quantized storage bytes == LIFE's analytical storage bytes."""
    k, n, g = 4096, 4096, 128
    w = torch.from_numpy(RNG.standard_normal((k, n)).astype(np.float32)
                         ).bfloat16()
    tree = quantize_tree({"w": w, "norm": torch.ones((k,),
                                                     dtype=torch.bfloat16)},
                         group_size=g, bits=4)
    assert isinstance(tree["w"], QuantizedTensor)
    assert tree["norm"].dtype == torch.bfloat16
    real = tree["w"].storage_bytes()
    analytical = dtypes.get("int4").storage_bytes(k * n, g)
    assert real == pytest.approx(analytical, rel=0.01)
    assert real == analytical                 # the same formula, exactly


def test_lora_merge_equals_inline():
    x = torch.from_numpy(RNG.standard_normal((8, 128)).astype(np.float32))
    w = torch.from_numpy(RNG.standard_normal((128, 64)).astype(np.float32)
                         * 0.1)
    gen = torch.Generator().manual_seed(0)
    ad = init_adapter(gen, 128, 64, rank=8, dtype=torch.float32)
    # randomize B so the adapter is non-trivial
    ad["B"] = torch.randn((8, 64), generator=gen) * 0.1
    merged = merge({"w": w}, {"w": ad})["w"]
    np.testing.assert_allclose((x @ merged).numpy(),
                               apply_inline(x, w, ad).numpy(), atol=1e-4)


def test_fresh_adapter_is_identity():
    x = torch.from_numpy(RNG.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy(RNG.standard_normal((64, 32)).astype(np.float32))
    ad = init_adapter(torch.Generator().manual_seed(0), 64, 32, rank=4,
                      dtype=torch.float32)
    np.testing.assert_allclose(apply_inline(x, w, ad).numpy(),
                               (x @ w).numpy(), atol=1e-5)


def test_merge_flops_matches_life_operator():
    db = StatsDB()
    F.lora_merge(db, 4096, 11008, 64)
    assert db.records[0].ops == merge_flops(4096, 11008, 64)
    assert merge_flops(4096, 11008, 64) == jlora.merge_flops(4096, 11008, 64)


def test_adapters_for_tree_skips_small():
    tree = {"big": torch.ones((512, 512)), "small": torch.ones((4, 4)),
            "vec": torch.ones((512,))}
    ads = init_adapters_for_tree(torch.Generator().manual_seed(0), tree,
                                 rank=4)
    assert ads["big"] is not None
    assert ads["small"] is None and ads["vec"] is None


def test_adapters_for_tree_compute_dtype_not_storage_dtype():
    """Adapters land in the compute dtype, not a quantized or
    low-precision base weight's storage dtype."""
    tree = {"w8": torch.ones((512, 512), dtype=torch.int8),
            "wb": torch.ones((512, 512), dtype=torch.bfloat16)}
    gen = torch.Generator().manual_seed(0)
    ads = init_adapters_for_tree(gen, tree, rank=4)
    assert ads["w8"]["A"].dtype == torch.bfloat16
    assert ads["w8"]["B"].dtype == torch.bfloat16
    assert ads["wb"]["A"].dtype == torch.bfloat16
    # explicit override still honored
    ads32 = init_adapters_for_tree(gen, tree, rank=4, dtype=torch.float32)
    assert ads32["w8"]["A"].dtype == torch.float32


# ---------------------------------------------------------------------------
# LoRA adapters across the packages
# ---------------------------------------------------------------------------

def test_adapter_trees_have_the_reference_structure():
    """The same leaves get adapters on both sides (shapes and dtypes);
    the draws differ (a torch.Generator against a JAX key)."""
    cfg = jconfigs.reduced(jconfigs.get("llama2-7b"))
    tree = jax_init_params(cfg, jax.random.PRNGKey(0))
    ref = jlora.init_adapters_for_tree(jax.random.PRNGKey(1), tree, rank=4,
                                       min_size=1 << 12)
    port_tree = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    port = init_adapters_for_tree(torch.Generator().manual_seed(1),
                                  port_tree, rank=4, min_size=1 << 12)

    def leaves(t, prefix=""):
        for key in sorted(t):
            v = t[key]
            if v is None or "A" in v:
                yield f"{prefix}{key}", v
            else:
                yield from leaves(v, f"{prefix}{key}/")

    got, want = dict(leaves(port)), dict(leaves(ref))
    assert got.keys() == want.keys()
    assert {k for k, v in want.items() if v is not None} == {"embed",
                                                               "lm_head"}
    for key, w in want.items():
        if w is None:
            assert got[key] is None, key
            continue
        for f in ("A", "B"):
            assert tuple(got[key][f].shape) == w[f].shape
            assert got[key][f].dtype == torch.bfloat16
        assert not got[key]["B"].any()           # fresh: the identity


def _adapter_layout(t):
    """(path, shapes) of every leaf of an adapter tree from either
    package: an adapter pair's (A, B) shapes, ``None``, or a quantized
    weight's node (its class name and metadata) with its fields below."""
    if t is None:
        yield "", None
    elif isinstance(t, dict) and "A" in t:
        yield "", (tuple(t["A"].shape), tuple(t["B"].shape))
    elif isinstance(t, dict):
        for key in sorted(t):
            for path, v in _adapter_layout(t[key]):
                yield f"/{key}{path}", v
    else:
        yield "", (type(t).__name__, t.group_size, t.bits)
        for field in ("w_q", "scales", "zeros"):
            for path, v in _adapter_layout(getattr(t, field)):
                yield f".{field}{path}", v


@pytest.mark.parametrize("min_size", [1 << 12, 1 << 16])
def test_adapters_for_a_quantized_tree_have_the_reference_structure(
        min_size):
    """On a quantized reduced tree carried across by the bridge, each
    quantized weight is visited as the reference flattens its pytree
    (w_q, scales, zeros): every 2-D field of at least ``min_size``
    elements gets a pair of its own shape, and the leaf is a
    ``QuantizedTensor`` of pairs, as the reference's ``tree_unflatten``
    builds it."""
    cfg = jconfigs.reduced(jconfigs.get("llama2-7b"))
    ref_tree = jquant.quantize_tree(jax_init_params(cfg,
                                                    jax.random.PRNGKey(0)))

    def carry(t):
        if isinstance(t, jquant.QuantizedTensor):
            return bridge.quantized_from_numpy(_jax_q(t), device="cpu")
        if isinstance(t, dict):
            return {k: carry(v) for k, v in t.items()}
        return bridge.tensor_from_numpy(np.asarray(t), device="cpu")

    port_tree = carry(ref_tree)
    ref = jlora.init_adapters_for_tree(jax.random.PRNGKey(1), ref_tree,
                                       rank=4, min_size=min_size)
    port = init_adapters_for_tree(torch.Generator().manual_seed(1),
                                  port_tree, rank=4, min_size=min_size)
    got, want = list(_adapter_layout(port)), list(_adapter_layout(ref))
    assert got == want
    assert isinstance(port["lm_head"], QuantizedTensor)
    assert port["lm_head"].w_q is not None       # the int values' own pair
    assert tuple(port["lm_head"].w_q["A"].shape) == (
        port_tree["lm_head"].w_q.shape[0], 4)


def test_merge_and_inline_match_reference():
    """One adapter pair carried across: ``merge`` and ``apply_inline``
    equal the reference's in f32 at f32 rounding."""
    k, n, r = 256, 96, 8
    w = RNG.standard_normal((k, n)).astype(np.float32) * 0.1
    x = RNG.standard_normal((6, k)).astype(np.float32)
    ad = {"A": RNG.standard_normal((k, r)).astype(np.float32) * r ** -0.5,
          "B": RNG.standard_normal((r, n)).astype(np.float32) * 0.1}
    tree = {"w": w, "norm": np.ones((k,), np.float32)}
    ads = {"w": ad, "norm": None}
    want = jlora.merge(jax.tree_util.tree_map(jnp.asarray, tree),
                       {"w": {f: jnp.asarray(a) for f, a in ad.items()},
                        "norm": None}, scale=0.5)
    port_ads = bridge.adapters_from_numpy(ads, device="cpu")
    assert port_ads["norm"] is None
    got = merge(bridge.params_from_numpy(tree, device="cpu"), port_ads,
                scale=0.5)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["norm"].numpy(), tree["norm"])
    inline = apply_inline(torch.from_numpy(x), torch.from_numpy(w),
                          port_ads["w"], scale=0.5)
    ref_inline = jlora.apply_inline(jnp.asarray(x), jnp.asarray(w),
                                    {f: jnp.asarray(a) for f, a in ad.items()},
                                    scale=0.5)
    np.testing.assert_allclose(inline.numpy(), np.asarray(ref_inline),
                               rtol=1e-5, atol=1e-5)
    back = bridge.adapters_to_numpy(port_ads)
    assert back["norm"] is None
    np.testing.assert_array_equal(back["w"]["A"], ad["A"])


def test_quantized_layer_through_both_packages_with_adapter():
    """A quantized projection plus an inline adapter: the port's plain
    ``quant_dense`` + delta equals the reference's kernel path + delta."""
    k, n, r = 256, 128, 4
    w = RNG.standard_normal((k, n)).astype(np.float32) * 0.05
    x = RNG.standard_normal((3, k)).astype(np.float32)
    A = RNG.standard_normal((k, r)).astype(np.float32) * 0.1
    B = RNG.standard_normal((r, n)).astype(np.float32) * 0.1
    ref_q = jquant.quantize_weight(jnp.asarray(w))
    jx = jnp.asarray(x)
    want = np.asarray(jquant.quant_dense(jx, ref_q)
                      + (jx @ jnp.asarray(A)) @ jnp.asarray(B))
    q = bridge.quantized_from_numpy(_jax_q(ref_q), device="cpu")
    tx = torch.from_numpy(x)
    got = (quant_dense(tx, q) + (tx @ torch.from_numpy(A))
           @ torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=F32_RTOL * np.abs(want).max())


def test_port_configs_are_the_references():
    import dataclasses
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    for name, cfg in jconfigs.ARCHS.items():
        assert dataclasses.asdict(configs.ARCHS[name]) == \
            dataclasses.asdict(cfg), name
    assert [f.name for f in dataclasses.fields(configs.ArchConfig)] == \
        [f.name for f in dataclasses.fields(jconfigs.ArchConfig)]
    assert {k: dataclasses.asdict(v) for k, v in
            configs.PAPER_VARIANTS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.PAPER_VARIANTS.items()}
