"""MoE and VLM decoders of the port against the JAX package: the MoE
layer (router, capacity-bounded dispatch, shared experts) in both
dispatch modes, the full forward with its aux loss and a VLM's vision
prefix, the training loss and its gradients, and the VLM data batches.
Reduced qwen2-moe-a2.7b and deepseek-moe-16b (E = 8, top-2; the
reference pads E to 16) and internvl2-26b (an 8-patch prefix), f32
weights carried across by the bridge (``test_torch_train._weights``)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.models import blocks as jblocks
from repro.models import forward as jax_forward
from repro.runtime import make_loss_fn as jax_make_loss_fn
from repro_torch import bridge, configs
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import blocks, forward
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import make_loss_fn
from test_torch_train import TOL, _weights

MOE_ARCHS = ["qwen2-moe-a2.7b", "deepseek-moe-16b"]


def _layer0(tree):
    return {k: v[0] for k, v in tree["layers"]["mlp"].items()}


def dropped_pairs(sel: torch.Tensor, n_experts: int, capacity: int) -> int:
    """(token, choice) pairs past their expert's capacity, per row of sel
    (b, s, k), in the flat order the dispatch assigns slots in."""
    flat = sel.reshape(sel.shape[0], -1)
    onehot = F.one_hot(flat, n_experts)
    pos = torch.gather(onehot.cumsum(1) - onehot, 2, flat[..., None])
    return int((pos >= capacity).sum())


def record_dispatches(monkeypatch):
    """Patch the port's MoE dispatch to record, for every call, the rows
    routed ``(b, n)`` and the (token, choice) pairs dropped; returns the
    list the records go to."""
    seen = []
    real = blocks._dispatch_combine

    def counted(p, x, weights, sel, n_experts, capacity):
        seen.append((tuple(x.shape[:2]),
                     dropped_pairs(sel, n_experts, capacity)))
        return real(p, x, weights, sel, n_experts, capacity)

    monkeypatch.setattr(blocks, "_dispatch_combine", counted)
    return seen


@pytest.fixture
def drops(monkeypatch):
    return record_dispatches(monkeypatch)


@pytest.fixture
def dispatch_mode(request):
    """Both packages' ``MOE_DISPATCH`` set to the case's mode."""
    old = jblocks.MOE_DISPATCH, blocks.MOE_DISPATCH
    jblocks.MOE_DISPATCH = blocks.MOE_DISPATCH = request.param
    yield request.param
    jblocks.MOE_DISPATCH, blocks.MOE_DISPATCH = old


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS + ["internvl2-26b"])
def test_configs_match_reference(arch):
    """Full and reduced configs, and the analytical parameter counts."""
    for make in (lambda m, a: m.get(a), lambda m, a: m.reduced(m.get(a))):
        assert (dataclasses.asdict(make(configs, arch))
                == dataclasses.asdict(make(jconfigs, arch)))
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("dispatch_mode", ["local", "global", "a2a"],
                         indirect=True)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_matches_reference(arch, dispatch_mode):
    """Output and aux to 1e-5 relative on a (2, 32) input whose routing
    overflows some experts' capacity, so tokens are dropped.  "a2a" has
    no mesh on one device and falls back to "local" in both packages."""
    cfg, jtree, ttree = _weights(arch)
    jp, tp = _layer0(jtree), _layer0(ttree)
    x = np.random.default_rng(1).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    want, jaux = jblocks.moe_forward(jconfigs.reduced(jconfigs.get(arch)),
                                     jp, jnp.asarray(x))
    got, aux = blocks.moe_forward(cfg, tp, torch.from_numpy(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    _, sel, _ = blocks._router(cfg, tp, torch.from_numpy(x))
    rows, tokens = ((1, 64) if dispatch_mode == "global" else (2, 32))
    capacity = math.ceil(tokens * cfg.top_k * 1.25 / cfg.n_experts)
    assert dropped_pairs(sel.reshape(rows, tokens, -1), cfg.n_experts,
                         capacity) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_ties_pick_the_lower_index_like_top_k(arch):
    """A router of zeros gives every expert the same probability:
    ``lax.top_k`` then picks experts 0 .. k-1, and so must the port."""
    cfg, jtree, ttree = _weights(arch)
    jp, tp = _layer0(jtree), _layer0(ttree)
    jp["router"] = jnp.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)
    jw, jsel, _ = jblocks._router(jconfigs.reduced(jconfigs.get(arch)), jp,
                                  jnp.asarray(x))
    w, sel, _ = blocks._router(cfg, tp, torch.from_numpy(x))
    assert (sel == torch.arange(cfg.top_k)).all()
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


def test_bf16_moe_forward_within_the_reference_tolerance():
    """bf16 weights and input: the same experts chosen for every token,
    and the output within the reference's own bf16 limit for its MoE
    layer (2e-2 max abs, ``tests/test_moe_a2a.py``)."""
    arch = "qwen2-moe-a2.7b"
    cfg, jtree, _ = _weights(arch)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                _layer0(jtree))
    tp = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    xb = jnp.asarray(np.random.default_rng(1).standard_normal(
        (2, 32, cfg.d_model)), jnp.bfloat16)
    x = bridge.tensor_from_numpy(np.asarray(xb), device="cpu")
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    want, jaux = jblocks.moe_forward(jcfg, jp, xb)
    got, aux = blocks.moe_forward(cfg, tp, x)
    assert got.dtype == torch.bfloat16
    _, jsel, _ = jblocks._router(jcfg, jp, xb)
    _, sel, _ = blocks._router(cfg, tp, x)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert dropped_pairs(sel, cfg.n_experts, math.ceil(
        32 * cfg.top_k * 1.25 / cfg.n_experts)) > 0
    err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
    assert err < 2e-2, err
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

def _vision(cfg, b=2, seed=3):
    """bf16 patch embeddings, as the reference's batches carry them."""
    ve = jnp.asarray(np.random.default_rng(seed).standard_normal(
        (b, cfg.vision_prefix_len, cfg.d_model)), jnp.bfloat16)
    return ve, bridge.tensor_from_numpy(np.asarray(ve), device="cpu")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS + ["internvl2-26b"])
def test_forward_matches_reference(arch, remat, drops):
    """Logits and the summed aux loss (the MoE cases drop tokens); a VLM
    with its vision prefix (logits over prefix + text positions)."""
    cfg, jtree, ttree = _weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 40))
    kw, jkw = {}, {}
    if cfg.family == "vlm":
        jkw["vision_embeds"], kw["vision_embeds"] = _vision(cfg)
    want, jaux = jax_forward(jcfg, jtree, jnp.asarray(toks, jnp.int32),
                             remat=remat, **jkw)
    got, aux = forward(cfg, ttree, torch.from_numpy(toks), remat=remat, **kw)
    assert got.shape == want.shape == (2, 40 + cfg.vision_prefix_len,
                                       cfg.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert (float(aux) > 0) == (cfg.family == "moe")
    assert (sum(d for _, d in drops) > 0) == (cfg.family == "moe")


def test_vlm_forward_without_vision_is_text_only():
    """No ``vision_embeds``: the text alone, as the reference (and both
    engines) serve a VLM."""
    cfg, jtree, ttree = _weights("internvl2-26b")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 12))
    want, _ = jax_forward(jconfigs.reduced(jconfigs.get("internvl2-26b")),
                          jtree, jnp.asarray(toks, jnp.int32))
    got, _ = forward(cfg, ttree, torch.from_numpy(toks))
    assert got.shape == (1, 12, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", MOE_ARCHS + ["internvl2-26b"])
def test_loss_and_grads_match_reference(arch, use_flash, drops):
    """``jax.value_and_grad`` of the reference's loss (ce + 0.01 aux; a
    VLM's logits sliced past its prefix) against autograd's, on the data
    pipeline's batches: loss, ce, aux and every leaf's gradient."""
    cfg, jtree, ttree = _weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    seq = 32 + cfg.vision_prefix_len
    jb = JaxSyntheticTokens(jcfg, JaxDataConfig(2, seq, seed=4)).batch(0)
    tb = SyntheticTokens(cfg, DataConfig(2, seq, seed=4),
                         device="cpu").batch(0)
    if cfg.family == "vlm":
        # the batches' embeddings, crossed from the reference's bit for bit
        tb["vision_embeds"] = bridge.tensor_from_numpy(
            np.asarray(jb["vision_embeds"]), device="cpu")
    jloss_fn = jax_make_loss_fn(jcfg, use_flash=use_flash, remat=True)
    (jloss, jparts), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jtree, jb)
    loss_fn = make_loss_fn(cfg, use_flash=use_flash, remat=True)
    leaves = [p.requires_grad_() for p in tree_leaves(ttree)]
    loss, parts = loss_fn(ttree, tb)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(parts[key].detach()),
                                   float(jparts[key]), **TOL)
    assert (float(parts["aux"].detach()) > 0) == (cfg.family == "moe")
    assert (sum(d for _, d in drops) > 0) == (cfg.family == "moe")
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(jg).max(), 1e-3))


# ---------------------------------------------------------------------------
# VLM batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mean_doc_len", [0, 8])
def test_vlm_synthetic_tokens_match_reference(mean_doc_len):
    """A VLM batch: the prefix's embeddings (b, P, d) in bf16 and
    ``seq_len - P`` text tokens, equal to the reference's bit for bit."""
    arch = "internvl2-26b"
    cfg = configs.reduced(configs.get(arch))
    data = dict(global_batch=3, seq_len=24, seed=5,
                mean_doc_len=mean_doc_len)
    td = SyntheticTokens(cfg, DataConfig(**data), device="cpu")
    jd = JaxSyntheticTokens(jconfigs.reduced(jconfigs.get(arch)),
                            JaxDataConfig(**data))
    for step in (0, 3):
        got, ref = td.batch(step), jd.batch(step)
        assert sorted(got) == sorted(ref)
        P = cfg.vision_prefix_len
        assert got["vision_embeds"].shape == (3, P, cfg.d_model)
        assert got["vision_embeds"].dtype == torch.bfloat16
        assert got["inputs"].shape == (3, 24 - P)
        for k in ref:
            assert tuple(got[k].shape) == ref[k].shape, k
            np.testing.assert_array_equal(bridge.tensor_to_numpy(got[k]),
                                          np.asarray(ref[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

def test_serve_launcher_serves_moe(capsys):
    from repro_torch.launch import serve
    summary = serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced",
                          "--device", "cpu", "--requests", "3",
                          "--max-slots", "2", "--prompt-len", "16",
                          "--new-tokens", "6", "--chunk", "8",
                          "--attn-impl", "paged", "--spec-k", "2"])
    assert summary["arch"] == "qwen2-moe-a2.7b-reduced"
    assert summary["tps"] > 0 and summary["spec_tokens_per_step"] >= 1
    assert "[LIFE twin" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "internvl2-26b"])
def test_train_launcher_trains_moe_and_vlm(arch, tmp_path):
    """The MoE summary holds the last logged aux loss beside the loss
    (which carries 0.01 of it, as the reference's does); a VLM trains on
    batches with a vision prefix."""
    from repro_torch.launch import train
    seq = 16 + configs.reduced(configs.get(arch)).vision_prefix_len
    summary = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq", str(seq),
                          "--ckpt-dir", str(tmp_path)])
    assert summary["arch"] == arch + "-reduced"
    assert np.isfinite(summary["final_loss"])
    assert ("final_aux" in summary) == (arch == "qwen2-moe-a2.7b")
    if "final_aux" in summary:
        assert summary["final_aux"] > 0
