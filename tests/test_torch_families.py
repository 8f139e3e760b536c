"""The SSM, hybrid, MLA and encoder-decoder models of the port against the
JAX package: parameter trees of every family, uncached forward logits,
the SSM's chunk streaming, one recurrent layer's gradients (``jax.vjp``),
one training step's loss and gradients, and
the behaviours of the reference's cached step that both packages keep
(the recurrent prefill, the conv state's dtype, a local chunk of a
window, writes past ``max_len``).  Reduced configs, f32 weights drawn by the
reference and carried across by the bridge (:func:`weights`).

Tolerance: 1e-5 relative norm (both sides run the same f32 arithmetic,
summed in another order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import forward as jax_forward
from repro.models import init_decode_state as jax_init_decode_state
from repro.models import init_params as jax_init_params
from repro.models import step as jax_step
from repro.runtime import make_loss_fn as jax_make_loss_fn
from repro_torch import bridge, configs
from repro_torch.models import (blocks, forward, init_decode_state,
                                init_params, step)
from repro_torch.runtime import make_loss_fn
from test_torch_train import _batches

FAMILIES = ["falcon-mamba-7b", "recurrentgemma-2b", "llama2-7b-mla",
            "whisper-base"]
RECURRENT = ["falcon-mamba-7b", "recurrentgemma-2b"]
REL = 1e-5


def jax_init(jcfg, seed):
    """The reference's init, compiled once (faster than op by op)."""
    return jax.jit(jax_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))


@functools.lru_cache(maxsize=None)
def _f32_tree(arch):
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jax_init(jcfg, 0))


def weights(arch):
    """The reference's init of the reduced config in f32, drawn once per
    arch: (config, JAX tree, port tree), each call with its own tensors."""
    tree = _f32_tree(arch)
    return (configs.reduced(configs.get(arch)),
            jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, device="cpu"))


def rel(a, b) -> float:
    """||a - b|| / ||b|| in f64 (tensors or arrays)."""
    a = a.detach().double().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _inputs(cfg, batch=2, seq=12, seed=0):
    """Prompt tokens and, for an encoder-decoder, f32 encoder frames:
    (port kwargs, reference kwargs)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq))
    kw, jkw = {}, {}
    if cfg.family == "encdec":
        fr = rng.standard_normal((batch, cfg.encoder_len, cfg.d_model))
        fr = fr.astype(np.float32)
        kw, jkw = dict(frames=torch.from_numpy(fr)), dict(frames=jnp.asarray(fr))
    return toks, kw, jkw


def _assert_states_match(state, jstate):
    assert state.keys() == jstate.keys()
    assert state["pos"] == int(jstate["pos"])
    for k, v in jstate.items():
        if k == "pos":
            continue
        assert str(state[k].dtype).replace("torch.", "") == str(v.dtype), k
        got, want = state[k].float().numpy(), np.asarray(v, np.float32)
        if k == "cache_pos" or not want.any():
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            assert rel(got, want) <= REL, k


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_param_tree_matches_reference(arch):
    """Keys, shapes and dtypes of the bf16 tree, every family: stacked
    or unrolled layers, the encoder, MLA's projections, and the leaves
    the reference keeps f32 (Mamba's A_log and D, RG-LRU's a_param)."""
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    ref = jax.eval_shape(lambda: jax_init_params(jcfg, jax.random.PRNGKey(0)))
    got = init_params(configs.reduced(configs.get(arch)), device="cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(ref)}
    have = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _leaves(got)}
    assert have == want
    f32 = {k for k, (_, dt) in want.items() if dt == "float32"}
    assert f32 == {k for k in want if k.rsplit("/", 1)[-1]
                   in ("A_log", "D", "a_param")}


def test_mamba_a_init_is_exact_and_the_bridge_keeps_f32_leaves():
    """``A_log`` holds log(1..d_state) bit for bit, as the reference's
    init; a bf16 reference tree with its f32 leaves crosses the bridge
    and back bit for bit, each leaf in its own dtype."""
    arch = "falcon-mamba-7b"
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    ref = jax.tree_util.tree_map(np.asarray, jax_init(jcfg, 0))
    got = init_params(configs.reduced(configs.get(arch)), device="cpu")
    a_log = got["layers"]["ssm"]["A_log"]
    assert a_log.dtype == torch.float32
    np.testing.assert_array_equal(a_log.numpy(), ref["layers"]["ssm"]["A_log"])
    np.testing.assert_array_equal(got["layers"]["ssm"]["D"].numpy(),
                                  ref["layers"]["ssm"]["D"])
    for tree in (ref, jax.tree_util.tree_map(np.asarray, jax_init(
            jconfigs.reduced(jconfigs.get("recurrentgemma-2b")), 1))):
        back = bridge.params_to_numpy(bridge.params_from_numpy(tree, "cpu"))
        for (k, a), (_, b) in zip(_leaves(tree), _leaves(back)):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# uncached forward, streaming, training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_logits_match_reference(arch):
    cfg, jp, tp = weights(arch)
    toks, kw, jkw = _inputs(cfg)
    want, _ = jax.jit(jax_forward, static_argnums=0)(
        jconfigs.reduced(jconfigs.get(arch)), jp, jnp.asarray(toks), **jkw)
    got, aux = forward(cfg, tp, torch.from_numpy(toks), **kw)
    assert got.shape == want.shape
    assert rel(got, want) <= REL
    assert float(aux) == 0.0


def _recurrent_layer(kind):
    """One recurrent layer of the reduced config: (config, reference
    config, port leaves, reference leaves, port forward, reference
    forward)."""
    arch = "falcon-mamba-7b" if kind == "mamba" else "recurrentgemma-2b"
    cfg, jp, tp = weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    if kind == "mamba":
        p, jl = tp["layers"]["ssm"], jp["layers"]["ssm"]
        p, jl = ({k: v[0] for k, v in p.items()},
                 {k: v[0] for k, v in jl.items()})
        return cfg, jcfg, p, jl, blocks.mamba_forward, jblocks.mamba_forward
    p, jl = tp["layers"]["l0"]["rglru"], jp["layers"]["l0"]["rglru"]
    return cfg, jcfg, p, jl, blocks.rglru_forward, jblocks.rglru_forward


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_recurrence_streams_long_sequences_like_the_reference(kind):
    """At s = 2048 (two ``SSM_CHUNK`` pieces, states threaded between
    them) the sequence forward of one layer equals the reference's."""
    cfg, jcfg, p, jl, fn, jfn = _recurrent_layer(kind)
    assert 2048 % blocks.SSM_CHUNK == 0 and 2048 > blocks.SSM_CHUNK
    x = np.random.default_rng(3).standard_normal(
        (1, 2048, cfg.d_model)).astype(np.float32)
    got = fn(cfg, p, torch.from_numpy(x))
    assert rel(got, jfn(jcfg, jl, jnp.asarray(x))) <= REL


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_recurrence_grads_match_reference(kind):
    """The sequence forms' backward (each position's views taken once):
    one layer's output and its gradients with respect to the input and
    every leaf, under one random upstream gradient, equal ``jax.vjp`` of
    the reference's forward at s = 2048 (two ``SSM_CHUNK`` pieces)."""
    cfg, jcfg, p, jl, fn, jfn = _recurrent_layer(kind)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 2048, cfg.d_model)).astype(np.float32)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(cfg, leaves, xt)
    up = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    grads = torch.autograd.grad(out, [xt, *leaves.values()],
                                torch.from_numpy(up), allow_unused=True)
    jout, vjp = jax.vjp(lambda x_, p_: jfn(jcfg, p_, x_), jnp.asarray(x), jl)
    jgx, jgp = vjp(jnp.asarray(up))
    assert rel(out, jout) <= REL
    assert rel(grads[0], jgx) <= REL
    for k, g in zip(leaves, grads[1:]):
        want = np.asarray(jgp[k], np.float32)
        if not want.any():
            assert g is None or not g.any(), k
        else:
            assert rel(g, want) <= REL, k


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_loss_and_grads_match_reference(arch):
    """One training step's loss (cross-entropy, remat on) and every
    gradient on the same batch, each within 1e-5 (relative norm).  An
    encoder-decoder's bf16 frames go in as f32 (exactly): the reference's
    encoder scan needs its carry in the weights' dtype."""
    cfg, jp, tp = weights(arch)
    (batch,), (jbatch,) = _batches(arch, 1, batch=2, seq=16)
    if "frames" in batch:
        batch["frames"] = batch["frames"].float()
        jbatch["frames"] = jbatch["frames"].astype(jnp.float32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jconfigs.reduced(jconfigs.get(arch))),
        has_aux=True))(jp, jbatch)
    names, leaves = zip(*_leaves(tp))
    for t in leaves:
        t.requires_grad_()
    loss, _ = make_loss_fn(cfg)(tp, batch)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    assert rel(loss, jloss) <= REL
    for k, jg in _leaves(jgrads):
        assert rel(grads[k], jg) <= REL, k


# ---------------------------------------------------------------------------
# behaviours of the reference's cached step, kept
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_cached_prefill_folds_only_the_first_token(arch):
    """A whole-prompt ``step`` takes the prompt's first token into the
    recurrent state and broadcasts its output over the chunk, so its
    logits differ from ``forward``'s last position by more than 1e-3 in
    both packages; token by token they agree.  The port's prefill equals
    the reference's."""
    cfg, jp, tp = weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    toks, _, _ = _inputs(cfg)
    full, _ = forward(cfg, tp, torch.from_numpy(toks))
    jfull, _ = jax_forward(jcfg, jp, jnp.asarray(toks))
    got, _ = step(cfg, tp, torch.from_numpy(toks),
                  init_decode_state(cfg, 2, 16, device="cpu"))
    want, _ = jax_step(jcfg, jp, jnp.asarray(toks),
                       jax_init_decode_state(jcfg, 2, 16))
    assert rel(got, want) <= REL
    assert rel(got, full[:, -1]) > 1e-3
    assert rel(want, jfull[:, -1]) > 1e-3
    # f32 KV, so that the local attention layers read what forward reads
    state = init_decode_state(cfg, 2, 16, torch.float32, device="cpu")
    for t in range(toks.shape[1]):
        by_token, state = step(cfg, tp, torch.from_numpy(toks[:, t:t + 1]),
                               state)
    assert rel(by_token, full[:, -1]) <= 1e-4


@pytest.mark.parametrize("arch", RECURRENT)
def test_conv_state_dtype_follows_the_reference(arch):
    """``init_decode_state`` makes the conv state bf16 whatever the
    weights; an f32 tree's first step promotes it to f32, and both
    packages carry f32 from then on (values within 1e-5)."""
    cfg, jp, tp = weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    key = "conv_state" if cfg.family == "ssm" else "rg_conv"
    toks, _, _ = _inputs(cfg, seq=3)
    state = init_decode_state(cfg, 2, 8, device="cpu")
    jstate = jax_init_decode_state(jcfg, 2, 8)
    assert state[key].dtype == torch.bfloat16
    assert jstate[key].dtype == jnp.bfloat16
    for t in range(3):
        _, state = step(cfg, tp, torch.from_numpy(toks[:, t:t + 1]), state)
        _, jstate = jax_step(jcfg, jp, jnp.asarray(toks[:, t:t + 1]), jstate)
        assert state[key].dtype == torch.float32
        assert jstate[key].dtype == jnp.float32
    for k, v in jstate.items():
        if k == "pos":
            assert state[k] == int(v)
            continue
        assert str(state[k].dtype).replace("torch.", "") == str(v.dtype), k
        assert rel(state[k].float(), np.asarray(v, np.float32)) <= REL, k


def test_local_chunk_of_a_window_ignores_the_earlier_chunk():
    """``_local_cached_attention`` with a chunk of s >= W attends over the
    chunk alone: a second chunk of W tokens at pos = W misses the first
    chunk's keys inside its queries' windows, so it differs from feeding
    the same tokens one at a time through the ring.  Both chunks (the
    s = W branch) equal the reference's, and so do the ring's outputs."""
    from repro.models import model as jmodel
    from repro_torch.models import model

    arch = "recurrentgemma-2b"
    cfg, jp, tp = weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    W = cfg.local_window
    p, jpa = tp["layers"]["l2"]["attn"], jp["layers"]["l2"]["attn"]
    x = np.random.default_rng(5).standard_normal(
        (2, 2 * W, cfg.d_model)).astype(np.float32)

    def fresh():
        ks = (2, W, cfg.n_kv_heads, cfg.head_dim)
        return (torch.zeros(ks), torch.zeros(ks),
                torch.full((2, W), -1, dtype=torch.int32))

    def jfresh():
        ks = (2, W, cfg.n_kv_heads, cfg.head_dim)
        return (jnp.zeros(ks), jnp.zeros(ks), jnp.full((2, W), -1, jnp.int32))

    ck, cv, cp = fresh()
    jck, jcv, jcp = jfresh()
    outs, jouts = [], []
    for c in range(2):
        xc = x[:, c * W:(c + 1) * W]
        outs.append(model._local_cached_attention(
            cfg, p, torch.from_numpy(xc), ck, cv, cp, c * W))
        y, jck, jcv, jcp = jmodel._local_cached_attention(
            jcfg, jpa, jnp.asarray(xc), jck, jcv, jcp, c * W)
        jouts.append(y)
    for a, b in zip(outs, jouts):
        assert rel(a, b) <= REL
    np.testing.assert_array_equal(cp.numpy(), np.asarray(jcp))
    # the second chunk's tokens one at a time after the same first chunk
    ck, cv, cp = fresh()
    model._local_cached_attention(cfg, p, torch.from_numpy(x[:, :W]),
                                  ck, cv, cp, 0)
    ring = torch.cat([model._local_cached_attention(
        cfg, p, torch.from_numpy(x[:, t:t + 1]), ck, cv, cp, t)
        for t in range(W, 2 * W)], dim=1)
    assert rel(outs[1], ring) > 1e-3
    # the last query's window lies inside the chunk: there they agree
    assert rel(outs[1][:, -1], ring[:, -1]) <= REL


def test_writes_past_max_len_are_clamped():
    """A chunk that runs past ``max_len`` is written at the clamped start
    ``L - s`` (``dynamic_update_slice``'s rule) and ``pos`` passes
    ``max_len`` without an error, in both packages."""
    arch = "llama2-7b"
    cfg, jp, tp = weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 10))
    state = init_decode_state(cfg, 2, 8, torch.float32, device="cpu")
    jstate = jax_init_decode_state(jcfg, 2, 8, jnp.float32)
    for piece in (toks[:, :6], toks[:, 6:]):
        got, state = step(cfg, tp, torch.from_numpy(piece), state)
        want, jstate = jax.jit(jax_step, static_argnums=0)(
            jcfg, jp, jnp.asarray(piece), jstate)
        assert rel(got, want) <= REL
    assert state["pos"] == int(jstate["pos"]) == 10
    _assert_states_match(state, jstate)
