"""The port's cached lockstep step against the JAX package: every family
(prefill whole and in chunks, then decode), the step's two blockwise
branches (a long prompt over the dense cache, a chunk of a window over
itself), and ``measure``'s lockstep branch without encoder frames
(``tests/test_torch_serve.py`` holds the ``Server``'s tokens).  Reduced configs, f32 weights drawn by the
reference and carried across by the bridge
(``test_torch_families.weights``).

Tolerance: logits within 1e-5 relative norm (the same f32 arithmetic
summed in another order; f32 KV, since a bf16 cache may round a tie one
ulp apart in the two packages); state dtypes equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattention
from repro.models import init_decode_state as jax_init_decode_state
from repro.models import step as jax_step
from repro_torch import api
from repro_torch.models import attention, init_decode_state, step
from test_torch_families import _assert_states_match, rel, weights

#: one model of each family the reference serves (MLA as its own)
SERVED = ["llama2-7b", "internvl2-26b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
          "recurrentgemma-2b", "llama2-7b-mla", "whisper-base"]
STEPPED = SERVED[:1] + ["qwen2-7b"] + SERVED[1:]
REL = 1e-5

_jit_step = jax.jit(jax_step, static_argnums=0)


def _extra(cfg, batch, seed=0):
    """The first chunk's extra inputs: a VLM's vision embeddings, an
    encoder-decoder's frames (f32), as (port, reference) kwargs."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        shape, key = (batch, cfg.vision_prefix_len, cfg.d_model), "vision_embeds"
    elif cfg.family == "encdec":
        shape, key = (batch, cfg.encoder_len, cfg.d_model), "frames"
    else:
        return {}, {}
    a = rng.standard_normal(shape).astype(np.float32)
    return {key: torch.from_numpy(a)}, {key: jnp.asarray(a)}


@pytest.mark.parametrize("chunks", [(12,), (6, 6)], ids=["whole", "chunked"])
@pytest.mark.parametrize("arch", STEPPED)
def test_step_matches_reference(arch, chunks):
    """Prefill (whole or in two chunks, the first carrying a VLM's vision
    embeddings or an encoder-decoder's frames), then two decode steps:
    each step's logits within 1e-5 of the reference's, and the state's
    tensors in the reference's dtypes."""
    cfg, jp, tp = weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 14))
    extra, jextra = _extra(cfg, 2)
    state = init_decode_state(cfg, 2, 40, torch.float32, device="cpu")
    jstate = jax_init_decode_state(jcfg, 2, 40, jnp.float32)
    off = 0
    for i, n in enumerate(chunks + (1, 1)):
        piece = toks[:, off:off + n]
        off += n
        got, state = step(cfg, tp, torch.from_numpy(piece), state,
                          **(extra if i == 0 else {}))
        want, jstate = _jit_step(jcfg, jp, jnp.asarray(piece), jstate,
                                 **(jextra if i == 0 else {}))
        assert rel(got, want) <= REL, (i, n)
    _assert_states_match(state, jstate)


@pytest.mark.parametrize("arch,s,max_len", [
    ("llama2-7b", 4096, 5120),          # cached_attention, s >= 4096
    ("recurrentgemma-2b", 64, 80),      # _local_cached_attention, s >= W
], ids=["dense", "local"])
def test_blockwise_branches_match_reference(arch, s, max_len, monkeypatch):
    """A prompt that takes the step's blockwise branch (every attention
    layer: the flash kernel on the card, the plain blockwise loop here),
    then one decode step: logits within 1e-5 of the reference's."""
    cfg, jp, tp = weights(arch)
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    calls = []
    real = attention.lockstep_blockwise

    def counted(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "lockstep_blockwise", counted)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, s + 1))
    state = init_decode_state(cfg, 1, max_len, torch.float32, device="cpu")
    jstate = jax_init_decode_state(jcfg, 1, max_len, jnp.float32)
    for piece in (toks[:, :s], toks[:, s:]):
        got, state = step(cfg, tp, torch.from_numpy(piece), state)
        want, jstate = _jit_step(jcfg, jp, jnp.asarray(piece), jstate)
        assert rel(got, want) <= REL
    n_attn = cfg.block_kinds().count("attn")
    assert len(calls) == n_attn
    window = cfg.local_window or None
    assert {c[2]["window"] for c in calls} == {window}
    assert {c[1][1] for c in calls} == {s if window else max_len}


def test_measure_runs_the_encoder_decoder_without_frames(monkeypatch):
    """``measure``'s lockstep branch prefills with no extra inputs, as the
    reference's does: an encoder-decoder's cross K/V stay the zeros of
    ``init_decode_state`` and every cross-attention adds exactly 0
    (``tests/test_torch_measure.py`` holds the branch's extras to the
    reference's)."""
    scn = dict(model="whisper-base", reduced=True, batch=2, n_requests=2,
               prompt_len=16, gen_len=4, chunk=8)
    outs = []
    real = attention.cross_attention

    def spy(*a, **kw):
        outs.append(real(*a, **kw))
        return outs[-1]

    monkeypatch.setattr(attention, "cross_attention", spy)
    rep = api.measure(api.Scenario(**scn), device="cpu")
    assert rep.extras["mode"] == "legacy-lockstep"
    assert (rep.extras["tokens"], rep.extras["requests"]) == (2 * 4, 2)
    assert outs and all(not o.any() for o in outs)
    # the reference: no frames leave its cross K/V zero, and zero K/V
    # give a zero cross-attention output
    cfg, jp, _ = weights("whisper-base")
    jcfg = jconfigs.reduced(jconfigs.get("whisper-base"))
    _, jstate = _jit_step(jcfg, jp, jnp.zeros((2, 8), jnp.int32),
                          jax_init_decode_state(jcfg, 2, 16))
    assert not np.asarray(jstate["cross_k"]).any()
    y = jattention.cross_attention(
        jcfg, jp["layers"]["l0"]["xattn"], jnp.ones((2, 1, cfg.d_model)),
        jstate["cross_k"][0], jstate["cross_v"][0])
    assert not np.asarray(y).any()


def test_blockwise_branch_keeps_the_reference_precondition():
    """The blockwise branches take what the reference's blockwise loop
    takes, s and L multiples of its 1024 blocks, and raise otherwise
    (the card's flash kernel behind the same check; GPU case in
    ``tests/test_torch_gpu.py``)."""
    q, k = torch.zeros((1, 1500, 2, 2, 32)), torch.zeros((1, 1500, 2, 32))
    with pytest.raises(ValueError, match="multiples of the blocks"):
        attention.lockstep_blockwise(q, k, k, window=None, q_offset=0)
