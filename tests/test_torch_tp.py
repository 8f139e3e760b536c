"""Tensor parallelism on the CPU: the port's engine at tp = 2 (two gloo
ranks, the kernels' plain versions) against the JAX package's engine at
tp = 1 on shared f32 weights.  Reduced llama2-7b (4 heads over 2 KV
heads: one KV head per rank) and qwen2-moe-a2.7b (8 experts padded to
16, 8 per rank), both attention paths, bf16 and int8 KV, four LoRA
tenants with speculative decoding (k = 4) and with bucketed admission:
every rank's tokens, prefix hits and trace are the reference's (only the
trace header's ``tp`` differs).  The reference's own multi-device
engine is not the oracle (its pipeline test fails on the seed).

Then the parameter cut (shards concatenate back to the whole tree; a
rank's draw is the one-device draw, cut), the logical axes against the
reference's, the sharded K4 and MoE layer against their one-device
results, and the reference's refusals.

This module imports no JAX at its top: the spawned ranks import it to
find their function, and a rank must not load the JAX package; the
reference runs in this process, from inside the tests."""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.engine import Engine, EngineConfig, Request
from repro_torch.launch import mesh as M
from repro_torch.models import act_sharding
from repro_torch.models.layers import init_params, logical_axes
from repro_torch.runtime import sharding as S

#: ``test_torch_engine.py``'s schedule: a radix hit, a copy-on-write
#: fork, tail chunks and pool backpressure
GEOMETRY = dict(max_slots=2, max_len=32, chunk_size=8, decode_block=3,
                block_size=8, n_blocks=6)
LORA = dict(lora_tenants=4, lora_ranks=(4, 8), n_blocks=8)
TENANTS = [0, 1, 3, None]

#: job -> (arch, EngineConfig keywords, each request's tenant)
JOBS = {
    "llama-gather-bf16": ("llama2-7b", dict(attn_impl="gather"), None),
    "llama-gather-int8": ("llama2-7b", dict(attn_impl="gather",
                                            kv_dtype="int8"), None),
    "llama-paged-bf16": ("llama2-7b", dict(attn_impl="paged"), None),
    "llama-paged-int8": ("llama2-7b", dict(attn_impl="paged",
                                           kv_dtype="int8"), None),
    "llama-lora-spec-gather": ("llama2-7b", dict(attn_impl="gather",
                                                 spec_k=4, **LORA), TENANTS),
    "llama-lora-spec-paged": ("llama2-7b", dict(attn_impl="paged", spec_k=4,
                                                **LORA), TENANTS),
    "llama-lora-bucketed-paged": ("llama2-7b", dict(
        attn_impl="paged", prefill_batch=2, **LORA), TENANTS),
    "moe-gather-bf16": ("qwen2-moe-a2.7b", dict(attn_impl="gather"), None),
    "moe-paged-int8": ("qwen2-moe-a2.7b", dict(attn_impl="paged",
                                               kv_dtype="int8"), None),
    "moe-lora-spec-paged": ("qwen2-moe-a2.7b", dict(
        attn_impl="paged", spec_k=4, **LORA), TENANTS),
}
ARCHS = sorted({arch for arch, _, _ in JOBS.values()})


def prompts(vocab):
    """``test_torch_engine._prompts``: rid 1 shares 10 tokens of rid 0,
    rid 2 repeats it."""
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, vocab, 24)
    p1 = np.concatenate([p0[:10], rng.integers(0, vocab, 9)])
    p3 = rng.integers(0, vocab, 13)
    return [p0.tolist(), p1.tolist(), p0.tolist(), p3.tolist()]


def requests(vocab, adapters, max_new=6):
    aids = adapters or [None] * 4
    return [(i, p, max_new, a)
            for i, (p, a) in enumerate(zip(prompts(vocab), aids))]


def events(trace):
    return [dataclasses.asdict(e) for e in trace]


# ---------------------------------------------------------------------------
# what a rank runs (importable by a spawned process: no JAX here)
# ---------------------------------------------------------------------------

def serve_jobs(mesh, trees, jobs):
    """Serve every job on this rank's shard; return its tokens, prefix
    hits and trace, what the rank holds, and whether it loaded JAX."""
    out = {}
    for name, (arch, kw, adapters) in jobs.items():
        cfg = configs.reduced(configs.get(arch))
        params = bridge.shard_from_numpy(trees[arch], cfg, mesh)
        eng = Engine(cfg, params, EngineConfig(**dict(GEOMETRY, **kw)),
                     device="cpu", mesh=mesh)
        res = eng.run([Request(rid=i, prompt=p, max_new=n, adapter_id=a)
                       for i, p, n, a in requests(cfg.vocab_size, adapters)])
        out[name] = dict(
            tokens=[r.tokens for r in res],
            cached=[r.cached_tokens for r in res], trace=events(eng.trace),
            tp=eng.tp, pp=eng.pp,
            pool=tuple(eng.state["cache_k"].shape),
            contiguous=eng.state["cache_k"].is_contiguous(),
            lanes={k: tuple(v.shape) for k, v in eng.state.items()
                   if k.startswith("lora_")},
            experts=(tuple(params["layers"]["mlp"]["w_gate"].shape)
                     if cfg.family == "moe" else None))
    out["jax_loaded"] = sorted(m for m in sys.modules
                               if m == "jax" or m.startswith("jax.")
                               or m == "repro" or m.startswith("repro."))
    return out


def sharded_modules(mesh, seed):
    """The tensor-parallel K4 (``make_sharded_grouped_lora``) and MoE
    layer on this rank, against the one-device results it returns too."""
    from repro_torch.kernels.grouped_lora import ops as lora_ops
    from repro_torch.models import blocks
    gen = torch.Generator().manual_seed(seed)
    S_, T, k, R, P = 3, 5, 32, 8, 2
    ns = (24, 8, 8)
    x = torch.randn(S_, T, k, generator=gen)
    idx = torch.tensor([1, -1, 0], dtype=torch.int32)
    As = [torch.randn(P, k, R, generator=gen) for _ in ns]
    Bs = [torch.randn(P, R, n, generator=gen) for n in ns]
    lanes = R // 2
    r = mesh.coords["model"]
    qkv, one = lora_ops.make_sharded_grouped_lora(mesh.groups["model"])
    cut = [(A[..., r * lanes:(r + 1) * lanes].contiguous(),
            B[:, r * lanes:(r + 1) * lanes].contiguous())
           for A, B in zip(As, Bs)]
    got_qkv = qkv(x, *cut, idx)
    part = one(x, *cut[0], idx)
    whole = [lora_ops.grouped_lora(x, A, B, idx) for A, B in zip(As, Bs)]

    cfg = configs.reduced(configs.get("qwen2-moe-a2.7b"))
    full = init_params(cfg, seed, device="cpu", dtype=torch.float32)
    p_full = {n: v[0] for n, v in full["layers"]["mlp"].items()}
    p_rank = {n: v[0] for n, v in S.shard_params(
        full, cfg, mesh)["layers"]["mlp"].items()}
    h = torch.randn(2, 6, cfg.d_model, generator=gen)
    act_sharding.clear_mesh()
    y_one, aux_one = blocks.moe_forward(cfg, p_full, h)
    act_sharding.set_mesh(mesh)
    y_ep, aux_ep = blocks.moe_forward(cfg, p_rank, h)
    act_sharding.clear_mesh()
    return dict(qkv=got_qkv, one=part, whole=whole, y_ep=y_ep, y_one=y_one,
                aux=(aux_ep, aux_one), experts=tuple(p_rank["w_gate"].shape))


# ---------------------------------------------------------------------------
# the JAX reference at tp = 1
# ---------------------------------------------------------------------------

def reference_run(arch, kw, adapters):
    """The reference engine on one device: tokens, hits and trace."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.engine import Engine as JEngine
    from repro.engine import EngineConfig as JEngineConfig
    from repro.engine import Request as JRequest
    from repro.launch.mesh import make_host_mesh
    from repro.runtime import ShardingPolicy
    from test_torch_engine import _weights
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    with make_host_mesh() as mesh:
        eng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                   _weights(arch)),
                      mesh, ShardingPolicy(),
                      JEngineConfig(**dict(GEOMETRY, **kw)))
        res = eng.run([JRequest(rid=i, prompt=p, max_new=n, adapter_id=a)
                       for i, p, n, a in requests(jcfg.vocab_size,
                                                  adapters)])
    return dict(tokens=[r.tokens for r in res],
                cached=[r.cached_tokens for r in res],
                trace=events(eng.trace))


def reference_weights():
    from test_torch_engine import _weights
    return {arch: _weights(arch) for arch in ARCHS}


def assert_same_as_reference(got_ranks, want, tp, pp):
    """Every rank served the reference's run; only the header's plan
    differs."""
    for got in got_ranks:
        assert got["tokens"] == want["tokens"]
        assert got["cached"] == want["cached"]
        assert got["trace"][1:] == want["trace"][1:]
        head, ref_head = dict(got["trace"][0]), dict(want["trace"][0])
        assert (head.pop("tp"), head.pop("pp")) == (tp, pp)
        assert (ref_head.pop("tp"), ref_head.pop("pp")) == (1, 1)
        assert head == ref_head
        assert (got["tp"], got["pp"]) == (tp, pp)


@pytest.fixture(scope="module")
def tp_world():
    return M.spawn(serve_jobs, (reference_weights(), JOBS), model=2,
                   device="cpu")


@pytest.mark.parametrize("job", list(JOBS))
def test_tp2_serves_the_reference_tokens(tp_world, job):
    arch, kw, adapters = JOBS[job]
    want = reference_run(arch, kw, adapters)
    assert_same_as_reference([r[job] for r in tp_world], want, tp=2, pp=1)
    if "spec_k" in kw:
        assert any(e["kind"] == "spec_step" for e in want["trace"])
    # the fork was served (a bucketed group admits rid 1 beside rid 0,
    # before rid 0's blocks are indexed, so it has no hit)
    assert want["cached"] == ([0, 0, 23, 0] if "prefill_batch" in kw
                              else [0, 8, 23, 0])


def test_tp2_ranks_hold_their_shards(tp_world):
    """Each rank's pool is its own contiguous (L, N, bs, Hk/tp, hd)
    buffer, its LoRA pool R/tp lanes of every factor, its MoE layer
    E_pad/tp experts; and no rank loaded JAX or the JAX package."""
    for ranks in tp_world:
        assert ranks["jax_loaded"] == []
        llama = ranks["llama-paged-bf16"]
        assert llama["pool"] == (2, 6, 8, 1, 32) and llama["contiguous"]
        lora = ranks["llama-lora-spec-paged"]["lanes"]
        assert lora["lora_A_q"] == (2, 2, 128, 4)        # (L, P, k, R/tp)
        assert lora["lora_B_q"] == (2, 2, 4, 128)        # (L, P, R/tp, n)
        assert lora["lora_A_o"] == (2, 2, 128, 4)
        assert ranks["moe-gather-bf16"]["experts"] == (2, 8, 128, 64)


@pytest.fixture(scope="module")
def module_world():
    return M.spawn(sharded_modules, (5,), model=2, device="cpu")


def test_sharded_grouped_lora_sums_the_rank_lanes(module_world):
    """K4 over R/tp lanes per rank: q/k/v summed in one all_reduce equal
    the whole-rank deltas; the o route's partials sum to them."""
    for r in module_world:
        for got, want in zip(r["qkv"], r["whole"]):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    total = module_world[0]["one"] + module_world[1]["one"]
    torch.testing.assert_close(total, module_world[0]["whole"][0],
                               rtol=1e-5, atol=1e-5)


def test_expert_parallel_moe_equals_one_device(module_world):
    """Each rank computes its 8 of 16 padded experts; one all_reduce
    gives the one-device layer's output and aux loss."""
    for r in module_world:
        assert r["experts"] == (8, 128, 64)
        torch.testing.assert_close(r["y_ep"], r["y_one"], rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(r["aux"][0], r["aux"][1])


# ---------------------------------------------------------------------------
# the parameter cut
# ---------------------------------------------------------------------------

def fake_mesh(model, pipe, m=0, s=0):
    """A rank's mesh coordinates without a process group (the cut needs
    no collective)."""
    return M.Mesh({"data": 1, "model": model, "pipe": pipe},
                  {"data": 0, "model": m, "pipe": s}, s * model + m,
                  torch.device("cpu"))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def unshard(shards, cfg, model, pipe):
    """The whole tree back from every rank's shard, keyed by ``(model
    index, stage)``: shards concatenated in rank order along each cut
    dim, expert padding dropped."""
    sizes = {"model": model, "pipe": pipe}

    def join(path, axes, _):
        def leaf(tree):
            for k in path:
                tree = tree[k]
            return tree
        cuts = S._cut_dims(path, axes, sizes, S.ShardingPolicy())
        stages = []
        for s in range(pipe):
            parts = [leaf(shards[(m, s)]) for m in range(model)]
            stages.append(torch.cat(parts, dim=cuts["model"])
                          if "model" in cuts else parts[0])
        t = torch.cat(stages, dim=cuts["pipe"]) if "pipe" in cuts else stages[0]
        if "model" in cuts and axes[cuts["model"]] == "experts":
            t = t.narrow(cuts["model"], 0, cfg.n_experts)
        return t
    return S._walk(shards[(0, 0)], logical_axes(cfg), join)


@pytest.mark.parametrize("plan", [(2, 1), (1, 2), (2, 2)],
                         ids=["tp2", "pp2", "tp2xpp2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shards_concatenate_to_the_whole_tree(arch, plan):
    """``shard_params``, then the shards concatenated back, gives the
    whole tree bit for bit; each shard is an owned contiguous copy; ``embed``,
    ``lm_head`` and the router stay whole over tp; and a rank's
    ``init_shard`` draw is the one-device draw, cut."""
    model, pipe = plan
    cfg = configs.reduced(configs.get(arch))
    full = init_params(cfg, 7, device="cpu", dtype=torch.float32)
    shards = {}
    for s in range(pipe):
        for m in range(model):
            mesh = fake_mesh(model, pipe, m, s)
            shard = S.shard_params(full, cfg, mesh)
            drawn = S.init_shard(cfg, 7, mesh, device="cpu",
                                 dtype=torch.float32)
            for (path, a), (_, b) in zip(_leaves(shard), _leaves(drawn)):
                assert torch.equal(a, b), path
                assert a.is_contiguous()
            assert torch.equal(shard["embed"], full["embed"])
            assert torch.equal(shard["lm_head"], full["lm_head"])
            shards[(m, s)] = shard
    back = unshard(shards, cfg, model, pipe)
    for (path, a), (_, b) in zip(_leaves(back), _leaves(full)):
        assert torch.equal(a, b), path
    wq = shards[(0, 0)]["layers"]["attn"]["wq"]
    assert wq.shape == (cfg.n_layers // pipe, cfg.d_model,
                        cfg.n_heads // model, cfg.head_dim)
    if cfg.family == "moe":
        mlp = shards[(model - 1, 0)]["layers"]["mlp"]
        assert mlp["router"].shape[-1] == cfg.n_experts
        if model > 1:            # 8 experts padded to 16, zeros on rank 1
            assert mlp["w_gate"].shape[1] == 16 // model
            assert not mlp["w_gate"].any()
        else:                    # no cut over experts: no padding
            assert mlp["w_gate"].shape[1] == cfg.n_experts


def test_a_shard_from_numpy_is_the_cut_of_the_bridged_tree():
    cfg = configs.reduced(configs.get("llama2-7b"))
    full = init_params(cfg, 3, device="cpu", dtype=torch.float32)
    tree = bridge.params_to_numpy(full)
    mesh = fake_mesh(2, 2, 1, 1)
    got = bridge.shard_from_numpy(tree, cfg, mesh)
    want = S.shard_params(full, cfg, mesh)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b), path


def test_logical_axes_match_reference():
    """Every leaf of every registered arch carries the reference's
    logical axis names."""
    from repro import configs as jconfigs
    from repro.models import logical_axes as jaxes
    for name in configs.ARCHS:
        got = logical_axes(configs.get(name))
        want = jaxes(jconfigs.get(name))
        assert got == want, name


# ---------------------------------------------------------------------------
# the reference's refusals
# ---------------------------------------------------------------------------

def _engine(arch, mesh, **kw):
    cfg = configs.reduced(configs.get(arch))
    params = init_params(cfg, 0, device="cpu", dtype=torch.float32)
    return Engine(cfg, params, EngineConfig(**dict(GEOMETRY, **kw)),
                  device="cpu", mesh=mesh)


def test_refuses_heads_that_do_not_divide():
    with pytest.raises(ValueError, match=r"tensor-parallel engine shards "
                       r"attention over KV heads: tp=3 must divide "
                       r"n_heads=4 and n_kv_heads=2 of arch "
                       r"'llama2-7b-reduced'"):
        _engine("llama2-7b", fake_mesh(3, 1))


def test_refuses_stages_that_do_not_divide_the_layers():
    with pytest.raises(ValueError, match=r"pp=3 must divide n_layers=2 of "
                       r"arch 'llama2-7b-reduced'"):
        _engine("llama2-7b", fake_mesh(1, 3))


def test_refuses_a_lora_rank_that_tp_does_not_divide():
    with pytest.raises(ValueError, match=r"tensor-parallel grouped LoRA "
                       r"shards the rank axis: tp=2 must divide the padded "
                       r"pool rank 3"):
        _engine("llama2-7b", fake_mesh(2, 1), lora_tenants=2,
                lora_ranks=(3,))


def test_refuses_too_few_cards_without_the_opt_in():
    """The reference's "needs N devices" refusal; sharing a card is an
    explicit opt-in that picks gloo, and one rank per card picks NCCL."""
    from repro_torch import api
    from repro_torch.api.run import _check_measurable
    with pytest.raises(ValueError, match=r"a mesh of 2 ranks needs 2 "
                       r"devices but only 1 are visible"):
        M.choose_backend("cuda", 2, 1)
    assert M.choose_backend("cuda", 2, 1, share_device=True) == "gloo"
    assert M.choose_backend("cuda", 4, 4) == "nccl"
    assert M.choose_backend("cpu", 4, 0) == "gloo"
    scn = api.Scenario(model="qwen2-7b", reduced=True, tp=2, pp=2)
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match=r"Scenario tp=2 × pp=2 needs "
                           r"4 devices but only \d are visible"):
            _check_measurable(scn, torch.device("cuda"), False)
    _check_measurable(scn, torch.device("cuda"), True)
    # a lockstep family is measurable on a mesh too (its Server's mesh,
    # tests/test_torch_lockstep_tp.py)
    _check_measurable(dataclasses.replace(scn, model="falcon-mamba-7b"),
                      torch.device("cpu"), False)
