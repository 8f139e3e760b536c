"""The lockstep ``Server`` on a mesh, on the CPU: the port's sharded
``Server`` (gloo ranks, the kernels' plain versions) against the JAX
package's ``Server`` on a one-device host mesh, on the same f32 weights
drawn by the reference and cut by ``bridge.shard_from_numpy``.  Reduced
falcon-mamba-7b (Mamba over ``inner``), recurrentgemma-2b (RG-LRU over
``inner``; 4 query heads, 2 a rank, over its one KV head, whole),
llama2-7b-mla (heads cut, the latent cache whole), whisper-base (the
encoder and cross K/V cut over heads, with frames), llama2-7b and
qwen2-moe-a2.7b (8 experts padded to 16, 8 a rank), each served at
tp = 2, pp = 2 and tp = 2 × pp = 2 with bf16 and int8 KV: every rank's
greedy tokens and ``final_pos`` are the reference's.  A tp = 3 world,
where no axis divides, holds every leaf whole and serves the same
tokens (the drop rule).  ``api.measure`` serves a lockstep family at
tp = 2 (a spawned world) and at pp = 2 (a rank of the pp world).

Each world is spawned once, in a thread, while the reference runs in
this process.  This module imports no JAX at its top: the spawned ranks
import it to find their function, and a rank must not load the JAX
package; every rank reports that it did not."""
import concurrent.futures
import sys

import numpy as np
import pytest
import torch

from repro_torch import api, bridge, configs
from repro_torch.launch import mesh as M
from repro_torch.models.layers import init_params
from repro_torch.runtime import ServeConfig, Server
from repro_torch.runtime import sharding as S

ARCHS = ["falcon-mamba-7b", "recurrentgemma-2b", "llama2-7b-mla",
         "whisper-base", "llama2-7b", "qwen2-moe-a2.7b"]
KVS = ("bf16", "int8")
#: ``tests/test_torch_serve.py``'s geometry: 2 prompts of 16 in chunks
#: of 8, 6 new tokens
SERVE = dict(batch=2, max_len=32, chunk_size=8)
PROMPT, NEW = 16, 6
#: (model, pipe) of each world
PLANS = {"tp2": (2, 1), "pp2": (1, 2), "tp2xpp2": (2, 2), "tp3": (3, 1)}
#: the lockstep scenario ``api.measure`` serves at tp = 2 and pp = 2
MEASURE = dict(model="falcon-mamba-7b", reduced=True, batch=2, n_requests=2,
               prompt_len=16, gen_len=4, chunk=8)


def inputs(arch):
    """(prompts, extra) as numpy: ``test_torch_serve``'s prompts and
    ``test_torch_lockstep._extra``'s frames (seed 3)."""
    cfg = configs.reduced(configs.get(arch))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                (2, PROMPT))
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = np.random.default_rng(3).standard_normal(
            (2, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return prompts, extra


def _shapes(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = tuple(v.shape)
    return out


# ---------------------------------------------------------------------------
# what a rank runs (importable by a spawned process: no JAX here)
# ---------------------------------------------------------------------------

def serve_all(mesh, trees, measure):
    """Serve every arch with every KV dtype on this rank's shard; return
    the tokens and stats, the shapes the rank holds, rank 0's
    ``api.measure`` report of ``MEASURE`` (if asked), and whether the
    rank loaded JAX."""
    from repro_torch.api.run import _measure_rank
    out = {"jobs": {}, "params": {}, "state": {}}
    for arch in ARCHS:
        cfg = configs.reduced(configs.get(arch))
        params = bridge.shard_from_numpy(trees[arch], cfg, mesh)
        prompts, extra = inputs(arch)
        extra = {k: torch.from_numpy(v) for k, v in extra.items()}
        for kv in KVS:
            server = Server(cfg, params, ServeConfig(**SERVE, kv_dtype=kv),
                            mesh=mesh)
            toks, stats = server.generate(prompts, NEW, extra=extra)
            out["jobs"][(arch, kv)] = (toks.tolist(), stats)
        out["params"][arch] = _shapes(params)
        out["state"][arch] = {k: tuple(v.shape) for k, v in
                              server.init_state().items() if k != "pos"}
    if measure:
        out["measure"] = _measure_rank(mesh, api.Scenario(**MEASURE), None)
    out["jax_loaded"] = sorted(m for m in sys.modules
                               if m == "jax" or m.startswith("jax.")
                               or m == "repro" or m.startswith("repro."))
    return out


# ---------------------------------------------------------------------------
# the worlds and the JAX reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    """Every world (and ``api.measure`` at tp = 2) started at once in
    threads; each test waits for the one it reads."""
    from test_torch_families import _f32_tree
    trees = {arch: _f32_tree(arch) for arch in ARCHS}
    pool = concurrent.futures.ThreadPoolExecutor(3)
    futs = {name: pool.submit(M.spawn, serve_all, (trees, name == "pp2"),
                              model=m, pipe=p, device="cpu")
            for name, (m, p) in PLANS.items()}
    futs["measure"] = pool.submit(
        api.measure, api.Scenario(**MEASURE, tp=2), device="cpu")
    yield futs
    pool.shutdown(wait=True)


_REFERENCE = {}


def reference(arch, kv):
    """The reference ``Server``'s tokens and stats on a one-device host
    mesh (as ``tests/test_torch_serve.py`` runs it)."""
    if (arch, kv) not in _REFERENCE:
        import jax
        import jax.numpy as jnp
        from repro import configs as jconfigs
        from repro.launch.mesh import make_host_mesh
        from repro.runtime import Server as JaxServer
        from repro.runtime import ServeConfig as JaxServeConfig
        from repro.runtime import ShardingPolicy
        from test_torch_families import _f32_tree
        jcfg = jconfigs.reduced(jconfigs.get(arch))
        prompts, extra = inputs(arch)
        params = jax.tree_util.tree_map(jnp.asarray, _f32_tree(arch))
        with make_host_mesh() as mesh:
            toks, stats = JaxServer(
                jcfg, params, mesh, ShardingPolicy(),
                JaxServeConfig(**SERVE, kv_dtype=kv)).generate(
                jnp.asarray(prompts), NEW,
                extra={k: jnp.asarray(v) for k, v in extra.items()})
        _REFERENCE[(arch, kv)] = (np.asarray(toks).tolist(), stats)
    return _REFERENCE[(arch, kv)]


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("plan", list(PLANS))
def test_sharded_server_serves_the_reference_tokens(worlds, plan, arch, kv):
    """Every rank's greedy tokens and ``final_pos`` equal the reference
    ``Server``'s on one device."""
    want = reference(arch, kv)
    ranks = worlds[plan].result()
    assert len(ranks) == PLANS[plan][0] * PLANS[plan][1]
    for r in ranks:
        assert r["jobs"][(arch, kv)] == want


def _whole(arch):
    cfg = configs.reduced(configs.get(arch))
    return cfg, _shapes(init_params(cfg, 0, device="cpu",
                                    dtype=torch.float32))


def test_tp2_ranks_hold_their_shards(worlds):
    """At tp = 2: Mamba and the RG-LRU hold half their ``inner`` channels
    and state, attention half its query heads; recurrentgemma-2b's one
    KV head and its cache, MLA's latent cache, ``embed``, ``lm_head`` and
    the router stay whole; whisper's encoder and cross K/V are cut over
    heads; no rank loaded JAX."""
    for r in worlds["tp2"].result():
        assert r["jax_loaded"] == []
        p, st = r["params"], r["state"]
        ssm = p["falcon-mamba-7b"]
        assert ssm["layers/ssm/in_proj"] == (2, 128, 256)     # 2 x di/tp
        assert ssm["layers/ssm/x_proj"][:2] == (2, 128)
        assert ssm["layers/ssm/dt_proj"][2] == 128
        assert ssm["layers/ssm/out_proj"] == (2, 128, 128)
        assert ssm["embed"] == (512, 128)
        assert st["falcon-mamba-7b"] == {"conv_state": (2, 2, 3, 128),
                                         "ssm_state": (2, 2, 128, 8)}
        rg = p["recurrentgemma-2b"]
        assert rg["layers/l0/rglru/linear_x"] == (128, 64)
        assert rg["layers/l0/rglru/linear_out"] == (64, 128)
        assert rg["layers/l2/attn/wq"] == (128, 2, 32)
        assert rg["layers/l2/attn/wk"] == (128, 1, 32)
        assert st["recurrentgemma-2b"]["cache_k"] == (1, 2, 32, 1, 32)
        assert st["recurrentgemma-2b"]["rg_h"] == (2, 2, 64)
        mla = p["llama2-7b-mla"]
        assert mla["layers/attn/q_up"][2] == 2
        assert mla["layers/attn/kv_down"] == _whole(
            "llama2-7b-mla")[1]["layers/attn/kv_down"]
        rank = configs.reduced(configs.get("llama2-7b-mla")).mla.kv_lora_rank
        assert st["llama2-7b-mla"]["cache_k"] == (2, 2, 32, rank)
        wh = p["whisper-base"]
        assert wh["encoder/layers/attn/wq"] == (2, 128, 2, 32)
        assert wh["layers/l0/xattn/wk"] == (128, 2, 32)
        assert st["whisper-base"]["cross_k"] == (2, 2, 64, 2, 32)
        moe = p["qwen2-moe-a2.7b"]
        assert moe["layers/mlp/w_gate"][1] == 8 and \
            moe["layers/mlp/router"][-1] == 8


def test_pp2_stages_hold_their_own_layers(worlds):
    """At pp = 2 a stage holds its block of every stacked ``layers`` axis,
    its own ``layers["l{i}"]`` of an unrolled stack and the entries of
    its layers in each per-kind state stack; ``api.measure`` on the pp
    world serves the lockstep branch."""
    ranks = worlds["pp2"].result()
    for stage, r in enumerate(ranks):
        assert r["jax_loaded"] == []
        rg = {k.split("/")[1] for k in r["params"]["recurrentgemma-2b"]
              if k.startswith("layers/")}
        assert rg == ({"l0"} if stage == 0 else {"l1", "l2"})
        st = r["state"]["recurrentgemma-2b"]
        assert st["rg_h"][0] == 1
        assert st["cache_k"][0] == (0 if stage == 0 else 1)
        wh = r["params"]["whisper-base"]
        assert {k.split("/")[1] for k in wh if k.startswith("layers/")} \
            == {f"l{stage}"}
        assert wh["encoder/layers/attn/wq"][0] == 1
        assert r["state"]["whisper-base"]["cross_k"][0] == 1
        assert r["params"]["falcon-mamba-7b"]["layers/ssm/in_proj"] == \
            (1, 128, 512)
    rep = ranks[0]["measure"]
    assert ranks[1]["measure"] is None
    assert rep.extras["mode"] == "legacy-lockstep"
    assert (rep.extras["tokens"], rep.extras["requests"]) == (2 * 4, 2)


def test_tp3_holds_every_leaf_whole(worlds):
    """Nothing of the reduced configs divides 3: every leaf and state
    key stays whole on every rank (``spec_for`` drops the assignment;
    the tokens are the reference's, above)."""
    for r in worlds["tp3"].result():
        for arch in ARCHS:
            cfg, whole = _whole(arch)
            assert r["params"][arch] == whole, arch
            want = {k: v for k, (v, _) in S.state_shapes(
                cfg, SERVE["batch"], SERVE["max_len"],
                M.Mesh({"data": 1, "model": 1, "pipe": 1},
                       {"data": 0, "model": 0, "pipe": 0}, 0,
                       torch.device("cpu"))).items()}
            assert r["state"][arch] == want, arch


def test_measure_serves_a_lockstep_family_at_tp2(worlds):
    """``api.measure(Scenario(tp=2))`` of reduced falcon-mamba-7b no
    longer refuses: it serves the lockstep branch on two ranks, with the
    reference's mode, token count and requests."""
    from repro import api as japi
    rep = worlds["measure"].result()
    want = japi.measure(japi.Scenario(**MEASURE))
    assert rep.extras["mode"] == want.extras["mode"] == "legacy-lockstep"
    for key in ("tokens", "requests"):
        assert rep.extras[key] == want.extras[key]
    assert rep.scenario["tp"] == 2


def test_mamba_in_proj_is_cut_per_half():
    """Each rank holds its channels of ``in_proj``'s input half and of its
    gate half, side by side, so ``chunk(2)`` splits them as on one
    device."""
    cfg = configs.reduced(configs.get("falcon-mamba-7b"))
    full = init_params(cfg, 1, device="cpu", dtype=torch.float32)
    w = full["layers"]["ssm"]["in_proj"]
    di = w.shape[-1] // 2
    for m in range(2):
        mesh = M.Mesh({"data": 1, "model": 2, "pipe": 1},
                      {"data": 0, "model": m, "pipe": 0}, m,
                      torch.device("cpu"))
        got = S.shard_params(full, cfg, mesh)["layers"]["ssm"]["in_proj"]
        x_in, z = got.chunk(2, dim=-1)
        h = di // 2
        assert torch.equal(x_in, w[..., m * h:(m + 1) * h])
        assert torch.equal(z, w[..., di + m * h:di + (m + 1) * h])


@pytest.mark.parametrize("H,Hk,tp,groups", [
    (4, 1, 2, (1, 2)),          # recurrentgemma-2b's case: one group a rank
    (6, 2, 3, (2, 1)),          # a rank's heads span two groups
    (4, 2, 2, (1, 2)),          # both cut: the rank's own KV head
])
def test_rank_query_heads_read_their_kv_heads(H, Hk, tp, groups):
    """Query head ``h`` reads KV head ``h // G`` (G = H/Hk) on a rank as on
    one device: with the KV heads whole and the query heads cut, each
    rank selects the KV heads its heads read; with both cut, its own."""
    import dataclasses
    from repro_torch.models import act_sharding, attention
    cfg = dataclasses.replace(configs.reduced(configs.get("llama2-7b")),
                              n_heads=H, n_kv_heads=Hk)
    G, d, hd = H // Hk, cfg.d_model, cfg.head_dim
    hk_rank = Hk // tp if Hk % tp == 0 else Hk
    k = torch.arange(hk_rank, dtype=torch.float32).view(1, 1, hk_rank, 1) \
        .expand(1, 3, hk_rank, hd)
    try:
        for r in range(tp):
            act_sharding.set_mesh(M.Mesh(
                {"data": 1, "model": tp, "pipe": 1},
                {"data": 0, "model": r, "pipe": 0}, r, torch.device("cpu")))
            p = {"wq": torch.zeros(d, H // tp, hd),
                 "wk": torch.zeros(d, hk_rank, hd)}
            assert attention._q_groups(cfg, p) == groups
            got, _ = attention._rank_kv(cfg, p, k, k)
            Hr, Gr = groups
            heads = [r * (H // tp) + i * Gr + j for i in range(Hr)
                     for j in range(Gr)]
            read = [int(got[0, 0, i, 0]) for i in range(Hr) for _ in range(Gr)]
            first = r * hk_rank if hk_rank < Hk else 0
            assert [first + x for x in read] == [h // G for h in heads]
    finally:
        act_sharding.clear_mesh()
