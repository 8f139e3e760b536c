"""The trainer on a mesh, on the CPU: gloo ranks of the port's
``make_train_step`` and ``Trainer`` (the kernels' plain versions) against
the JAX package's ``make_train_step`` on a one-device host mesh, on the
same f32 weights drawn by the reference and cut by
``bridge.shard_from_numpy``.  GSPMD does not change the math, so the
reference's one-device step is the oracle of every mesh.

Meshes: dp = 2, dp = 2 with FSDP, tp = 2, dp = 2 × tp = 2 with FSDP, and
dp = 2 with two microbatches; families: dense (granite-3-2b, a tied
embedding), moe (qwen2-moe-a2.7b: the aux loss's means over dp, 8
experts padded to 16 at tp), ssm, hybrid, mla, encdec (with frames) and
vlm (with vision embeddings); the encoder frames go in as f32, exactly,
as ``tests/test_torch_families.py`` gives them.  Per step the loss,
``grad_norm`` and aux equal the reference's within ``TOL``; the final
params within
``PARAM_TOL`` (see there).  Whole leaves are equal on every tp rank;
``compress_int8`` on a cut leaf takes the whole leaf's scale; a pipe
axis is refused; a retried step under a mesh ends where a run without
the fault does; checkpoints cross both ways at any mesh shape; the
training specs equal the reference's ``PartitionSpec``s.

The two worlds (2 and 4 ranks) are spawned once, in threads, while the
reference runs in this process.  This module imports no JAX at its top:
the spawned ranks import it to find their functions, and each reports
that it loaded neither ``jax`` nor ``repro``."""
import concurrent.futures
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import mesh as M
from repro_torch.models.layers import param_defs
from repro_torch.optim import AdamW, compress_int8
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import Trainer, TrainerConfig, make_train_step
from repro_torch.runtime import sharding as S

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite-3-2b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
         "recurrentgemma-2b", "llama2-7b-mla", "whisper-base",
         "internvl2-26b"]
#: mesh -> (data, model, fsdp, microbatches)
MESHES = {"dp2": (2, 1, False, 1), "dp2_fsdp": (2, 1, True, 1),
          "tp2": (1, 2, False, 1), "dp2xtp2_fsdp": (2, 2, True, 1),
          "dp2_mb2": (2, 1, False, 2)}
STEPS, BATCH, SEQ = 3, 4, 32
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)
#: ``tests/test_torch_train.py``'s: f32 on both sides, the same
#: arithmetic summed in other orders
TOL = dict(rtol=1e-5, atol=1e-5)
#: the final params: AdamW divides each gradient element by its own
#: running magnitude, so an element whose contributions nearly cancel
#: carries the ~1e-7 relative sum-order difference of a rank's partial
#: sums as a larger relative difference of its update.  Measured on the
#: CPU: at most 1.3e-4 (lr 1e-3, 3 steps), on a few elements of the
#: embedding and of ``gate`` under tp; 1.2e-5 under dp.  The loss, the
#: grad norm and every other element hold ``TOL``.
PARAM_TOL = dict(rtol=1e-5, atol=2.5e-4)
CKPT_ARCH = "granite-3-2b"


def _loaded_reference() -> list:
    return sorted(m for m in sys.modules if m == "jax"
                  or m.startswith("jax.") or m == "repro"
                  or m.startswith("repro."))


def _paths(defs, path=()):
    for k in sorted(defs):
        if isinstance(defs[k], dict):
            yield from _paths(defs[k], path + (k,))
        else:
            yield path + (k,), defs[k]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _whole(params, cfg, mesh, policy):
    """``{"a/b": numpy}`` of the whole leaves of a rank's shards (every
    rank must call: the leaves are assembled by all-reduce)."""
    return {"/".join(path): S.unshard_leaf(
        path, d.axes, _get(params, path).detach(), d.shape, mesh,
        policy).numpy() for path, d in _paths(param_defs(cfg))}


def _flat(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = np.asarray(v, np.float32)
    return out


# ---------------------------------------------------------------------------
# what a rank runs (importable by a spawned process: no JAX here)
# ---------------------------------------------------------------------------

def _train(mesh, arch, tree, fsdp, microbatches):
    """Three steps of ``make_train_step`` on this rank's cut of the
    reference's f32 weights: (metrics per step, whole params on rank 0,
    this rank's leaves that the tp axis leaves whole, the trained state)."""
    cfg = configs.reduced(configs.get(arch))
    policy = S.ShardingPolicy(fsdp=fsdp)
    params = bridge.shard_from_numpy(tree, cfg, mesh, policy)
    opt = AdamW(**OPT)
    state = opt.init(params)
    step = make_train_step(cfg, opt, mesh, policy, microbatches=microbatches)
    data = SyntheticTokens(cfg, DataConfig(BATCH, SEQ, 0), device="cpu")
    metrics = []
    for i in range(STEPS):
        batch = data.batch(i)
        if "frames" in batch:      # f32 frames, as the reference takes them
            batch["frames"] = batch["frames"].float()
        params, state, m = step(params, state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = _whole(params, cfg, mesh, policy)
    cuts = S.param_cuts(cfg, mesh, policy)
    tp_whole = {"/".join(p): _get(params, p).detach().numpy()
                for p, _ in _paths(param_defs(cfg))
                if "model" not in _get(cuts, p)}
    return metrics, whole if mesh.rank == 0 else None, tp_whole, (params,
                                                                   state)


def _retry_runs(mesh, tmp):
    """A 2 × 2 FSDP ``Trainer`` (bf16, the port's own draw) run straight,
    with a fault before any checkpoint (retried on the live params) and
    with one after the checkpoint of step 1 (retried from
    ``restore_sharded``): each rank's final shards of the three runs."""
    cfg = configs.reduced(configs.get(CKPT_ARCH))
    policy = S.ShardingPolicy(fsdp=True)

    def run(name, ckpt_every, fail_at):
        armed = {"on": fail_at is not None}

        def injector(step):
            if armed["on"] and step == fail_at:
                armed["on"] = False
                raise RuntimeError("simulated preemption")
        data = SyntheticTokens(cfg, DataConfig(BATCH, SEQ, 0), device="cpu")
        trainer = Trainer(cfg, AdamW(**OPT), data,
                          TrainerConfig(total_steps=4, ckpt_every=ckpt_every,
                                        ckpt_dir=os.path.join(tmp, name),
                                        log_every=1),
                          failure_injector=injector, mesh=mesh, policy=policy)
        params, state, log = trainer.run()
        assert not armed["on"]
        return [t.detach().clone() for t in (*tree_leaves(params),
                                             *tree_leaves(state.mu),
                                             *tree_leaves(state.nu))], log
    return {name: run(name, every, at) for name, every, at in (
        ("straight", 100, None), ("live", 100, 2), ("restored", 2, 3))}


def world(mesh, trees, jobs, extras):
    """Every job of this world: ``(arch, mesh name)`` trained on the
    mesh of that name (built here from the spawned world's ranks), then
    the extras the 4-rank world runs.  Returns what the tests read."""
    out = {"rank": mesh.rank, "coords": dict(mesh.coords), "jobs": {},
           "groups": {a: g is not None for a, g in mesh.groups.items()}}
    meshes = {}
    for arch, name in jobs:
        data, model, fsdp, mb = MESHES[name]
        if (data, model) not in meshes:
            meshes[(data, model)] = (
                mesh if (data, model) == (mesh.shape["data"],
                                          mesh.shape["model"])
                else M.make_host_mesh(data, model, device=mesh.device))
        metrics, whole, tp_whole, _ = _train(meshes[(data, model)], arch,
                                             trees[arch], fsdp, mb)
        out["jobs"][(arch, name)] = dict(
            metrics=metrics, whole=whole, tp_whole=tp_whole,
            coords=dict(meshes[(data, model)].coords))
    if extras:
        out.update(_extras(mesh, trees, **extras))
    out["loaded"] = _loaded_reference()
    return out


def _extras(mesh, trees, ref_ckpt, port_ckpt, tmp):
    """The 4-rank world's checks beyond training: ``restore_sharded`` of
    a reference checkpoint, a checkpoint saved from the mesh,
    ``compress_int8`` on a cut leaf, and the retries."""
    cfg = configs.reduced(configs.get(CKPT_ARCH))
    policy = S.ShardingPolicy(fsdp=True)
    out = {}
    # a reference checkpoint restored as this rank's shards
    params = bridge.shard_from_numpy(trees[CKPT_ARCH], cfg, mesh, policy)
    opt = AdamW(**OPT)
    (rp, rs), step = CheckpointManager(ref_ckpt).restore_sharded(
        (params, opt.init(params)), mesh, policy, cfg=cfg)
    out["restored"] = dict(step=step, count=int(rs.count),
                           params=bridge.params_to_numpy(rp),
                           mu=bridge.params_to_numpy(rs.mu))
    # three steps on the mesh, saved whole from it
    _, _, _, (tp, ts) = _train(mesh, CKPT_ARCH, trees[CKPT_ARCH], True, 1)
    CheckpointManager(port_ckpt).save(STEPS, (tp, ts), mesh=mesh,
                                      policy=policy, cfg=cfg)
    out["saved_whole"] = _whole(tp, cfg, mesh, policy)
    out["saved_mu"] = _whole(ts.mu, cfg, mesh, policy)
    # int8 compression of a leaf cut over both axes
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (8, 6)).astype(np.float32))
    g[3, 5] = 9.0                         # the max lives on one rank only
    d, m = mesh.coords["data"], mesh.coords["model"]
    block = g[d * 4:(d + 1) * 4, m * 3:(m + 1) * 3]
    cut = compress_int8(block, groups=(mesh.groups["model"],
                                       mesh.groups["data"]))
    out["int8"] = (torch.equal(cut, compress_int8(g)[
        d * 4:(d + 1) * 4, m * 3:(m + 1) * 3]),
        torch.equal(compress_int8(block), cut))
    out["retry"] = _retry_runs(mesh, tmp)
    return out


# ---------------------------------------------------------------------------
# the reference, the worlds
# ---------------------------------------------------------------------------

def _f32_tree(arch):
    import jax
    from repro import configs as jconfigs
    from repro.models import init_params as jax_init
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                  jax_init(jcfg, jax.random.PRNGKey(0)))


def _reference(arch, tree, microbatches):
    """The JAX package's ``make_train_step`` on ``make_host_mesh()``:
    three steps' metrics (the aux loss from its loss function on the
    same microbatches) and the final params."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.data import DataConfig as JaxDataConfig
    from repro.data import SyntheticTokens as JaxSyntheticTokens
    from repro.launch.mesh import make_host_mesh
    from repro.optim import AdamW as JaxAdamW
    from repro.runtime import ShardingPolicy
    from repro.runtime import make_loss_fn, make_train_step as jax_step
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    mesh = make_host_mesh()
    opt = JaxAdamW(**OPT)
    step, _ = jax_step(jcfg, opt, mesh, ShardingPolicy(),
                       microbatches=microbatches, donate=False)
    loss_fn = jax.jit(make_loss_fn(jcfg, remat=True))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = opt.init(params)
    data = JaxSyntheticTokens(jcfg, JaxDataConfig(BATCH, SEQ, 0))
    metrics = []
    for i in range(STEPS):
        batch = data.batch(i)
        if "frames" in batch:
            # the reference's encoder scan takes bf16 frames only under
            # bf16 weights; the f32 tree gets them as f32 (exactly)
            batch["frames"] = batch["frames"].astype(jnp.float32)
        rows = BATCH // microbatches
        aux = (np.mean([float(loss_fn(params, jax.tree_util.tree_map(
            lambda v: v[j * rows:(j + 1) * rows], batch))[1]["aux"])
            for j in range(microbatches)]) if jcfg.family == "moe" else 0.0)
        with mesh:
            params, state, m = step(params, state, batch)
        metrics.append(dict(loss=float(m["loss"]),
                            grad_norm=float(m["grad_norm"]), aux=aux))
    return metrics, _flat(jax.tree_util.tree_map(np.asarray, params))


def _reference_checkpoint(path, tree):
    """A reference checkpoint of (f32 params after one update, AdamW
    state at count 1) at step 5."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager as JaxCheckpointManager
    from repro.optim import AdamW as JaxAdamW
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = JaxAdamW(**OPT)
    state = opt.init(params)
    grads = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 0.01, params)
    params, state, _ = opt.update(grads, state, params)
    JaxCheckpointManager(path).save(5, (params, state))
    return (_flat(jax.tree_util.tree_map(np.asarray, params)),
            _flat(jax.tree_util.tree_map(np.asarray, state.mu)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds started at once in threads; the reference runs here
    meanwhile.  Each test waits for what it reads."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    trees = {arch: _f32_tree(arch) for arch in ARCHS}
    ref_ckpt, port_ckpt = str(tmp / "reference"), str(tmp / "port")
    ref_whole = _reference_checkpoint(ref_ckpt, trees[CKPT_ARCH])
    two = [(a, n) for a in ARCHS for n in MESHES if n != "dp2xtp2_fsdp"]
    four = [(a, "dp2xtp2_fsdp") for a in ARCHS]
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futs = {"two": pool.submit(M.spawn, world, (trees, two, None), data=2,
                               device="cpu"),
            "four": pool.submit(M.spawn, world, (trees, four, dict(
                ref_ckpt=ref_ckpt, port_ckpt=port_ckpt, tmp=str(tmp))),
                data=2, model=2, device="cpu")}
    # the reference's compiles release the interpreter: three at a time
    keys = [(arch, mb) for arch in ARCHS for mb in (1, 2)]
    with concurrent.futures.ThreadPoolExecutor(3) as refs_pool:
        refs = dict(zip(keys, refs_pool.map(
            lambda key: _reference(key[0], trees[key[0]], key[1]), keys)))
    yield dict(futs=futs, refs=refs, ref_whole=ref_whole,
               port_ckpt=port_ckpt, trees=trees)
    pool.shutdown(wait=True)


def _ranks(worlds, name):
    return worlds["futs"]["four" if name == "dp2xtp2_fsdp" else "two"] \
        .result()


# ---------------------------------------------------------------------------
# training on every mesh against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_training_matches_the_reference(worlds, arch, name):
    ranks = _ranks(worlds, name)
    want_metrics, want_params = worlds["refs"][(arch, MESHES[name][3])]
    jobs = [r["jobs"][(arch, name)] for r in ranks]
    for job in jobs:                   # the metrics are global: equal
        assert job["metrics"] == jobs[0]["metrics"]
    for i, (got, want) in enumerate(zip(jobs[0]["metrics"], want_metrics)):
        for key in ("loss", "grad_norm", "aux"):
            np.testing.assert_allclose(got[key], want[key],
                                       err_msg=f"step {i} {key}", **TOL)
    whole = jobs[0]["whole"]
    assert sorted(whole) == sorted(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(whole[k], v, err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("name", ["tp2", "dp2xtp2_fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_whole_leaves_stay_equal_on_every_tp_rank(worlds, arch, name):
    """Norms, the router and every leaf tp does not cut get the same
    whole gradient on each tp rank (Megatron's f/g), so
    after three steps the ranks of a replica hold them bit for bit
    alike."""
    jobs = [r["jobs"][(arch, name)] for r in _ranks(worlds, name)]
    by_replica = {}
    for job in jobs:
        by_replica.setdefault(job["coords"]["data"], []).append(job)
    for replica in by_replica.values():
        assert len(replica) == 2 and replica[0]["tp_whole"]
        for k, v in replica[0]["tp_whole"].items():
            np.testing.assert_array_equal(replica[1]["tp_whole"][k], v,
                                          err_msg=k)


def test_ranks_are_laid_out_data_major(worlds):
    """rank = data·(pipe·model) + pipe·model + model, each axis of more
    than one rank with its group, and no rank loaded JAX."""
    for name, (data, model) in (("two", (2, 1)), ("four", (2, 2))):
        ranks = worlds["futs"][name].result()
        assert len(ranks) == data * model
        for r in ranks:
            c = r["coords"]
            assert r["rank"] == c["data"] * model + c["model"]
            assert r["groups"] == {"data": True, "model": model > 1,
                                   "pipe": False}
            assert r["loaded"] == []
        # the tp = 2 mesh made inside the two-rank world
        tp = [r["jobs"][(ARCHS[0], "tp2")]["coords"] for r in ranks
              ] if name == "two" else []
        assert tp in ([], [{"data": 0, "model": 0, "pipe": 0},
                           {"data": 0, "model": 1, "pipe": 0}])


def test_compress_int8_on_a_cut_leaf_equals_the_whole_one(worlds):
    for r in worlds["futs"]["four"].result():
        same_as_whole, same_as_alone = r["int8"]
        assert same_as_whole
        # the rank without the largest element would scale otherwise
        assert same_as_alone == (r["coords"]["data"] == 0
                                 and r["coords"]["model"] == 1)


def test_pipe_axis_is_refused():
    cfg = configs.reduced(configs.get("granite-3-2b"))
    mesh = M.Mesh({"data": 1, "model": 1, "pipe": 2},
                  {"data": 0, "model": 0, "pipe": 0}, 0, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match=r"trains on no pipe axis"):
        make_train_step(cfg, AdamW(), mesh)


def test_retry_under_a_mesh_equals_a_run_without_the_fault(worlds):
    """On 2 × 2 ranks with FSDP: a fault before any checkpoint is retried
    on the live shards, one after the checkpoint of step 1 from
    ``restore_sharded``; both end bit for bit where the straight run
    does, params and moments, on every rank."""
    for r in worlds["futs"]["four"].result():
        straight, log = r["retry"]["straight"]
        assert [e["step"] for e in log] == [0, 1, 2, 3]
        for name in ("live", "restored"):
            got, glog = r["retry"][name]
            assert glog[-1]["step"] == 3
            assert all(torch.equal(a, b) for a, b in zip(got, straight)), \
                name


# ---------------------------------------------------------------------------
# checkpoints across packages and mesh shapes
# ---------------------------------------------------------------------------

def test_reference_checkpoint_restores_sharded_on_2x2(worlds):
    """The reference writes (one device); each rank of a 2 × 2 FSDP mesh
    restores exactly its cut of every leaf, moments like params."""
    want_params, want_mu = worlds["ref_whole"]
    cfg = configs.reduced(configs.get(CKPT_ARCH))
    policy = S.ShardingPolicy(fsdp=True)
    unflat = lambda flat: bridge.params_from_numpy(_unflatten(flat),
                                                   device="cpu")
    for r in worlds["futs"]["four"].result():
        mesh = M.Mesh({"data": 2, "model": 2, "pipe": 1}, r["coords"],
                      r["rank"], torch.device("cpu"))
        got = r["restored"]
        assert got["step"] == 5 and got["count"] == 1
        for key, flat in (("params", want_params), ("mu", want_mu)):
            cut = bridge.params_to_numpy(S.shard_params(unflat(flat), cfg,
                                                        mesh, policy))
            mine = _flat(got[key])
            assert sorted(mine) == sorted(_flat(cut))
            for k, v in _flat(cut).items():
                np.testing.assert_array_equal(mine[k], v, err_msg=k)


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


def test_port_checkpoint_from_2x2_restores_in_the_reference(worlds):
    """The port saves from a 2 × 2 FSDP mesh; the reference restores the
    whole leaves on one device, and so does the port (tp = 1)."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import CheckpointManager as JaxCheckpointManager
    from repro.optim import AdamW as JaxAdamW
    four = worlds["futs"]["four"].result()
    want, want_mu = four[0]["saved_whole"], four[0]["saved_mu"]
    example = jax.tree_util.tree_map(jnp.asarray,
                                     worlds["trees"][CKPT_ARCH])
    example = (example, JaxAdamW(**OPT).init(example))
    (jp, js), step = JaxCheckpointManager(worlds["port_ckpt"]).restore(
        example)
    assert step == STEPS and int(js.count) == STEPS
    for got, ref in ((_flat(jax.tree_util.tree_map(np.asarray, jp)), want),
                     (_flat(jax.tree_util.tree_map(np.asarray, js.mu)),
                      want_mu)):
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    cfg = configs.reduced(configs.get(CKPT_ARCH))
    from repro_torch.models.layers import init_params
    tp = init_params(cfg, 1, device="cpu", dtype=torch.float32)
    (pp, ps), step = CheckpointManager(worlds["port_ckpt"]).restore(
        (tp, AdamW().init(tp)))
    for k, v in _flat(bridge.params_to_numpy(pp)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# ---------------------------------------------------------------------------
# specs, the mesh's device, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [{"data": 2, "model": 2}, {"data": 4},
                                   {"pod": 2, "data": 16, "model": 16}],
                         ids=["data2_model2", "data4", "pod2_data16_model16"])
@pytest.mark.parametrize("name", sorted(configs.ARCHS))
def test_training_specs_equal_the_reference(name, shape):
    """``batch_specs``, ``policy_for`` and ``opt_state_specs`` against
    the reference's ``batch_shardings``, ``policy_for`` and
    ``dataclass_opt_shardings`` (``AbstractMesh``: no devices)."""
    import dataclasses as dc
    from jax.sharding import AbstractMesh
    from repro import configs as jconfigs
    from repro.runtime import sharding as JS
    from repro.runtime.train import dataclass_opt_shardings

    @dc.dataclass(frozen=True)
    class Shape:
        shape: dict
    jmesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    jcfg, cfg = jconfigs.get(name), configs.get(name)
    for batch in (0, 3, 64):
        jpol = JS.policy_for(jcfg, jmesh, batch=batch)
        pol = S.policy_for(cfg, Shape(shape), batch=batch)
        assert dc.asdict(pol) == dc.asdict(jpol)
    struct = {k: np.zeros(s, np.float32) for k, s in (
        ("inputs", (64, 2048)), ("targets", (64, 2048)), ("mask", (64, 2048)),
        ("frames", (64, 1500, 512)), ("vision_embeds", (3, 256, 64)),
        ("extra", (64, 7)))}
    for fsdp in (False, True):
        for seq_shard in (False, True):
            dp = tuple(a for a in ("pod", "data") if a in shape)
            jpol = JS.ShardingPolicy(dp_axes=dp, fsdp=fsdp,
                                     seq_shard=seq_shard)
            pol = S.ShardingPolicy(dp_axes=dp, fsdp=fsdp, seq_shard=seq_shard)
            got = S.batch_specs(cfg, Shape(shape), pol, struct)
            want = {k: tuple(v.spec) for k, v in JS.batch_shardings(
                jcfg, jmesh, jpol, struct).items()}
            assert got == want
            jopt = dataclass_opt_shardings(
                JS.param_shardings(jcfg, jmesh, jpol), jmesh)
            opt = S.opt_state_specs(S.param_specs(cfg, Shape(shape), pol))
            assert opt.count == tuple(jopt.count.spec)
            for mine, ref in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
                assert _flat_specs(mine) == {k: tuple(v.spec) for k, v in
                                             _flat_specs(ref).items()}


def _flat_specs(tree, path=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = v
    return out


def test_a_one_rank_mesh_is_on_the_card_or_raises():
    """``make_host_mesh()`` asked for no device takes the card; without
    one it raises instead of running on the host."""
    if torch.cuda.is_available():
        assert M.make_host_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            M.make_host_mesh()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(configs.reduced(configs.get("granite-3-2b")), AdamW(),
                    None, TrainerConfig(), mesh=M.make_host_mesh())
    assert M.make_host_mesh(device="cpu").device.type == "cpu"
    assert M.make_host_mesh(data=1, device="cpu").shape == {
        "data": 1, "model": 1, "pipe": 1}


def test_shard_batch_takes_the_rank_rows():
    """The port's batch override: a rank holds its replica's block of
    rows with ``seq`` whole, though the reference's spec cuts ``seq``
    over ``"model"`` under ``seq_shard``; rows the data axis does not
    divide are refused."""
    mesh = M.Mesh({"data": 2, "model": 2, "pipe": 1},
                  {"data": 1, "model": 0, "pipe": 0}, 2, torch.device("cpu"))
    batch = {"inputs": torch.arange(24).reshape(4, 6),
             "frames": torch.zeros(4, 3, 2)}
    seq = S.ShardingPolicy(seq_shard=True)
    assert S.batch_specs(None, mesh, seq, batch)["inputs"] == ("data",
                                                                "model")
    for policy in (S.ShardingPolicy(), seq):
        got = S.shard_batch(batch, mesh, policy)
        assert torch.equal(got["inputs"], batch["inputs"][2:])
        assert got["frames"].shape == (2, 3, 2)
    with pytest.raises(ValueError, match="multiple of the 2"):
        S.shard_batch({"inputs": torch.zeros(3, 6)}, mesh, S.ShardingPolicy())


def test_train_launcher_data2_reduced_cpu(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "granite-3-2b", "--reduced", "--device", "cpu", "--steps", "3",
         "--batch", "4", "--seq", "32", "--data", "2", "--fsdp",
         "--ckpt-dir", str(tmp_path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "data=2 x model=1 x pipe=1: 2 ranks on the CPU" in out.stderr
    summary = json.loads(out.stdout[out.stdout.index("{"):])
    cfg = configs.reduced(configs.get("granite-3-2b"))
    assert summary["arch"] == "granite-3-2b-reduced"
    assert summary["params"] == sum(np.prod(d.shape) for _, d in
                                    _paths(param_defs(cfg)))
    assert summary["steps"] == 3 and np.isfinite(summary["final_loss"])
