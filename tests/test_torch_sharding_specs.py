"""``runtime.sharding``'s rules against the JAX package's, with no ranks:
for every registered config, every parameter leaf's ``spec_for`` (the
reference's ``param_shardings``) and every decode-state key's
(``decode_state_shardings``), and ``decode_state_axes``, on four mesh
shapes, with FSDP and sequence sharding each on and off.  The reference
side needs only mesh shapes: ``jax.sharding.AbstractMesh`` (no devices);
the port's ``spec_for`` reads only ``mesh.shape``.  The port's spec of a
dim is a mesh axis, a tuple of axes or None, as the reference's
``PartitionSpec`` entries are."""
import dataclasses
import functools
import itertools

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as M
from repro_torch.runtime import sharding as S

MESHES = {"model2": {"model": 2}, "model2_pipe2": {"model": 2, "pipe": 2},
          "data2_model2": {"data": 2, "model": 2},
          "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16}}
#: (batch, max_len) of the decode state: one that divides every mesh,
#: one that divides none
STATES = ((32, 4096), (3, 100))


@dataclasses.dataclass(frozen=True)
class _Shape:
    shape: dict


def _policies(shape, module):
    dp = tuple(a for a in ("pod", "data") if a in shape)
    return [module.ShardingPolicy(dp_axes=dp or ("data",), fsdp=f,
                                  seq_shard=q)
            for f, q in itertools.product((False, True), repeat=2)]


@functools.lru_cache(maxsize=None)
def _reference_shapes(name):
    from repro import configs as jconfigs
    from repro import models
    jcfg = jconfigs.get(name)
    return jcfg, models.abstract_params(jcfg)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", configs.ARCHS)
def test_specs_equal_the_reference(name, mesh):
    from jax.sharding import AbstractMesh
    from repro.runtime import sharding as JS
    shape = MESHES[mesh]
    jmesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    jcfg, abstract = _reference_shapes(name)
    cfg = configs.get(name)
    assert S.decode_state_axes(cfg) == JS.decode_state_axes(jcfg)
    assert {p: d.shape for p, d in _leaves(S.param_defs(cfg))} == {
        p: tuple(a.shape) for p, a in _leaves(abstract)}
    for pol, jpol in zip(_policies(shape, S), _policies(shape, JS)):
        got = dict(_leaves(S.param_specs(cfg, _Shape(shape), pol)))
        want = {path: tuple(s.spec) for path, s in _leaves(
            JS.param_shardings(jcfg, jmesh, jpol))}
        assert got == want, (pol, [p for p in want if got.get(p) != want[p]])
        for batch, max_len in STATES:
            got = S.decode_state_specs(cfg, batch, max_len, _Shape(shape),
                                       pol)
            want = {k: tuple(s.spec) for k, s in JS.decode_state_shardings(
                jcfg, batch, max_len, jmesh, jpol).items()}
            assert got == want, (pol, batch, max_len)


def test_rank_spec_overrides():
    """What a rank holds differs from the reference's spec only by the
    documented overrides: the router whole, experts checked padded,
    ``kv_len`` never cut, ``layers`` cut by stage for any count, Mamba's
    ``in_proj`` checked per half.  ``vocab`` is no override: it is cut
    where the reference cuts it."""
    mesh = _Shape({"data": 1, "model": 2, "pipe": 3})
    pol = S.ShardingPolicy()
    assert S.spec_for(("vocab", "embed"), (512, 128), mesh, pol) == \
        ("model", None)
    assert S.rank_spec(("embed",), ("vocab", "embed"), (512, 128), mesh) \
        == ("model", None)
    assert S.rank_spec(("layers", "mlp", "router"),
                       ("layers", "embed", "experts"), (3, 128, 60), mesh) \
        == ("pipe", None, None)
    assert S.spec_for(("experts", "embed", "expert_mlp"), (15, 8, 8),
                      mesh, pol) == (None, None, None)
    assert S.rank_spec(("layers", "mlp", "w_gate"),
                       ("experts", "embed", "expert_mlp"), (15, 8, 8),
                       mesh) == ("model", None, None)
    cache = ("layers", "batch", "kv_len", "kv_heads", None)
    assert S.spec_for(cache, (2, 4, 32, 1, 8), mesh, pol)[2] == "model"
    assert S.rank_spec(("cache_k",), cache, (2, 4, 32, 1, 8), mesh) == \
        ("pipe", "data", None, None, None)
    assert S.rank_spec(("layers", "ssm", "in_proj"), ("embed", "inner"),
                       (8, 6), mesh) == (None, None)        # 3 per half
    assert S.stage_range(26, 1, 2) == (13, 26)
    assert [S.stage_range(3, s, 2) for s in range(2)] == [(0, 1), (1, 3)]


@pytest.mark.parametrize("plan", [(2, 1), (1, 2), (2, 2)],
                         ids=["tp2", "pp2", "tp2xpp2"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b",
                                  "llama2-7b-mla", "whisper-base"])
def test_rank_shards_cover_the_whole_tree(arch, plan):
    """Every leaf of the whole tree is held by some rank, each rank's
    shard of a leaf is its spec's block (Mamba's ``in_proj`` per half),
    and ``init_shard`` draws the cut of the one-device draw."""
    from repro_torch.models.layers import init_params, logical_axes
    model, pipe = plan
    cfg = configs.reduced(configs.get(arch))
    full = init_params(cfg, 5, device="cpu", dtype=torch.float32)
    axes = dict(_leaves(logical_axes(cfg)))
    held = set()
    for s in range(pipe):
        for m in range(model):
            mesh = M.Mesh({"data": 1, "model": model, "pipe": pipe},
                          {"data": 0, "model": m, "pipe": s}, s * model + m,
                          torch.device("cpu"))
            shard = S.shard_params(full, cfg, mesh)
            drawn = S.init_shard(cfg, 5, mesh, device="cpu",
                                 dtype=torch.float32)
            got = dict(_leaves(shard))
            assert got.keys() == dict(_leaves(drawn)).keys()
            for path, t in got.items():
                assert torch.equal(t, dict(_leaves(drawn))[path]), path
                whole = dict(_leaves(full))[path]
                spec = S.rank_spec(path, axes[path], tuple(whole.shape),
                                   mesh)
                for dim, a in enumerate(spec):
                    if a is not None and mesh.shape[a] > 1:
                        assert t.shape[dim] < whole.shape[dim], path
                held.add(path)
    assert held == set(dict(_leaves(full)))
