"""The vocabulary cut over tensor-parallel ranks, on the CPU: one gloo
world of two ranks (``launch.mesh.spawn``) runs the helpers of
``models.act_sharding`` and the trainer's vocab-parallel
``cross_entropy`` on the same numpy-seeded inputs, and each result is
held against the plain operation on the whole vocabulary:

* ``tp_argmax`` equals ``torch.argmax`` exactly, ties across the shard
  seam included (rank 0's index wins, as in ``torch.argmax`` and
  ``jnp.argmax``), in f32 and bf16;
* ``vocab_embed`` equals the whole lookup exactly, and each rank's
  table gradient is its rows of the whole one;
* ``tp_whole_logits`` and a temperature draw equal the whole ones;
* the vocab-parallel loss and its gradient equal ``cross_entropy`` on
  whole logits within 1e-6 (f32).

Then ``rank_spec`` of every ``vocab`` dim equals ``spec_for``'s (the
reference's rules, held equal to its ``PartitionSpec``s by
``tests/test_torch_sharding_specs.py``) for every config, and the widths
tp = 2 does not divide stay whole.

This module imports no JAX: the spawned ranks import it to find their
function."""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.engine.sampling import sample
from repro_torch.launch import mesh as M
from repro_torch.models import act_sharding
from repro_torch.models.layers import param_defs
from repro_torch.runtime import sharding as S
from repro_torch.runtime.train import cross_entropy

V, D = 64, 8
#: f32 on both sides, the same arithmetic in another order
CE_TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 3, V)).astype(np.float32)
    top = logits.max() + 1.0
    logits[0, 0, [V // 2 - 1, V // 2]] = top      # a tie across the seam
    logits[0, 1, [5, V - 3]] = top                # ... far from it
    logits[1, 2, [V // 2, V // 2 + 7]] = top      # a tie inside rank 1
    return dict(
        logits=logits,
        table=rng.standard_normal((V, D)).astype(np.float32),
        ids=rng.integers(0, V, (3, 7)),
        dy=rng.standard_normal((3, 7, D)).astype(np.float32),
        targets=rng.integers(0, V, (4, 3)),
        mask=(rng.random((4, 3)) > 0.2).astype(np.float32))


def _rank(mesh):
    """One rank's results on its block of the vocabulary."""
    act_sharding.set_mesh(mesh)
    x = _inputs()
    r, w = mesh.coords["model"], V // mesh.shape["model"]
    cut = lambda a: torch.from_numpy(np.ascontiguousarray(a[..., r * w:
                                                           (r + 1) * w]))
    logits = cut(x["logits"])
    out = {"argmax": act_sharding.tp_argmax(logits, V).numpy(),
           "argmax_bf16": act_sharding.tp_argmax(
               logits.bfloat16(), V).numpy(),
           "whole": act_sharding.tp_whole_logits(logits, V).numpy()}
    gen = torch.Generator().manual_seed(3)
    out["drawn"] = sample(logits, 0.7, gen, vocab=V).numpy()

    table = torch.from_numpy(x["table"][r * w:(r + 1) * w]).requires_grad_()
    ids = torch.from_numpy(x["ids"])
    emb = act_sharding.vocab_embed(table, ids, V)
    (emb * torch.from_numpy(x["dy"])).sum().backward()
    out["embed"] = emb.detach().numpy()
    out["embed_grad"] = table.grad.numpy()

    lg = logits.clone().requires_grad_()
    loss = cross_entropy(lg, torch.from_numpy(x["targets"]),
                         torch.from_numpy(x["mask"]), vocab=V)
    loss.backward()
    out["loss"] = float(loss.detach())
    out["loss_grad"] = lg.grad.numpy()
    act_sharding.clear_mesh()
    return out


@pytest.fixture(scope="module")
def ranks():
    return M.spawn(_rank, model=2, device="cpu")


def _whole():
    x = _inputs()
    logits = torch.from_numpy(x["logits"])
    table = torch.from_numpy(x["table"]).requires_grad_()
    emb = table[torch.from_numpy(x["ids"])]
    (emb * torch.from_numpy(x["dy"])).sum().backward()
    lg = logits.clone().requires_grad_()
    loss = cross_entropy(lg, torch.from_numpy(x["targets"]),
                         torch.from_numpy(x["mask"]))
    loss.backward()
    gen = torch.Generator().manual_seed(3)
    return dict(logits=x["logits"], embed=emb.detach().numpy(),
                embed_grad=table.grad.numpy(), loss=float(loss.detach()),
                loss_grad=lg.grad.numpy(),
                drawn=sample(logits, 0.7, gen, vocab=V).numpy())


def test_tp_argmax_equals_argmax_with_ties_across_the_seam(ranks):
    logits = torch.from_numpy(_whole()["logits"])
    want = torch.argmax(logits, -1).numpy()
    assert want[0, 0] == V // 2 - 1 and want[0, 1] == 5 \
        and want[1, 2] == V // 2
    want_bf16 = torch.argmax(logits.bfloat16(), -1).numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["argmax"], want)
        np.testing.assert_array_equal(r["argmax_bf16"], want_bf16)
        assert r["argmax"].dtype == np.int64


def test_vocab_embed_equals_the_whole_lookup(ranks):
    whole = _whole()
    w = V // len(ranks)
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["embed"], whole["embed"])
        np.testing.assert_array_equal(
            r["embed_grad"], whole["embed_grad"][i * w:(i + 1) * w])


def test_whole_logits_and_a_temperature_draw_equal_the_whole_ones(ranks):
    whole = _whole()
    for r in ranks:
        np.testing.assert_array_equal(r["whole"], whole["logits"])
        np.testing.assert_array_equal(r["drawn"], whole["drawn"])


def test_vocab_parallel_cross_entropy_equals_the_whole_one(ranks):
    whole = _whole()
    w = V // len(ranks)
    for i, r in enumerate(ranks):
        np.testing.assert_allclose(r["loss"], whole["loss"], **CE_TOL)
        np.testing.assert_allclose(
            r["loss_grad"], whole["loss_grad"][..., i * w:(i + 1) * w],
            **CE_TOL)


def test_helpers_are_the_plain_operations_on_a_whole_vocabulary():
    """With the whole vocabulary on the rank (no mesh, or a width tp does
    not divide) the helpers make no collective."""
    x = _inputs()
    logits, table = (torch.from_numpy(x[k]) for k in ("logits", "table"))
    ids = torch.from_numpy(x["ids"])
    assert torch.equal(act_sharding.tp_argmax(logits, V),
                       torch.argmax(logits, -1))
    assert torch.equal(act_sharding.vocab_embed(table, ids, V), table[ids])
    assert act_sharding.tp_whole_logits(logits, V) is logits


_MESHES = {"tp2": {"data": 1, "model": 2}, "tp3": {"data": 1, "model": 3},
           "dp2xtp2": {"data": 2, "model": 2}}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", sorted(_MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_rank_spec_cuts_vocab_where_spec_for_does(arch, mesh, fsdp):
    cfg = configs.get(arch)
    shape = S._Shape(_MESHES[mesh])
    pol = S.ShardingPolicy(fsdp=fsdp)
    seen = 0
    for path, d in _leaves(param_defs(cfg)):
        if "vocab" in d.axes:
            seen += 1
            assert S.rank_spec(path, d.axes, d.shape, shape, pol) == \
                S.spec_for(d.axes, d.shape, shape, pol), path
    assert seen >= 1


def _leaves(defs, path=()):
    for k, v in defs.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("arch,cut", [
    ("qwen2-7b", True), ("llama2-7b", True), ("qwen2-moe-a2.7b", True),
    ("recurrentgemma-2b", True), ("granite-3-2b", False),
    ("whisper-base", False)])
def test_vocab_is_cut_at_tp2_where_it_divides(arch, cut):
    """At tp = 2: qwen2-7b (152064), llama2-7b (32000), qwen2-moe-a2.7b
    (151936) and recurrentgemma-2b (256000, tied) cut their vocabulary;
    granite-3-2b (49155) and whisper-base (51865) keep it whole; every
    reduced config (512) cuts it."""
    shape = S._Shape({"data": 1, "model": 2})
    for c, want in ((configs.get(arch), cut),
                    (configs.reduced(configs.get(arch)), True)):
        specs = S.rank_specs(c, 1, 8, shape)["params"]
        got = {specs["embed"][0]}
        if "lm_head" in specs:
            got.add(specs["lm_head"][1])
        assert got == {"model" if want else None}, (c.name, c.vocab_size)
