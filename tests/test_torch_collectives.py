"""The gathers of ``models.act_sharding`` on a 2 × 2 gloo world on the CPU
(``launch.mesh.spawn``: data = 2, model = 2), each held bit for bit to
the path the port took before it issued all-gathers and reduce-scatters
(each rank's piece in a zero buffer of the whole width, summed by one
``all_reduce``; the gradient's reduce-scatter an ``all_reduce`` and the
rank's slice):

* ``tp_all_gather`` and ``fsdp_gather``, forward and gradient;
* ``tp_argmax`` with ties across the ranks' blocks, and
  ``tp_whole_logits``;

over both transports of ``core.collectives``: gloo's gather and
reduce-scatter on CPU tensors, and the all-reduce that ranks sharing a
card take (gloo gathers no CUDA tensor), forced here.  Under a work
count on the same ranks, ``fsdp_gather`` with a gradient reports one
all-gather and one reduce-scatter and no all-reduce, and ``tp_argmax``
two all-gathers, whichever transport ran.

This module imports no JAX: the spawned ranks import it to find their
function."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import collectives, counts
from repro_torch.launch import mesh as M
from repro_torch.models import act_sharding

V = 16
TRANSPORTS = ("gather", "all_reduce")


def _old_gathered(x, dim, group, ways, index):
    """The port's earlier all-gather: a zero buffer summed by all_reduce."""
    shape = list(x.shape)
    w = shape[dim]
    shape[dim] = ways * w
    full = x.new_zeros(shape)
    full.narrow(dim, index * w, w).copy_(x)
    dist.all_reduce(full, group=group)
    return full


def _old_argmax(logits, group, ways, index):
    """The port's earlier ``tp_argmax``: each rank's (value, index) pair
    in f32, gathered in one zero-filled all_reduce."""
    held = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1, keepdim=True)
    pair = torch.cat([logits.gather(-1, idx).float(),
                      (idx + index * held).float()], dim=-1)
    pairs = _old_gathered(pair, pair.dim() - 1, group, ways,
                          index).unflatten(-1, (ways, 2))
    best = torch.argmax(pairs[..., 0], dim=-1, keepdim=True)
    return pairs[..., 1].gather(-1, best)[..., 0].long()


def _inputs(data, model):
    """This rank's shard, upstream gradients and logits block (numpy)."""
    rng = np.random.default_rng(100 + 10 * data + model)
    logits = np.random.default_rng(7).standard_normal((3, 2, V)).astype(
        np.float32)
    top = logits.max() + 1.0
    logits[0, 0, [V // 2 - 1, V // 2]] = top      # a tie across the seam
    logits[1, 1, [2, V - 1]] = top                # ... far from it
    w = V // 2
    return dict(
        shard=rng.standard_normal((3, 5)).astype(np.float32),
        dy_tp=rng.standard_normal((3, 10)).astype(np.float32),
        dy_fsdp=rng.standard_normal((6, 5)).astype(np.float32),
        logits=np.ascontiguousarray(logits[..., model * w:(model + 1) * w]))


def _results(mesh, x):
    """The helpers' forward results and gradients on this rank."""
    t = lambda a: torch.from_numpy(a)
    out = {}
    shard = t(x["shard"]).requires_grad_()
    y = act_sharding.tp_all_gather(shard, -1)
    y.backward(t(x["dy_tp"]))
    out["tp_fwd"], out["tp_grad"] = y.detach().numpy(), shard.grad.numpy()
    shard = t(x["shard"]).requires_grad_()
    y = act_sharding.fsdp_gather(shard, 0)
    y.backward(t(x["dy_fsdp"]))
    out["fsdp_fwd"], out["fsdp_grad"] = y.detach().numpy(), \
        shard.grad.numpy()
    out["tp_nograd"] = act_sharding.tp_all_gather(t(x["shard"]), 0).numpy()
    logits = t(x["logits"])
    out["argmax"] = act_sharding.tp_argmax(logits, V).numpy()
    out["argmax_bf16"] = act_sharding.tp_argmax(logits.bfloat16(),
                                                V).numpy()
    out["whole"] = act_sharding.tp_whole_logits(logits, V).numpy()
    return out


def _old_results(mesh, x):
    """The same from the earlier path."""
    t = lambda a: torch.from_numpy(a)
    tp, dp = mesh.groups["model"], mesh.groups["data"]
    r, d = mesh.coords["model"], mesh.coords["data"]
    shard = t(x["shard"])
    out = {"tp_fwd": _old_gathered(shard, 1, tp, 2, r).numpy(),
           "tp_grad": t(x["dy_tp"]).narrow(1, 5 * r, 5).numpy(),
           "fsdp_fwd": _old_gathered(shard, 0, dp, 2, d).numpy()}
    dy = t(x["dy_fsdp"]).clone()
    dist.all_reduce(dy, group=dp)
    out["fsdp_grad"] = dy.narrow(0, 3 * d, 3).numpy()
    out["tp_nograd"] = _old_gathered(shard, 0, tp, 2, r).numpy()
    logits = t(x["logits"])
    out["argmax"] = _old_argmax(logits, tp, 2, r).numpy()
    out["argmax_bf16"] = _old_argmax(logits.bfloat16(), tp, 2, r).numpy()
    out["whole"] = _old_gathered(logits, 2, tp, 2, r).numpy()
    return out


def _counted(x):
    """Collective counts of fsdp_gather with a gradient, and of
    tp_argmax."""
    shard = torch.from_numpy(x["shard"]).requires_grad_()
    with counts.count_work() as fsdp:
        act_sharding.fsdp_gather(shard, 0).backward(
            torch.from_numpy(x["dy_fsdp"]))
    with counts.count_work() as argmax:
        act_sharding.tp_argmax(torch.from_numpy(x["logits"]), V)
    return {"fsdp": fsdp.collective_counts,
            "argmax": argmax.collective_counts}


def _rank(mesh):
    act_sharding.set_mesh(mesh)
    x = _inputs(mesh.coords["data"], mesh.coords["model"])
    out = {"old": _old_results(mesh, x)}
    real = collectives._through_all_reduce
    for transport in TRANSPORTS:
        if transport == "all_reduce":
            collectives._through_all_reduce = lambda x, group: True
        try:
            out[transport] = _results(mesh, x)
            out[f"counts_{transport}"] = _counted(x)
        finally:
            collectives._through_all_reduce = real
    act_sharding.clear_mesh()
    return out


@pytest.fixture(scope="module")
def ranks():
    return M.spawn(_rank, data=2, model=2, device="cpu")


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("what", ["tp_fwd", "tp_grad", "fsdp_fwd",
                                  "fsdp_grad", "tp_nograd", "argmax",
                                  "argmax_bf16", "whole"])
def test_gathers_equal_the_earlier_path_bit_for_bit(ranks, transport, what):
    for r in ranks:
        new, old = r[transport][what], r["old"][what]
        assert new.dtype == old.dtype and new.shape == old.shape
        np.testing.assert_array_equal(new, old)


def test_tp_argmax_ties_go_to_the_lower_rank(ranks):
    """The tie across the seam and the one far from it go to rank 0's
    index, as torch.argmax gives them."""
    for r in ranks:
        for transport in TRANSPORTS:
            got = r[transport]["argmax"]
            assert got[0, 0] == V // 2 - 1 and got[1, 1] == 2


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_counts_name_the_reference_ops(ranks, transport):
    none = {k: 0 for k in counts.COLLECTIVES}
    for r in ranks:
        c = r[f"counts_{transport}"]
        assert c["fsdp"] == {**none, "all-gather": 1, "reduce-scatter": 1}
        assert c["argmax"] == {**none, "all-gather": 2}
