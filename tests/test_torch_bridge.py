"""Parameter bridge: the JAX package's tree crosses into the port bit for
bit and back, and the port draws a tree of the same structure."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jax_init_params
from repro_torch import bridge, configs
from repro_torch.models import init_params

ARCHS = ["llama2-7b", "qwen2-7b"]


def _flat(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_round_trip_is_bit_exact(arch, dtype):
    cfg = jconfigs.reduced(jconfigs.get(arch))
    tree = jax_init_params(cfg, jax.random.PRNGKey(0))
    if dtype == "f32":
        tree = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    port = bridge.params_from_numpy(np_tree, device="cpu")
    back = bridge.params_to_numpy(port)
    want = dict(_flat(np_tree))
    got = dict(_flat(back))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        # bit for bit, bf16 included
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))
    expect = torch.bfloat16 if dtype == "bf16" else torch.float32
    assert all(t.dtype == expect for _, t in _flat(port))


def test_bridge_casts_after_the_exact_crossing():
    arr = np.asarray(jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16))
    t = bridge.tensor_from_numpy(arr, device="cpu", dtype=torch.float32)
    assert t.dtype == torch.float32
    assert t.tolist() == [1.0, -2.5, 3.140625]
    ints = bridge.tensor_from_numpy(np.arange(3, dtype=np.int32), device="cpu",
                                    dtype=torch.float32)
    assert ints.dtype == torch.int32          # only floating leaves cast


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_reference_tree_structure(arch):
    """The port's own random tree has the reference's keys, shapes, the
    init rule (ones, zeros, std-0.02 normals) and its dtype."""
    jcfg = jconfigs.reduced(jconfigs.get(arch))
    cfg = configs.reduced(configs.get(arch))
    ref = dict(_flat(jax_init_params(jcfg, jax.random.PRNGKey(0))))
    got = dict(_flat(init_params(cfg, 0, device="cpu")))
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        t = got[k]
        assert tuple(t.shape) == r.shape, k
        assert t.dtype == torch.bfloat16
        if "gamma" in k:
            assert bool((t == 1).all()), k
        elif k.split("/")[-1] in ("bq", "bk", "bv"):
            assert bool((t == 0).all()), k
        else:
            assert abs(float(t.float().std()) - 0.02) < 2e-3, k
    # a seed fixes the draw
    again = dict(_flat(init_params(cfg, 0, device="cpu")))
    assert all(torch.equal(again[k], got[k]) for k in got)
