"""The traffic: the serving lengths and order are the same for every
seed, the token ids differ; a training row is the same for a seed and
step and differs from every other."""
import numpy as np
import pytest

from portbench.kinds.closed_loop import Clients
from portbench.kinds.train import Batches
from portbench.tests.conftest import SERVE, train_files

SEEDS = (0, 7, 2**31 + 11, 2**40 + 3)


def _requests(traffic, vocab, seed, n=40):
    cl = Clients(traffic, vocab, seed)
    out = []
    for i in range(n):
        r = cl.next(i % traffic["clients"])
        out.append((len(r.prompt), r.max_new, r.prompt))
    return out


@pytest.mark.parametrize("seed", SEEDS[1:])
def test_serving_lengths_fixed_ids_differ(manifest, seed):
    cell = manifest.cell(SERVE)
    traffic, vocab = manifest.traffic(cell), manifest.config(cell)["vocab_size"]
    a, b = _requests(traffic, vocab, SEEDS[0]), _requests(traffic, vocab, seed)
    assert [x[:2] for x in a] == [x[:2] for x in b]
    assert all(not np.array_equal(x[2], y[2]) for x, y in zip(a, b))
    again = _requests(traffic, vocab, seed)
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(b, again))
    assert all(0 <= p.min() and p.max() < vocab for _, _, p in b)


def test_serving_lists(manifest):
    t = manifest.traffic(manifest.cell(SERVE))
    P, O = t["prompt_lengths"], t["output_lengths"]
    assert len(P) == len(O) == 16 and P[0] == 8192 and P[-1] == 16384
    assert O[0] == 16 and O[-1] == 64
    assert max(P) + max(O) <= t["engine"]["max_len"]
    cl = Clients(t, 10, 0)
    # every client walks all sixteen prompt lengths, from its own offset
    for c in range(t["clients"]):
        assert sorted(cl.lengths(c, j)[0] for j in range(16)) == sorted(P)


@pytest.mark.parametrize("seed", SEEDS)
def test_training_rows(manifest, seed):
    conf, traffic, _ = train_files()
    vocab = conf["vocab_size"]
    data = Batches(traffic, vocab, seed, "cpu")
    i0, t0, m0 = data.rows(0)
    i1, _, _ = data.rows(1)
    assert i0.shape == (traffic["batch"], traffic["seq_len"])
    assert np.array_equal(i0, Batches(traffic, vocab, seed, "cpu").rows(0)[0])
    assert not np.array_equal(i0, i1)
    assert len({r.tobytes() for r in np.concatenate([i0, i1])}) == 2 * len(i0)
    assert np.array_equal(i0[:, 1:], t0[:, :-1])
    assert i0.min() >= 0 and i0.max() < vocab
    eos = traffic["eos_id"]
    assert np.array_equal(m0 == 0, i0 == eos) and (i0 == eos).any()
