"""The frozen counts against shapes worked by hand."""
import importlib
import inspect
from pathlib import Path

import pytest
import torch

from portbench import flops
from portbench.counts import k1, k2, k6_bwd, k6_fwd as k6
from portbench.peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_k2_prefill():
    # a chunk of 4 rows (1 KV head, 2 query heads, d 8) at start 6, 3 valid
    q, ck = meta(4, 1, 2, 8), meta(10, 4, 1, 8)
    keys = 9
    nbytes = 2 * 64 * 2 + keys * 8 * 2 * 2 + 3 * 4
    pairs = 7 + 8 + 9
    flops_ = 4 * pairs * 2 * 8
    want = max(nbytes / HBM_BYTES_PER_S, flops_ / BF16_FLOPS_PER_S) * 1e3
    call = dict(q=q, cache_k=ck, start=6, valid=3, bs=4)
    assert k2.least_ms(call) == pytest.approx(want, rel=1e-12)
    assert k2.prefill_bound(q, ck, 6, 3, 4)[1] == "bytes"


def test_k1_decode_counts_shared_blocks_once():
    q, ck = meta(2, 1, 1, 8), meta(8, 4, 1, 8)
    tables = torch.tensor([[0, 1, 2], [0, 3, 4]], dtype=torch.int32)
    pos = torch.tensor([5, 2])
    # slot 0: block 0 whole (4 keys), block 1 two keys; slot 1: block 0,
    # three keys -> block 0 counts 4 keys once
    keys = 4 + 2
    blocks = 2 + 1
    nbytes = 2 * 16 * 2 + keys * 8 * 2 * 2 + blocks * 4 + 2 * 4
    call = dict(q=q, cache_k=ck, tables=tables, pos=pos, bs=4)
    assert k1.least_ms(call) == pytest.approx(
        nbytes / HBM_BYTES_PER_S * 1e3, rel=1e-12)


def test_k6_pairs_and_bound():
    assert k6.attention_pairs(4, 4, True, None, 0) == 10
    assert k6.attention_pairs(4, 4, False, None, 0) == 16
    assert k6.attention_pairs(4, 4, True, 2, 0) == 7
    case = (2, 4096, 4096, 32, 8, 64, True, None, 0)
    pairs = 4096 * 4097 // 2
    fwd = 4 * 2 * 32 * 64 * pairs / BF16_FLOPS_PER_S * 1e3
    assert k6.least_ms(dict(case=case, elem=2, backward=False)) == \
        pytest.approx(fwd, rel=1e-12)
    assert k6_bwd.least_ms(dict(case=case, elem=2, backward=True)) == \
        pytest.approx(2.5 * fwd, rel=1e-12)


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


#: a call of each count file's entry point, as positional arguments
CALLS = {
    "k1": lambda: (_bf(2, 1, 2, 8), _bf(8, 4, 1, 8), _bf(8, 4, 1, 8),
                   torch.tensor([[0, 1], [2, 3]], dtype=torch.int32),
                   torch.tensor([5, 2], dtype=torch.int32)),
    "k2": lambda: (_bf(4, 1, 2, 8), _bf(8, 4, 1, 8), _bf(8, 4, 1, 8),
                   torch.tensor([0, 1, 2], dtype=torch.int32), 6, 3),
    "k6_fwd": lambda: (_bf(1, 16, 4, 8), _bf(1, 16, 2, 8), _bf(1, 16, 2, 8)),
    "k6_bwd": lambda: (_bf(1, 16, 4, 8), _bf(1, 16, 2, 8), _bf(1, 16, 2, 8),
                       _bf(1, 16, 4, 8), torch.zeros(1, 4, 16),
                       _bf(1, 16, 4, 8)),
}
COUNTS = sorted(p.stem for p in (Path(k1.__file__).parent).glob("*.py")
                if p.stem != "__init__")


def test_every_count_file_has_a_call():
    assert sorted(CALLS) == COUNTS


@pytest.mark.parametrize("name", COUNTS)
def test_count_reads_its_entry_points_arguments(name):
    """Each count names an entry point of the program, takes one call's
    arguments by that function's own names, and counts a least time
    from what it kept."""
    from portbench.probes import KernelProbes
    probes = KernelProbes([name])
    assert probes.names == [name]
    module, attr = probes.counts[name].ENTRY
    entry = getattr(importlib.import_module(module), attr)
    bound = inspect.signature(entry).bind(*CALLS[name]())
    bound.apply_defaults()
    probes.calls[name].append(
        probes.counts[name].shapes(bound.arguments, probes))
    assert probes.least_ms()[name] > 0


def test_model_flops(manifest):
    from portbench.tests.conftest import SERVE, train_files
    conf = train_files()[0]
    n = (49155 * 2048 + 40 * (2 * 2048 * 2048 + 2 * 2048 * 512
                             + 3 * 2048 * 8192 + 2 * 2048) + 2048)
    pairs = 4096 * 4097 // 2
    want = 6 * n * 4 * 4096 + 12 * 4 * 32 * 64 * pairs * 40
    assert flops.train_flops(conf, 4, 4096) == want

    class Ev:
        def __init__(self, kind, **kw):
            self.kind = kind
            self.__dict__.update(kw)
    q = manifest.config(manifest.cell(SERVE))
    per_token = 2 * 28 * (3584 * 3584 * 2 + 3584 * 512 * 2 + 3 * 3584 * 18944)
    head = 2 * 3584 * 152064
    chunk = Ev("prefill_chunk", chunk=3, past_len=5)
    attn = 4 * 28 * 128 * (6 + 7 + 8) * 28
    assert flops.serve_flops(q, [chunk]) == per_token * 3 + attn + head
    block = Ev("decode_block", n_steps=2, slots=((0, 10, 1), (1, 20, 5)))
    dec = (3 * (per_token + head)
           + 4 * 28 * 128 * 28 * (11 + 21 + 22))
    assert flops.serve_flops(q, [block]) == dec
