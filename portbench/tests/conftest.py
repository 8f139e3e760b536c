"""Tiny versions of the cells for the CPU: the cells' own files with the
widths, depths and lengths cut to what a test run holds."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.manifest import (HERE, Manifest, _load_json,  # noqa: E402
                                limits_file, traffic_file)

# the runs here are timed windows of tiny models: one thread each, so
# that workers running side by side do not starve each other's windows
torch.set_num_threads(1)

SERVE, TRAIN = "qwen2-7b.docs-16k", "granite-3-2b.train-4k"


def train_files():
    """The training cell's files: kept for the cell, which is not in
    BENCHMARK.json while the program's embedding gradient is at fault
    (PERF.md, Open questions)."""
    return (_load_json(HERE / "configs" / "granite-3-2b.json"),
            traffic_file("train-4k"), limits_file(TRAIN))
TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=256)


@pytest.fixture(scope="session")
def manifest():
    return Manifest(ROOT)


def tiny_serve(m):
    cell = m.cell(SERVE)
    conf, traffic = m.config(cell), m.traffic(cell)
    conf.update(TINY)
    traffic.update(clients=4, prompt_lengths=[20, 27, 33, 40],
                   output_lengths=[3, 5, 6, 9])
    traffic["engine"].update(max_slots=2, max_len=64, chunk_size=16,
                             decode_block=2, n_blocks=8)
    traffic["check"]["requests"] = 2
    return conf, traffic, m.limits(cell)


def tiny_train(m):
    conf, traffic, limits = train_files()
    conf.update(TINY, attention_multiplier=0.25)
    traffic.update(batch=2, seq_len=32)
    traffic["doc_length"].update(median=12, max=40)
    return conf, traffic, limits


#: a size at which a bf16 program and its float32 reference read apart
#: from a planted fault or the float8 control (widths the logits' spread
#: and the gradients' sums need), still seconds on the CPU
SMALL = dict(hidden_size=128, intermediate_size=256, num_hidden_layers=4,
             vocab_size=4096)


def small_serve(m):
    conf, traffic, limits = tiny_serve(m)
    conf.update(SMALL)
    traffic.update(prompt_lengths=[40, 60, 80, 100],
                   output_lengths=[12, 16, 20, 24])
    traffic["engine"].update(max_len=128, chunk_size=32, decode_block=4,
                             n_blocks=32)
    traffic["check"]["requests"] = 4
    return conf, traffic, limits


def small_train(m):
    conf, traffic, limits = tiny_train(m)
    conf.update(SMALL, attention_multiplier=32 ** -0.5)
    traffic.update(batch=4, seq_len=64)
    return conf, traffic, limits
