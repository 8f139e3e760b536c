"""Faults planted under the timed path, for the tests that see
``correct`` come out false and for the readings that set a training
cell's upper limits (``portbench.control``).  Each is a context manager
that breaks the program where it is, so that the harness runs as it
does in a benchmark run, which uses none of these."""
from __future__ import annotations

import contextlib
import copy


@contextlib.contextmanager
def _under_train_step(wrap):
    """``make_train_step`` gives its step wrapped in ``wrap``."""
    from repro_torch.runtime import train
    real = train.make_train_step
    train.make_train_step = lambda *a, **kw: wrap(real(*a, **kw))
    try:
        yield
    finally:
        train.make_train_step = real


def half_batch():
    """A training step that leaves out half of the batch's rows and takes
    the mean over the rest."""
    def wrap(step):
        def broken(params, state, batch):
            rows = next(iter(batch.values())).shape[0] // 2
            return step(params, state, {k: v[:rows] for k, v in batch.items()})
        return broken
    return _under_train_step(wrap)


def unchanged_state():
    """A training step that returns the parameters and the optimizer's
    state as they were."""
    def wrap(step):
        def broken(params, state, batch):
            _, _, metrics = step(copy.deepcopy(params), copy.deepcopy(state),
                                 batch)
            return params, state, metrics
        return broken
    return _under_train_step(wrap)


@contextlib.contextmanager
def altered_tokens():
    """Every sampled token is the next id after the one the logits
    chose, where the engine produces it."""
    from repro_torch.engine import decode_loop, scheduler
    real = scheduler.sample

    def shifted(logits, *a, vocab, **kw):
        return (real(logits, *a, vocab=vocab, **kw) + 1) % vocab
    scheduler.sample = decode_loop.sample = shifted
    try:
        yield
    finally:
        scheduler.sample = decode_loop.sample = real


@contextlib.contextmanager
def unwritten_cache():
    """An engine step that leaves the KV cache as it was: no key or
    value is written."""
    from repro_torch.engine import decode_loop
    real = decode_loop._write_kv
    decode_loop._write_kv = lambda *a, **kw: None
    try:
        yield
    finally:
        decode_loop._write_kv = real
