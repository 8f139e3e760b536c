"""The window's arithmetic counts only what completed inside it."""
import types

import numpy as np

from portbench.kinds.closed_loop import (pick_sample, tokens_completed,
                                         window_counts)


def test_prompt_tokens_count_chunks_completed_in_the_window():
    # chunks completing 1.0, 9.99, 10.0 and 10.01 s after the opening
    chunks = [(1.0, 2048), (9.99, 2048), (10.0, 100), (10.01, 2048)]
    assert tokens_completed(chunks, 10.0, lambda e: e) == 4196


def test_requests_in_the_window():
    r = lambda arrival, first, finished: types.SimpleNamespace(
        arrival=arrival, first_token=first, finished=finished)
    # base 100 on the host clock; the window is [110, 120]
    results = {0: r(1.0, 5.0, 9.0),        # all before the window
               1: r(5.0, 12.0, 15.0),      # first token and end inside
               2: r(12.0, 19.0, 25.0),     # first token inside, ends after
               3: r(18.0, 0.0, 0.0)}       # not started
    w = window_counts(results, 100.0, 110.0, 120.0)
    assert w["finished"] == [1]
    assert sorted(w["ttft_s"]) == [7.0, 7.0]


def test_train_window_counts_every_step_it_ran(manifest, monkeypatch):
    """On the host clock (off the card) the training window holds every
    step it started, and its rate is their tokens over its length."""
    from repro_torch.runtime import train
    from portbench import run as R
    from portbench.tests.conftest import tiny_train
    conf, traffic, limits = tiny_train(manifest)
    calls = []
    real = train.make_train_step

    def counting(*a, **kw):
        step = real(*a, **kw)

        def wrapped(*args):
            calls.append(1)
            return step(*args)
        return wrapped
    monkeypatch.setattr(train, "make_train_step", counting)
    out = R.run_cell(conf, traffic, limits, seed=5, seconds=0.5, trace=False,
                     device="cpu")
    steps = len(calls) - traffic["check_steps"]
    assert out["attempted"] == out["run"].steps == steps >= 2
    assert out["metrics"]["train_tokens_per_s"] == (
        steps * traffic["batch"] * traffic["seq_len"] / out["run"].window_s)


def test_sample_is_the_longest_then_one_per_slot():
    # requests 0..11 on slots r % 4; request 7 is the longest
    finished = list(range(12))
    slot_of = {r: r % 4 for r in finished}
    size = lambda r: 100 if r == 7 else r
    for seed in range(5):
        got = pick_sample(finished, slot_of, size, 5,
                          np.random.default_rng(seed))
        assert got[0] == 7 and len(got) == len(set(got)) == 5
        assert sorted(slot_of[r] for r in got[:4]) == [0, 1, 2, 3]
    again = pick_sample(finished, slot_of, size, 5, np.random.default_rng(4))
    assert again == got
    assert pick_sample([3], slot_of, size, 5, np.random.default_rng(0)) == [3]
    assert pick_sample([], slot_of, size, 5, np.random.default_rng(0)) == []
