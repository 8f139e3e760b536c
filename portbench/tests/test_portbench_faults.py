"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU, once for each fault a cell can have (one chip: no exchange
between chips to leave out).

The cells' limits are set for their own widths (PERF.md gives the
readings); at the small size a test run holds, the logits and losses
spread less, so these limits stand between the small model's sound
readings and its faults in the same way."""
import pytest

from portbench import faults
from portbench import run as R
from portbench.tests.conftest import small_serve, small_train

SEED = 2**31 + 101
SERVE_LIMITS = {"max_logit_gap": {"limit": 0.02}}
TRAIN_LIMITS = {"first_loss_gap": {"limit": 1e-3},
                "change_gap": {"limit": 0.05}}


def serve(m):
    conf, traffic, _ = small_serve(m)
    return R.run_cell(conf, traffic, SERVE_LIMITS, seed=SEED, seconds=5.0,
                      trace=False, device="cpu")


def train(m):
    conf, traffic, _ = small_train(m)
    return R.run_cell(conf, traffic, TRAIN_LIMITS, seed=SEED, seconds=0.3,
                      trace=False, device="cpu")


def test_sound_runs_are_correct(manifest):
    for out in (serve(manifest), train(manifest)):
        assert out["correct"], out["verdict"]


@pytest.mark.parametrize("fault", ["altered_tokens", "unwritten_cache"])
def test_serving_fault(manifest, fault):
    with getattr(faults, fault)():
        out = serve(manifest)
    assert not out["correct"], out["verdict"]


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state"])
def test_training_fault(manifest, fault):
    with getattr(faults, fault)():
        out = train(manifest)
    assert not out["correct"], out["verdict"]
