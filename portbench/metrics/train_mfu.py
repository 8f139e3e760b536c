"""The model FLOPs of the window's training steps
(``portbench.flops.train_flops``: 6 N per token and attention's forward
and backward, remat's recompute not counted) over the window's seconds
times the card's bf16 peak, in percent."""
from portbench.peaks import BF16_FLOPS_PER_S

LAYER, UNIT, SOURCE, MOVES = ("trainer", "%", "host_clock",
                              "train_tokens_per_s")


def read(run):
    if not run.steps:
        return None
    return 100 * run.model_flops / (run.window_s * BF16_FLOPS_PER_S)
