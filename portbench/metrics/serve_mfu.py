"""The model FLOPs of the window's prefill chunks and decode blocks
(``portbench.flops.serve_flops``) over the window's seconds times the
card's bf16 peak, in percent."""
from portbench.peaks import BF16_FLOPS_PER_S

LAYER, UNIT, SOURCE, MOVES = ("model", "%", "host_clock",
                              "prompt_tokens_per_s")


def read(run):
    if not run.events or not run.model_flops:
        return None
    return 100 * run.model_flops / (run.window_s * BF16_FLOPS_PER_S)
