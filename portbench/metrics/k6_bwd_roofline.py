"""K6 backward, ``flash_bwd``: the least time its calls' shapes need
(``portbench/counts/k6_bwd.py``) over the device time inside the
benchmark's ranges around the entry point, in percent."""

LAYER, UNIT, SOURCE, MOVES = ("flash attention", "%", "device_trace",
                              "train_tokens_per_s")
RANGES = ("k6_bwd",)


def read(run):
    return run.roofline("k6_bwd")
