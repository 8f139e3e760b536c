"""K1, ``paged_decode``: the least time its calls' shapes need
(``portbench/counts/k1.py``) over the device time inside the
benchmark's ranges around the entry point, in percent."""

LAYER, UNIT, SOURCE, MOVES = ("paged attention", "%", "device_trace",
                              "prompt_tokens_per_s")
RANGES = ("k1",)


def read(run):
    return run.roofline("k1")
