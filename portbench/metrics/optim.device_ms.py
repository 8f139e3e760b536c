"""Device milliseconds a training step spends inside the program's
``optimizer`` profiler range (AdamW's update)."""

LAYER, UNIT, SOURCE, MOVES = ("optimizer", "ms", "device_trace",
                              "train_tokens_per_s")
RANGES = ("optimizer",)


def read(run):
    ms = run.range_ms("optimizer")
    return ms / run.steps if run.steps and ms else None
