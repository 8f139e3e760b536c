"""The training run's peak of allocated device memory
(``torch.cuda.max_memory_allocated``), in GB."""

LAYER, UNIT, SOURCE, MOVES = ("trainer", "GB", "program_counter",
                              "train_tokens_per_s")


def read(run):
    return run.peak_bytes / 1e9 if run.steps and run.peak_bytes else None
