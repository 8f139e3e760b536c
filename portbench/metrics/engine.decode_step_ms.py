"""Milliseconds per decode step of ``Engine.decode_fn``: the benchmark's
spans around each call (one decode block), between two
synchronisations, over the block's steps."""

LAYER, UNIT, SOURCE, MOVES = ("engine steps", "ms", "program_span",
                              "prompt_tokens_per_s")


def read(run):
    spans = run.spans.get("engine.decode", [])
    steps = sum(n for _, n in spans)
    return sum(s for s, _ in spans) * 1e3 / steps if steps else None
