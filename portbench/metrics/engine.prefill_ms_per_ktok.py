"""Milliseconds per 1,000 prompt tokens of ``Engine.prefill_fn``: the
benchmark's spans around each call, between two synchronisations."""

LAYER, UNIT, SOURCE, MOVES = ("engine steps", "ms/ktok", "program_span",
                              "prompt_tokens_per_s")


def read(run):
    spans = run.spans.get("engine.prefill", [])
    tokens = sum(n for _, n in spans)
    return sum(s for s, _ in spans) * 1e6 / tokens if tokens else None
