"""Mean live slots per decode block of the window (``Engine.trace``'s
``decode_block`` events)."""

LAYER, UNIT, SOURCE, MOVES = ("scheduler", "slots", "program_counter",
                              "prompt_tokens_per_s")


def read(run):
    blocks = [len(ev.slots) for ev in run.events if ev.kind == "decode_block"]
    return sum(blocks) / len(blocks) if blocks else None
