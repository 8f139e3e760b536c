"""Time to first token, 90th percentile: from the client's send to the
request's first token, over every request whose first token came in the
window (the engine's own timestamps of each request)."""
import statistics

LAYER, UNIT, SOURCE, MOVES = ("scheduler", "ms", "host_clock",
                              "prompt_tokens_per_s")


def read(run):
    if len(run.ttft_s) < 2:
        return None
    return statistics.quantiles(run.ttft_s, n=10)[8] * 1e3
