"""Serving in a closed loop: a fixed pool of clients, each sending its
next request when its last answer is back, through the program's
continuous-batching engine (``Engine.submit`` / ``Engine.step``).

The traffic file fixes the clients, the lists of prompt and output
lengths and how each client walks them, so the same requests in the same
order reach the engine for every seed; ``--seed`` draws the weights and
the prompts' token ids.  The window opens after the warm-up step that
admits the first wave and lasts ``seconds``: ``prompt_tokens_per_s`` is
the prompt tokens of every chunk whose prefill completed inside it (a
CUDA event recorded after each ``Engine.prefill_fn`` call, read against
one recorded when the window opened) over its length.  The engine steps
on until the step in progress at the close has ended, and the per-layer
metrics are read over those whole steps.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import check, weights
from portbench.flops import serve_flops
from portbench.probes import KernelProbes, Spans
from portbench.reference import decoder
from portbench.trace import WINDOW, record

MASK64 = (1 << 64) - 1
#: the host ranges this kind opens, by which the idle gaps are named
RANGES = ("engine.step", "engine.prefill", "engine.decode", "loop")


class Clients:
    """The closed loop's clients and the requests they send."""

    def __init__(self, traffic: Dict, vocab: int, seed: int):
        self.t, self.vocab, self.seed = traffic, vocab, seed & MASK64
        self.sent = [0] * traffic["clients"]
        self.owner: Dict[int, int] = {}
        self.prompts: Dict[int, np.ndarray] = {}
        self.budget: Dict[int, int] = {}

    def lengths(self, c: int, j: int):
        """Client c's j-th request's (prompt, output) lengths: the same
        for every seed."""
        P, O = self.t["prompt_lengths"], self.t["output_lengths"]
        return (P[(c + j) % len(P)],
                O[(self.t["output_stride"] * c + j) % len(O)])

    def next(self, c: int):
        from repro_torch.engine import Request
        plen, out = self.lengths(c, self.sent[c])
        self.sent[c] += 1
        rid = len(self.owner)
        rng = np.random.default_rng([self.seed, rid, 7])
        prompt = rng.integers(0, self.vocab, size=plen, dtype=np.int64)
        self.owner[rid], self.prompts[rid], self.budget[rid] = c, prompt, out
        return Request(rid=rid, prompt=prompt, max_new=out)


def _settle(eng, clients: Clients, done: set) -> List[int]:
    """Send each client whose request finished its next one; returns the
    requests that finished."""
    finished = [rid for rid, r in eng.results.items()
                if r.finished > 0 and rid not in done]
    for rid in sorted(finished):
        done.add(rid)
        eng.submit(clients.next(clients.owner[rid]))
    return finished


def tokens_completed(chunks, seconds: float, since) -> int:
    """The prompt tokens of the chunks whose prefill completed within
    ``seconds`` of the window's opening: ``chunks`` are (event after the
    chunk, tokens), ``since(event)`` its seconds after the opening."""
    return sum(n for e, n in chunks if since(e) <= seconds)


def window_counts(results, base: float, t_open: float,
                  t_close: float) -> Dict:
    """The requests that finished between ``t_open`` and ``t_close`` and
    the time to first token of each request whose first token came
    between them; ``results``' times count from ``base`` on the host
    clock."""
    inside = lambda t: t > 0 and t_open <= base + t <= t_close
    return {"finished": [rid for rid, r in results.items()
                         if inside(r.finished)],
            "ttft_s": [r.first_token - r.arrival for r in results.values()
                       if inside(r.first_token)]}


def pick_sample(finished, slot_of, size, n: int, rng) -> List[int]:
    """The requests the reference checks: the longest (``size``) first,
    then the others in an order drawn from ``rng``, one for each slot
    (``slot_of``) not yet in the sample before any slot's second, until
    there are ``n``."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (size(r), r))
    rest = [int(r) for r in rng.permutation(
        sorted(r for r in finished if r != longest))]
    sample, slots = [longest], {slot_of.get(longest)}
    for r in rest:
        if len(sample) < n and slot_of.get(r) not in slots:
            sample.append(r)
            slots.add(slot_of.get(r))
    sample += [r for r in rest if r not in sample][:n - len(sample)]
    return sample


def check_inputs(clients, results, sample, device):
    """Each sampled request's prompt followed by its served tokens but
    the last, the positions whose logits chose the served tokens, and
    the served tokens."""
    seqs, want, served = [], [], []
    for rid in sample:
        toks = results[rid].tokens
        prompt = clients.prompts[rid]
        full = np.concatenate([prompt, np.asarray(toks[:-1], np.int64)])
        seqs.append(torch.from_numpy(full).to(device))
        want.append(torch.arange(len(prompt) - 1, len(full), device=device))
        served.append(torch.tensor(toks, device=device))
    return seqs, want, served


def run(ctx) -> Dict:
    from repro_torch.engine import Engine, EngineConfig
    from repro_torch.models import abstract_params

    conf, traffic, device, seed = ctx.conf, ctx.traffic, ctx.device, ctx.seed
    weights.check_against_program(conf, abstract_params(ctx.arch))
    params = weights.draw(conf, seed, device)
    e = traffic["engine"]
    ec = EngineConfig(max_slots=e["max_slots"], max_len=e["max_len"],
                      chunk_size=e["chunk_size"],
                      decode_block=e["decode_block"],
                      block_size=e["block_size"], n_blocks=e["n_blocks"],
                      prefix_cache=e["prefix_cache"], kv_dtype=e["kv_dtype"],
                      attn_impl=e["attn_impl"],
                      temperature=e["temperature"], seed=seed % (1 << 31))
    ctx.sync()
    t_draw = time.perf_counter()
    eng = Engine(ctx.arch, params, ec, device=device)
    clients = Clients(traffic, conf["vocab_size"], seed)
    done: set = set()
    for c in range(traffic["clients"]):
        eng.submit(clients.next(c))
    t_wave = time.perf_counter()
    eng.step()                          # the first wave: every shape
    _settle(eng, clients, done)
    ctx.sync()
    ctx.log(f"set-up: weights drawn at {t_draw - ctx.t0:.1f} s, the first "
            f"wave from {t_wave - ctx.t0:.1f} s to "
            f"{time.perf_counter() - ctx.t0:.1f} s")

    chunks = []                         # (event after the chunk, tokens)
    prefill = eng.prefill_fn

    def timed_prefill(*args):
        out = prefill(*args)
        chunks.append((ctx.event(), args[5]))
        return out
    eng.prefill_fn = timed_prefill

    probes = spans = prof = None
    if ctx.trace:
        from portbench.trace import profiler
        probes = KernelProbes(ctx.ranges)
        spans = Spans(torch.device(device))
        step = eng.step
        eng.step = lambda: _ranged("engine.step", step)
        eng.prefill_fn = spans.wrap("engine.prefill", eng.prefill_fn,
                                    lambda a: a[5])
        eng.decode_fn = spans.wrap("engine.decode", eng.decode_fn,
                                   lambda a: ec.decode_block)
        prof = profiler()
        prof.__enter__()
        probes.__enter__()
    n0 = len(eng.trace)
    opened = ctx.event()
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t0
    with record(WINDOW):
        while True:
            eng.step()
            with record("loop"):
                _settle(eng, clients, done)
            if time.perf_counter() - t_open >= ctx.seconds:
                break
    t_close = time.perf_counter()
    if ctx.trace:
        probes.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    ctx.sync()
    window_s = t_close - t_open
    peak = ctx.peak_bytes()
    prompt_tokens = tokens_completed(chunks, ctx.seconds,
                                     lambda e: ctx.elapsed(opened, e))
    results = eng.results
    w = window_counts(results, eng._t0, t_open, t_close)
    bad = [rid for rid in w["finished"]
           if len(results[rid].tokens) != clients.budget[rid]
           or not all(0 <= t < conf["vocab_size"] for t in results[rid].tokens)]
    finished, events = w["finished"], eng.trace[n0:]
    run_rec = ctx.record(
        window_s=window_s, events=events,
        ttft_s=w["ttft_s"],
        spans=spans.spans if spans else {},
        model_flops=serve_flops(conf, events), peak_bytes=peak)
    if ctx.trace:
        run_rec.add_trace(prof, probes, ctx.ranges + RANGES)

    # the output check, once the program's state is freed
    slot_of = {ev.rid: ev.slot for ev in eng.trace
               if ev.kind == "prefill_chunk"}
    del eng, params
    ctx.free()
    sample = pick_sample(finished, slot_of,
                         lambda r: len(clients.prompts[r]) + clients.budget[r],
                         traffic["check"]["requests"],
                         np.random.default_rng([seed & MASK64, 11]))
    t_ref = time.perf_counter()
    seqs, want, served = check_inputs(clients, results, sample, device)
    # weights drawn again from the seed: nothing the program held
    tree = weights.draw(conf, seed, device)
    ref = decoder.logits_at(conf, tree, seqs, want) if sample else []
    gap = max((check.logit_gap(lg, tok) for lg, tok in zip(ref, served)),
              default=float("inf"))
    ctx.log(f"reference over {len(sample)} requests on "
            f"{len({slot_of.get(r) for r in sample})} slots "
            f"({sum(len(t) for t in served)} served tokens) "
            f"in {time.perf_counter() - t_ref:.1f} s; per request the share "
            f"of served tokens that are its best and the median gap: "
            f"{[check.token_agreement(r, t) for r, t in zip(ref, served)]}")
    del tree
    return dict(metrics={"prompt_tokens_per_s": prompt_tokens / ctx.seconds,
                         "setup_s": setup_s},
                compared={"max_logit_gap": gap},
                attempted=len(finished), failed=len(bad), run=run_rec,
                check=dict(seqs=seqs, want=want, served=served, ref=ref))


def _ranged(name, fn):
    with record(name):
        return fn()
