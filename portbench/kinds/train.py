"""Training: the program's training step (``make_train_step``: the loss
through the model with remat and the flash kernels, its gradient, AdamW
in place) driven on packed documents drawn from ``--seed``.

Set-up draws the weights, builds the one step object and drives it
through the traffic's first ``check_steps`` steps, which also warm up
every shape; the plain reference follows those steps once the window
has closed.  The window then runs further steps of the same call on
fresh rows, keeping at most two steps in flight, and closes when the
first step that completes ``seconds`` or more after it opened is done:
``train_tokens_per_s`` is the tokens of every step of the window over
the window's length, both taken from CUDA events.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from portbench import check, weights
from portbench.flops import train_flops
from portbench.probes import KernelProbes
from portbench.reference import decoder
from portbench.reference.adamw import AdamW as RefAdamW
from portbench.trace import WINDOW, record

MASK64 = (1 << 64) - 1
#: the host ranges this kind opens, by which the idle gaps are named
RANGES = ("train.step",)


class Batches:
    """Rows of packed documents: heavy-tailed document lengths, Zipf
    token ids, an end-of-document token after each document; row k of a
    seed is the same on every run and differs from every other."""

    def __init__(self, traffic: Dict, vocab: int, seed: int, device):
        self.t, self.seed, self.device = traffic, seed & MASK64, device
        eos = traffic["eos_id"]
        ranks = np.arange(1, vocab, dtype=np.float64)
        p = ranks ** -traffic["tokens"]["exponent"]
        self.cdf = np.cumsum(p) / p.sum()
        self.ids = np.delete(np.arange(vocab), eos)     # every id but eos

    def rows(self, k: int):
        t = self.t
        b, s, dl = t["batch"], t["seq_len"], t["doc_length"]
        rng = np.random.default_rng([self.seed, k, 3])
        need, parts = b * (s + 1), []
        while need > 0:
            n = int(np.clip(round(rng.lognormal(np.log(dl["median"]),
                                                dl["sigma"])),
                            dl["min"], dl["max"]))
            doc = self.ids[np.searchsorted(self.cdf, rng.random(n))]
            parts += [doc, np.array([t["eos_id"]])]
            need -= n + 1
        stream = np.concatenate(parts)[:b * (s + 1)].reshape(b, s + 1)
        inputs, targets = stream[:, :-1], stream[:, 1:]
        mask = (inputs != t["eos_id"]).astype(np.float32)
        return inputs.astype(np.int64), targets.astype(np.int64), mask

    def batch(self, k: int) -> Dict[str, torch.Tensor]:
        dev = torch.device(self.device)

        def put(a):
            t = torch.from_numpy(a)
            if dev.type == "cuda":
                return t.pin_memory().to(dev, non_blocking=True)
            return t.to(dev)
        inputs, targets, mask = self.rows(k)
        return {"inputs": put(inputs), "targets": put(targets),
                "mask": put(mask)}


def norms(tree: Dict, scale: float = 1.0) -> Dict:
    return {p: float(t.double().norm()) * scale
            for p, t in weights.flat(tree).items()}


def first_gradient(t: Dict, mu: Dict, grad_norm: float) -> Dict:
    """Each leaf's norm of the first step's gradient as the optimizer got
    it, before its clipping: from the first moment after one step
    (``(1 - b1) * g * clip scale``) and the global norm the step
    reported."""
    clip = t.get("clip_norm")
    scale = min(1.0, clip / (grad_norm + 1e-9)) if clip else 1.0
    return norms(mu, 1 / ((1 - t["b1"]) * scale))


def change_norms(conf: Dict, seed: int, device, params: Dict) -> Dict:
    """Each leaf's norm of its change since the draw, the first weights
    drawn again leaf by leaf from the seed."""
    now = weights.flat(params)
    return {p: float((now[p].detach().double() - w0.double()).norm())
            for p, w0 in weights.leaves(conf, seed, device)}


def reference(conf: Dict, traffic: Dict, seed: int, device,
              data: Batches) -> Dict:
    """The plain reference's losses, first gradient norms (before
    clipping) and changes over the check steps, from the weights drawn
    again from the seed."""
    decoder.strict_f32()
    p16 = dict(weights.leaves(conf, seed, device))
    opt = RefAdamW(conf["training"], p16)
    losses, first = [], None
    for k in range(traffic["check_steps"]):
        inputs, targets, mask = (torch.from_numpy(a).to(device)
                                 for a in data.rows(k))
        p32 = {p: w.float().requires_grad_() for p, w in p16.items()}
        count = float(mask.sum())
        total = 0.0
        for r in range(inputs.shape[0]):
            loss = decoder.row_loss(conf, p32, inputs[r], targets[r],
                                    mask[r], count)
            loss.backward()
            total += float(loss.detach())
        grads = {p: w.grad for p, w in p32.items()}
        del p32
        taken = opt.update(p16, grads)
        del grads
        losses.append(total)
        if k == 0:
            first = taken
    change = {p: float((p16[p].double() - w0.double()).norm())
              for p, w0 in weights.leaves(conf, seed, device)}
    return {"loss": losses, "grad": first, "change": change}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers read from the check steps: the first step's loss, the
    worst step's loss, the worst leaf's first gradient and its change
    (the cell's limits say which are held)."""
    keep = check.moving_leaves(ref["grad"])
    return {"first_loss_gap": check.loss_gap(prog["loss"][:1],
                                             ref["loss"][:1]),
            "loss_gap": check.loss_gap(prog["loss"], ref["loss"]),
            "grad_gap": check.leaf_gap(prog["grad"], ref["grad"], keep),
            "grad_gap_median": check.leaf_gap(prog["grad"], ref["grad"],
                                              keep, worst=False),
            "change_gap": check.leaf_gap(prog["change"], ref["change"],
                                         keep)}


def run(ctx) -> Dict:
    from repro_torch.models import abstract_params
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import compress_int8
    from repro_torch.runtime import train as program

    conf, traffic, device, seed = ctx.conf, ctx.traffic, ctx.device, ctx.seed
    t = conf["training"]
    weights.check_against_program(conf, abstract_params(ctx.arch))
    params = weights.draw(conf, seed, device)
    opt = AdamW(lr=t["lr"], b1=t["b1"], b2=t["b2"], eps=t["eps"],
                weight_decay=t["weight_decay"], clip_norm=t["clip_norm"],
                warmup_steps=t["warmup_steps"], total_steps=t["total_steps"],
                min_lr_frac=t["min_lr_frac"],
                compress={"int8": compress_int8}.get(t["grad_compression"]))
    state = opt.init(params)
    step = program.make_train_step(ctx.arch, opt, use_flash=t["flash"],
                                   remat=t["remat"])
    data = Batches(traffic, conf["vocab_size"], seed, device)
    b, s = traffic["batch"], traffic["seq_len"]

    prog = {"loss": []}
    t_steps = time.perf_counter()
    for k in range(traffic["check_steps"]):
        params, state, m = step(params, state, data.batch(k))
        prog["loss"].append(float(m["loss"]))
        if k == 0:
            prog["grad"] = first_gradient(t, state.mu,
                                          float(m["grad_norm"]))
    prog["change"] = change_norms(conf, seed, device, params)
    ctx.sync()
    ctx.log(f"set-up: {time.perf_counter() - ctx.t0:.1f} s, of it the "
            f"{traffic['check_steps']} check steps from "
            f"{t_steps - ctx.t0:.1f} s")

    probes = prof = None
    if ctx.trace:
        from portbench.trace import profiler
        probes = KernelProbes(ctx.ranges)
        inner = step
        step = lambda *a: _ranged("train.step", inner, *a)
        prof = profiler()
        prof.__enter__()
        probes.__enter__()
    ev = ctx.event
    opened = ev()
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t0
    done, losses = [], []
    k = traffic["check_steps"]
    with record(WINDOW):
        while True:
            params, state, m = step(params, state, data.batch(k))
            losses.append(m["loss"])
            done.append(ev())
            k += 1
            if len(done) >= 2:
                done[-2].synchronize()
                if time.perf_counter() - t_open >= ctx.seconds:
                    break
        done[-1].synchronize()
    t_close = time.perf_counter()
    if ctx.trace:
        probes.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    window_s = ctx.elapsed(opened, done[-1])
    peak = ctx.peak_bytes()
    finite = all(bool(torch.isfinite(x)) for x in losses)
    steps = len(done)
    run_rec = ctx.record(window_s=window_s, steps=steps, peak_bytes=peak,
                         model_flops=steps * train_flops(conf, b, s))
    if ctx.trace:
        run_rec.add_trace(prof, probes, ctx.ranges + RANGES)

    del params, state, step, m, losses
    ctx.free()
    t_ref = time.perf_counter()
    ref = reference(conf, traffic, seed, device, data)
    ctx.log(f"reference over {traffic['check_steps']} steps in "
            f"{time.perf_counter() - t_ref:.1f} s; losses program "
            f"{prog['loss']} reference {ref['loss']}")
    keep = check.moving_leaves(ref["grad"])
    for what in ("grad", "change"):
        ctx.log(f"widest {what} gaps (leaf, program, reference, gap): "
                f"{check.worst_leaves(prog[what], ref[what], keep)}")
    return dict(metrics={"train_tokens_per_s": steps * b * s / window_s,
                         "setup_s": setup_s},
                compared=compare(prog, ref), attempted=steps,
                failed=0 if finite else steps, run=run_rec,
                check=dict(prog=prog, ref=ref))


def _ranged(name, fn, *args):
    with record(name):
        return fn(*args)
