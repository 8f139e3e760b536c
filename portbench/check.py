"""The numbers that decide ``correct``, each worked out from the
program's outputs and the plain reference's, and compared with its limit
in ``portbench/limits/<workload>.json``."""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone and is left out of the change
NOUGHT = 1e-3


def logit_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a served token's reference logit lies
    below the reference's best at its position: ref_logits (n, V), the
    served tokens (n,)."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens[:, None].long())[:, 0]
    return float((best - got).max())


def leaf_gap(prog: Dict, ref: Dict, keep: Sequence = None,
             worst: bool = True) -> float:
    """The worst leaf's gap (or with ``worst=False`` the median leaf's)
    between the program's norm and the reference's, over the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    keys = list(keep if keep is not None else ref)
    med = statistics.median(ref[k] for k in keys)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]
    return max(gaps) if worst else statistics.median(gaps)


def worst_leaves(prog: Dict, ref: Dict, keep: Sequence, n: int = 3):
    """The n leaves with the widest gaps, for the log: (leaf, program's
    norm, reference's norm, gap)."""
    med = statistics.median(ref[k] for k in keep)
    gaps = sorted(((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k)
                   for k in keep), reverse=True)[:n]
    return [(".".join(k), prog[k], ref[k], g) for g, k in gaps]


def token_agreement(ref_logits: torch.Tensor, tokens: torch.Tensor):
    """(share of served tokens that are the reference's best, median
    gap), for the log."""
    best = ref_logits.max(dim=-1)
    got = ref_logits.gather(-1, tokens[:, None].long())[:, 0]
    return (float((best.indices == tokens).float().mean()),
            float((best.values - got).median()))


def moving_leaves(ref_grad: Dict) -> List:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= NOUGHT * med]


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def verdict(numbers: Dict[str, float], limits: Dict) -> Dict:
    """Each number the cell's limits name beside its limit; ``ok`` when
    it is at or under it (a number that is missing or not finite
    fails)."""
    out = {}
    for name, lim in limits.items():
        value = numbers.get(name, float("nan"))
        ok = value == value and value <= lim["limit"]
        out[name] = {"value": value, "limit": lim["limit"], "ok": ok}
    return out
