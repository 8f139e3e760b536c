"""A configuration's weights, drawn by the benchmark on the card from
``--seed`` in the type they are served in, one large call per leaf.

The tree has the port's layout (``repro_torch.models.init_params``:
nested dicts, the decoder layers stacked on a leading axis), which the
harness checks against the program's own shapes before it hands the
tree over.  The plain reference reads the same tree.  Both sides get the
same tensors; nothing here comes from the program.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

#: standard deviation of every drawn leaf (the configs' initializer_range)
STD = 0.02
MASK64 = (1 << 64) - 1


def dims(conf: Dict) -> Dict[str, int]:
    """The widths of a dense GQA decoder from its config file."""
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    return dict(L=conf["num_hidden_layers"], d=d, H=H,
                Hk=conf["num_key_value_heads"],
                hd=conf.get("head_dim") or d // H,
                f=conf["intermediate_size"], V=conf["vocab_size"])


def layout(conf: Dict) -> Dict[Tuple[str, ...], Tuple[Tuple[int, ...], str]]:
    """Leaf path -> (shape, init) in the order leaves are drawn (paths
    sorted, as ``init_params`` walks its keys); init is ``normal`` or
    ``ones``."""
    w = dims(conf)
    L, d, H, Hk, hd, f, V = (w[k] for k in ("L", "d", "H", "Hk", "hd", "f",
                                            "V"))
    leaves = {("embed",): ((V, d), "normal"),
              ("ln_f", "gamma"): ((d,), "ones"),
              ("layers", "ln1", "gamma"): ((L, d), "ones"),
              ("layers", "ln2", "gamma"): ((L, d), "ones"),
              ("layers", "attn", "wq"): ((L, d, H, hd), "normal"),
              ("layers", "attn", "wk"): ((L, d, Hk, hd), "normal"),
              ("layers", "attn", "wv"): ((L, d, Hk, hd), "normal"),
              ("layers", "attn", "wo"): ((L, H, hd, d), "normal"),
              ("layers", "mlp", "gate"): ((L, d, f), "normal"),
              ("layers", "mlp", "up"): ((L, d, f), "normal"),
              ("layers", "mlp", "down"): ((L, f, d), "normal")}
    if conf.get("attention_bias"):
        leaves[("layers", "attn", "bq")] = ((L, H, hd), "normal")
        leaves[("layers", "attn", "bk")] = ((L, Hk, hd), "normal")
        leaves[("layers", "attn", "bv")] = ((L, Hk, hd), "normal")
    if not conf["tie_word_embeddings"]:
        leaves[("lm_head",)] = ((d, V), "normal")
    return dict(sorted(leaves.items()))


def param_count(conf: Dict) -> int:
    return sum(int(np.prod(shape)) for shape, _ in layout(conf).values())


def generator(seed: int, device, salt: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 0x9E3779B97F4A7C15 + salt) & MASK64)
    return gen


def leaves(conf: Dict, seed: int, device, dtype=torch.bfloat16
           ) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """Each leaf in draw order, drawn from ``seed``; the same seed gives
    the same tensors on the same device."""
    gen = generator(seed, device, salt=1)
    for path, (shape, init) in layout(conf).items():
        if init == "ones":
            yield path, torch.ones(shape, dtype=dtype, device=device)
        else:
            w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            yield path, w.mul_(STD)


def draw(conf: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The whole tree, nested as the port nests it."""
    tree: Dict = {}
    for path, w in leaves(conf, seed, device, dtype):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = w
    return tree


def flat(tree: Dict, prefix: Tuple[str, ...] = ()) -> Dict:
    """Leaf path -> tensor of a nested tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def check_against_program(conf: Dict, abstract: Dict) -> None:
    """Raise unless the program's parameter tree (``abstract_params``:
    shapes on the meta device) has exactly this layout's leaves and
    shapes, so that the two sides read one tree alike."""
    ours = {p: s for p, (s, _) in layout(conf).items()}
    theirs = {p: tuple(t.shape) for p, t in flat(abstract).items()}
    if ours != theirs:
        raise RuntimeError(f"the program's parameter tree differs from the "
                           f"benchmark's layout: {sorted(set(ours.items()) ^ set(theirs.items()))}")
