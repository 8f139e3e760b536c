"""The plain reference of a dense GQA decoder (Qwen2, Granite without its
multipliers): RMSNorm, rotary positions on split halves, grouped-query
causal attention, a SiLU-gated MLP, an untied or tied LM head.

Plain PyTorch in float32 with TF32 off, written from the published
descriptions; it imports nothing of the program.  It reads the weights
the benchmark drew (``portbench.weights``: bf16 tensors in the port's
layout) and upcasts each layer's leaves as it reaches them, so it runs
layer by layer and, inside a layer, in blocks of rows and of queries.

Departures from the published models, shared with the program: the
Granite multipliers are not applied (the config file states them as
run); nothing else.

``quant="fp8"`` is a serving control: every matrix product's operands
are rounded to float8 e4m3 (activations per row, weights per output
column, scaled to the format's largest value) and multiplied in float32,
the step below bf16 that a serving change could take.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def strict_f32() -> None:
    """Float32 products in full float32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``'s
    complement (the amax over ``dim``), back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    if quant is None:
        return x @ w
    if quant != "fp8":
        raise ValueError(f"unknown reduced precision {quant!r}")
    return fp8_round(x, -1) @ fp8_round(w, 0)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (s, heads, hd): the halves (x1, x2) rotated by position * theta
    ** (-2i / hd)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = (positions.to(torch.float64)[:, None] * inv)[:, None, :]
    cos, sin = ang.cos().to(x.dtype), ang.sin().to(x.dtype)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, q_block: int = 1024):
    """q (s, H, hd), k and v (s, Hk, hd): softmax(q k^T / sqrt(hd)) v
    with the causal mask, query head h reading KV head h // (H / Hk);
    one block of queries at a time, against the keys up to its end."""
    s, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty_like(q)
    for i in range(0, s, q_block):
        j = min(s, i + q_block)
        sc = torch.einsum("qhd,khd->hqk", q[i:j], k[:j]) * hd ** -0.5
        qi = torch.arange(i, j, device=q.device)[:, None]
        kj = torch.arange(j, device=q.device)[None, :]
        sc = sc.masked_fill(kj > qi, float("-inf"))
        out[i:j] = torch.einsum("hqk,khd->qhd", sc.softmax(-1), v[:j])
    return out


def layer_weights(tree: Dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's leaves of the stacked tree, upcast to float32."""
    lay = tree["layers"]
    w = {"ln1": lay["ln1"]["gamma"][i], "ln2": lay["ln2"]["gamma"][i]}
    for k, t in lay["attn"].items():
        w[k] = t[i]
    for k, t in lay["mlp"].items():
        w[k] = t[i]
    return {k: t.float() for k, t in w.items()}


def attention_block(conf: Dict, w: Dict, x: torch.Tensor,
                    positions: torch.Tensor, quant=None) -> torch.Tensor:
    """The attention half of a layer, residual included: x (s, d)."""
    s, d = x.shape
    H, Hk = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = d // H
    h = rmsnorm(x, w["ln1"], conf["rms_norm_eps"])
    q = matmul(h, w["wq"].reshape(d, H * hd), quant).view(s, H, hd)
    k = matmul(h, w["wk"].reshape(d, Hk * hd), quant).view(s, Hk, hd)
    v = matmul(h, w["wv"].reshape(d, Hk * hd), quant).view(s, Hk, hd)
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rope(q, positions, conf["rope_theta"])
    k = rope(k, positions, conf["rope_theta"])
    o = causal_attention(q, k, v)
    return x + matmul(o.reshape(s, H * hd), w["wo"].reshape(H * hd, d),
                      quant)


def mlp_block(conf: Dict, w: Dict, x: torch.Tensor, quant=None,
              rows: int = 4096) -> torch.Tensor:
    """The MLP half of a layer, residual included, ``rows`` at a time."""
    out = torch.empty_like(x)
    for i in range(0, x.shape[0], rows):
        xi = x[i:i + rows]
        h = rmsnorm(xi, w["ln2"], conf["rms_norm_eps"])
        y = F.silu(matmul(h, w["gate"], quant)) * matmul(h, w["up"], quant)
        out[i:i + rows] = xi + matmul(y, w["down"], quant)
    return out


def head_weight(conf: Dict, tree: Dict) -> torch.Tensor:
    """The LM head (d, V) in float32: the embedding's transpose when
    tied."""
    if conf["tie_word_embeddings"]:
        return tree["embed"].float().t()
    return tree["lm_head"].float()


@torch.no_grad()
def logits_at(conf: Dict, tree: Dict, sequences: Sequence[torch.Tensor],
              want: Sequence[torch.Tensor], quant=None) -> List[torch.Tensor]:
    """For each token sequence (1-D, on the weights' device) the logits
    (n, V) in float32 at its positions ``want`` (a position's logits
    predict the token after it)."""
    strict_f32()
    embed = tree["embed"]
    xs = [embed[s].float() for s in sequences]
    pos = [torch.arange(s.shape[0], device=s.device) for s in sequences]
    for i in range(conf["num_hidden_layers"]):
        w = layer_weights(tree, i)
        xs = [mlp_block(conf, w, attention_block(conf, w, x, p, quant), quant)
              for x, p in zip(xs, pos)]
        del w
    gamma = tree["ln_f"]["gamma"].float()
    head = head_weight(conf, tree)
    return [matmul(rmsnorm(x[idx], gamma, conf["rms_norm_eps"]), head, quant)
            for x, idx in zip(xs, want)]


def _layer_train(conf, w, x, positions):
    return mlp_block(conf, w, attention_block(conf, w, x, positions))


def row_loss(conf: Dict, params32: Dict, inputs: torch.Tensor,
             targets: torch.Tensor, mask: torch.Tensor,
             count: float) -> torch.Tensor:
    """One row's share of the batch's masked mean cross-entropy (its
    masked sum over the batch's ``count``), through float32 leaves
    ``params32`` (path -> tensor, requiring grad), each layer
    recomputed in the backward."""
    L = conf["num_hidden_layers"]
    x = params32[("embed",)][inputs]
    positions = torch.arange(inputs.shape[0], device=inputs.device)
    for i in range(L):
        w = {"ln1": params32[("layers", "ln1", "gamma")][i],
             "ln2": params32[("layers", "ln2", "gamma")][i]}
        for path, t in params32.items():
            if path[:2] in (("layers", "attn"), ("layers", "mlp")):
                w[path[2]] = t[i]
        x = checkpoint(_layer_train, conf, w, x, positions,
                       use_reentrant=False)
    h = rmsnorm(x, params32[("ln_f", "gamma")], conf["rms_norm_eps"])
    head = (params32[("embed",)].t() if conf["tie_word_embeddings"]
            else params32[("lm_head",)])
    logp = torch.log_softmax(h @ head, dim=-1)
    ll = logp.gather(-1, targets[:, None])[:, 0]
    return -(ll * mask).sum() / count
