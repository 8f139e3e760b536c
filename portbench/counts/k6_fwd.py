"""K6's forward, ``flash_fwd``; ``k6_bwd`` counts its backward with the
same bound.  ``attention_pairs`` and ``flash_bound`` are frozen copies
of ``chip_smoke.py``'s."""
import numpy as np

from portbench.peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S

ENTRY = ("repro_torch.kernels.flash_attention.ops", "flash_fwd")


def attention_pairs(s, L, causal, window, q_offset) -> int:
    """Live (query, key) pairs of one (batch, head)."""
    qp = q_offset + np.arange(s)
    hi = np.minimum(L, qp + 1) if causal else np.full(s, L)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(s, int)
    return int(np.maximum(0, hi - lo).sum())


def flash_bound(case, elem, backward):
    """Forward: q, k, v read once, o and the f32 log-sum-exp written once;
    4*b*H*d flops per live pair (QK^T and PV).  Backward: q, k, v, o, dO
    and the log-sum-exp read, dq, dk, dv written; 2.5x the forward's
    flops (QK^T again, dO V^T, dV, dQ, dK)."""
    b, s, L, H, Hk, d, causal, window, q_offset = case
    q_el, kv_el, lse = b * s * H * d, b * L * Hk * d, b * H * s * 4
    flops = 4 * b * H * d * attention_pairs(s, L, causal, window, q_offset)
    if backward:
        flops *= 2.5
        nbytes = elem * (3 * q_el + 2 * kv_el) + lse + elem * (q_el + 2 * kv_el)
    else:
        nbytes = elem * (2 * q_el + 2 * kv_el) + lse
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def call_case(a, backward: bool):
    """One call's ``case``, element size and direction, ``a`` its
    arguments by name."""
    b, s, H, d = a["q"].shape
    k = a["k"]
    return dict(case=(b, s, k.shape[1], H, k.shape[2], d, a["causal"],
                      a["window"], a["q_offset"]),
                elem=a["q"].element_size(), backward=backward)


def shapes(a, probe):
    return call_case(a, backward=False)


def least_ms(call) -> float:
    """``call``: the ``case`` tuple (b, s, L, H, Hk, d, causal, window,
    q_offset), the element size and whether it is the backward."""
    return flash_bound(call["case"], call["elem"], call["backward"])[0]
