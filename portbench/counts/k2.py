"""K2, ``paged_prefill``: one slot's prompt chunk against its block
table.  ``prefill_bound`` is a frozen copy of ``chip_smoke.py``'s."""
from portbench.peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S

ENTRY = ("repro_torch.kernels.paged_attention.ops", "paged_prefill")


def prefill_bound(q, cache_k, start, valid, bs):
    C, Hk, G, d = q.shape
    kv_bytes = cache_k.element_size()
    keys = start + valid
    nbytes = (2 * q.numel() * q.element_size()
              + keys * Hk * d * 2 * kv_bytes + (-(-keys // bs)) * 4)
    pairs = sum(start + c + 1 for c in range(valid))    # causal (row, key)
    flops = 4 * pairs * Hk * G * d
    return (max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3,
            "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
            else "operations")


def shapes(a, probe):
    """What the count needs from one call, ``a`` its arguments by name."""
    return dict(q=probe.meta(a["q"]), cache_k=probe.meta(a["cache_k"]),
                start=int(a["start"]), valid=int(a["valid"]),
                bs=a["cache_k"].shape[1])


def least_ms(call) -> float:
    """``call``: the arguments of one ``paged_prefill`` call as the
    harness recorded them (``q``, ``cache_k``, ``start``, ``valid``,
    ``bs``)."""
    return prefill_bound(call["q"], call["cache_k"], call["start"],
                         call["valid"], call["bs"])[0]
