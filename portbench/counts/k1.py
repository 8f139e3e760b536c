"""K1, ``paged_decode``: one query token per slot against its block
table.  ``decode_bound`` is a frozen copy of ``chip_smoke.py``'s."""
from portbench.peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S

ENTRY = ("repro_torch.kernels.paged_attention.ops", "paged_decode")


def decode_bound(q, cache_k, tables, pos, bs):
    """Each distinct (block, offset <= cursor) of K and V is read once:
    blocks that several tables share count once."""
    S, Hk, G, d = q.shape
    kv_bytes = cache_k.element_size()
    need = {}                                   # block id -> keys read
    for row, p in zip(tables.tolist(), pos.tolist()):
        for t in range(p // bs + 1):
            n = bs if t < p // bs else p % bs + 1
            need[row[t]] = max(need.get(row[t], 0), n)
    keys = sum(need.values())
    blocks = sum(p // bs + 1 for p in pos.tolist())
    nbytes = (2 * q.numel() * q.element_size()          # q in, out
              + keys * Hk * d * 2 * kv_bytes            # K and V once
              + blocks * 4 + S * 4)                     # table ids, cursors
    pairs = sum(p + 1 for p in pos.tolist())            # (query, key)
    flops = 4 * pairs * Hk * G * d                      # QK^T and PV
    return (max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3,
            "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
            else "operations")


def shapes(a, probe):
    """What the count needs from one call, ``a`` its arguments by name:
    the tables and cursors are kept on the card and read back after the
    window."""
    return dict(q=probe.meta(a["q"]), cache_k=probe.meta(a["cache_k"]),
                tables=probe.keep(a["block_tables"]),
                pos=probe.keep(a["pos"]), bs=a["cache_k"].shape[1])


def least_ms(call) -> float:
    """``call``: ``q`` and ``cache_k`` (anything with ``shape``,
    ``numel()`` and ``element_size()``), host copies of ``tables`` and
    ``pos``, and ``bs``."""
    return decode_bound(call["q"], call["cache_k"], call["tables"],
                        call["pos"], call["bs"])[0]
