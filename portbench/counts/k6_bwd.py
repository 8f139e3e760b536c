"""K6's backward, ``flash_bwd``: ``k6_fwd``'s bound with the backward's
operations and bytes."""
from portbench.counts.k6_fwd import call_case, least_ms  # noqa: F401

ENTRY = ("repro_torch.kernels.flash_attention.ops", "flash_bwd")


def shapes(a, probe):
    return call_case(a, backward=True)
