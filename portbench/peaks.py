"""The card's published peaks: NVIDIA H100 SXM data sheet, dense rates
without sparsity, at the 700 W power limit.  A card set to a lower limit
runs below them; the harness reports its name and limit beside every
number."""

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
