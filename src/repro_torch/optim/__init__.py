"""AdamW with global-norm clipping and a cosine schedule."""
from .adamw import AdamW, AdamWState, compress_int8, global_norm

__all__ = ["AdamW", "AdamWState", "compress_int8", "global_norm"]
