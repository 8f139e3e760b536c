"""LoRA adapters of the port: merge vs inline application (paper §3.3.5)."""
from .adapters import (init_adapter, init_adapters_for_tree, merge,
                       apply_inline, merge_flops)

__all__ = ["init_adapter", "init_adapters_for_tree", "merge", "apply_inline",
           "merge_flops"]
