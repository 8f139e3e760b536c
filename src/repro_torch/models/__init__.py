"""Model zoo of the port (layers, attention, blocks, forward, the cached
lockstep step)."""
from .layers import init_params, param_defs
from .model import forward, init_decode_state, layer_params, step

__all__ = ["forward", "init_decode_state", "init_params", "layer_params",
           "param_defs", "step"]
