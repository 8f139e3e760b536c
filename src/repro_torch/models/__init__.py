"""Model zoo of the port (layers, attention, blocks, forward, the cached
lockstep step, and their meta-device stand-ins for the dry-run)."""
from .layers import init_params, param_defs
from .model import (abstract_decode_state, abstract_params, forward,
                    init_decode_state, layer_params, step)

__all__ = ["abstract_decode_state", "abstract_params", "forward",
           "init_decode_state", "init_params", "layer_params", "param_defs",
           "step"]
