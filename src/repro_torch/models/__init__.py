"""Dense decoder model of the port (layers, attention, MLP, forward)."""
from .layers import init_params, param_defs
from .model import forward, layer_params

__all__ = ["forward", "init_params", "layer_params", "param_defs"]
