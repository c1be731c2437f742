from .device import resolve_device
from .weights import init_weights, load_reference_checkpoint

__all__ = ["init_weights", "load_reference_checkpoint", "resolve_device"]
