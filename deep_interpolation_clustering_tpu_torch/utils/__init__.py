from .device import disable_tf32, resolve_device

__all__ = ["disable_tf32", "resolve_device"]
