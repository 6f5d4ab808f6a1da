from .device import disable_tf32, resolve_device
from .logging import logger, timer

__all__ = ["disable_tf32", "logger", "resolve_device", "timer"]
