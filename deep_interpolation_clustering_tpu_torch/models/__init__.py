from .net import Net, NetOutput

__all__ = ["Net", "NetOutput"]
