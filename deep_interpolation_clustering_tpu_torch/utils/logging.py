"""The port's logger and block timer (its own copy of the JAX package's
`utils/logging.py` `logger` and `utils/timing.py` `timer`, reference
utils.py:21-35, :102-116). The logger is the `"dicl.torch"` logger every
module of the port writes to.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager


logger = logging.getLogger("dicl.torch")
if not getattr(logger, "handler_set", None):
    _stream = logging.StreamHandler()
    _stream.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s - %(funcName)s(%(lineno)d): %(message)s", "%H:%M:%S"))
    logger.setLevel(logging.INFO)
    logger.addHandler(_stream)
    logger.handler_set = True
    logger.propagate = False


def _fmt(diff: float) -> str:
    if diff >= 3600:
        return f"{diff / 3600:.2f}h"
    if diff >= 60:
        return f"{diff / 60:.2f}m"
    return f"{diff:.2f}s"


@contextmanager
def timer(message: str):
    """Log the host-clock duration of the block (the caller synchronises the
    card where device work must be inside it)."""
    tick = time.time()
    yield
    logger.info("%s: %s", message, _fmt(time.time() - tick))
