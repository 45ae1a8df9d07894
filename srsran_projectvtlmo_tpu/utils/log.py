"""Per-module async logging: the srslog equivalent.

The reference's srslog runs frontends that push fmt records onto a lock-free
queue drained by one backend thread into sinks, with per-module log levels and
bounded hex dumps configured from YAML
(reference: lib/srslog/srslog.cpp, lib/srslog/backend_worker.cpp;
hex dump limits: apps/units/flexible_du/du_low/du_low_config.h:63-71).

Here: stdlib logging + a QueueHandler/QueueListener pair (one background
drain thread, non-blocking frontends), per-module levels from a config dict,
and a bounded `hex_dump` helper for IQ/bit buffers.
"""

from __future__ import annotations

import atexit
import logging
import logging.handlers
import queue
import sys

import numpy as np

#: Module registry (mirrors the reference's per-layer loggers: PHY, MAC, ...).
_MODULES = ("PHY", "FAPI", "OFH", "LOWER", "UPPER", "HARQ", "METRICS")

_LEVELS = {
    "none": logging.CRITICAL + 10,
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
}

_listener: logging.handlers.QueueListener | None = None
_queue: queue.SimpleQueue | None = None
#: Max bytes rendered by hex_dump (reference hex_max_size, du_low_config.h:66).
hex_max_size = 64


def init_logging(levels: dict[str, str] | None = None, stream=None) -> None:
    """Start the async backend and apply per-module levels.

    levels: e.g. {"PHY": "info", "OFH": "debug", "all": "warning"}.
    """
    global _listener, _queue
    if _listener is not None:
        _listener.stop()
    _queue = queue.SimpleQueue()
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s.%(msecs)03d [%(name)-7s] [%(levelname).1s] %(message)s",
        datefmt="%H:%M:%S"))
    _listener = logging.handlers.QueueListener(_queue, handler)
    _listener.start()
    atexit.register(_listener.stop)

    levels = levels or {}
    default = _LEVELS[levels.get("all", "warning")]
    qh = logging.handlers.QueueHandler(_queue)
    for mod in _MODULES:
        lg = logging.getLogger(f"srsran.{mod}")
        lg.handlers = [qh]
        lg.propagate = False
        lg.setLevel(_LEVELS.get(levels.get(mod, ""), default))


def get_logger(module: str) -> logging.Logger:
    """Module logger ('PHY', 'FAPI', 'OFH', ...); init_logging() configures
    levels, otherwise stdlib defaults apply."""
    return logging.getLogger(f"srsran.{module}")


def hex_dump(data, max_size: int | None = None) -> str:
    """Bounded hex rendering of a byte/bit/IQ buffer (reference: srslog's
    log_hex with hex_max_size)."""
    limit = hex_max_size if max_size is None else max_size
    arr = np.asarray(data)
    if arr.dtype.kind == "f":
        raw = arr.astype(np.float32).tobytes()
    else:
        raw = arr.astype(np.uint8).tobytes()
    clipped = raw[:limit]
    body = " ".join(f"{b:02x}" for b in clipped)
    suffix = f" ... ({len(raw)} bytes)" if len(raw) > limit else ""
    return body + suffix
