"""Logging and metrics helpers, the port's own copy of
``get_logger`` and the JSONL ``MetricsEmitter`` of
``actalker_tpu/utils/observability.py``. Its ``phase_timer``,
``device_trace`` and ``seed_everything`` have no caller in the port yet
(``tools/profile_step.py`` traces the device)."""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional


_logger = None


def get_logger(name: str = "actalker_tpu_torch") -> logging.Logger:
    global _logger
    if _logger is None:
        logger = logging.getLogger(name)
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"))
            logger.addHandler(h)
        logger.setLevel(os.environ.get("ACTALKER_LOGLEVEL", "INFO"))
        _logger = logger
    return _logger


class MetricsEmitter:
    """Append-only JSONL metric sink (loss curves, step timings); without a
    path, each record goes to the log."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = open(path, "a") if path else None

    def emit(self, **fields: Any) -> Dict[str, Any]:
        fields.setdefault("ts", time.time())
        if self._fh:
            self._fh.write(json.dumps(fields) + "\n")
            self._fh.flush()
        else:
            get_logger().info("metric %s", fields)
        return fields

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
