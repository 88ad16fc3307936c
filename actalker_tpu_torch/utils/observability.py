"""Logging, metrics, timing and seeding helpers, the port's own copy of
``actalker_tpu/utils/observability.py``: ``get_logger``, the JSONL
``MetricsEmitter``, ``phase_timer`` (wall-clock phases, the card
synchronized at both ends), ``device_trace`` (``torch.profiler`` into a
directory; ``tools/profile_step.py`` reads its trace) and
``seed_everything`` (Python, numpy and torch's default generator; the
port's own draws stay on explicit generators)."""
from __future__ import annotations

import contextlib
import json
import logging
import os
import random
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


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


def _synchronize(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(name: str, emitter: Optional[MetricsEmitter] = None, device=None):
    """Wall-clock timing of the block; with a CUDA ``device`` the card is
    synchronized before and after, so the phase holds its kernels. On exit
    the seconds are emitted (``phase``, ``seconds``) or logged. Yields a
    dict that holds ``seconds`` afterwards."""
    out: Dict[str, Any] = {"phase": name}
    _synchronize(device)
    t0 = time.perf_counter()
    yield out
    _synchronize(device)
    out["seconds"] = time.perf_counter() - t0
    if emitter:
        emitter.emit(phase=name, seconds=out["seconds"])
    else:
        get_logger().info("phase %s took %.3fs", name, out["seconds"])


@contextlib.contextmanager
def device_trace(logdir: str, device=None):
    """``torch.profiler`` over the block (CPU activity, and CUDA's with a
    CUDA ``device``, synchronized at both ends), its chrome trace written
    to ``logdir/trace.json`` on exit. Yields the profiler, whose
    ``trace_path`` names the file."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.trace_path = os.path.join(logdir, "trace.json")
    _synchronize(device)
    with prof:
        yield prof
        _synchronize(device)
    prof.export_chrome_trace(prof.trace_path)


def seed_everything(seed: int) -> None:
    """Seed Python's ``random``, numpy's global generator and torch's
    default generators (CPU and every card)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
