"""Logging, metrics, tracing and seeding helpers, the port's own copy of
``actalker_tpu/utils/observability.py``: ``get_logger``, the JSONL
``MetricsEmitter`` (``training/train.py``'s ``metrics.jsonl``),
``device_trace`` (``torch.profiler`` into a directory;
``tools/profile_step.py`` reads its trace), the program's spans and
counters, and ``seed_everything`` (Python, numpy and torch's default
generator; the port's own draws stay on explicit generators).

Spans and counters. ``span(name)`` marks a block of the program (names
dotted by layer: ``sampler.window``, ``unet.norm``, ``trainer.commit``);
``count(name, n)`` adds to a counter. Both are off unless a
``torch.profiler`` session runs or an operator's ``with tracing():`` is
open; off, ``span`` returns one shared object that does nothing, after a
flag check and ``torch._C._autograd._profiler_enabled()``. On, a span is a
``torch.profiler.record_function`` range (inside a profiler session, a
``user_annotation`` beside the kernels it launched), host start and end
from ``time.perf_counter_ns``, its parent (the innermost span open on the
same thread) and, with a card in use, a CUDA event pair on the current
stream. Finished spans go into a bounded in-memory store
(``STORE_CAPACITY``; later ones are dropped and counted); a counter takes a
host integer or a device tensor, summed on the device without a
synchronization. ``span_table()`` synchronizes once and reduces the store
by span name; ``reset()`` clears it. Nothing is written while the program
runs.

Work that autograd runs on its device thread (the recomputed forwards of
checkpointed blocks in a CUDA backward) opens its spans there, with no
parent: they are not children of the span around ``backward()``.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import logging
import os
import random
import sys
import threading
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


# ------------------------------------------------------ spans and counters

STORE_CAPACITY = 2 ** 16

_profiler_enabled = torch._C._autograd._profiler_enabled
_forced = 0                   # depth of the open ``tracing()`` blocks
_local = threading.local()    # .stack: the ids of this thread's open spans
_ids = itertools.count(1)
_lock = threading.Lock()      # the store's updates (autograd's thread records too)


class _Store:
    def __init__(self):
        self.spans = []
        self.dropped = 0
        self.host_counts: Dict[str, int] = {}
        self.device_counts: Dict[str, torch.Tensor] = {}


_store = _Store()


class _Off:
    """What ``span`` returns while spans are off: entry and exit do nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def enabled() -> bool:
    """Whether spans and counters record: a ``torch.profiler`` session runs
    or a ``tracing()`` block is open."""
    return bool(_forced) or _profiler_enabled()


@contextlib.contextmanager
def tracing():
    """Spans and counters on for the block, with no profiler running (on
    every thread of the process)."""
    global _forced
    with _lock:
        _forced += 1
    try:
        yield
    finally:
        with _lock:
            _forced -= 1


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "t0", "t1", "ev0", "ev1", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.ev0 = self.ev1 = None
        if torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        self._range.__exit__(*exc)
        self._range = None
        _stack().pop()
        with _lock:
            if len(_store.spans) < STORE_CAPACITY:
                _store.spans.append(self)
            else:
                _store.dropped += 1
        return False


def span(name: str):
    """A context manager marking the block as span ``name`` while spans are
    on (``enabled()``); else the shared no-op."""
    if _forced or _profiler_enabled():
        return _Span(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n) -> None:
    """Adds ``n`` to counter ``name`` while spans are on: a host integer, or
    a device tensor (summed where it lives, read by ``span_table``)."""
    if not (_forced or _profiler_enabled()):
        return
    if torch.is_tensor(n):
        n = n.detach().sum()
        with _lock:
            prev = _store.device_counts.get(name)
            _store.device_counts[name] = n if prev is None else prev + n.to(prev.device)
    else:
        with _lock:
            _store.host_counts[name] = _store.host_counts.get(name, 0) + int(n)


def reset() -> None:
    """Clears the stored spans, the counters and the count of drops."""
    global _store
    with _lock:
        _store = _Store()


def span_table() -> Dict[str, Any]:
    """The store reduced by span name (one synchronization):
    ``{"spans": {name: {"n", "device_ms", "self_device_ms", "host_ms"}},
    "counters": {name: int}, "dropped": int}``. A span's device ms run from
    its start event to its end event (without a card: its host ms); its
    self device ms leave out the device ms of its direct children."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    with _lock:
        store = _store
        spans = list(store.spans)
        counters = dict(store.host_counts)
        device_counts = dict(store.device_counts)
    dev = {s.id: (s.ev0.elapsed_time(s.ev1) if s.ev0 is not None
                  else (s.t1 - s.t0) / 1e6) for s in spans}
    inner = dict.fromkeys(dev, 0.0)
    for s in spans:
        if s.parent in inner:
            inner[s.parent] += dev[s.id]
    table: Dict[str, Dict[str, float]] = {}
    for s in spans:
        row = table.setdefault(s.name, {"n": 0, "device_ms": 0.0,
                                        "self_device_ms": 0.0, "host_ms": 0.0})
        row["n"] += 1
        row["device_ms"] += dev[s.id]
        row["self_device_ms"] += dev[s.id] - inner[s.id]
        row["host_ms"] += (s.t1 - s.t0) / 1e6
    for name, t in device_counts.items():
        counters[name] = counters.get(name, 0) + int(t.item())
    return {"spans": table, "counters": counters, "dropped": store.dropped}
