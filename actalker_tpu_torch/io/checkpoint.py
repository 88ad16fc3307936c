"""Step-keyed checkpoints with rotation, twin of
``actalker_tpu/io/checkpoint.py`` (the reference's ``checkpoint-<step>``
directories, auto-discovery of the latest step on resume, and a
``total_limit`` rotation that deletes the oldest).

A checkpoint is ``<directory>/checkpoint-<step>/state.pt``: one
``torch.save`` of the same tree the JAX driver saves, ``{"params": {artifact:
state dict}}`` plus ``"ema"`` when the EMA is on.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = "state.pt"


def _path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"checkpoint-{step}")


def save_checkpoint(directory: str, step: int, state: Dict[str, Any],
                    total_limit: Optional[int] = None) -> str:
    path = _path(directory, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if total_limit:
        rotate_checkpoints(directory, total_limit)
    return path


def list_checkpoints(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"checkpoint-(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, STATE_FILE)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(directory: str) -> Optional[int]:
    steps = list_checkpoints(directory)
    return steps[-1] if steps else None


def rotate_checkpoints(directory: str, total_limit: int) -> None:
    steps = list_checkpoints(directory)
    for s in steps[:-total_limit] if total_limit > 0 else []:
        shutil.rmtree(_path(directory, s), ignore_errors=True)


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       map_location="cpu") -> Dict[str, Any]:
    """Load; ``step=None`` picks the latest (the reference's discovery)."""
    if step is None:
        step = latest_checkpoint(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return torch.load(os.path.join(_path(directory, step), STATE_FILE),
                      map_location=map_location, weights_only=True)
