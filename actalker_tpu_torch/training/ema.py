"""Exponential moving average of parameters (``use_ema`` in
``configs/train.yaml``; off by default). Twin of
``actalker_tpu/training/ema.py``.

Under gradient accumulation the optimizer commits only every k-th
micro-step; ``ema_step`` moves the average only on those micro-steps, so
the effective decay per real update stays ``decay``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn


@torch.no_grad()
def ema_init(modules: Dict[str, nn.Module]) -> Dict[str, Dict[str, torch.Tensor]]:
    """fp32 copies of every parameter, keyed as the modules' state dicts."""
    return {name: {k: p.detach().float().clone()
                   for k, p in m.named_parameters()}
            for name, m in modules.items()}


@torch.no_grad()
def ema_update(ema: Dict[str, Dict[str, torch.Tensor]],
               modules: Dict[str, nn.Module], decay: float = 0.9999,
               commit: Optional[bool] = None):
    """In place: e = e * decay + p * (1 - decay); nothing when ``commit`` is
    False."""
    if commit is False:
        return ema
    for name, m in modules.items():
        dst = ema[name]
        ps = dict(m.named_parameters())
        es = list(dst.values())
        torch._foreach_mul_(es, decay)
        torch._foreach_add_(es, [ps[k].float() for k in dst], alpha=1.0 - decay)
    return ema


def ema_step(ema, modules, committed: bool, decay: float = 0.9999):
    """EMA update gated on whether the optimizer just committed."""
    return ema_update(ema, modules, decay=decay, commit=committed)
