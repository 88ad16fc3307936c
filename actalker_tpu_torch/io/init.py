"""Seeded parameter initialization and the inference-precision cast.

Twin of ``actalker_tpu/io/init.py``: ``random_init_`` fills every parameter
with ``standard_normal * 0.02`` from a seed (the ``random_like`` /
``--random-weights`` semantics), drawing from a ``torch.Generator`` on the
target device so a full-width UNet initializes on the card in seconds;
``cast_params_bf16_`` mirrors ``cast_params_bf16``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

# scan state parameters stay fp32 (the scan contract, and the reference's
# own fp32 override of its mamba parameters)
FP32_PARAMS = ("A_logs", "dt_projs_weight", "dt_projs_bias")


INIT_SCALE = 0.02


@torch.no_grad()
def random_init_(module: nn.Module, seed: int, device) -> nn.Module:
    """Materialize ``module`` (possibly built on the meta device) on
    ``device`` with fp32 parameters ~ N(0, INIT_SCALE^2), drawn in
    ``named_parameters`` order from one generator seeded with ``seed``."""
    module.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for _, p in module.named_parameters():
        p.data = torch.randn(p.shape, generator=gen, device=device) * INIT_SCALE
    return module


@torch.no_grad()
def cast_params_bf16_(module: nn.Module) -> nn.Module:
    """In place: >= 2-D fp32 parameters become bf16; 1-D parameters (biases,
    norm affines, ``Ds``) and the scan's ``A_logs`` / ``dt_projs_weight`` /
    ``dt_projs_bias`` stay fp32."""
    for name, p in module.named_parameters():
        if (p.ndim >= 2 and p.dtype == torch.float32
                and name.rsplit(".", 1)[-1] not in FP32_PARAMS):
            p.data = p.data.to(torch.bfloat16)
    return module
