"""Seeded parameter initialization and the inference-precision cast.

Twin of ``actalker_tpu/io/init.py``: ``random_init_`` fills every parameter
with ``standard_normal * 0.02`` from a seed (the ``random_like`` /
``--random-weights`` semantics), drawing from a ``torch.Generator`` on the
target device so a full-width UNet initializes on the card in seconds;
``cast_params_bf16_`` mirrors ``cast_params_bf16``. ``lineage_init_`` gives
the SS2D lineage (``models/ssm_spatial.py``) the JAX package's own
initializers instead, which keep the scan's range of decays.
"""
from __future__ import annotations

import math

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


# flax's lecun_normal: a normal truncated to +-2 std, rescaled by the std of
# the standard normal truncated there, so the variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lineage_init_(module: nn.Module, seed: int, device) -> nn.Module:
    """Materialize ``module`` (possibly built on the meta device) on
    ``device`` with fp32 parameters from the JAX package's recipes, drawn
    in ``named_parameters`` order from one generator seeded with ``seed``:

      * ``x_proj_weight`` (K, R + 2N, D) ~ U(+-D^-0.5); ``dt_projs_weight``
        (K, D, R) ~ U(+-R^-0.5);
      * ``dt_projs_bias``: the inverse softplus of dt = exp(U(log 1e-3,
        log 0.1)) clamped at 1e-4;
      * ``A_logs`` = log(1..N) per row (S4D-real), ``Ds`` = 1;
      * other >= 2-D weights (dense, conv) lecun-normal over their fan-in,
        1-D weights (norm scales) 1, biases 0.

    ``random_init_``'s N(0, 0.02^2) would put every A near -1 and hide the
    scan's range of decays."""
    module.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("x_proj_weight", "dt_projs_weight"):
            bound = p.shape[-1] ** -0.5
            p.uniform_(-bound, bound, generator=gen)
        elif leaf == "dt_projs_bias":
            lo, hi = math.log(1e-3), math.log(0.1)
            u = torch.rand(p.shape, generator=gen, device=device)
            dt = torch.exp(u * (hi - lo) + lo).clamp_min(1e-4)
            p.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif leaf == "A_logs":
            n = p.shape[-1]
            p.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                           device=device)).expand(p.shape))
        elif leaf == "Ds" or (leaf == "weight" and p.ndim == 1):
            p.fill_(1.0)
        elif leaf == "weight":
            std = p[0].numel() ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
        else:
            p.zero_()
    return module
