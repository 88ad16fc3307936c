"""GEGLU feed-forward y = (h * gelu(g)) @ W2^T + b2 with [h | g] = x @ W1^T
+ b1 (K4).

Twin of ``actalker_tpu/ops/mlp.py``. Weights are in torch ``Linear`` layout
(W1 (2I, C), W2 (Cout, I)), biases fp32. The gate runs in fp32 with the exact
erf GELU, and h is rounded to the weight dtype before the second product,
as the TPU kernel does. CPU tensors take the plain version; CUDA tensors
launch the kernel or raise. When autograd needs it, ``GegluMlpFn`` runs K4
forward and differentiates the plain version in its backward, as the JAX
package's ``_mlp_bwd`` recomputes through ``_mlp_xla``.
"""
from __future__ import annotations

import math

import torch

from actalker_tpu_torch.ops._build import (
    Kernel, check, check_cuda_tensors, needs_grad, ptr, stream_of)

KERNEL = Kernel("geglu_mlp", replaces="actalker_tpu/ops/mlp.py:47")

_BF16 = (torch.bfloat16,)
_F32 = (torch.float32,)


def _gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))


def geglu_mlp_ref(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain version of K4 (twin of ``_mlp_xla``) with fp32 products."""
    inner = w2.shape[1]
    h2 = x.float() @ w1.float().t() + b1.float()
    h = (h2[..., :inner] * _gelu_erf(h2[..., inner:])).to(w2.dtype)
    return (h.float() @ w2.float().t() + b2.float()).to(x.dtype)


def _geglu_fwd(x, w1, b1, w2, b2) -> torch.Tensor:
    """K4 launches (plain version for CPU tensors)."""
    if not x.is_cuda:
        return geglu_mlp_ref(x, w1, b1, w2, b2)
    c = x.shape[-1]
    inner, cout = w2.shape[1], w2.shape[0]
    m = math.prod(x.shape[:-1])
    check(tuple(w1.shape) == (2 * inner, c), f"K4: w1 {tuple(w1.shape)}")
    check(tuple(b1.shape) == (2 * inner,) and tuple(b2.shape) == (cout,),
          "K4: bias shapes")
    check(c % 8 == 0 and inner % 8 == 0 and cout % 2 == 0,
          f"K4: C={c} and I={inner} must be multiples of 8, Cout even")
    x2 = x.reshape(m, c)
    check_cuda_tensors("K4", (x2, w1, b1, w2, b2),
                       {"x": _BF16, "w1": _BF16, "b1": _F32, "w2": _BF16,
                        "b2": _F32})
    h = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    y = torch.empty((m, cout), dtype=x.dtype, device=x.device)
    stream = stream_of(x)
    KERNEL.launch("geglu_in_bf16", "ppppiiip", ptr(x2), ptr(w1), ptr(b1),
                  ptr(h), m, c, inner, stream)
    KERNEL.launch("linear_bias_bf16", "ppppiiip", ptr(h), ptr(w2), ptr(b2),
                  ptr(y), m, inner, cout, stream)
    return y.reshape(*x.shape[:-1], cout)


class GegluMlpFn(torch.autograd.Function):
    """K4 forward; the backward differentiates ``geglu_mlp_ref``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _geglu_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = geglu_mlp_ref(*ins)
        return torch.autograd.grad(out, ins, dy)


def geglu_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """x (..., C); w1 (2I, C); b1 (2I,); w2 (Cout, I); b2 (Cout,);
    differentiable through ``GegluMlpFn`` when autograd needs it."""
    args = (x, w1, b1, w2, b2)
    if needs_grad(*args):
        return GegluMlpFn.apply(*args)
    return _geglu_fwd(*args)
