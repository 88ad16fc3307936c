"""GEGLU feed-forward y = (h * gelu(g)) @ W2^T + b2 with [h | g] = x @ W1^T
+ b1 (K4).

Twin of ``actalker_tpu/ops/mlp.py``. Weights are in torch ``Linear`` layout
(W1 (2I, C), W2 (Cout, I)), biases fp32. The gate runs in fp32 with the exact
erf GELU, and h is rounded to the weight dtype before the second product,
as the TPU kernel does. CPU tensors take the plain version; CUDA tensors
launch the kernel or raise. When autograd needs it, ``GegluMlpFn`` runs K4
forward and differentiates ``geglu_mlp_xla`` in its backward, as the JAX
package's ``_mlp_bwd`` recomputes through ``_mlp_xla``: its products take
and return the weights' dtype, so the backward's GEMMs run in bf16 as the
JAX package's do.

K4 is two launches of one GEMM engine, each under a plan that ``plans``
picks from the shapes alone (``csrc/geglu_mlp.cu`` says what each does);
each launch counts its plan as ``k4.plan.<name>``
(``utils/observability.count``).
"""
from __future__ import annotations

import math

import torch

from actalker_tpu_torch.ops._build import (
    Kernel, check, check_cuda_tensors, needs_grad, ptr, stream_of)
from actalker_tpu_torch.utils.observability import count

KERNEL = Kernel("geglu_mlp", replaces="actalker_tpu/ops/mlp.py:47")

_BF16 = (torch.bfloat16,)
_F32 = (torch.float32,)

# the C entries' plan numbers (csrc/geglu_mlp.cu, ``Plan``)
PLANS = {"in_resident": 0, "in_stream": 1, "out_tma": 2, "out_regs": 3}
# in_resident keeps a 128-row block of x whole in shared memory: its K up to
# C = 320, and a block per row block, so the card's 132 SMs each want one
RESIDENT_C = 320
RESIDENT_MIN_M = 128 * 132


def plans(m: int, c: int, inner: int, cout: int):
    """(GEGLU launch plan, output projection plan) for x (M, C), I = inner
    hidden units and Cout outputs: x's rows stay in shared memory where they
    fit and fill the card, and y is stored by TMA where its rows are 16-byte
    strided. A function of the shapes alone."""
    first = "in_resident" if c <= RESIDENT_C and m >= RESIDENT_MIN_M else "in_stream"
    return first, "out_tma" if cout % 8 == 0 else "out_regs"


def _gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x * (2.0 ** -0.5)))


def geglu_mlp_ref(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain version of K4 (twin of ``_mlp_xla``) with fp32 products."""
    inner = w2.shape[1]
    h2 = x.float() @ w1.float().t() + b1.float()
    h = (h2[..., :inner] * _gelu_erf(h2[..., inner:])).to(w2.dtype)
    return (h.float() @ w2.float().t() + b2.float()).to(x.dtype)


def geglu_mlp_xla(x, w1, b1, w2, b2) -> torch.Tensor:
    """Twin of ``_mlp_xla``, the function the JAX backward differentiates:
    each product takes and returns the operands' dtype (fp32 accumulation
    inside), the fp32 biases are added to its output."""
    inner = w2.shape[1]
    h2 = (x @ w1.t()).float() + b1.float()
    h = h2[..., :inner] * _gelu_erf(h2[..., inner:])
    return ((h.to(w2.dtype) @ w2.t()).float() + b2.float()).to(x.dtype)


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
    # TMA reads rows at 16-byte strides; the epilogue stores column pairs
    check(c % 8 == 0 and inner % 8 == 0 and cout % 2 == 0,
          f"K4: C={c} and I={inner} must be multiples of 8, Cout even")
    x2 = x.reshape(m, c)
    check_cuda_tensors("K4", (x2, w1, b1, w2, b2),
                       {"x": _BF16, "w1": _BF16, "b1": _F32, "w2": _BF16,
                        "b2": _F32})
    h = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    y = torch.empty((m, cout), dtype=x.dtype, device=x.device)
    stream = stream_of(x)
    first, second = plans(m, c, inner, cout)
    KERNEL.launch("geglu_in_bf16", "ppppiiiip", ptr(x2), ptr(w1), ptr(b1),
                  ptr(h), m, c, inner, PLANS[first], stream)
    count("k4.plan." + first, 1)
    KERNEL.launch("linear_bias_bf16", "ppppiiiip", ptr(h), ptr(w2), ptr(b2),
                  ptr(y), m, inner, cout, PLANS[second], stream)
    count("k4.plan." + second, 1)
    return y.reshape(*x.shape[:-1], cout)


class GegluMlpFn(torch.autograd.Function):
    """K4 forward; the backward differentiates ``geglu_mlp_xla``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _geglu_fwd(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = geglu_mlp_xla(*ins)
        return torch.autograd.grad(out, ins, dy)


def geglu_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """x (..., C); w1 (2I, C); b1 (2I,); w2 (Cout, I); b2 (Cout,);
    differentiable through ``GegluMlpFn`` when autograd needs it."""
    args = (x, w1, b1, w2, b2)
    if needs_grad(*args):
        return GegluMlpFn.apply(*args)
    return _geglu_fwd(*args)
