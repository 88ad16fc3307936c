"""Fused GroupNorm affine + SiLU + 3x3 conv for the resnet blocks (K8).

Twin of ``actalker_tpu/ops/resconv.py``: y = conv3x3(silu(x * a + b)) + cb,
NHWC, stride 1, SAME padding, where (a, b) is the per-(N, C) fp32 GroupNorm
affine of x. As in the JAX package, the statistics stay outside the conv:
on the card they come from K7-GN's statistics launch (the same fp32 sums,
one read of x), and K8 folds the affine and SiLU into its conv's operand
gather. The activation is rounded to the compute dtype before the product,
which accumulates in fp32; the bias is added in fp32.

Weights stay in torch's (Co, C, 3, 3) layout under the reference's names;
K8 takes them re-laid out per call as (Co, 9 * C) (tap-major, 9 * C * Co
bf16, a sliver of the activations). CPU tensors take the plain version;
CUDA tensors launch K7-GN's statistics and K8 or raise, on every shape the
configuration reaches (the JAX package's VMEM gate has no counterpart).
``GnSiluConv3x3Fn`` differentiates ``gn_silu_conv3x3_xla`` in its backward,
as the JAX package's ``_bwd`` recomputes through ``_gnconv_xla``: a conv in
the compute dtype whose output is taken in fp32, so the backward's convs
run in bf16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from actalker_tpu_torch.ops._build import (
    Kernel, check, check_cuda_tensors, needs_grad, ptr, stream_of)
from actalker_tpu_torch.ops.norms import gn_affine, group_norm_affine

__all__ = ["KERNEL", "VARIANTS", "GnSiluConv3x3Fn", "conv_launch",
           "conv_operands", "gn_affine", "gn_silu_conv3x3",
           "gn_silu_conv3x3_ref", "gn_silu_conv3x3_xla"]

KERNEL = Kernel("gn_silu_conv3x3", replaces="actalker_tpu/ops/resconv.py:43")
# K8 and its stage knock-outs, one C entry each (the TPU bisect tool's
# variants, tools/micro_resconv_bisect.py:30)
VARIANTS = ("full", "noshift", "noaffine", "nosilu", "mmonly")

_BF16 = (torch.bfloat16,)
_F32 = (torch.float32,)


def gn_silu_conv3x3_ref(x, gamma, beta, groups: int, eps: float, w, cb
                        ) -> torch.Tensor:
    """Plain version of K8 (twin of ``_gnconv_xla``): x (N, H, W, C);
    w (Co, C, 3, 3); cb (Co,)."""
    a, b = gn_affine(x, gamma, beta, groups, eps)
    y = x.float() * a[:, None, None, :] + b[:, None, None, :]
    y = (y * torch.sigmoid(y)).to(x.dtype)
    out = F.conv2d(y.permute(0, 3, 1, 2).float(), w.to(x.dtype).float(),
                   padding=1) + cb.float()[:, None, None]
    return out.permute(0, 2, 3, 1).to(x.dtype)


def gn_silu_conv3x3_xla(x, gamma, beta, groups: int, eps: float, w, cb
                        ) -> torch.Tensor:
    """Twin of ``_gnconv_xla``, the function the JAX backward
    differentiates: the activation rounded to x's dtype, the conv in that
    dtype with its output taken in fp32, the fp32 bias added."""
    a, b = gn_affine(x, gamma, beta, groups, eps)
    y = x.float() * a[:, None, None, :] + b[:, None, None, :]
    y = (y * torch.sigmoid(y)).to(x.dtype)
    out = F.conv2d(y.permute(0, 3, 1, 2), w.to(x.dtype), padding=1).float() \
        + cb.float()[:, None, None]
    return out.permute(0, 2, 3, 1).to(x.dtype)


def conv_operands(x, gamma, beta, groups, eps, w, cb):
    """K8's operands from a CUDA call: x contiguous, the fp32 affine (a, b)
    from K7-GN's statistics launch, the (Co, 9 * C) weights, the fp32
    bias. Raises on what K8 does not take."""
    check(x.ndim == 4, f"K8: x {tuple(x.shape)} must be (N, H, W, C)")
    c, co = x.shape[-1], w.shape[0]
    check(tuple(w.shape) == (co, c, 3, 3), f"K8: w {tuple(w.shape)}")
    check(tuple(cb.shape) == (co,), "K8: bias shape")
    check(c % 8 == 0 and co % 8 == 0,
          f"K8: C={c} and Co={co} must be multiples of 8")
    check(x.dtype in _BF16, f"K8: x dtype {x.dtype} not in {_BF16}")
    x = x.contiguous()
    a, b = group_norm_affine(x, gamma, beta, groups, eps)
    wt = w.to(x.dtype).permute(0, 2, 3, 1).reshape(co, 9 * c).contiguous()
    return x, a, b, wt, cb.float().contiguous()


def conv_launch(x, a, b, wt, cb, variant: str = "full") -> torch.Tensor:
    """The K8 launch on ``conv_operands``' operands; ``variant`` picks one
    of K8's stage knock-outs (``VARIANTS``, for the bisect tool
    ``tools/resconv_bisect.py``), "full" is K8 itself."""
    n, h, wd, c = x.shape
    co = wt.shape[0]
    check(variant in VARIANTS, f"K8: variant {variant!r} not in {VARIANTS}")
    check_cuda_tensors("K8", (x, a, b, wt, cb),
                       {"x": _BF16, "a": _F32, "b": _F32, "w": _BF16,
                        "cb": _F32})
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    fn = ("gn_silu_conv3x3_bf16" if variant == "full"
          else f"gn_silu_conv3x3_{variant}_bf16")
    KERNEL.launch(fn, "ppppppiiiiip", ptr(x), ptr(a), ptr(b), ptr(wt), ptr(cb),
                  ptr(y), n, h, wd, c, co, stream_of(x))
    return y


def _gn_silu_conv3x3_fwd(x, gamma, beta, groups, eps, w, cb) -> torch.Tensor:
    """K7-GN statistics + K8 launches (plain version for CPU tensors)."""
    if not x.is_cuda:
        return gn_silu_conv3x3_ref(x, gamma, beta, groups, eps, w, cb)
    return conv_launch(*conv_operands(x, gamma, beta, groups, eps, w, cb))


class GnSiluConv3x3Fn(torch.autograd.Function):
    """K8 forward; the backward differentiates ``gn_silu_conv3x3_xla``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, w, cb):
        ctx.save_for_backward(x, gamma, beta, w, cb)
        ctx.groups, ctx.eps = groups, eps
        return _gn_silu_conv3x3_fwd(x, gamma, beta, groups, eps, w, cb)

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w, cb = [t.detach().requires_grad_(True)
                                 for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = gn_silu_conv3x3_xla(x, gamma, beta, ctx.groups, ctx.eps, w, cb)
        dx, dg, db, dw, dcb = torch.autograd.grad(out, (x, gamma, beta, w, cb),
                                                  dy)
        return dx, dg, db, None, None, dw, dcb


def gn_silu_conv3x3(x, gamma, beta, groups: int, eps: float, w, cb
                    ) -> torch.Tensor:
    """y = conv3x3(silu(group_norm(x))) + cb: x (N, H, W, C); gamma / beta
    (C,); w (Co, C, 3, 3); cb (Co,); differentiable through
    ``GnSiluConv3x3Fn`` when autograd needs it."""
    args = (x, gamma, beta, groups, eps, w, cb)
    if needs_grad(x, gamma, beta, w, cb):
        return GnSiluConv3x3Fn.apply(*args)
    return _gn_silu_conv3x3_fwd(*args)
