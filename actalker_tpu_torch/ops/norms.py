"""LayerNorm and GroupNorm with fp32 statistics and an fp32 affine (K7-LN,
K7-GN).

Twin of ``actalker_tpu/ops/norms.py``. Both normalize channel-last tensors:
LayerNorm over the last axis, GroupNorm over every axis but the first and
the last (x (N, ..., C) is taken as (N, M, C)) and the C / G channels of
each group. Statistics are E[x] and E[x^2] in fp32 with the variance
clamped at 0; the affine runs in fp32 and the output is cast once to the
input dtype. This is a different function from the default branch of
``models/common.py``, which applies the affine in the activation dtype.

CPU tensors take the plain versions; CUDA tensors launch the kernels or
raise. ``LayerNormFn`` / ``GroupNormFn`` run the kernel forward and
differentiate the plain version in their backward, as the JAX package's
``_ln_bwd`` / ``_gn_bwd`` recompute through ``_ln_xla`` / ``_gn_xla``.
"""
from __future__ import annotations

import math

import torch

from actalker_tpu_torch.ops._build import (
    Kernel, check, check_cuda_tensors, fp32_of, needs_grad, ptr, stream_of)

LN_KERNEL = Kernel("layer_norm", replaces="actalker_tpu/ops/norms.py:35")
GN_KERNEL = Kernel("group_norm", replaces="actalker_tpu/ops/norms.py:119")

_DTYPES = (torch.bfloat16, torch.float32)
_F32 = (torch.float32,)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
# rows per statistics block of K7-GN: about 64k elements each, so a VAE
# image (512 * 512 rows) spreads over 512 blocks
_GN_BLOCK_ELEMS = 65536


def layer_norm_ref(x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K7-LN (twin of ``_ln_xla``)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf.square().mean(dim=-1, keepdim=True) - mu.square()).clamp_min(0.0)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma.float()
            + beta.float()).to(x.dtype)


def gn_affine(x, gamma, beta, groups: int, eps: float):
    """Per-(N, C) fp32 (a, b) of GroupNorm with statistics over every axis
    but the first and the last (twin of ``resconv._gn_affine``)."""
    n, c = x.shape[0], x.shape[-1]
    dims = tuple(range(1, x.ndim - 1))
    s1 = x.mean(dim=dims, dtype=torch.float32)                      # (N, C)
    s2 = x.float().square().mean(dim=dims)
    m1 = s1.reshape(n, groups, c // groups).mean(-1)
    m2 = s2.reshape(n, groups, c // groups).mean(-1)
    inv = torch.rsqrt((m2 - m1.square()).clamp_min(0.0) + eps)
    a = inv.repeat_interleave(c // groups, dim=1) * gamma.float()[None]
    b = beta.float()[None] - m1.repeat_interleave(c // groups, dim=1) * a
    return a, b


def group_norm_ref(x, gamma, beta, groups: int = 32, eps: float = 1e-5
                   ) -> torch.Tensor:
    """Plain version of K7-GN (twin of ``_gn_xla``)."""
    a, b = gn_affine(x, gamma, beta, groups, eps)
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    return (x.float() * a.reshape(shape) + b.reshape(shape)).to(x.dtype)


def _check_affine_args(name, x, gamma, beta):
    c = x.shape[-1]
    if c % 8 or gamma.shape != (c,) or beta.shape != (c,):
        check(c % 8 == 0, f"{name}: C={c} must be a multiple of 8")
        check(False, f"{name}: gamma / beta must be ({c},)")


_NORM_DTYPES = {"x": _DTYPES, "gamma": _F32, "beta": _F32}


_LN_FN = {dt: f"layer_norm_{sfx}" for dt, sfx in _SUFFIX.items()}


def _ln_launch(x, xp: int, gp: int, bp: int, y, eps: float, dev: int) -> None:
    """K7-LN's launch on x's device ``dev``: x / y contiguous of one dtype,
    (..., C), normalized over C; xp / gp / bp the pointers of x, gamma and
    beta (fp32 (C,))."""
    c = x.shape[-1]
    LN_KERNEL.launch(_LN_FN[x.dtype], "ppppiifp", xp, gp, bp, y.data_ptr(),
                     x.numel() // c, c, eps,
                     torch._C._cuda_getCurrentRawStream(dev))


def layer_norm_launch(x, gamma, beta, y, eps: float) -> None:
    """The bare K7-LN launch into y, on operands that pass the wrapper's
    checks; no checks (the launch alone, for timing)."""
    _ln_launch(x, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y, eps,
               x.get_device())


def _layer_norm_fwd(x, gamma, beta, eps: float) -> torch.Tensor:
    """K7-LN launch (plain version for CPU tensors). The kernel takes x in
    its own shape (no reshape or view per call), and the checks that pass
    cost a few attribute reads: messages are built only on failure."""
    if not x.is_cuda:
        return layer_norm_ref(x, gamma, beta, eps)
    c = x.shape[-1]
    dev = x.get_device()
    xp, gp, bp = x.data_ptr(), gamma.data_ptr(), beta.data_ptr()
    # the common case in one expression; anything else is normalized (or
    # raises with its reason) below
    if not (c % 8 == 0 and gamma.shape == (c,) and beta.shape == (c,)
            and x.dtype in _LN_FN and gamma.dtype is _F32[0]
            and beta.dtype is _F32[0] and x.is_contiguous()
            and gamma.is_contiguous() and beta.is_contiguous()
            and gamma.get_device() == dev and beta.get_device() == dev
            and xp % 16 == 0 and gp % 16 == 0 and bp % 16 == 0):
        _check_affine_args("K7-LN", x, gamma, beta)
        x, gamma, beta = x.contiguous(), fp32_of(gamma), fp32_of(beta)
        check_cuda_tensors("K7-LN", (x, gamma, beta), _NORM_DTYPES)
        xp, gp, bp = x.data_ptr(), gamma.data_ptr(), beta.data_ptr()
    y = torch.empty_like(x)
    _ln_launch(x, xp, gp, bp, y, eps, dev)
    return y


def _gn_operands(name, x, gamma, beta, groups):
    """x as a contiguous (N, M, C) CUDA tensor, fp32 gamma / beta, and the
    K7-GN statistics layout: (rows per block, partial-sum buffer)."""
    _check_affine_args(name, x, gamma, beta)
    n, c = x.shape[0], x.shape[-1]
    if not (x.ndim >= 3 and c % groups == 0 and groups <= 256):
        check(False, f"{name}: x {tuple(x.shape)} with {groups} groups")
    x3 = x.contiguous().reshape(n, -1, c)
    gamma, beta = fp32_of(gamma), fp32_of(beta)
    check_cuda_tensors(name, (x3, gamma, beta), _NORM_DTYPES)
    m = x3.shape[1]
    rows = max(1, min(m, _GN_BLOCK_ELEMS // c))
    part = torch.empty((n, math.ceil(m / rows), groups, 2), dtype=torch.float32,
                       device=x.device)
    return x3, gamma, beta, rows, part


def group_norm_affine(x, gamma, beta, groups: int, eps: float):
    """The per-(N, C) fp32 GroupNorm affine (a, b): K7-GN's statistics
    launch on CUDA tensors, ``gn_affine`` on CPU tensors."""
    if not x.is_cuda:
        return gn_affine(x, gamma, beta, groups, eps)
    x3, gamma, beta, rows, part = _gn_operands("K7-GN", x, gamma, beta, groups)
    n, m, c = x3.shape
    a = torch.empty((n, c), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    GN_KERNEL.launch(f"gn_affine_{_SUFFIX[x.dtype]}", "ppppppiiiiifp", ptr(x3),
                     ptr(gamma), ptr(beta), ptr(part), ptr(a), ptr(b), n, m, c,
                     groups, rows, eps, stream_of(x))
    return a, b


def _group_norm_fwd(x, gamma, beta, groups: int, eps: float) -> torch.Tensor:
    """K7-GN launch (plain version for CPU tensors)."""
    if not x.is_cuda:
        return group_norm_ref(x, gamma, beta, groups, eps)
    x3, gamma, beta, rows, part = _gn_operands("K7-GN", x, gamma, beta, groups)
    n, m, c = x3.shape
    a = torch.empty((n, c), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    y = torch.empty_like(x3)
    GN_KERNEL.launch(f"group_norm_{_SUFFIX[x.dtype]}", "pppppppiiiiifp",
                     ptr(x3), ptr(gamma), ptr(beta), ptr(part), ptr(a), ptr(b),
                     ptr(y), n, m, c, groups, rows, eps, stream_of(x))
    return y.reshape(x.shape)


class LayerNormFn(torch.autograd.Function):
    """K7-LN forward; the backward differentiates ``layer_norm_ref``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        return _layer_norm_fwd(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = layer_norm_ref(*ins, ctx.eps)
        return (*torch.autograd.grad(out, ins, dy), None)


class GroupNormFn(torch.autograd.Function):
    """K7-GN forward; the backward differentiates ``group_norm_ref``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.groups, ctx.eps = groups, eps
        return _group_norm_fwd(x, gamma, beta, groups, eps)

    @staticmethod
    def backward(ctx, dy):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = group_norm_ref(*ins, ctx.groups, ctx.eps)
        return (*torch.autograd.grad(out, ins, dy), None, None)


def layer_norm(x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., C); gamma / beta (C,);
    differentiable through ``LayerNormFn`` when autograd needs it."""
    if needs_grad(x, gamma, beta):
        return LayerNormFn.apply(x, gamma, beta, eps)
    return _layer_norm_fwd(x, gamma, beta, eps)


def group_norm(x, gamma, beta, groups: int = 32, eps: float = 1e-5
               ) -> torch.Tensor:
    """GroupNorm of x (N, ..., C) with ``groups`` channel groups; gamma /
    beta (C,); differentiable through ``GroupNormFn`` when autograd needs
    it."""
    if needs_grad(x, gamma, beta):
        return GroupNormFn.apply(x, gamma, beta, groups, eps)
    return _group_norm_fwd(x, gamma, beta, groups, eps)
