"""Fused GroupNorm affine + SiLU + 3x3 conv for the resnet blocks (K8).

Twin of ``actalker_tpu/ops/resconv.py``: y = conv3x3(silu(x * a + b)) + cb,
NHWC, stride 1, SAME padding, where (a, b) is the per-(N, C) fp32 GroupNorm
affine of x. As in the JAX package, the statistics stay outside the conv:
on the card they come from K7-GN's statistics launch (the same fp32 sums,
one read of x), and K8 applies the affine and SiLU to each halo pixel
once, in shared memory, before its taps read it. The activation is rounded to the compute dtype before the product,
which accumulates in fp32; the bias is added in fp32.

Weights stay in torch's (Co, C, 3, 3) layout under the reference's names;
K8 reads them re-laid out as (Co, 9 * C) (tap-major, bf16), built once per
weight tensor and kept while the tensor lives and its version counter does
not move (``conv_weight``), so an in-place update rebuilds it and inference
pays no re-layout per call. ``conv_plan`` picks K8's tiles (the halo's row
stride, the Co tile, the weight ring's depth) from the shape; the CPU tests
hold it against every UNet and VAE shape. CPU tensors take the plain version;
CUDA tensors launch K7-GN's statistics and K8 or raise, on every shape the
configuration reaches (the JAX package's VMEM gate has no counterpart).
``GnSiluConv3x3Fn`` differentiates ``gn_silu_conv3x3_xla`` in its backward,
as the JAX package's ``_bwd`` recomputes through ``_gnconv_xla``: a conv in
the compute dtype whose output is taken in fp32, so the backward's convs
run in bf16.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from actalker_tpu_torch.ops._build import (
    Kernel, check, check_cuda_tensors, derived, fp32_of, needs_grad, ptr,
    stream_of)
from actalker_tpu_torch.ops.norms import gn_affine, group_norm_affine

__all__ = ["KERNEL", "VARIANTS", "GnSiluConv3x3Fn", "conv_launch",
           "conv_operands", "conv_plan", "conv_weight", "gn_affine",
           "gn_silu_conv3x3", "gn_silu_conv3x3_ref", "gn_silu_conv3x3_xla",
           "halo_source"]

KERNEL = Kernel("gn_silu_conv3x3", replaces="actalker_tpu/ops/resconv.py:43")
# K8 and its stage knock-outs, one C entry each (the TPU bisect tool's
# variants, tools/micro_resconv_bisect.py:30)
VARIANTS = ("full", "noshift", "noaffine", "nosilu", "mmonly")

_BF16 = (torch.bfloat16,)
_F32 = (torch.float32,)
_K8_DTYPES = {"x": _BF16, "a": _F32, "b": _F32, "w": _BF16, "cb": _F32}
_K8_IN_DTYPES = {"x": _BF16, "w": _BF16, "cb": _F32}
# the C entry of each variant
_ENTRIES = {v: "gn_silu_conv3x3_bf16" if v == "full" else f"gn_silu_conv3x3_{v}_bf16"
            for v in VARIANTS}

# K8's tiling (csrc/gn_silu_conv3x3.cu): 128 output pixels per block, C in
# chunks of 64 channels (128-byte rows), the halo brought in TMA boxes of
# 136 pixels, Co tiles of one wgmma width, a block's dynamic shared memory
# at most the card's 227 KB
BM, KC, BOX = 128, 64, 136
BN_CHOICES = (160, 128, 64)
MAX_STAGES = 6
SMEM_LIMIT = 232448


def _smem_bytes(bn: int, rows: int, stages: int) -> int:
    """A block's dynamic shared memory (the kernel's ``smem_bytes``): the
    weight ring, three halo buffers of ``rows`` pixels, the zero row, the
    bias, the slot table and the barriers, plus 1024 bytes of alignment
    slack."""
    return (1024 + stages * bn * 2 * KC + 3 * rows * 2 * KC + 16 + 4 * bn
            + 4 * rows + 8 * (2 * stages + 9))


@functools.lru_cache(maxsize=None)
def conv_plan(n: int, h: int, w: int, c: int, co: int) -> dict:
    """K8's tiles for x (n, h, w, c) -> co: ``seg`` the halo's row stride
    (W while the three row windows of a 128-pixel tile fit one run of
    boxes, else a box), ``slots`` the halo pixels the taps read, ``rows``
    the pixels a halo buffer holds (whole boxes), ``bn`` the Co tile (the
    widest wgmma width that tiles Co with the least padding), ``stages``
    the weight ring's depth, ``smem`` the block's shared memory, and the
    grid (``m_tiles`` x ``n_tiles``)."""
    seg = w if w <= BOX else BOX
    slots = 2 * seg + BM + 2
    rows = -(-slots // BOX) * BOX
    bn = min(BN_CHOICES, key=lambda b: (-(-co // b) * b - co, -b))
    stages = min(MAX_STAGES, (SMEM_LIMIT - _smem_bytes(bn, rows, 0))
                 // (bn * 2 * KC + 16))
    return {"seg": seg, "slots": slots, "rows": rows, "bn": bn,
            "stages": stages, "smem": _smem_bytes(bn, rows, stages),
            "chunks": -(-c // KC), "m_tiles": -(-(n * h * w) // BM),
            "n_tiles": -(-co // bn)}


def halo_source(slot: int, m0: int, w: int, seg: int) -> int:
    """The linear input pixel that K8's halo slot ``slot`` holds for the
    tile starting at output pixel m0 (the kernel's slot table; the caller
    masks pixels outside [0, N*H*W)). Output pixel m0 + i reads tap
    (dy, dx) at slot i + (dx + 1) + (dy + 1) * seg."""
    j = min(slot // seg, 2)
    return m0 - 1 + (j - 1) * w + (slot - j * seg)


def conv_weight(w, dtype) -> torch.Tensor:
    """K8's (Co, 9 * C) re-layout of w (Co, C, 3, 3) in ``dtype``, built
    once per weight tensor: kept while w lives and rebuilt when w's version
    counter moves (an in-place update, an optimizer step)."""
    return derived(w, ("k8 weight", dtype), lambda t: t.to(dtype).permute(
        0, 2, 3, 1).reshape(t.shape[0], 9 * t.shape[1]).contiguous())


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


def _conv_inputs(x, w, cb):
    """x contiguous, the cached (Co, 9 * C) weights and fp32 bias, and K8's
    plan, from a CUDA call. Raises on what K8 does not take."""
    c, co = x.shape[-1], w.shape[0]
    if not (x.ndim == 4 and w.shape == (co, c, 3, 3) and cb.shape == (co,)
            and c % 8 == 0 and co % 8 == 0 and x.dtype in _BF16):
        check(x.ndim == 4, f"K8: x {tuple(x.shape)} must be (N, H, W, C)")
        check(tuple(w.shape) == (co, c, 3, 3), f"K8: w {tuple(w.shape)}")
        check(tuple(cb.shape) == (co,), "K8: bias shape")
        check(c % 8 == 0 and co % 8 == 0,
              f"K8: C={c} and Co={co} must be multiples of 8")
        check(False, f"K8: x dtype {x.dtype} not in {_BF16}")
    x = x.contiguous()
    return x, conv_weight(w, x.dtype), fp32_of(cb), conv_plan(*x.shape, co)


def conv_operands(x, gamma, beta, groups, eps, w, cb):
    """K8's operands from a CUDA call: x contiguous, the fp32 affine (a, b)
    from K7-GN's statistics launch, the cached (Co, 9 * C) weights, the
    fp32 bias. Raises on what K8 does not take."""
    x, wt, cb, _ = _conv_inputs(x, w, cb)
    a, b = group_norm_affine(x, gamma, beta, groups, eps)
    return x, a, b, wt, cb


def _launch(fn, x, a, b, wt, cb, plan) -> torch.Tensor:
    """One K8 entry on checked operands: y (N, H, W, Co)."""
    n, h, wd, c = x.shape
    co = wt.shape[0]
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    KERNEL.launch(fn, "ppppppiiiiiiiip", ptr(x), ptr(a), ptr(b), ptr(wt),
                  ptr(cb), ptr(y), n, h, wd, c, co, plan["bn"], plan["seg"],
                  plan["stages"], stream_of(x))
    return y


def conv_launch(x, a, b, wt, cb, variant: str = "full") -> torch.Tensor:
    """The K8 launch on ``conv_operands``' operands; ``variant`` picks one
    of K8's stage knock-outs (``VARIANTS``, for the bisect tool
    ``tools/resconv_bisect.py``), "full" is K8 itself."""
    c, co = x.shape[-1], wt.shape[0]
    fn = _ENTRIES.get(variant)
    if fn is None:
        check(False, f"K8: variant {variant!r} not in {VARIANTS}")
    check_cuda_tensors("K8", (x, a, b, wt, cb), _K8_DTYPES)
    if x.ndim != 4 or wt.shape != (co, 9 * c):
        check(False, f"K8: x {tuple(x.shape)}, wt {tuple(wt.shape)}")
    return _launch(fn, x, a, b, wt, cb, conv_plan(*x.shape, co))


def _gn_silu_conv3x3_fwd(x, gamma, beta, groups, eps, w, cb) -> torch.Tensor:
    """K7-GN statistics + K8 launches (plain version for CPU tensors). The
    checks, the cached weights and the plan come before K7-GN's launch, so
    that little host work sits between the two launches."""
    if not x.is_cuda:
        return gn_silu_conv3x3_ref(x, gamma, beta, groups, eps, w, cb)
    x, wt, cb, plan = _conv_inputs(x, w, cb)
    check_cuda_tensors("K8", (x, wt, cb), _K8_IN_DTYPES)
    a, b = group_norm_affine(x, gamma, beta, groups, eps)
    return _launch(_ENTRIES["full"], x, a, b, wt, cb, plan)


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
