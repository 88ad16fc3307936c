"""Shared building blocks: norms with fp32 statistics, and linear / conv
layers that compute in their input's dtype.

Twin of ``actalker_tpu/models/common.py``. The norm lowering follows the
JAX package's switch (``ACTALKER_NORM`` or ``set_norm_impl``, read at call
time): "xla" (default) applies the affine in the activation dtype; "fused"
routes every ``LayerNormF32`` / ``GroupNorm32`` through ``ops/norms.py``
(K7-LN / K7-GN: fp32 affine, one cast of the output). Video
tensors keep the JAX layout, (B, F, H, W, C), and images are NHWC; a conv
hands cuDNN an NCHW view with channels-last strides, so no copy is made
around it. Parameter names follow the reference's diffusers modules
(``weight`` / ``bias``), so the reference state dicts load unchanged.
"""
from __future__ import annotations

import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.ops.norms import group_norm, layer_norm

_NORM_IMPL = os.environ.get("ACTALKER_NORM", "xla")
if _NORM_IMPL not in ("fused", "xla"):
    raise ValueError(f"ACTALKER_NORM={_NORM_IMPL!r}: 'fused' or 'xla'")


def set_norm_impl(impl: str) -> None:
    """Set the norm lowering: "fused" (K7-LN / K7-GN) or "xla" (the
    default, plain branches)."""
    global _NORM_IMPL
    if impl not in ("fused", "xla"):
        raise ValueError(f"norm impl {impl!r}: 'fused' or 'xla'")
    _NORM_IMPL = impl


def norm_impl() -> str:
    """The current norm lowering, "fused" or "xla"."""
    return _NORM_IMPL


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` whose weights are cast to the input dtype (as
    ``nn.Dense(dtype=...)`` computes in its dtype)."""

    def forward(self, x):
        return F.linear(x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    """2-D conv on NHWC input, weights in torch (O, I / groups, kh, kw)
    layout."""

    def forward(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), _cast(self.weight, x.dtype),
                     _cast(self.bias, x.dtype), self.stride, self.padding,
                     self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class TemporalConv(nn.Conv3d):
    """(3, 1, 1) conv over the frame axis of (B, F, H, W, C) video."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x):
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), _cast(self.weight, x.dtype),
                     _cast(self.bias, x.dtype), padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


class GroupNorm32(nn.Module):
    """GroupNorm over the channel-last axis: fp32 statistics over every axis
    but the first and the last, affine applied in the activation dtype
    (fused: in fp32, by K7-GN)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups = num_groups if channels >= num_groups else channels
        if channels % self.groups:
            raise ValueError(f"{channels} channels, {self.groups} groups")
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        if _NORM_IMPL == "fused":
            return group_norm(x, self.weight, self.bias, self.groups, self.eps)
        n, c = x.shape[0], x.shape[-1]
        dims = tuple(range(1, x.ndim - 1))
        s1 = x.mean(dim=dims, dtype=torch.float32)                 # (N, C)
        s2 = x.float().square().mean(dim=dims)
        mean_g = s1.reshape(n, self.groups, -1).mean(-1)
        var_g = (s2.reshape(n, self.groups, -1).mean(-1)
                 - mean_g.square()).clamp_min(0.0)
        inv_c = torch.rsqrt(var_g + self.eps).repeat_interleave(
            c // self.groups, dim=1)
        mean_c = mean_g.repeat_interleave(c // self.groups, dim=1)
        a = inv_c * self.weight.float()
        b = self.bias.float() - mean_c * a
        shape = (n,) + (1,) * (x.ndim - 2) + (c,)
        return x * a.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)


class LayerNormF32(nn.Module):
    """LayerNorm over the last axis with fp32 statistics, affine applied in
    the activation dtype (fused: in fp32, by K7-LN)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        if _NORM_IMPL == "fused":
            return layer_norm(x, self.weight, self.bias, self.eps)
        mean = x.mean(dim=-1, keepdim=True, dtype=torch.float32)
        var = (x.float().square().mean(dim=-1, keepdim=True)
               - mean.square()).clamp_min(0.0)
        a = torch.rsqrt(var + self.eps) * self.weight.float()
        b = self.bias.float() - mean * a
        return x * a.to(x.dtype) + b.to(x.dtype)
