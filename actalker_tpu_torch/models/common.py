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
Each norm call is the leaf span ``unet.norm`` (``utils/observability``),
under either lowering.
"""
from __future__ import annotations

import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.ops.norms import group_norm, layer_norm
from actalker_tpu_torch.utils.observability import spanned

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
    ``nn.Dense(dtype=...)`` computes in its dtype). Under tensor
    parallelism (``parallel/tensor.py`` sets ``tp`` and ``tp_mode``) it
    holds this rank's slice: "col" / "col_gather" of the output features
    (the latter all-gathered), "row" of the input features (the partial
    products all-reduced, then the whole bias)."""

    tp = None
    tp_mode = None

    def forward(self, x):
        w, b = _cast(self.weight, x.dtype), _cast(self.bias, x.dtype)
        if self.tp is None:
            return F.linear(x, w, b)
        from actalker_tpu_torch.parallel.tensor import copy_to, gather_last, reduce_from

        if self.tp_mode == "row":
            y = reduce_from(F.linear(x, w), self.tp)
            return y if b is None else y + b
        y = F.linear(copy_to(x, self.tp), w, b)
        return gather_last(y, self.tp) if self.tp_mode == "col_gather" else y


def _conv_tp(conv, x, fn):
    """``fn(x)`` of a conv with its output channels sharded over tp ranks
    (``parallel/tensor.py``): the whole input in, every rank's channels
    all-gathered out (channels last)."""
    if conv.tp is None:
        return fn(x)
    from actalker_tpu_torch.parallel.tensor import copy_to, gather_last

    return gather_last(fn(copy_to(x, conv.tp)), conv.tp)


class Conv2d(nn.Conv2d):
    """2-D conv on NHWC input, weights in torch (O, I / groups, kh, kw)
    layout; under tensor parallelism, this rank's output channels
    (``_conv_tp``)."""

    tp = None

    def _conv(self, x):
        y = F.conv2d(x.permute(0, 3, 1, 2), _cast(self.weight, x.dtype),
                     _cast(self.bias, x.dtype), self.stride, self.padding,
                     self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)

    def forward(self, x):
        return _conv_tp(self, x, self._conv)


class Conv2dNCHW(nn.Conv2d):
    """2-D conv on NCHW input, weights cast to the input dtype (the image
    encoders, which run channel-first)."""

    def forward(self, x):
        return F.conv2d(x, _cast(self.weight, x.dtype), _cast(self.bias, x.dtype),
                        self.stride, self.padding, self.dilation, self.groups)


class FrozenBatchNorm(nn.Module):
    """y = weight * (x - running_mean) / sqrt(running_var + eps) + bias over
    the channel axis 1."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * inv.reshape(shape) + (self.bias - self.running_mean * inv
                                         ).reshape(shape)


class TemporalConv(nn.Conv3d):
    """(3, 1, 1) conv over the frame axis of (B, F, H, W, C) video (under
    tensor parallelism, this rank's output channels)."""

    tp = None

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, (3, 1, 1), padding=(1, 0, 0))

    def _conv(self, x):
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), _cast(self.weight, x.dtype),
                     _cast(self.bias, x.dtype), padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)

    def forward(self, x):
        return _conv_tp(self, x, self._conv)


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

    @spanned("unet.norm")
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

    @spanned("unet.norm")
    def forward(self, x):
        if _NORM_IMPL == "fused":
            return layer_norm(x, self.weight, self.bias, self.eps)
        mean = x.mean(dim=-1, keepdim=True, dtype=torch.float32)
        var = (x.float().square().mean(dim=-1, keepdim=True)
               - mean.square()).clamp_min(0.0)
        a = torch.rsqrt(var + self.eps) * self.weight.float()
        b = self.bias.float() - mean * a
        return x * a.to(x.dtype) + b.to(x.dtype)
