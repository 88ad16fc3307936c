"""StyleGAN2 resampling in plain PyTorch, twin of
``actalker_tpu/ops/upfirdn2d.py``.

The reference compiles ``src/utils/enhance/op/upfirdn2d.cu`` and
``fused_bias_act.cu`` as CUDA extensions; neither is a TPU kernel, and the
JAX package computes them as XLA convolutions. Here upsample-FIR-downsample
is a zero-insertion upsample, a pad, one depthwise ``conv2d`` with the
flipped FIR filter (a true convolution, as the reference's native path) and
a stride; bias + LeakyReLU + sqrt(2) gain is one elementwise expression.

Layout NCHW; filters are (kh, kw), applied to every channel.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def make_kernel(k: Sequence[float]) -> np.ndarray:
    k = np.asarray(k, np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def upfirdn2d(x: torch.Tensor, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """x (N, C, H, W): insert ``up - 1`` zeros after every sample (the input
    becomes (H * up, W * up)), pad both spatial axes by ``pad`` (before,
    after), convolve with ``kernel`` and keep every ``down``-th output."""
    n, c, h, w = x.shape
    k = torch.as_tensor(np.asarray(kernel), dtype=x.dtype, device=x.device)
    if up > 1:
        z = x.new_zeros(n, c, h, up, w, up)
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(n, c, h * up, w * up)
    p0, p1 = pad
    x = F.pad(x, (p0, p1, p0, p1))
    filt = torch.flip(k, (0, 1)).expand(c, 1, *k.shape)
    return F.conv2d(x, filt, stride=down, groups=c)


def upsample2x(x: torch.Tensor, kernel=(1, 3, 3, 1)) -> torch.Tensor:
    k = make_kernel(kernel) * 4.0
    p = k.shape[0] - 2
    return upfirdn2d(x, k, up=2, pad=((p + 1) // 2 + 1, p // 2))


def downsample2x(x: torch.Tensor, kernel=(1, 3, 3, 1)) -> torch.Tensor:
    k = make_kernel(kernel)
    p = k.shape[0] - 2
    return upfirdn2d(x, k, down=2, pad=((p + 1) // 2, p // 2))


def blur(x: torch.Tensor, kernel=(1, 3, 3, 1), pad=(2, 1),
         upsample_factor: int = 1) -> torch.Tensor:
    k = make_kernel(kernel)
    if upsample_factor > 1:
        k = k * (upsample_factor ** 2)
    return upfirdn2d(x, k, pad=pad)


def fused_leaky_relu(x: torch.Tensor, bias: torch.Tensor,
                     negative_slope: float = 0.2,
                     scale: float = 2 ** 0.5) -> torch.Tensor:
    """bias over the channel axis 1, LeakyReLU, then the sqrt(2) gain."""
    y = x + bias.reshape((1, -1) + (1,) * (x.ndim - 2))
    return F.leaky_relu(y, negative_slope) * scale
