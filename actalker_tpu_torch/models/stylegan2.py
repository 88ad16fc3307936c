"""StyleGAN2 / GPEN generator for blind face restoration (BFR), twin of
``actalker_tpu/models/stylegan2.py`` (the reference's
``src/utils/enhance/model_enhance.py``, FullGenerator_paper): a conv
encoder pyramid whose per-scale features are concatenated onto the
synthesis network's activations (GPEN's ``isconcat``), EqualConv /
EqualLinear with lr-mul weight scaling, ModulatedConv2d with
demodulation, FIR blur resampling (``ops/upfirdn2d.py``) and skip ToRGBs.

Keyed as ``enhance-512.pth``: ``ecd0.0.0.weight`` / ``ecd0.0.1.bias``,
``ecd{k}.0.{1,2}``, ``final_linear.0``, ``generator.style.{1..n_mlp}``,
``generator.input.input``, ``generator.conv1`` / ``to_rgb1``,
``generator.convs.{i}`` / ``to_rgbs.{j}``. Modulated conv weights are
(1, out, in, k, k), EqualLinear weights are stored divided by their
lr_mul, and the biases of the encoder's convs and of each StyledConv live
in their fused LeakyReLUs. A ``kernel`` entry of the file (the fixed FIR
filter the reference keeps as a buffer of each Blur / Upsample) is
ignored. Images are NHWC in [-1, 1] at the boundary, NCHW inside.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.ops.upfirdn2d import (
    blur, fused_leaky_relu, upsample2x)

BLUR = (1, 3, 3, 1)


class _FixedFilter(nn.Module):
    """A module whose FIR filter is a constant: the reference stores it as
    a ``kernel`` buffer, which loading drops."""

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "kernel", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class Blur(_FixedFilter):
    def __init__(self, pad, upsample_factor: int = 1):
        super().__init__()
        self.pad, self.upsample_factor = tuple(pad), upsample_factor

    def forward(self, x):
        return blur(x, BLUR, pad=self.pad, upsample_factor=self.upsample_factor)


class Upsample(_FixedFilter):
    def forward(self, x):
        return upsample2x(x, BLUR)


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return fused_leaky_relu(x, self.bias)


class EqualLinear(nn.Module):
    def __init__(self, cin: int, cout: int, bias_init: float = 0.0,
                 lr_mul: float = 1.0, activation: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin) / lr_mul)
        self.bias = nn.Parameter(torch.full((cout,), float(bias_init)))
        self.scale, self.lr_mul, self.activation = cin ** -0.5 * lr_mul, lr_mul, activation

    def forward(self, x):
        y = x @ (self.weight * self.scale).t()
        b = self.bias * self.lr_mul
        return fused_leaky_relu(y, b) if self.activation else y + b


class EqualConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.scale = (cin * k * k) ** -0.5
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return F.conv2d(x, self.weight * self.scale, self.bias,
                        self.stride, self.padding)


class ModulatedConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, style_dim: int,
                 demodulate: bool = True, upsample: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(1, cout, cin, k, k))
        self.modulation = EqualLinear(style_dim, cin, bias_init=1.0)
        self.scale = (cin * k * k) ** -0.5
        self.demodulate, self.upsample = demodulate, upsample
        if upsample:
            # the factor-2 transposed conv's padding, folded into the blur
            p = (len(BLUR) - 2) - (k - 1)
            self.blur = Blur(((p + 1) // 2 + 1, p // 2 + 1), upsample_factor=2)

    def forward(self, x, style):
        n, cin, h, w = x.shape
        s = self.modulation(style)                              # (N, in)
        weight = self.weight[0] * self.scale                    # (out, in, k, k)
        wmod = weight[None] * s[:, None, :, None, None]          # (N, out, in, k, k)
        demod = (torch.rsqrt(wmod.square().sum((2, 3, 4)) + 1e-8)
                 if self.demodulate else None)                   # (N, out)
        if self.upsample:
            # per-sample weights as a grouped transposed conv, batch -> groups
            if demod is not None:
                wmod = wmod * demod[:, :, None, None, None]
            k = weight.shape[-1]
            wg = wmod.transpose(1, 2).reshape(n * cin, -1, k, k)
            y = F.conv_transpose2d(x.reshape(1, n * cin, h, w), wg, stride=2,
                                   groups=n)
            return self.blur(y.reshape(n, -1, *y.shape[2:]))
        # the style scales the inputs and the demodulation the outputs, so
        # one conv with the shared weight computes the per-sample conv
        y = F.conv2d(x * s[:, :, None, None], weight,
                     padding=weight.shape[-1] // 2)
        return y * demod[:, :, None, None] if demod is not None else y


class NoiseInjection(nn.Module):
    """GPEN's noise: the encoder feature is concatenated onto the channels
    (scaled by one learned weight); no random noise is drawn."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, x, noise):
        return torch.cat([x, self.weight * noise], 1)


class StyledConv(nn.Module):
    def __init__(self, cin: int, cout: int, style_dim: int, upsample: bool = False):
        super().__init__()
        self.conv = ModulatedConv2d(cin, cout, 3, style_dim, upsample=upsample)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(2 * cout)

    def forward(self, x, style, noise):
        return self.activate(self.noise(self.conv(x, style), noise))


class ToRGB(nn.Module):
    def __init__(self, cin: int, style_dim: int, upsample: bool = True):
        super().__init__()
        if upsample:
            self.upsample = Upsample()
        self.conv = ModulatedConv2d(cin, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        y = self.conv(x, style) + self.bias
        return y if skip is None else y + self.upsample(skip)


class ConstantInput(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.input = nn.Parameter(torch.randn(1, channels, 4, 4))


class PixelNorm(nn.Module):
    def forward(self, x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + 1e-8)


def channels(channel_multiplier: int = 2) -> dict:
    m = channel_multiplier
    return {4: 512, 8: 512, 16: 512, 32: 512, 64: 256 * m, 128: 128 * m,
            256: 64 * m, 512: 32 * m, 1024: 16 * m}


class _Synthesis(nn.Module):
    """The StyleGAN2 generator (``generator.*``): style MLP, a 4 x 4
    constant, then two StyledConvs and a ToRGB a resolution."""

    def __init__(self, size, style_dim, n_mlp, ch):
        super().__init__()
        self.style = nn.Sequential(PixelNorm(), *(
            EqualLinear(style_dim, style_dim, lr_mul=0.01, activation=True)
            for _ in range(n_mlp)))
        self.input = ConstantInput(ch[4])
        self.conv1 = StyledConv(ch[4], ch[4], style_dim)
        self.to_rgb1 = ToRGB(2 * ch[4], style_dim, upsample=False)
        self.convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        cin = ch[4]
        for i in range(3, int(math.log2(size)) + 1):
            cout = ch[2 ** i]
            self.convs.append(StyledConv(2 * cin, cout, style_dim, upsample=True))
            self.convs.append(StyledConv(2 * cout, cout, style_dim))
            self.to_rgbs.append(ToRGB(2 * cout, style_dim))
            cin = cout


class GPENGenerator(nn.Module):
    """FullGenerator_paper at ``size`` (512: ``enhance-512.pth``): (N, size,
    size, 3) in [-1, 1] -> the restored (N, size, size, 3)."""

    def __init__(self, size: int = 512, style_dim: int = 512, n_mlp: int = 8,
                 channel_multiplier: int = 2):
        super().__init__()
        ch = channels(channel_multiplier)
        log_size = int(math.log2(size))
        self.n_ecd = log_size - 1
        # ecd0: a 1x1 conv; ecdK: blur + 3x3 stride-2 conv; the fused
        # LeakyReLU carries each one's bias
        self.ecd0 = nn.Sequential(nn.Sequential(
            EqualConv2d(3, ch[size], 1, bias=False), FusedLeakyReLU(ch[size])))
        cin = ch[size]
        for idx in range(1, self.n_ecd):
            cout = ch[2 ** (log_size - idx)]
            setattr(self, f"ecd{idx}", nn.Sequential(nn.Sequential(
                Blur((2, 2)), EqualConv2d(cin, cout, 3, stride=2, bias=False),
                FusedLeakyReLU(cout))))
            cin = cout
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 16, style_dim, activation=True))
        self.generator = _Synthesis(size, style_dim, n_mlp, ch)

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        feats = []
        for idx in range(self.n_ecd):
            h = getattr(self, f"ecd{idx}")(h)
            feats.append(h)
        g = self.generator
        style = g.style(self.final_linear(h.flatten(1)))
        feats = feats[::-1]
        y = g.input.input.expand(x.shape[0], -1, -1, -1)
        y = g.conv1(y, style, feats[0])
        rgb = g.to_rgb1(y, style)
        for j, to_rgb in enumerate(g.to_rgbs):
            noise = feats[j + 1]
            y = g.convs[2 * j](y, style, noise)
            y = g.convs[2 * j + 1](y, style, noise)
            rgb = to_rgb(y, style, rgb)
        return rgb.permute(0, 2, 3, 1)


def feathered_box_mask(size: int = 512, margin: int = 26,
                       sigma: float = 24.0) -> np.ndarray:
    """The compositing mask: a rectangle blurred by a separable gaussian
    (the reference's two blurs, ``bfr_enhance.py:18-21``)."""
    m = np.zeros((size, size), np.float32)
    m[margin:size - margin, margin:size - margin] = 1.0
    r = int(3 * sigma)
    xs = np.arange(-r, r + 1)
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    m = np.apply_along_axis(lambda v: np.convolve(v, g, mode="same"), 0, m)
    m = np.apply_along_axis(lambda v: np.convolve(v, g, mode="same"), 1, m)
    return m

