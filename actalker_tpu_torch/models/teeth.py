"""Teeth-region enhancement network, twin of ``actalker_tpu/models/teeth.py``
(the reference's ``src/utils/enhance_teeth/enhance_teeth_pnnx.py``, a
PNNX-exported BatchNorm / ReLU autoencoder on a 512 x 512 mouth crop):
a conv stem; six encoder stages (an asymmetric-pad stride-2 conv, then a
resblock; channels 32-32-64-128-256-512-512, attention at the bottom); a
res-attn-res middle on both sides of the latent conv; six decoder stages
(nearest 2x, conv, resblock; attention at the top); a BN-conv-tanh head
giving RGB and an alpha matte mapped to [0, 1].

Keyed as the export's flat attributes, which ``io/jax_export.py::
convert_teeth`` reads: ``encoder_conv_in``, ``encoder_blocks_K_J_*``,
``convbn2d_N`` (the resblocks' first convs, BatchNorm folded by PNNX),
``*_mid_blocks_*``, ``encoder_conv_out_{0,2}``, ``decoder_conv_out4_{0,1}``.
The standalone BatchNorms are inference-only affines (eps 1e-5).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import FrozenBatchNorm

ENC_CH = (32, 64, 128, 256, 512, 512)
DEC_CH = (512, 512, 256, 128, 64, 32)


def bicubic_512(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 512, 512): Keys cubic (a = -0.5) with
    antialiasing when shrinking, as ``jax.image.resize(method="cubic")``."""
    return F.interpolate(x, size=(512, 512), mode="bicubic", align_corners=False,
                         antialias=True)


class TeethEnhancer(nn.Module):
    """(N, H, W, 3) in [-1, 1] -> (rgb (N, 512, 512, 3) in [-1, 1], alpha
    (N, 512, 512, 1) in [0, 1]). ``resize_input=False`` skips the bicubic
    resize to 512 (small inputs in tests)."""

    def __init__(self, resize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.encoder_conv_in = nn.Conv2d(3, ENC_CH[0], 3, padding=1)
        # (name, norm1, convbn index, conv2, residual) of every resblock
        self._res = {}
        cin = ENC_CH[0]
        for i, ch in enumerate(ENC_CH):
            if i > 0:
                self._conv(f"encoder_blocks_{i}_0_conv", cin, cin, stride=2, pad=0)
            j = 1 if i > 0 else 0
            self._resblock(f"encoder_res_{i}", f"encoder_blocks_{i}_{j}_norm1", i,
                           f"encoder_blocks_{i}_{j}_conv2",
                           f"encoder_blocks_{i}_1_residual_func"
                           if 0 < i < 5 else None, cin, ch)
            cin = ch
        self._attn("encoder_blocks_5_2", 512)
        self._resblock("encoder_mid_res1", "encoder_mid_blocks_0_norm1", 6,
                       "encoder_mid_blocks_0_conv2", None, 512, 512)
        self._attn("encoder_mid_blocks_1", 512)
        self._resblock("encoder_mid_res2", "encoder_mid_blocks_2_norm1", 7,
                       "encoder_mid_blocks_2_conv2", None, 512, 512)
        self.encoder_conv_out_0 = FrozenBatchNorm(512)
        self._conv("encoder_conv_out_2", 512, 512)
        self._conv("decoder_conv_in", 512, 512)
        self._resblock("decoder_mid_res1", "decoder_mid_blocks_0_norm1", 8,
                       "decoder_mid_blocks_0_conv2", None, 512, 512)
        self._attn("decoder_mid_blocks_1", 512)
        self._resblock("decoder_mid_res2", "decoder_mid_blocks_2_norm1", 9,
                       "decoder_mid_blocks_2_conv2", None, 512, 512)
        cin = 512
        for i, ch in enumerate(DEC_CH):
            if i > 0:
                self._conv(f"decoder_blocks_{i}_0_conv", cin, cin)
            j = 1 if i > 0 else 0
            self._resblock(f"decoder_res_{i}", f"decoder_blocks_{i}_{j}_norm1", 10 + i,
                           f"decoder_blocks_{i}_{j}_conv2",
                           f"decoder_blocks_{i}_1_residual_func" if i > 1 else None,
                           cin, ch)
            cin = ch
        self._attn("decoder_blocks_0_1", 512)
        self.decoder_conv_out4_0 = FrozenBatchNorm(DEC_CH[-1])
        self._conv("decoder_conv_out4_1", DEC_CH[-1], 4)

    def _conv(self, name, cin, cout, k=3, stride=1, pad=1):
        setattr(self, name, nn.Conv2d(cin, cout, k, stride, pad))

    def _resblock(self, name, norm1, convbn, conv2, residual, cin, cout):
        setattr(self, norm1, FrozenBatchNorm(cin))
        self._conv(f"convbn2d_{convbn}", cin, cout)
        self._conv(conv2, cout, cout)
        if residual is not None:
            self._conv(residual, cin, cout, k=1, pad=0)
        self._res[name] = (norm1, f"convbn2d_{convbn}", conv2, residual)

    def _attn(self, src, c):
        setattr(self, f"{src}_norm", FrozenBatchNorm(c))
        for nm in ("q", "k", "v", "proj_out"):
            self._conv(f"{src}_{nm}", c, c, k=1, pad=0)

    def res(self, name, x):
        """norm1 -> relu -> conv1 -> relu -> conv2, plus the input (through
        a 1x1 conv where the width changes)."""
        norm1, conv1, conv2, residual = (getattr(self, n) if n else None
                                         for n in self._res[name])
        h = conv2(F.relu(conv1(F.relu(norm1(x)))))
        return (x if residual is None else residual(x)) + h

    def attn(self, src, x):
        """Single-head attention over the H * W positions, 1x1 projections,
        softmax scale 1 / sqrt(C)."""
        n, c, h, w = x.shape
        y = getattr(self, f"{src}_norm")(x)
        q, k, v = (getattr(self, f"{src}_{nm}")(y).flatten(2).transpose(1, 2)
                   for nm in ("q", "k", "v"))
        wts = torch.softmax(q @ k.transpose(1, 2) / c ** 0.5, -1)
        o = (wts @ v).transpose(1, 2).reshape(n, c, h, w)
        return x + getattr(self, f"{src}_proj_out")(o)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)
        if self.resize_input:
            x = bicubic_512(x)
        h = self.encoder_conv_in(x)
        for i in range(len(ENC_CH)):
            if i > 0:
                h = getattr(self, f"encoder_blocks_{i}_0_conv")(F.pad(h, (0, 1, 0, 1)))
            h = self.res(f"encoder_res_{i}", h)
        h = self.attn("encoder_blocks_5_2", h)
        h = self.res("encoder_mid_res1", h)
        h = self.attn("encoder_mid_blocks_1", h)
        h = self.res("encoder_mid_res2", h)
        h = self.encoder_conv_out_2(F.relu(self.encoder_conv_out_0(h)))
        h = self.decoder_conv_in(h)
        h = self.res("decoder_mid_res1", h)
        h = self.attn("decoder_mid_blocks_1", h)
        h = self.res("decoder_mid_res2", h)
        for i in range(len(DEC_CH)):
            if i > 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"decoder_blocks_{i}_0_conv")(h)
            h = self.res(f"decoder_res_{i}", h)
            if i == 0:
                h = self.attn("decoder_blocks_0_1", h)
        h = torch.tanh(self.decoder_conv_out4_1(self.decoder_conv_out4_0(h)))
        h = h.permute(0, 2, 3, 1)
        return h[..., :3], (h[..., 3:4] + 1.0) / 2.0
