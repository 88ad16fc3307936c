"""VMamba-style spatial SS2D block, the conditional SSM lineage (v5 / v6 /
v9) and the MambaUPNet decoder stack.

Twin of ``actalker_tpu/models/ssm_spatial.py``, NHWC like the rest of the
port. Parity targets in the reference (none is on the production v10 path):
  * ``SS2D`` (``src/models/base/mamba_layer.py:186-420``): K-directional
    selective scan over H x W feature maps -> ``SS2DSpatial``;
  * ``SS2D_cond_v5`` / ``_v6`` / ``_v9`` (``mamba_layer.py:1555-1899``) ->
    ``SS2DCondV5`` / ``SS2DCondV6`` / ``SS2DCondV9``;
  * the ``MambaUPNet`` decoder (``mamba_layer.py:2427-2666``) -> ``HSSBlock``,
    ``LSSModule``, ``PatchExpand2D``, ``LSSLayerUp``, ``MambaUPNet``.

Every recurrence runs through ``SS2DUnit`` (``models/ssm.py``) and so
through K5, one launch per direction (K6 in the gradient). Scan directions
are host-computed composite permutation tables (base spatial transform o
scan order), each applied as one ``index_select`` with the table on the
device. Plain convs, linears and norms stay cuDNN / cuBLAS / plain PyTorch,
as the JAX package runs them outside Pallas. Module and parameter names
follow the JAX parameter tree, so ``io/jax_export.export_lineage`` maps it
mechanically.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.attention_blocks import (
    downsample_ip_mask, expand_mask_rows)
from actalker_tpu_torch.models.common import Conv2d, LayerNormF32, Linear
from actalker_tpu_torch.models.ssm import SS2DUnit, scan_one_direction
from actalker_tpu_torch.ops.scan_orders import inverse_table, order_table


def direction_perms(h: int, w: int, num_direction: int,
                    scan_type: str = "scan") -> list[np.ndarray]:
    """Composite permutations for the K // 2 base scan directions.

    Each entry p satisfies seq[j] = tokens_flat[p[j]] where tokens_flat is
    the row-major (H * W) flattening: base 0 row-major, base 1 (K >= 4) the
    transpose (column-major), base 2 (K >= 8) rot90, base 3 (K >= 8) the
    transpose of rot90. The other K // 2 directions are the same
    traversals reversed, run as reverse scans (no tables)."""
    if num_direction not in (2, 4, 8):
        raise ValueError(f"num_direction {num_direction}: 2, 4 or 8")
    if num_direction >= 4 and h != w:
        raise ValueError("K >= 4 directional scans assume a square grid")
    p = order_table(scan_type, h, w)
    perms = [p]
    if num_direction >= 4:
        # transposed grid position i = (x * H + y) holds row-major token y * W + x
        i = np.arange(h * w)
        perms.append(((i % h) * w + i // h)[p])
    if num_direction >= 8:
        # torch.rot90(x, 1, (H, W)): out[i, j] = in[j, W - 1 - i], out is (W, H)
        i = np.arange(w * h)
        perms.append(((i % h) * w + (w - 1 - i // h))[p])
        # transpose of the rotation: out[a, b] = in[a, W - 1 - b]
        a = np.arange(h * w)
        perms.append(((a // w) * w + (w - 1 - a % w))[p])
    return perms


class DirectionalScanParams(SS2DUnit):
    """The per-direction scan parameters of ``SS2DSpatial``: ``SS2DUnit``'s
    recipe and names (``mamba_layer.py:245-297``), scanned one direction of
    an already ordered sequence at a time."""

    def scan_direction(self, seq, k: int, reverse: bool) -> torch.Tensor:
        """Direction k's projections and scan on (B, L, d), in seq's dtype."""
        d, n, rank = self.d_inner, self.d_state, self.rank
        x_dbl = F.linear(seq, self.x_proj_weight[k].to(seq.dtype))
        delta = F.linear(x_dbl[..., :rank], self.dt_projs_weight[k].to(seq.dtype))
        A = -torch.exp(self.A_logs[k * d:(k + 1) * d].float())
        return scan_one_direction(
            seq, delta, A, x_dbl[..., rank:rank + n], x_dbl[..., rank + n:],
            self.Ds[k * d:(k + 1) * d], self.dt_projs_bias[k], reverse, seq.dtype)


class SS2DSpatial(nn.Module):
    """K-directional selective scan over (B, H, W, C) feature maps: in_proj,
    depthwise 3x3 conv + SiLU, K directional scans in fp32 (the reference's
    ``forward_core`` upcasts), LayerNorm, the silu(z) gate, out_proj."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 3,
                 expand: int = 2, num_direction: int = 4,
                 scan_type: str = "scan"):
        super().__init__()
        d_inner = expand * d_model
        self.d_inner, self.num_direction, self.scan_type = (
            d_inner, num_direction, scan_type)
        self.in_proj = Linear(d_model, 2 * d_inner, bias=False)
        self.conv2d = Conv2d(d_inner, d_inner, d_conv, padding=d_conv // 2,
                             groups=d_inner)
        self.scans = DirectionalScanParams(
            d_inner, d_state, math.ceil(d_model / 16), num_direction)
        self.out_norm = LayerNormF32(d_inner)
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def forward(self, x):
        b, h, w, _ = x.shape
        k_total, half = self.num_direction, self.num_direction // 2
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        xs = F.silu(self.conv2d(xs))
        tokens = xs.reshape(b, h * w, self.d_inner).float()
        perms = direction_perms(h, w, k_total, self.scan_type)
        fwd = [torch.from_numpy(p).to(x.device) for p in perms]
        inv = [torch.from_numpy(inverse_table(p)).to(x.device) for p in perms]
        y = torch.zeros_like(tokens)
        for k in range(k_total):
            seq = tokens.index_select(1, fwd[k % half])
            yk = self.scans.scan_direction(seq, k, reverse=k >= half)
            y = y + yk.index_select(1, inv[k % half])
        y = self.out_norm(y.reshape(b, h, w, self.d_inner))
        y = y * F.silu(z.to(y.dtype))
        return self.out_proj(y.to(x.dtype))


class SS2DCondV5(nn.Module):
    """``n_ssd_unit`` parallel scan units over [tokens | cond], averaged
    (``mamba_layer.py:1555-1630``)."""

    def __init__(self, d_model: int, d_cond: int = 1024, n_ssd_unit: int = 2,
                 d_state: int = 16, expand: int = 2, num_direction: int = 2):
        super().__init__()
        d_inner, rank = expand * d_model, math.ceil(d_model / 16)
        self.n_ssd_unit = n_ssd_unit
        self.in_proj = Linear(d_model, d_inner, bias=False)
        self.cond_proj = Linear(d_cond, d_inner, bias=False)
        self.fuse_proj = Linear(d_inner, d_inner, bias=False)
        for i in range(n_ssd_unit):
            setattr(self, f"ssd_unit_{i}",
                    SS2DUnit(d_inner, d_state, rank, num_direction))
        self.out_norm = LayerNormF32(d_inner)
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def forward(self, x, cond):
        """x (B, L, C); cond (B or 1, S, d_cond) -> (B, L, C)."""
        b, l, _ = x.shape
        cp = self.cond_proj(cond.to(x.dtype))
        seq = torch.cat([self.in_proj(x), cp.expand(b, -1, -1)], dim=1)
        seq = F.silu(self.fuse_proj(seq))
        y = sum(getattr(self, f"ssd_unit_{i}")(seq)
                for i in range(self.n_ssd_unit)) / self.n_ssd_unit
        return self.out_proj(self.out_norm(y[:, :l]))


class SS2DCondV6(nn.Module):
    """Two-stage scan: an intra-SSM over the tokens, then a cond-SSM over
    [intra | cond] (``mamba_layer.py:1632-1706``)."""

    def __init__(self, d_model: int, d_cond: int = 1024, d_state: int = 16,
                 expand: int = 2, num_direction: int = 2):
        super().__init__()
        d_inner, rank = expand * d_model, math.ceil(d_model / 16)
        self.in_proj = Linear(d_model, d_inner, bias=False)
        self.intra_ssm = SS2DUnit(d_inner, d_state, rank, num_direction)
        self.cond_proj = Linear(d_cond, d_inner, bias=False)
        self.fuse_proj = Linear(d_inner, d_inner, bias=False)
        self.cond_ssm = SS2DUnit(d_inner, d_state, rank, num_direction)
        self.out_norm = LayerNormF32(d_inner)
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def forward(self, x, cond):
        """x (B, L, C); cond (B or 1, S, d_cond) -> (B, L, C)."""
        b, l, _ = x.shape
        xz = self.intra_ssm(self.in_proj(x))
        cp = self.cond_proj(cond.to(x.dtype))
        seq = F.silu(self.fuse_proj(torch.cat([xz, cp.expand(b, -1, -1)], dim=1)))
        return self.out_proj(self.out_norm(self.cond_ssm(seq)[:, :l]))


class SS2DCondV9(nn.Module):
    """Dual-branch conditional scan with a *soft* region-mask multiply and a
    fuse scan (``mamba_layer.py:1802-1899``): each branch scans [tokens |
    identity | cond], its token outputs are multiplied by the bicubic-
    downsampled mask values (not v10's hard select), and the summed branches
    run through a third unit before the output norm."""

    def __init__(self, d_model: int, d_cond: int = 1024, d_state: int = 16,
                 expand: int = 2, num_direction: int = 2):
        super().__init__()
        d_inner, rank = expand * d_model, math.ceil(d_model / 16)
        self.id_proj = Linear(d_cond, d_inner, bias=False)
        for proj in ("in_proj1", "in_proj2"):
            setattr(self, proj, Linear(d_model, d_inner, bias=False))
        for proj in ("audio_proj", "exp_proj"):
            setattr(self, proj, Linear(d_cond, d_inner, bias=False))
        for unit in ("audio_unit", "exp_unit", "fuse_unit"):
            setattr(self, unit, SS2DUnit(d_inner, d_state, rank, num_direction))
        self.out_norm = LayerNormF32(d_inner)
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def forward(self, x, id_emb, audio_cond, exp_cond, audio_mask, exp_mask):
        """x (B, L, C); id_emb (B or 1, 1, d_cond); audio_cond / exp_cond
        (B or 1, S, d_cond); masks (Bm, 1, H, W) or None (all on)."""
        b, l, _ = x.shape
        id_tok = F.silu(self.id_proj(id_emb.to(x.dtype))).expand(b, -1, -1)

        def branch(in_proj, proj, unit, cond, mask):
            ct = F.silu(getattr(self, proj)(cond.to(x.dtype))).expand(b, -1, -1)
            seq = torch.cat([getattr(self, in_proj)(x), id_tok, ct], dim=1)
            y = getattr(self, unit)(seq)[:, :l]
            if mask is not None:
                y = y * expand_mask_rows(downsample_ip_mask(mask, l), b).to(y.dtype)
            return y

        y = (branch("in_proj1", "audio_proj", "audio_unit", audio_cond, audio_mask)
             + branch("in_proj2", "exp_proj", "exp_unit", exp_cond, exp_mask))
        return self.out_proj(self.out_norm(self.fuse_unit(y)))


def _instance_norm(x, eps: float = 1e-5):
    """torch ``nn.InstanceNorm2d`` defaults (affine=False) on NHWC."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class HSSBlock(nn.Module):
    """LayerNorm -> SS2DSpatial with a residual (``mamba_layer.py:2427-2448``;
    DropPath is the identity at inference)."""

    def __init__(self, hidden_dim: int, d_state: int = 16,
                 num_direction: int = 4, scan_type: str = "scan"):
        super().__init__()
        self.ln_1 = LayerNormF32(hidden_dim)
        self.self_attention = SS2DSpatial(hidden_dim, d_state=d_state,
                                          num_direction=num_direction,
                                          scan_type=scan_type)

    def forward(self, x):
        return x + self.self_attention(self.ln_1(x))


class LSSModule(nn.Module):
    """SSM blocks and 7x7 / 5x5 depthwise conv branches fused by a 1x1 conv,
    with a residual (``mamba_layer.py:2450-2526``)."""

    _BRANCHES = ((7, "conv1b7", "conv77", "conv1a7"),
                 (5, "conv1b5", "conv55", "conv1a5"))

    def __init__(self, hidden_dim: int, depth: int = 2, d_state: int = 16,
                 num_direction: int = 4, scan_type: str = "scan"):
        super().__init__()
        d = hidden_dim
        self.depth = depth
        for i in range(depth):
            setattr(self, f"smm_blocks_{i}",
                    HSSBlock(d, d_state, num_direction, scan_type))
        for k, pre, mid, post in self._BRANCHES:
            setattr(self, pre, Conv2d(d, d, 1))
            setattr(self, mid, Conv2d(d, d, k, padding=k // 2, groups=d,
                                      bias=False))
            setattr(self, post, Conv2d(d, d, 1))
        self.finalconv11 = Conv2d(3 * d, d, 1)

    def forward(self, x):
        out_ssm = x
        for i in range(self.depth):
            out_ssm = getattr(self, f"smm_blocks_{i}")(out_ssm)
        outs = {}
        for k, pre, mid, post in self._BRANCHES:
            h = F.silu(_instance_norm(getattr(self, pre)(x)))
            h = F.silu(_instance_norm(getattr(self, mid)(h)))
            outs[k] = F.silu(_instance_norm(getattr(self, post)(h)))
        h = self.finalconv11(torch.cat([out_ssm, outs[5], outs[7]], dim=-1))
        return h + x


class PatchExpand2D(nn.Module):
    """2x spatial upsample and 2x channel reduction by a linear pixel shuffle
    (``mamba_layer.py:57-70``); input channels 2 * dim."""

    def __init__(self, dim: int):
        super().__init__()
        self.expand = Linear(2 * dim, 4 * dim, bias=False)
        self.norm = LayerNormF32(dim)

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.expand(x).reshape(b, h, w, 2, 2, c // 2)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c // 2)
        return self.norm(y)


class LSSLayerUp(nn.Module):
    """Decoder stage: an optional PatchExpand2D, then LSSModules
    (``mamba_layer.py:2528-2610``): depth % 3 == 0 gives depth // 3
    modules of depth 3, else depth // 2 modules of depth 2."""

    def __init__(self, dim: int, depth: int, d_state: int = 16,
                 num_direction: int = 4, scan_type: str = "scan",
                 upsample: bool = False):
        super().__init__()
        inner = 3 if depth % 3 == 0 else 2
        self.n_blocks = depth // inner
        self.upsample = PatchExpand2D(dim) if upsample else None
        for i in range(self.n_blocks):
            setattr(self, f"blocks_{i}",
                    LSSModule(dim, inner, d_state, num_direction, scan_type))

    def forward(self, x):
        if self.upsample is not None:
            x = self.upsample(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"blocks_{i}")(x)
        return x


class MambaUPNet(nn.Module):
    """VM-UNet-style four-stage decoder (``mamba_layer.py:2612-2666``): NHWC
    input at the deepest resolution; returns the upsampled stage outputs,
    shallowest first (NHWC, where the reference returns NCHW)."""

    def __init__(self, dims_decoder: Sequence[int] = (512, 256, 128, 64),
                 depths_decoder: Sequence[int] = (3, 4, 6, 3),
                 d_state: int = 16, num_direction: int = 4,
                 scan_type: str = "scan"):
        super().__init__()
        self.n_stages = len(dims_decoder)
        for i, (dim, depth) in enumerate(zip(dims_decoder, depths_decoder)):
            setattr(self, f"layers_up_{i}",
                    LSSLayerUp(dim, depth, d_state, num_direction, scan_type,
                               upsample=i != 0))

    def forward(self, x) -> list:
        outs = []
        for i in range(self.n_stages):
            x = getattr(self, f"layers_up_{i}")(x)
            if i != 0:
                outs.insert(0, x)
        return outs
