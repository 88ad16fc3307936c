"""The plain fp32 reference of the ACTalker UNet: SVD-XT's spatio-temporal
conditional UNet with the parallel Mamba control blocks (SS2DCondV10) and
the two IP-adapter branches (audio, expression).

Written from the published description (diffusers' SVD UNet and the
ACTalker control blocks), in plain PyTorch ops (``reference/ops.py``),
float32 throughout. Parameter names are diffusers', so one state dict
loads into this module and into the system under test. Departures from a
literal transcription, none of which changes the function:

* the control block scans each branch's selected tokens (those whose
  bicubic-downsampled region mask reaches 1) followed by the identity and
  control tokens, in both directions, the reference's masked-select
  formulation; rows of the batch share their identity's mask;
* attention and the scan run in blocks of rows (``ops.BLOCK_BYTES``).

Video tensors are (B, F, H, W, C); conditioning is a ``Cond`` bundle.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import ops


@dataclasses.dataclass
class UNetSizes:
    """The published widths (SVD-XT 1.1 ``unet/config.json`` and the
    ACTalker control blocks)."""

    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    d_state: int = 16
    ssm_expand: int = 2
    # levels whose down / up blocks carry cross-attention (and the SSM);
    # the last level's are plain resnet blocks
    cross_attn_levels: int = 3
    gradient_checkpointing: bool = False


@dataclasses.dataclass
class Cond:
    """All conditioning of one UNet call (BF = batch * frames): id_tokens
    (BF, 1, d); audio_tokens (BF, 32, d); vasa_tokens (BF, 1, d); region
    masks (Bm, 1, H, W) or None, Bm dividing the batch."""

    id_tokens: torch.Tensor
    audio_tokens: torch.Tensor
    vasa_tokens: torch.Tensor
    audio_mask: Optional[torch.Tensor] = None
    exp_mask: Optional[torch.Tensor] = None
    ip_scales: Tuple[float, float] = (1.25, 1.25)

    def pooled(self, frames: int) -> "Cond":
        """Frame-mean tokens for the temporal blocks."""
        def pool(t):
            bf, s, c = t.shape
            return t.reshape(bf // frames, frames, s, c).mean(dim=1)

        return dataclasses.replace(self, id_tokens=pool(self.id_tokens),
                                   audio_tokens=pool(self.audio_tokens),
                                   vasa_tokens=pool(self.vasa_tokens))


# ------------------------------------------------------------- layers

class Linear(nn.Linear):
    def forward(self, x):
        return ops.linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    """NHWC in and out."""

    def forward(self, x):
        return ops.conv2d_nhwc(x, self.weight, self.bias, self.stride, self.padding)


class TemporalConv(nn.Conv3d):
    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x):
        return ops.temporal_conv(x, self.weight, self.bias)


class GroupNorm32(nn.Module):
    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = min(groups, channels), eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return ops.group_norm(x, self.weight, self.bias, self.groups, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return ops.layer_norm(x, self.weight, self.bias, self.eps)


def sinusoidal(t: torch.Tensor, dim: int) -> torch.Tensor:
    """(N,) -> (N, dim): [cos, sin] of t * 10000^(-i / (dim / 2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    arg = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int, cout: Optional[int] = None):
        super().__init__()
        self.linear_1 = Linear(cin, dim)
        self.linear_2 = Linear(dim, cout or dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class AlphaBlender(nn.Module):
    """a * spatial + (1 - a) * temporal, a = sigmoid(mix_factor), or 1
    where ``image_only_indicator`` is set."""

    def __init__(self, alpha: float = 0.5):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor([alpha]))

    def forward(self, xs, xt, image_only):
        a = torch.where(image_only.bool(), torch.ones((), device=xs.device),
                        torch.sigmoid(self.mix_factor)[..., None])
        a = a.reshape(-1, 1, 1) if xs.ndim == 3 else a[:, :, None, None, None]
        return a * xs + (1.0 - a) * xt


def downsample_mask(mask: torch.Tensor, num_queries: int) -> torch.Tensor:
    """(B, 1, H, W) -> (B, num_queries, 1), as diffusers'
    ``IPAdapterMaskProcessor.downsample``: a bicubic resize (align_corners
    False) to a grid chosen from the query count and the aspect ratio,
    flattened, then zero-padded or cut to ``num_queries``."""
    b, _, h, w = mask.shape
    mh = int(math.sqrt(num_queries / (w / h)))
    mh += int(num_queries % mh != 0)
    mw = num_queries // mh
    m = F.interpolate(mask.float(), size=(mh, mw), mode="bicubic",
                      align_corners=False).reshape(b, mh * mw)
    if mh * mw < num_queries:
        m = F.pad(m, (0, num_queries - mh * mw))
    return m[:, :num_queries, None]


def rows_of(m: torch.Tensor, batch: int) -> torch.Tensor:
    """A per-sample tensor (leading axis Bm) repeated to ``batch`` rows."""
    return m if m.shape[0] == batch else m.repeat_interleave(batch // m.shape[0], 0)


# ---------------------------------------------------------- attention

class _IPProcessor(nn.Module):
    def __init__(self, ctx: int, inner: int, n: int):
        super().__init__()
        self.to_k_ip = nn.ModuleList([Linear(ctx, inner, bias=False) for _ in range(n)])
        self.to_v_ip = nn.ModuleList([Linear(ctx, inner, bias=False) for _ in range(n)])


class Attention(nn.Module):
    """Self-attention (no context) or cross-attention over ``context``
    plus one scaled, optionally region-masked branch per IP adapter."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None,
                 adapters: int = 0):
        super().__init__()
        self.heads, self.adapters = heads, adapters
        kv = context_dim or dim
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(kv, dim, bias=False)
        self.to_v = Linear(kv, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])
        if adapters:
            self.processor = _IPProcessor(kv, dim, adapters)

    def _attend(self, q, k, v):
        b, bk = q.shape[0], k.shape[0]
        if bk == b:
            return ops.attention(q, k, v, self.heads)
        s = q.shape[1]
        out = ops.attention(q.reshape(bk, (b // bk) * s, -1), k, v, self.heads)
        return out.reshape(b, s, -1)

    def forward(self, x, context=None, ip_contexts=None, ip_scales=None,
                ip_masks=None):
        b, s, _ = x.shape
        ctx = x if context is None else context
        q = self.to_q(x)
        out = self._attend(q, self.to_k(ctx), self.to_v(ctx))
        for i in range(self.adapters):
            ip = ip_contexts[i]
            o = self._attend(q, self.processor.to_k_ip[i](ip),
                             self.processor.to_v_ip[i](ip))
            if ip_masks is not None and ip_masks[i] is not None:
                o = o * rows_of(downsample_mask(ip_masks[i], s), b)
            out = out + o * ip_scales[i]
        return self.to_out[0](out)


class _GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    """GEGLU: (h * gelu(gate)) @ W2, [h | gate] = x @ W1."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_GEGLU(dim, 4 * dim), nn.Identity(),
                                  Linear(4 * dim, dim)])

    def forward(self, x):
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * ops.gelu_erf(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int, adapters: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim, adapters)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, ip_contexts, ip_scales, ip_masks):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, ip_contexts, ip_scales, ip_masks)
        return x + self.ff(self.norm3(x))


class _FrameSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(dim, dim, bias=False)
        self.to_v = Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim)])

    def forward(self, x, frames: int):
        return self.to_out[0](ops.frame_attention(
            self.to_q(x), self.to_k(x), self.to_v(x), frames, self.heads))


class TemporalBasicTransformerBlock(nn.Module):
    """Attention across frames; the cross-attention folds the frames into
    the queries over the frame-pooled context, its IP branches unmasked."""

    def __init__(self, dim: int, heads: int, context_dim: int, adapters: int):
        super().__init__()
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm(dim)
        self.attn1 = _FrameSelfAttention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim, adapters)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, frames: int, context, ip_contexts, ip_scales):
        bf, s, c = x.shape
        h = self.ff_in(self.norm_in(x)) + x
        h = h + self.attn1(self.norm1(h), frames)
        h = h + self.attn2(self.norm2(h).reshape(bf // frames, frames * s, c),
                           context, ip_contexts, ip_scales).reshape(bf, s, c)
        return h + self.ff(self.norm3(h))


# --------------------------------------------------------- the SSM block

class SS2DUnit(nn.Module):
    """Parameters of one branch's two-direction scan."""

    def __init__(self, d_inner: int, d_state: int, rank: int, directions: int = 2):
        super().__init__()
        k, d, n = directions, d_inner, d_state
        self.x_proj_weight = nn.Parameter(torch.zeros(k, rank + 2 * n, d))
        self.dt_projs_weight = nn.Parameter(torch.zeros(k, d, rank))
        self.dt_projs_bias = nn.Parameter(torch.zeros(k, d))
        self.A_logs = nn.Parameter(torch.zeros(k * d, n))
        self.Ds = nn.Parameter(torch.ones(k * d))


def selected_tokens(mask: Optional[torch.Tensor], rows: int, l: int,
                    device) -> torch.Tensor:
    """(rows, L) bool: the tokens whose bicubic-downsampled mask value
    reaches 1 (every token without a mask)."""
    if mask is None:
        return torch.ones(rows, l, dtype=torch.bool, device=device)
    return rows_of(downsample_mask(mask, l)[..., 0] >= 1.0 - 1e-6, rows)


class SS2DCondV10(nn.Module):
    """Per branch (audio, expression): project the tokens with in_proj;
    scan the selected ones, followed by the branch's identity and control
    tokens, in both directions; keep the two directions' sum at the
    selected tokens and the projection elsewhere. The branches are summed,
    then LayerNorm and out_proj."""

    def __init__(self, d_model: int, d_cond: int, d_state: int, expand: int):
        super().__init__()
        di = expand * d_model
        self.d_inner, self.d_state = di, d_state
        self.rank = math.ceil(d_model / 16)
        self.id_proj = Linear(d_cond, di, bias=False)
        for name, proj, unit in (("1", "audio_proj", "audio_unit"),
                                 ("2", "exp_proj", "exp_unit")):
            setattr(self, f"in_proj{name}", Linear(d_model, di, bias=False))
            setattr(self, proj, Linear(d_cond, di, bias=False))
            setattr(self, unit, SS2DUnit(di, d_state, self.rank))
        self.out_norm = LayerNorm(di)
        self.out_proj = Linear(di, d_model, bias=False)

    def _branch(self, x, in_proj, tail, sel, unit):
        b, l, _ = x.shape
        di, n, r = self.d_inner, self.d_state, self.rank
        xz = in_proj(x)                                        # (B, L, di)
        count = sel.sum(dim=1)
        k = int(count.max())
        if k == 0:
            return xz
        # selected tokens first, in token order, then the rest
        order = torch.argsort((~sel).to(torch.int8), dim=1, stable=True)[:, :k]
        active = torch.arange(k, device=x.device)[None] < count[:, None]
        u = torch.cat([torch.gather(xz, 1, order[..., None].expand(b, k, di)),
                       tail], dim=1)
        live = torch.cat([active, torch.ones(b, tail.shape[1], dtype=torch.bool,
                                             device=x.device)], dim=1)
        y = 0.0
        for d in range(2):
            x_dbl = ops.linear(u, unit.x_proj_weight[d])
            dt = ops.linear(x_dbl[..., :r], unit.dt_projs_weight[d])
            delta = F.softplus(dt + unit.dt_projs_bias[d]) * live[..., None]
            A = -torch.exp(unit.A_logs[d * di:(d + 1) * di])
            y = y + ops.selective_scan(u, delta, A, x_dbl[..., r:r + n],
                                       x_dbl[..., r + n:r + 2 * n],
                                       unit.Ds[d * di:(d + 1) * di], reverse=d == 1)
        y = torch.where(active[..., None], y[:, :k], torch.gather(
            xz, 1, order[..., None].expand(b, k, di)))
        return xz.scatter(1, order[..., None].expand(b, k, di), y)

    def forward(self, x, id_emb, audio, vasa, audio_mask, exp_mask):
        b, l, _ = x.shape
        id_tok = F.silu(self.id_proj(id_emb))
        y = 0.0
        for name, proj, cond, mask, unit in (
                ("1", "audio_proj", audio, audio_mask, "audio_unit"),
                ("2", "exp_proj", vasa, exp_mask, "exp_unit")):
            tail = torch.cat([id_tok, F.silu(getattr(self, proj)(cond))], dim=1)
            sel = selected_tokens(mask, b, l, x.device)
            y = y + self._branch(x, getattr(self, f"in_proj{name}"), tail, sel,
                                 getattr(self, unit))
        return self.out_proj(self.out_norm(y))


class TransformerSpatioTemporal(nn.Module):
    def __init__(self, dim: int, heads: int, sizes: UNetSizes, mamba: bool):
        super().__init__()
        ctx = sizes.cross_attention_dim
        self.norm = GroupNorm32(dim, eps=1e-6)
        self.proj_in = Linear(dim, dim)
        self.time_pos_embed = TimestepEmbedding(dim, 4 * dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, heads, ctx, 2)])
        self.mamba_blocks = nn.ModuleList([SS2DCondV10(
            dim, ctx, sizes.d_state, sizes.ssm_expand)]) if mamba else None
        self.temporal_transformer_blocks = nn.ModuleList(
            [TemporalBasicTransformerBlock(dim, heads, ctx, 2)])
        self.time_mixer = AlphaBlender()
        self.proj_out = Linear(dim, dim)

    def forward(self, x, cond: Cond, image_only):
        b, f, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x.reshape(b * f, hh * ww, c)))
        emb = self.time_pos_embed(sinusoidal(
            torch.arange(f, device=x.device), c).repeat(b, 1))[:, None]
        pooled = cond.pooled(f)
        toks = [cond.audio_tokens, cond.vasa_tokens]
        h = self.transformer_blocks[0](h, cond.id_tokens, toks, cond.ip_scales,
                                       [cond.audio_mask, cond.exp_mask])
        if self.mamba_blocks is not None:
            h = self.mamba_blocks[0](h, cond.id_tokens, cond.audio_tokens,
                                     cond.vasa_tokens, cond.audio_mask, cond.exp_mask)
        mix = self.temporal_transformer_blocks[0](
            h + emb, f, pooled.id_tokens, [pooled.audio_tokens, pooled.vasa_tokens],
            cond.ip_scales)
        h = self.time_mixer(h, mix, image_only)
        return self.proj_out(h).reshape(b, f, hh, ww, c) + x


# ------------------------------------------------------------ resnets

class ResnetBlock2D(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, eps: float):
        super().__init__()
        self.norm1 = GroupNorm32(cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(temb, cout)
        self.norm2 = GroupNorm32(cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + (x if self.conv_shortcut is None else self.conv_shortcut(x))


class TemporalResnetBlock(nn.Module):
    def __init__(self, c: int, temb: int, eps: float):
        super().__init__()
        self.norm1 = GroupNorm32(c, eps=eps)
        self.conv1 = TemporalConv(c, c)
        self.time_emb_proj = Linear(temb, c)
        self.norm2 = GroupNorm32(c, eps=eps)
        self.conv2 = TemporalConv(c, c)

    def forward(self, x, temb):
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None, :]
        return self.conv2(F.silu(self.norm2(h))) + x


class SpatioTemporalResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb: int, eps: float):
        super().__init__()
        self.spatial_res_block = ResnetBlock2D(cin, cout, temb, eps)
        self.temporal_res_block = TemporalResnetBlock(cout, temb, eps)
        self.time_mixer = AlphaBlender()

    def forward(self, x, temb, image_only):
        b, f, hh, ww, c = x.shape
        xs = self.spatial_res_block(x.reshape(b * f, hh, ww, c), temb)
        xs = xs.reshape(b, f, hh, ww, -1)
        xt = self.temporal_res_block(xs, temb.reshape(b, f, -1))
        return self.time_mixer(xs, xt, image_only)


class _Resample(nn.Module):
    def __init__(self, c: int, stride: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=stride, padding=1)


def _frames(x, fn):
    b, f = x.shape[:2]
    y = fn(x.reshape(b * f, *x.shape[2:]))
    return y.reshape(b, f, *y.shape[1:])


def downsample(m, x):
    return _frames(x, m.conv)


def upsample(m, x):
    return _frames(x, lambda t: m.conv(
        t.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)))


# ------------------------------------------------------------- blocks

def layer(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` under autograd, recomputed in the
    backward (one checkpoint scope a resnet or transformer: the fp32
    activations of a whole block do not fit beside the optimizer state)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class DownBlock(nn.Module):
    def __init__(self, cin, cout, temb, sizes: UNetSizes, heads, cross, last):
        super().__init__()
        n = sizes.layers_per_block
        eps = 1e-6 if cross else 1e-5
        self.resnets = nn.ModuleList([SpatioTemporalResBlock(
            cin if i == 0 else cout, cout, temb, eps) for i in range(n)])
        if cross:
            self.attentions = nn.ModuleList([TransformerSpatioTemporal(
                cout, heads, sizes, True) for _ in range(n)])
        self.cross, self.remat = cross, sizes.gradient_checkpointing
        self.downsamplers = None if last else nn.ModuleList([_Resample(cout, 2)])

    def forward(self, x, temb, cond, image_only):
        states = []
        for i, resnet in enumerate(self.resnets):
            x = layer(self.remat, resnet, x, temb, image_only)
            if self.cross:
                x = layer(self.remat, self.attentions[i], x, cond, image_only)
            states.append(x)
        if self.downsamplers is not None:
            x = downsample(self.downsamplers[0], x)
            states.append(x)
        return x, states


class MidBlock(nn.Module):
    def __init__(self, c, temb, sizes: UNetSizes, heads):
        super().__init__()
        self.resnets = nn.ModuleList([SpatioTemporalResBlock(c, c, temb, 1e-5)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([TransformerSpatioTemporal(
            c, heads, sizes, False)])
        self.remat = sizes.gradient_checkpointing

    def forward(self, x, temb, cond, image_only):
        x = layer(self.remat, self.resnets[0], x, temb, image_only)
        x = layer(self.remat, self.attentions[0], x, cond, image_only)
        return layer(self.remat, self.resnets[1], x, temb, image_only)


class UpBlock(nn.Module):
    def __init__(self, cin, skips: Sequence[int], cout, temb, sizes, heads,
                 cross, last):
        super().__init__()
        ins = [cin] + [cout] * (len(skips) - 1)
        self.resnets = nn.ModuleList([SpatioTemporalResBlock(
            i + s, cout, temb, 1e-5) for i, s in zip(ins, skips)])
        if cross:
            self.attentions = nn.ModuleList([TransformerSpatioTemporal(
                cout, heads, sizes, True) for _ in skips])
        self.cross, self.remat = cross, sizes.gradient_checkpointing
        self.upsamplers = None if last else nn.ModuleList([_Resample(cout, 1)])

    def forward(self, x, skips: List, temb, cond, image_only):
        for i, resnet in enumerate(self.resnets):
            x = layer(self.remat, resnet, torch.cat([x, skips.pop()], dim=-1), temb,
                      image_only)
            if self.cross:
                x = layer(self.remat, self.attentions[i], x, cond, image_only)
        if self.upsamplers is not None:
            x = upsample(self.upsamplers[0], x)
        return x


class UNet(nn.Module):
    def __init__(self, sizes: UNetSizes = UNetSizes()):
        super().__init__()
        self.sizes = s = sizes
        boc, heads = s.block_out_channels, s.num_attention_heads
        ch0, temb = boc[0], 4 * boc[0]
        n_lv = len(boc)
        self.conv_in = Conv2d(s.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.add_embedding = TimestepEmbedding(s.projection_class_embeddings_input_dim, temb)
        skips, ch = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for i in range(n_lv):
            last = i == n_lv - 1
            self.down_blocks.append(DownBlock(ch, boc[i], temb, s, heads[i],
                                              i < s.cross_attn_levels, last))
            skips += [boc[i]] * (s.layers_per_block + (0 if last else 1))
            ch = boc[i]
        self.mid_block = MidBlock(ch, temb, s, heads[-1])
        self.up_blocks = nn.ModuleList()
        for i in range(n_lv):
            out, last = boc[n_lv - 1 - i], i == n_lv - 1
            mine = [skips.pop() for _ in range(s.layers_per_block + 1)]
            self.up_blocks.append(UpBlock(ch, mine, out, temb, s, heads[n_lv - 1 - i],
                                          i >= n_lv - s.cross_attn_levels, last))
            ch = out
        self.conv_norm_out = GroupNorm32(ch)
        self.conv_out = Conv2d(ch, s.out_channels, 3, padding=1)

    def forward(self, sample, timestep, cond: Cond, added_time_ids,
                pose_fea: Optional[torch.Tensor] = None):
        """sample (B, F, H, W, 8); timestep scalar or (B,); added_time_ids
        (B, 3); pose_fea (B, F, H, W, 320) -> (B, F, H, W, 4)."""
        s = self.sizes
        b, f, hh, ww, _ = sample.shape
        ts = torch.as_tensor(timestep, device=sample.device).reshape(-1).expand(b)
        ch0 = s.block_out_channels[0]
        emb = self.time_embedding(sinusoidal(ts, ch0))
        add = sinusoidal(added_time_ids.reshape(-1), s.addition_time_embed_dim)
        emb = (emb + self.add_embedding(add.reshape(b, -1))).repeat_interleave(f, 0)
        image_only = torch.zeros(b, f, device=sample.device)
        h = self.conv_in(sample.reshape(b * f, hh, ww, -1)).reshape(b, f, hh, ww, ch0)
        if pose_fea is not None:
            h = h + pose_fea
        states = [h]
        for blk in self.down_blocks:
            h, st = blk(h, emb, cond, image_only)
            states += st
        h = self.mid_block(h, emb, cond, image_only)
        for blk in self.up_blocks:
            n = len(blk.resnets)
            mine = states[-n:]
            del states[-n:]
            h = blk(h, mine, emb, cond, image_only)
        h = self.conv_out(F.silu(self.conv_norm_out(h.reshape(b * f, hh, ww, -1))))
        return h.reshape(b, f, hh, ww, s.out_channels)
