"""Transformer blocks: self/cross attention with IP-adapter branches, GEGLU
feed-forward, and the spatial/temporal basic blocks.

Twin of ``actalker_tpu/models/attention_blocks.py`` on its default
("tokens") path: q/k/v stay in (B, S, H*Dh) token layout, spatial
self-attention runs K2 (``ops.mha.mha_tokens``), the temporal block's
attention across frames runs K3 (``ops.mha.frame_attention_tokens``) in the
(B*F, S, C) layout, and every feed-forward runs K4 (``ops.mlp.geglu_mlp``).
Parameter names follow the reference (diffusers ``Attention`` /
``FeedForward``), so its state dicts load unchanged. Under autograd the
three op wrappers run their ``torch.autograd.Function``s (K2 -> K2-bwd;
K3 and K4 differentiate their plain versions); under ``no_grad`` they
launch the inference kernels alone.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import LayerNormF32, Linear
from actalker_tpu_torch.ops.attention import dot_product_attention
from actalker_tpu_torch.ops.mha import frame_attention_tokens, mha_tokens
from actalker_tpu_torch.ops.mlp import geglu_mlp


def downsample_ip_mask(mask: torch.Tensor, num_queries: int) -> torch.Tensor:
    """(B, 1, H, W) -> (B, num_queries, 1) multiplier, as diffusers'
    ``IPAdapterMaskProcessor.downsample``: bicubic resize (a = -0.75,
    align_corners=False) to a grid chosen from the query count and the mask
    aspect ratio, flatten, then zero-pad / truncate to ``num_queries``."""
    b, _, o_h, o_w = mask.shape
    ratio = o_w / o_h
    mask_h = int(math.sqrt(num_queries / ratio))
    mask_h = mask_h + int((num_queries % mask_h) != 0)
    mask_w = num_queries // mask_h
    m = F.interpolate(mask.float(), size=(mask_h, mask_w), mode="bicubic",
                      align_corners=False).reshape(b, mask_h * mask_w)
    if mask_h * mask_w < num_queries:
        m = F.pad(m, (0, num_queries - mask_h * mask_w))
    elif mask_h * mask_w > num_queries:
        m = m[:, :num_queries]
    return m[:, :, None]


def expand_mask_rows(m: torch.Tensor, batch: int) -> torch.Tensor:
    """Expand a per-sample mask (leading axis Bm) to the token batch: Bm == 1
    broadcasts, Bm > 1 repeats each sample row ``batch // Bm`` times."""
    bm = m.shape[0]
    if bm == batch:
        return m
    if bm == 1:
        return m.expand((batch,) + tuple(m.shape[1:]))
    if batch % bm:
        raise ValueError(f"batch {batch} not a multiple of mask rows {bm}")
    return m.repeat_interleave(batch // bm, dim=0)


class _IPProcessor(nn.Module):
    """Holder of the per-adapter key/value projections, named as the
    reference's ``IPAdapterAttnProcessor2_0`` (``processor.to_k_ip.{i}``)."""

    def __init__(self, context_dim: int, inner: int, num_adapters: int):
        super().__init__()
        self.to_k_ip = nn.ModuleList(
            [Linear(context_dim, inner, bias=False) for _ in range(num_adapters)])
        self.to_v_ip = nn.ModuleList(
            [Linear(context_dim, inner, bias=False) for _ in range(num_adapters)])


class Attention(nn.Module):
    """Multi-head attention with optional IP-adapter branches.

    Self-attention (no context, no adapters) runs K2 in token layout. Cross
    attention attends over ``context`` plus one branch per adapter
    (``ip_contexts``), each scaled and optionally region-masked. A context
    of one token is its value row (softmax over one key is 1), so no q/k
    projection runs there; the q/k weights still exist for the reference's
    state dict.
    """

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, num_adapters: int = 0):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim, self.inner = heads, head_dim, inner
        self.num_adapters = num_adapters
        kv_dim = context_dim or query_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(kv_dim, inner, bias=False)
        self.to_v = Linear(kv_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, query_dim)])
        if num_adapters:
            self.processor = _IPProcessor(kv_dim, inner, num_adapters)

    def forward(self, x, context=None, ip_contexts: Optional[List] = None,
                ip_scales: Optional[Sequence[float]] = None,
                ip_masks: Optional[List] = None):
        b, s, _ = x.shape
        if context is None and self.num_adapters == 0:
            o = mha_tokens(self.to_q(x), self.to_k(x), self.to_v(x), self.heads)
            return self.to_out[0](o)
        ctx = x if context is None else context
        inner, heads, hd = self.inner, self.heads, self.head_dim

        def attend(q, k, v):
            bk = k.shape[0]
            if bk == b:
                return dot_product_attention(q, k, v)
            qf = q.reshape(bk, (b // bk) * s, heads, hd)
            return dot_product_attention(qf, k, v).reshape(b, s, heads, hd)

        def broadcast_v(v):
            bv = v.shape[0]
            return v.reshape(bv, 1, inner).expand(bv, (b // bv) * s, inner) \
                .reshape(b, s, inner)

        ip_lens = [c.shape[1] for c in (ip_contexts or [])]
        q = None
        if ctx.shape[1] > 1 or any(n > 1 for n in ip_lens):
            q = self.to_q(x).reshape(b, s, heads, hd)

        v = self.to_v(ctx)
        if ctx.shape[1] == 1:
            out = broadcast_v(v)
        else:
            bc = ctx.shape[0]
            k = self.to_k(ctx).reshape(bc, -1, heads, hd)
            out = attend(q, k, v.reshape(bc, -1, heads, hd)).reshape(b, s, inner)

        if self.num_adapters:
            if ip_contexts is None or len(ip_contexts) != self.num_adapters:
                raise ValueError("one ip context per adapter is required")
            scales = ip_scales or [1.0] * self.num_adapters
            for i, ip_ctx in enumerate(ip_contexts):
                bi = ip_ctx.shape[0]
                v_ip = self.processor.to_v_ip[i](ip_ctx)
                if ip_ctx.shape[1] == 1:
                    ip_out = broadcast_v(v_ip)
                else:
                    k_ip = self.processor.to_k_ip[i](ip_ctx)
                    ip_out = attend(q, k_ip.reshape(bi, -1, heads, hd),
                                    v_ip.reshape(bi, -1, heads, hd)
                                    ).reshape(b, s, inner)
                if ip_masks is not None and ip_masks[i] is not None:
                    m = downsample_ip_mask(ip_masks[i], s).to(ip_out.dtype)
                    ip_out = ip_out * expand_mask_rows(m, b)
                out = out + ip_out * scales[i]
        return self.to_out[0](out)


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)


class FeedForward(nn.Module):
    """GEGLU feed-forward (reference keys ``net.0.proj`` / ``net.2``), run as
    one K4 call: bf16 weights, fp32 biases. Under tensor parallelism
    (``parallel/tensor.py`` sets ``tp``) the call takes this rank's H / tp
    value and gate columns and proj_out rows, its partial output is
    all-reduced and the bias added once."""

    tp = None

    def __init__(self, dim: int):
        super().__init__()
        inner = dim * 4
        self.net = nn.ModuleList([_GEGLUProj(dim, inner), nn.Identity(),
                                  Linear(inner, dim)])

    def forward(self, x):
        p1, p2 = self.net[0].proj, self.net[2]
        if self.tp is None:
            return geglu_mlp(x, p1.weight.to(x.dtype), p1.bias.float(),
                             p2.weight.to(x.dtype), p2.bias.float())
        from actalker_tpu_torch.parallel.tensor import copy_to, reduce_from

        y = geglu_mlp(copy_to(x, self.tp), p1.weight.to(x.dtype), p1.bias.float(),
                      p2.weight.to(x.dtype), torch.zeros_like(p2.bias, dtype=torch.float32))
        return reduce_from(y, self.tp) + p2.bias.to(x.dtype)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn (K2) -> LN -> cross-attn (+IP) -> LN -> GEGLU FF (K4)."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, num_adapters: int = 0):
        super().__init__()
        self.norm1 = LayerNormF32(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.has_cross = context_dim is not None
        if self.has_cross:
            self.norm2 = LayerNormF32(dim)
            self.attn2 = Attention(dim, heads, head_dim, context_dim,
                                   num_adapters)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context=None, ip_contexts=None, ip_scales=None,
                ip_masks=None):
        x = x + self.attn1(self.norm1(x))
        if self.has_cross:
            x = x + self.attn2(self.norm2(x), context=context,
                               ip_contexts=ip_contexts, ip_scales=ip_scales,
                               ip_masks=ip_masks)
        return x + self.ff(self.norm3(x))


class _FrameSelfAttention(nn.Module):
    """Self-attention over the frame axis in the native (B*F, S, C) layout
    (K3); parameters named as ``Attention``'s self-attention."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads = heads
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, dim)])

    def forward(self, x, num_frames: int):
        o = frame_attention_tokens(self.to_q(x), self.to_k(x), self.to_v(x),
                                   num_frames, self.heads)
        return self.to_out[0](o)


class TemporalBasicTransformerBlock(nn.Module):
    """Attention over the frame axis, computed in the (B*F, S, C) layout:
    LN/FF are per token, frame self-attention is K3, and the cross-attention
    folds frames into the query length over the frame-pooled context (its
    IP branches run unmasked, as in the reference)."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, num_adapters: int = 0):
        super().__init__()
        self.norm_in = LayerNormF32(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNormF32(dim)
        self.attn1 = _FrameSelfAttention(dim, heads, head_dim)
        self.has_cross = context_dim is not None
        if self.has_cross:
            self.norm2 = LayerNormF32(dim)
            self.attn2 = Attention(dim, heads, head_dim, context_dim,
                                   num_adapters)
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, num_frames: int, context=None, ip_contexts=None,
                ip_scales=None):
        bf, s, c = x.shape
        b = bf // num_frames
        h = self.ff_in(self.norm_in(x)) + x
        h = h + self.attn1(self.norm1(h), num_frames)
        if self.has_cross:
            h = h + self.attn2(
                self.norm2(h).reshape(b, num_frames * s, c), context=context,
                ip_contexts=ip_contexts, ip_scales=ip_scales,
            ).reshape(bf, s, c)
        return h + self.ff(self.norm3(h))
