"""Multi-head attention in TOKEN layout, (B, S, C = H * Dh): spatial
self-attention (K2) and attention across frames (K3).

Twin of ``actalker_tpu/ops/mha.py``. Each op has a plain PyTorch version
(fp32 scores, softmax and accumulation) and a wrapper that launches the
hand-written CUDA kernel on CUDA tensors. The wrappers take the plain
version only for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from actalker_tpu_torch.ops._build import (
    Kernel, check, check_cuda_tensors, ptr, stream_of)

HEAD_DIM = 64   # the kernels' head dim (every flagship width: 320/5, 640/10, 1280/20)

# K2 replaces _mha_kernel (:54) and _mha_kernel_1pass (:111); K3 _frame_kernel_v2
MHA_KERNEL = Kernel("mha", replaces="actalker_tpu/ops/mha.py:54")
FRAME_KERNEL = Kernel("frame_attention", replaces="actalker_tpu/ops/mha.py:401")

_BF16 = (torch.bfloat16,)


def mha_tokens_ref(q, k, v, heads: int, scale: Optional[float] = None
                   ) -> torch.Tensor:
    """Plain version of K2 (twin of ``_mha_xla``), 8 batch rows at a time so
    the (8, H, S, S) fp32 scores stay bounded."""
    batch_chunk = 8
    b, s, c = q.shape
    d = c // heads
    sc = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    for i in range(0, b, batch_chunk):
        sl = slice(i, i + batch_chunk)
        n = q[sl].shape[0]
        q4 = q[sl].float().reshape(n, s, heads, d).transpose(1, 2)
        k4 = k[sl].float().reshape(n, s, heads, d).transpose(1, 2)
        v4 = v[sl].float().reshape(n, s, heads, d).transpose(1, 2)
        p = torch.softmax((q4 @ k4.transpose(-1, -2)) * sc, dim=-1)
        out[sl] = (p @ v4).transpose(1, 2).reshape(n, s, c).to(q.dtype)
    return out


def mha_tokens(q, k, v, heads: int, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Self-attention in token layout: q/k/v (B, S, C) -> (B, S, C)."""
    if not q.is_cuda:
        return mha_tokens_ref(q, k, v, heads, scale)
    b, s, c = q.shape
    check(k.shape == q.shape and v.shape == q.shape, "K2: q/k/v shapes differ")
    check(c == heads * HEAD_DIM, f"K2: C={c} must be heads*{HEAD_DIM}")
    check_cuda_tensors("K2", (q, k, v), {"q": _BF16, "k": _BF16, "v": _BF16})
    sc = HEAD_DIM ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    MHA_KERNEL.launch("mha_tokens_bf16", "ppppiiifp", ptr(q), ptr(k), ptr(v),
                      ptr(o), b, s, heads, sc, stream_of(q))
    return o


def frame_attention_tokens_ref(q, k, v, num_frames: int, heads: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of K3 (twin of ``_frame_xla``, fp32 throughout)."""
    bf, s, c = q.shape
    b = bf // num_frames
    d = c // heads
    sc = d ** -0.5 if scale is None else scale
    q5 = q.float().reshape(b, num_frames, s, heads, d)
    k5 = k.float().reshape(b, num_frames, s, heads, d)
    v5 = v.float().reshape(b, num_frames, s, heads, d)
    scores = torch.einsum("bfshd,bgshd->bshfg", q5, k5) * sc
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bshfg,bgshd->bfshd", probs, v5)
    return o.reshape(bf, s, c).to(q.dtype)


def frame_attention_tokens(q, k, v, num_frames: int, heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention over the frame axis per spatial token: q/k/v (B*F, S, C)
    -> (B*F, S, C)."""
    if not q.is_cuda:
        return frame_attention_tokens_ref(q, k, v, num_frames, heads, scale)
    bf, s, c = q.shape
    check(k.shape == q.shape and v.shape == q.shape, "K3: q/k/v shapes differ")
    check(bf % num_frames == 0, f"K3: {bf} rows not a multiple of F")
    check(c == heads * HEAD_DIM, f"K3: C={c} must be heads*{HEAD_DIM}")
    check_cuda_tensors("K3", (q, k, v), {"q": _BF16, "k": _BF16, "v": _BF16})
    sc = HEAD_DIM ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    FRAME_KERNEL.launch("frame_attention_bf16", "ppppiiiifp", ptr(q), ptr(k),
                        ptr(v), ptr(o), bf // num_frames, num_frames, s, heads,
                        sc, stream_of(q))
    return o
