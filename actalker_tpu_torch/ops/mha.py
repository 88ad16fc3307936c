"""Multi-head attention in TOKEN layout, (B, S, C = H * Dh): spatial
self-attention (K2) and attention across frames (K3).

Twin of ``actalker_tpu/ops/mha.py``. Each op has a plain PyTorch version
(fp32 scores, softmax and accumulation) and a wrapper that launches the
hand-written CUDA kernel on CUDA tensors. The wrappers take the plain
version only for CPU tensors.

Gradients, as the JAX package's custom_vjp rules: ``MhaTokensFn`` runs
K2's training entry (which also writes the row log-sum-exp) and the
hand-written backward kernel K2-bwd (the JAX package runs the stock Pallas
flash-attention backward there); ``FrameAttentionFn`` runs K3 forward and
differentiates ``frame_attention_tokens_xla`` in its backward, as
``_frame_bwd`` recomputes through ``_frame_xla`` (products in the input
dtype, so bf16 in training). Under ``no_grad`` the wrappers launch
exactly the inference kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from actalker_tpu_torch.ops._build import (
    Kernel, check, check_cuda_tensors, needs_grad, ptr, stream_of)

HEAD_DIM = 64   # the kernels' head dim (every flagship width: 320/5, 640/10, 1280/20)

# K2 replaces _mha_kernel (:54) and _mha_kernel_1pass (:111); K3 _frame_kernel_v2
MHA_KERNEL = Kernel("mha", replaces="actalker_tpu/ops/mha.py:54")
FRAME_KERNEL = Kernel("frame_attention", replaces="actalker_tpu/ops/mha.py:401")
# K2-bwd replaces the flash-attention backward that _mha_bwd (:280) runs
MHA_BWD_KERNEL = Kernel("mha_bwd", replaces="actalker_tpu/ops/mha.py:280")

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


def _mha_checks(q, k, v, heads, scale) -> float:
    c = q.shape[-1]
    check(k.shape == q.shape and v.shape == q.shape, "K2: q/k/v shapes differ")
    check(c == heads * HEAD_DIM, f"K2: C={c} must be heads*{HEAD_DIM}")
    check_cuda_tensors("K2", (q, k, v), {"q": _BF16, "k": _BF16, "v": _BF16})
    return HEAD_DIM ** -0.5 if scale is None else scale


def _mha_fwd(q, k, v, heads: int, scale: Optional[float] = None,
             with_lse: bool = False):
    """K2 launch; ``with_lse`` runs the training entry and also returns the
    (B, H, S) fp32 base-2 log-sum-exp of the scaled scores."""
    if not q.is_cuda:
        return mha_tokens_ref(q, k, v, heads, scale), None
    b, s, _ = q.shape
    sc = _mha_checks(q, k, v, heads, scale)
    o = torch.empty_like(q)
    if not with_lse:
        MHA_KERNEL.launch("mha_tokens_bf16", "ppppiiifp", ptr(q), ptr(k),
                          ptr(v), ptr(o), b, s, heads, sc, stream_of(q))
        return o, None
    lse = torch.empty((b, heads, s), dtype=torch.float32, device=q.device)
    MHA_KERNEL.launch("mha_tokens_lse_bf16", "pppppiiifp", ptr(q), ptr(k),
                      ptr(v), ptr(o), ptr(lse), b, s, heads, sc, stream_of(q))
    return o, lse


def mha_tokens_bwd_ref(q, k, v, do, heads: int, scale: Optional[float] = None):
    """Plain version of K2-bwd: autograd through ``mha_tokens_ref``, one
    chunk of 8 batch rows at a time (rows are independent), so the fp32
    scores of only one chunk are alive. Returns (dq, dk, dv)."""
    batch_chunk = 8
    grads = [torch.empty_like(t) for t in (q, k, v)]
    for i in range(0, q.shape[0], batch_chunk):
        sl = slice(i, i + batch_chunk)
        with torch.enable_grad():
            ins = [t[sl].detach().requires_grad_(True) for t in (q, k, v)]
            out = mha_tokens_ref(*ins, heads, scale)
            parts = torch.autograd.grad(out, ins, do[sl])
        for g, part in zip(grads, parts):
            g[sl] = part
    return tuple(grads)


def mha_tokens_bwd(q, k, v, o, lse, do, heads: int,
                   scale: Optional[float] = None):
    """K2-bwd: (dq, dk, dv) of the token-layout attention from the forward's
    output ``o`` and log-sum-exp ``lse``. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if not q.is_cuda:
        return mha_tokens_bwd_ref(q, k, v, do, heads, scale)
    b, s, _ = q.shape
    sc = _mha_checks(q, k, v, heads, scale)
    check_cuda_tensors("K2-bwd", (o, do, lse),
                       {"o": _BF16, "do": _BF16, "lse": (torch.float32,)})
    check(o.shape == q.shape and do.shape == q.shape
          and tuple(lse.shape) == (b, heads, s), "K2-bwd: o / do / lse shapes")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dsum = torch.empty((b, heads, s), dtype=torch.float32, device=q.device)
    MHA_BWD_KERNEL.launch("mha_bwd_bf16", "ppppppppppiiifp", ptr(q), ptr(k),
                          ptr(v), ptr(o), ptr(do), ptr(lse), ptr(dsum),
                          ptr(dq), ptr(dk), ptr(dv), b, s, heads, sc,
                          stream_of(q))
    return dq, dk, dv


class MhaTokensFn(torch.autograd.Function):
    """K2 (training entry, with the log-sum-exp) forward, K2-bwd backward."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        o, lse = _mha_fwd(q, k, v, heads, scale, with_lse=True)
        ctx.heads, ctx.scale = heads, scale
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*mha_tokens_bwd(q, k, v, o, lse, do.contiguous(), ctx.heads,
                                ctx.scale), None, None)


def mha_tokens(q, k, v, heads: int, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Self-attention in token layout: q/k/v (B, S, C) -> (B, S, C);
    differentiable through ``MhaTokensFn`` when autograd needs it."""
    if needs_grad(q, k, v):
        return MhaTokensFn.apply(q, k, v, heads, scale)
    return _mha_fwd(q, k, v, heads, scale)[0]


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


def frame_attention_tokens_xla(q, k, v, num_frames: int, heads: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Twin of ``_frame_xla``, the function the JAX backward differentiates:
    both products take and return the input dtype, the softmax runs in fp32
    and its probabilities are cast back to the input dtype."""
    bf, s, c = q.shape
    b = bf // num_frames
    d = c // heads
    sc = d ** -0.5 if scale is None else scale
    q5, k5, v5 = (x.reshape(b, num_frames, s, heads, d) for x in (q, k, v))
    scores = torch.einsum("bfshd,bgshd->bshfg", q5, k5).float()
    probs = torch.softmax(scores * sc, dim=-1).to(q.dtype)
    o = torch.einsum("bshfg,bgshd->bfshd", probs, v5)
    return o.reshape(bf, s, c)


# K3's geometry (csrc/frame_attention.cu): tokens (one a warp) per block
# of the tensor-core kernel, and the most frames it takes; past that a
# plain kernel with 8 lanes per (token, head, query frame) of 256-thread
# blocks computes the same function
FRAME_WARPS, FRAME_MAX_F = 4, 32


def frame_plan(bf: int, num_frames: int, s: int, heads: int) -> dict:
    """K3's launch plan for q/k/v of (B*F, S, heads * 64): ``m_tiles`` of 16
    query frames (0: the plain kernel), the grid, threads per block and the
    dynamic shared bytes (every warp stages its token's F query, key and
    value rows of 128 bytes)."""
    b = bf // num_frames
    if num_frames <= FRAME_MAX_F:
        return {"m_tiles": -(-num_frames // 16),
                "grid": (-(-s // FRAME_WARPS), heads, b),
                "threads": 32 * FRAME_WARPS,
                "smem": FRAME_WARPS * 3 * num_frames * 2 * HEAD_DIM}
    return {"m_tiles": 0, "grid": (-(-bf * s * heads * 8 // 256), 1, 1),
            "threads": 256, "smem": 0}


def _frame_fwd(q, k, v, num_frames: int, heads: int,
               scale: Optional[float] = None) -> torch.Tensor:
    """K3 launch (plain version for CPU tensors)."""
    if not q.is_cuda:
        return frame_attention_tokens_ref(q, k, v, num_frames, heads, scale)
    bf, s, c = q.shape
    check(k.shape == q.shape and v.shape == q.shape, "K3: q/k/v shapes differ")
    check(bf % num_frames == 0, f"K3: {bf} rows not a multiple of F")
    check(c == heads * HEAD_DIM, f"K3: C={c} must be heads*{HEAD_DIM}")
    check(bf // num_frames < 65536 and heads < 65536,
          "K3: batch and heads must each be below 65536 (grid limits)")
    check_cuda_tensors("K3", (q, k, v), {"q": _BF16, "k": _BF16, "v": _BF16})
    sc = HEAD_DIM ** -0.5 if scale is None else scale
    plan = frame_plan(bf, num_frames, s, heads)
    o = torch.empty_like(q)
    FRAME_KERNEL.launch("frame_attention_bf16", "ppppiiiifiip", ptr(q), ptr(k),
                        ptr(v), ptr(o), bf // num_frames, num_frames, s, heads,
                        sc, plan["m_tiles"], plan["smem"], stream_of(q))
    return o


class FrameAttentionFn(torch.autograd.Function):
    """K3 forward; the backward differentiates ``frame_attention_tokens_xla``
    (as the JAX package's ``_frame_bwd`` recomputes through ``_frame_xla``)."""

    @staticmethod
    def forward(ctx, q, k, v, num_frames, heads, scale):
        ctx.args = (num_frames, heads, scale)
        ctx.save_for_backward(q, k, v)
        return _frame_fwd(q, k, v, num_frames, heads, scale)

    @staticmethod
    def backward(ctx, do):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = frame_attention_tokens_xla(*ins, *ctx.args)
        return (*torch.autograd.grad(out, ins, do), None, None, None)


def frame_attention_tokens(q, k, v, num_frames: int, heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Attention over the frame axis per spatial token: q/k/v (B*F, S, C)
    -> (B*F, S, C); differentiable through ``FrameAttentionFn``."""
    if needs_grad(q, k, v):
        return FrameAttentionFn.apply(q, k, v, num_frames, heads, scale)
    return _frame_fwd(q, k, v, num_frames, heads, scale)
