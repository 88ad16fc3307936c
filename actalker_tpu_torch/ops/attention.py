"""Plain scaled-dot-product attention for the attentions that are no kernel
of this repository: the cross-attentions over the conditioning tokens, the
VAE's single-head attention and the audio encoder's self-attention (twin of ``actalker_tpu/ops/attention.py``,
which leaves them to XLA).

Shapes: q (B, Sq, H, Dh), k/v (B, Sk, H, Dh) -> (B, Sq, H, Dh). Scores and
softmax in fp32; the batch is walked in chunks so the fp32 scores stay
under ``_MAX_SCORES`` elements.
"""
from __future__ import annotations

from typing import Optional

import torch


_MAX_SCORES = 2 ** 28     # 1 GiB of fp32 scores per chunk


def dot_product_attention(q, k, v, scale: Optional[float] = None
                          ) -> torch.Tensor:
    """``scale`` multiplies the scores (default Dh^-0.5)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    sc = d ** -0.5 if scale is None else scale
    chunk = max(1, _MAX_SCORES // (h * sq * sk))
    out = torch.empty_like(q)
    for i in range(0, b, chunk):
        sl = slice(i, i + chunk)
        logits = torch.einsum("bqhd,bkhd->bhqk", q[sl].float(),
                              k[sl].float()) * sc
        probs = torch.softmax(logits, dim=-1)
        out[sl] = torch.einsum("bhqk,bkhd->bqhd", probs,
                               v[sl].float()).to(q.dtype)
    return out
