"""The reference's bicubic resize, twin of ``actalker_tpu/ops/resize.py``'s
``torch_bicubic_resize``.

The reference resamples with ``F.interpolate(mode="bicubic",
align_corners=False)`` (Keys a = -0.75, no antialiasing; its mask
downsample and the evaluation harness's frame resizes). The JAX package
rebuilds that kernel as two weight matrices because ``jax.image.resize``'s
cubic differs; here it is the call itself. The mask downsample already
lives in ``models/attention_blocks.py``; this module serves the evaluation
harness (``evaluation/run_eval.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def torch_bicubic_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the last two axes of ``x`` (any leading axes) to (out_h,
    out_w) with torch's bicubic, ``align_corners=False``; computes in
    fp32."""
    lead = x.shape[:-2]
    y = F.interpolate(x.float().reshape(-1, 1, *x.shape[-2:]), size=(out_h, out_w),
                      mode="bicubic", align_corners=False)
    return y.reshape(*lead, out_h, out_w)
