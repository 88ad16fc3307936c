"""The reference's resizes, twins of ``actalker_tpu/ops/resize.py``'s
``torch_bicubic_resize`` and ``resize_with_antialiasing``.

The reference resamples with ``F.interpolate(mode="bicubic",
align_corners=False)`` (Keys a = -0.75, no antialiasing; its mask
downsample and the evaluation harness's frame resizes). The JAX package
rebuilds that kernel as two weight matrices because ``jax.image.resize``'s
cubic differs; here it is the call itself. The mask downsample already
lives in ``models/attention_blocks.py``; this module serves the evaluation
harness (``evaluation/run_eval.py``). ``resize_with_antialiasing`` is the
SVD lineage's CLIP-size resize of the reference image (the reference
pipeline's ``_resize_with_antialiasing``); the two-IP pipeline replaces
CLIP with the ArcFace embedding, so it sits on the compatibility path.
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


def _gaussian_taps(ks: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(ks, dtype=torch.float64, device=device) - ks // 2
    g = torch.exp(-x ** 2 / (2.0 * sigma ** 2))
    return (g / g.sum()).float()


def resize_with_antialiasing(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the last two axes of ``x`` (any leading axes) to (out_h,
    out_w) as the reference pipeline's ``_resize_with_antialiasing``
    (``pipeline_svd_audio_adapter_motionexp_idembed_vasa_two_ip.py:779-805``):
    a gaussian blur with skimage's sigma ``max((in / out - 1) / 2, 0.001)``
    per axis and kernel size ``max(4 sigma, 3)`` made odd, reflect padding,
    along the width then the height, then torch's bicubic with
    ``align_corners=True``. Computes in fp32."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    sig_h = max((h / out_h - 1.0) / 2.0, 0.001)
    sig_w = max((w / out_w - 1.0) / 2.0, 0.001)
    ks_h, ks_w = int(max(4.0 * sig_h, 3)), int(max(4.0 * sig_w, 3))
    ks_h += 1 - ks_h % 2
    ks_w += 1 - ks_w % 2
    y = x.float().reshape(-1, 1, h, w)
    gw = _gaussian_taps(ks_w, sig_w, y.device).reshape(1, 1, 1, ks_w)
    y = F.conv2d(F.pad(y, (ks_w // 2, ks_w // 2, 0, 0), mode="reflect"), gw)
    gh = _gaussian_taps(ks_h, sig_h, y.device).reshape(1, 1, ks_h, 1)
    y = F.conv2d(F.pad(y, (0, 0, ks_h // 2, ks_h // 2), mode="reflect"), gh)
    y = F.interpolate(y, size=(out_h, out_w), mode="bicubic", align_corners=True)
    return y.reshape(*lead, out_h, out_w)
