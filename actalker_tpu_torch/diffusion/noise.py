"""Noise draws, twin of ``actalker_tpu/diffusion/noise.py``.

``video_fusion_noise`` mixes a per-clip common noise with per-frame
independent noise, ``sqrt(1 - s) * common + sqrt(s) * ind`` (the
reference's ``src/utils/noise_util.py:31-83``); ``random_noise`` adds the
training's per-(batch, channel) offset (``noise_util.py:8-28``). Video
tensors are (B, T, C, H, W), as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def random_noise(generator: Optional[torch.Generator], shape: Sequence[int],
                 dtype: torch.dtype = torch.float32,
                 noise_offset: Optional[float] = None,
                 device=None) -> torch.Tensor:
    """Standard normal noise of ``shape``, plus ``noise_offset`` times a
    per-(batch, channel) normal shift when given."""
    noise = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                        device=device)
    if noise_offset is not None:
        b, _, c = shape[0], shape[1], shape[2]
        noise = noise + noise_offset * torch.randn(
            (b, 1, c, 1, 1), generator=generator, dtype=dtype, device=device)
    return noise


def video_fusion_noise(generator: Optional[torch.Generator],
                       shape: Sequence[int], w_ind_noise: float = 0.5,
                       dtype: torch.dtype = torch.float32,
                       initial_common_noise: Optional[torch.Tensor] = None,
                       initial_ind_noise: Optional[torch.Tensor] = None,
                       device=None) -> torch.Tensor:
    """Correlated video noise over (B, T, C, H, W).

    ``initial_common_noise`` (B, 1, C, H, W) is the reference's injection
    hook (``noise_util.py:38``) and ``initial_ind_noise`` (B, T, C, H, W)
    the same for the per-frame draw: given, they replace the draws from
    ``generator``."""
    b, t, c, h, w = shape
    if initial_common_noise is not None:
        common = initial_common_noise.to(dtype=dtype, device=device)
    else:
        common = torch.randn((b, 1, c, h, w), generator=generator,
                             dtype=dtype, device=device)
    if initial_ind_noise is not None:
        ind = initial_ind_noise.to(dtype=dtype, device=device)
    else:
        ind = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                          device=device)
    s = torch.tensor(w_ind_noise, dtype=dtype)
    return torch.sqrt(1.0 - s) * common + torch.sqrt(s) * ind
