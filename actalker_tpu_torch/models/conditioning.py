"""Conditioning bundle threaded through the UNet (twin of
``actalker_tpu/models/conditioning.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class Conditioning:
    """All cross-attention / SSM conditioning for one UNet call.

    Shapes (BF = batch * frames):
      id_tokens:    (BF, 1, d_cond)   identity embedding tokens
      audio_tokens: (BF, 32, d_cond)  audio-window context tokens
      vasa_tokens:  (BF, 1, d_cond)   expression + pose token
      audio_mask:   (Bm, 1, H, W) region mask of the audio branch or None;
                    Bm == 1 broadcasts over the token batch
      exp_mask:     (Bm, 1, H, W) region mask of the expression branch
      ip_scales:    per-adapter attention scales (audio, vasa)
    """

    id_tokens: torch.Tensor
    audio_tokens: torch.Tensor
    vasa_tokens: torch.Tensor
    audio_mask: Optional[torch.Tensor] = None
    exp_mask: Optional[torch.Tensor] = None
    ip_scales: Tuple[float, float] = (1.25, 1.25)

    def pooled_over_frames(self, num_frames: int) -> "Conditioning":
        """Frame-mean tokens for the temporal blocks (``spatial2time``)."""
        def pool(t):
            bf, s, c = t.shape
            return t.reshape(bf // num_frames, num_frames, s, c).mean(dim=1)

        return dataclasses.replace(
            self, id_tokens=pool(self.id_tokens),
            audio_tokens=pool(self.audio_tokens),
            vasa_tokens=pool(self.vasa_tokens))
