"""Conditioning projection heads, twin of ``actalker_tpu/models/projections.py``:
the audio window -> 32 context tokens, the VASA expression -> one token, and
the ArcFace identity -> one token. Parameter names are the reference's."""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import LayerNormF32, Linear


class AudioProjModel(nn.Module):
    def __init__(self, seq_len: int = 10, blocks: int = 5, channels: int = 384,
                 intermediate_dim: int = 1024, output_dim: int = 1024,
                 context_tokens: int = 32):
        super().__init__()
        self.context_tokens, self.output_dim = context_tokens, output_dim
        self.proj1 = Linear(seq_len * blocks * channels, intermediate_dim)
        self.proj2 = Linear(intermediate_dim, intermediate_dim)
        self.proj3 = Linear(intermediate_dim, context_tokens * output_dim)
        self.norm = LayerNormF32(output_dim)

    def forward(self, audio_embeds):
        """(B, F, window, blocks, channels) -> (B, F, context_tokens, out)."""
        b, f = audio_embeds.shape[:2]
        x = F.relu(self.proj1(audio_embeds.reshape(b * f, -1)))
        x = self.proj3(F.relu(self.proj2(x)))
        x = self.norm(x.reshape(b * f, self.context_tokens, self.output_dim))
        return x.reshape(b, f, self.context_tokens, self.output_dim)


class VasaProjModel(nn.Module):
    def __init__(self, input_dim: int = 512, output_dim: int = 1018):
        super().__init__()
        self.proj1 = Linear(input_dim, output_dim)
        self.norm = LayerNormF32(output_dim)

    def forward(self, x):
        return self.norm(self.proj1(x))


class IDProjModel(nn.Module):
    def __init__(self, input_dim: int = 512, intermediate_dim: int = 1024,
                 output_dim: int = 1024):
        super().__init__()
        self.proj1 = Linear(input_dim, intermediate_dim)
        self.proj2 = Linear(intermediate_dim, intermediate_dim)
        self.proj3 = Linear(intermediate_dim, output_dim)

    def forward(self, x):
        return self.proj3(F.relu(self.proj2(F.relu(self.proj1(x)))))
