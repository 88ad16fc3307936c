"""Whisper-tiny audio encoder, twin of ``actalker_tpu/models/whisper.py``.

HF ``WhisperModel.encoder`` as the reference uses it (``Inference.py:179,
450-461``): log-mel (B, 80, T <= 3000) -> conv1 (k3) + GELU -> conv2 (k3,
stride 2) + GELU -> + positions -> 4 pre-LN transformer layers (6 heads, d
384, GELU MLP 1536) -> final LayerNorm. The pipeline stacks all five hidden
states (the embedding output and each layer's; the last after the final
LayerNorm, as HF's ``hidden_states``), so ``forward`` returns (B, T // 2, 5,
384).

The module is keyed as the encoder of HF's ``WhisperModel`` (``conv1.weight``,
``layers.0.self_attn.q_proj.weight``, ...), so the encoder's entries of
whisper-tiny's ``pytorch_model.bin`` load with ``strict=True``
(``io/init.py::whisper_state_dict`` strips their ``encoder.`` prefix). Its
self-attention is the plain ``ops/attention.py`` (the JAX package has no
kernel there); its LayerNorms follow ``ACTALKER_NORM`` like every
``LayerNormF32``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from actalker_tpu_torch.models.common import LayerNormF32, Linear
from actalker_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    d_model: int = 384
    layers: int = 4
    heads: int = 6
    ffn_dim: int = 1536
    num_mel_bins: int = 80
    max_positions: int = 1500


class WhisperAttention(nn.Module):
    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(d_model, d_model)
        self.k_proj = Linear(d_model, d_model, bias=False)
        self.v_proj = Linear(d_model, d_model)
        self.out_proj = Linear(d_model, d_model)

    def forward(self, h):
        b, s, c = h.shape
        hd = c // self.heads
        q = self.q_proj(h) * hd ** -0.5
        k, v = self.k_proj(h), self.v_proj(h)
        o = dot_product_attention(
            *(t.reshape(b, s, self.heads, hd) for t in (q, k, v)), scale=1.0)
        return self.out_proj(o.reshape(b, s, c))


class WhisperEncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.self_attn_layer_norm = LayerNormF32(cfg.d_model)
        self.self_attn = WhisperAttention(cfg.d_model, cfg.heads)
        self.final_layer_norm = LayerNormF32(cfg.d_model)
        self.fc1 = Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = Linear(cfg.ffn_dim, cfg.d_model)

    def forward(self, x):
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig = WhisperConfig()):
        super().__init__()
        self.cfg = cfg
        c = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, c, 3, padding=1)
        self.conv2 = nn.Conv1d(c, c, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(cfg.max_positions, c)
        with torch.no_grad():
            self.embed_positions.weight.copy_(
                sinusoid_positions(cfg.max_positions, c))
        self.layers = nn.ModuleList(WhisperEncoderLayer(cfg)
                                    for _ in range(cfg.layers))
        self.layer_norm = LayerNormF32(c)

    def forward(self, mel):
        """mel (B, num_mel_bins, T <= 3000) -> stacked hidden states
        (B, T // 2, 1 + layers, d_model) in mel's dtype."""
        w = self.conv1.weight.to(mel.dtype)
        x = F.gelu(F.conv1d(mel, w, self.conv1.bias.to(mel.dtype), padding=1))
        x = F.gelu(F.conv1d(x, self.conv2.weight.to(mel.dtype),
                            self.conv2.bias.to(mel.dtype), stride=2, padding=1))
        x = x.transpose(1, 2)                                   # (B, T', C)
        x = x + self.embed_positions.weight[:x.shape[1]].to(x.dtype)
        states = [x]
        for layer in self.layers:
            x = layer(x)
            states.append(x)
        states[-1] = self.layer_norm(x)
        return torch.stack(states, dim=2)


def sinusoid_positions(length: int, channels: int) -> torch.Tensor:
    """Whisper's fixed sinusoidal position table (also a weight of the
    checkpoint, which overwrites it)."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2,
                                                  dtype=torch.float32))
    t = torch.arange(length, dtype=torch.float32)[:, None] * inv[None]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)
