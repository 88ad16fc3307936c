"""The flagship model: spatio-temporal conditional UNet (SVD-XT with the
parallel Mamba control blocks), twin of ``actalker_tpu/models/unet.py``.

conv_in (8 -> 320), sinusoidal time + added-time embeddings, the PoseGuider
condition added after conv_in, 3 cross-attention down blocks + 1 plain
(320/640/1280/1280, heads 5/10/20/20), a mid block without the SSM, the
mirrored up path, then GroupNorm / SiLU / conv_out (-> 4). Video tensors are
(B, F, H, W, C); conditioning comes as one ``Conditioning`` bundle.
Parameter names are the reference's (diffusers), so ``export_unet`` state
dicts load with ``strict=True``. Spans (``utils/observability``):
``unet.forward`` around a call; inside it ``unet.resnet``,
``unet.transformer``, ``unet.attention``, ``unet.ff``, ``unet.ssm`` (a
control block with its out-norm and out-projection) and the norms'
``unet.norm``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from actalker_tpu_torch.models.attention_blocks import Attention
from actalker_tpu_torch.models.common import Conv2d, GroupNorm32
from actalker_tpu_torch.models.conditioning import Conditioning
from actalker_tpu_torch.models.embeddings import (
    TimestepEmbedding, sinusoidal_embedding)
from actalker_tpu_torch.models.ssm import SS2DCondV10
from actalker_tpu_torch.models.unet_blocks import (
    CrossAttnDownBlockSpatioTemporal, CrossAttnUpBlockSpatioTemporal,
    DownBlockSpatioTemporal, UNetMidBlockSpatioTemporal, UpBlockSpatioTemporal)
from actalker_tpu_torch.utils.observability import spanned


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "CrossAttnDownBlockSpatioTemporal",
        "DownBlockSpatioTemporal",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
        "CrossAttnUpBlockSpatioTemporal",
    )
    num_attention_heads: Tuple[int, ...] = (5, 10, 20, 20)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 768
    transformer_layers_per_block: int = 1
    use_mamba: bool = True
    # recompute each down / mid / up block in the backward pass, one scope
    # per block as the JAX package's nn.remat (configs/train.yaml solver)
    gradient_checkpointing: bool = False
    # the reference's ablation lineage as config: any subset of
    # {"audio", "vasa", "id", "ssd", "cross_attn"}
    ablate: Tuple[str, ...] = ()
    # static masked-token capacity fractions (audio, exp) of every
    # SS2DCondV10 (its gather path); the pipeline computes them from the
    # clip's region masks. None scans every token.
    mask_capacity: Optional[Tuple[float, float]] = None

    def tiny(self) -> "UNetConfig":
        """A scaled-down config for tests."""
        return dataclasses.replace(
            self, block_out_channels=(32, 64, 64, 64),
            num_attention_heads=(2, 4, 4, 4), layers_per_block=1)

    def micro(self) -> "UNetConfig":
        """A 2-level config for tests."""
        return dataclasses.replace(
            self, block_out_channels=(32, 64), num_attention_heads=(2, 4),
            down_block_types=("CrossAttnDownBlockSpatioTemporal",
                              "DownBlockSpatioTemporal"),
            up_block_types=("UpBlockSpatioTemporal",
                            "CrossAttnUpBlockSpatioTemporal"),
            layers_per_block=1)


class UNetSpatioTemporalCondition(nn.Module):
    """``dtype`` is the compute dtype: the sample, embeddings and every
    activation run in it; norm statistics and the scan state stay fp32."""

    def __init__(self, config: UNetConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        boc = cfg.block_out_channels
        ch0, temb = boc[0], boc[0] * 4
        kw = dict(context_dim=cfg.cross_attention_dim,
                  transformer_layers=cfg.transformer_layers_per_block,
                  ablate=cfg.ablate)
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb)
        self.add_embedding = TimestepEmbedding(
            cfg.projection_class_embeddings_input_dim, temb)

        skips, ch = [ch0], ch0
        self.down_blocks = nn.ModuleList()
        for i, kind in enumerate(cfg.down_block_types):
            out, last = boc[i], i == len(boc) - 1
            if kind == "CrossAttnDownBlockSpatioTemporal":
                blk = CrossAttnDownBlockSpatioTemporal(
                    ch, out, temb, cfg.num_attention_heads[i],
                    cfg.layers_per_block, add_downsample=not last,
                    use_mamba=cfg.use_mamba, **kw)
            else:
                blk = DownBlockSpatioTemporal(ch, out, temb,
                                              cfg.layers_per_block, not last)
            self.down_blocks.append(blk)
            skips += [out] * (cfg.layers_per_block + (0 if last else 1))
            ch = out

        self.mid_block = UNetMidBlockSpatioTemporal(
            ch, temb, cfg.num_attention_heads[-1], **kw)

        self.up_blocks = nn.ModuleList()
        rev, rev_heads = list(reversed(boc)), list(reversed(cfg.num_attention_heads))
        for i, kind in enumerate(cfg.up_block_types):
            out, last = rev[i], i == len(boc) - 1
            n = cfg.layers_per_block + 1
            mine = [skips.pop() for _ in range(n)]      # popped in use order
            if kind == "CrossAttnUpBlockSpatioTemporal":
                blk = CrossAttnUpBlockSpatioTemporal(
                    ch, mine, out, temb, rev_heads[i], add_upsample=not last,
                    use_mamba=cfg.use_mamba, **kw)
            else:
                blk = UpBlockSpatioTemporal(ch, mine, out, temb, not last)
            self.up_blocks.append(blk)
            ch = out
        self.conv_norm_out = GroupNorm32(ch)
        self.conv_out = Conv2d(ch, cfg.out_channels, 3, padding=1)
        self.set_mask_capacity(cfg.mask_capacity)

    def set_mask_capacity(self, caps: Optional[Tuple[float, float]]) -> None:
        """Give every SS2DCondV10 the capacity fractions ``caps`` (audio,
        exp), or None for the masked-dense scan, and record them in
        ``config.mask_capacity``."""
        self.config = dataclasses.replace(self.config, mask_capacity=caps)
        for mod in self.modules():
            if isinstance(mod, SS2DCondV10):
                mod.capacity_frac = caps

    def attn2_modules(self) -> Iterator[Attention]:
        """Cross-attentions in the reference's ``attn_processors`` order
        (down -> mid -> up; spatial block then temporal block), the order of
        an ``adapter_module-*.pth`` ModuleList."""
        for name, mod in self.named_modules():
            if name.endswith(".attn2") and isinstance(mod, Attention):
                yield mod

    @spanned("unet.forward")
    def forward(self, sample, timestep, cond: Conditioning, added_time_ids,
                spatial_condition: Optional[torch.Tensor] = None):
        """sample (B, F, H, W, 8); timestep scalar or (B,); added_time_ids
        (B, 3); spatial_condition (B, F, H, W, 320) -> (B, F, H, W, 4)."""
        cfg, dt = self.config, self.dtype
        b, f, hh, ww, _ = sample.shape
        ts = torch.as_tensor(timestep, device=sample.device).reshape(-1)
        ts = ts.expand(b) if ts.numel() == 1 else ts
        ch0 = cfg.block_out_channels[0]
        emb = self.time_embedding(sinusoidal_embedding(ts, ch0).to(dt))
        add = sinusoidal_embedding(added_time_ids.reshape(-1),
                                   cfg.addition_time_embed_dim).reshape(b, -1)
        emb = (emb + self.add_embedding(add.to(dt))).repeat_interleave(f, dim=0)
        ioi = torch.zeros(b, f, dtype=dt, device=sample.device)

        h = self.conv_in(sample.to(dt).reshape(b * f, hh, ww, -1))
        h = h.reshape(b, f, hh, ww, ch0)
        if spatial_condition is not None:
            h = h + spatial_condition.to(dt)
        remat = cfg.gradient_checkpointing and torch.is_grad_enabled()

        def run(fn, *args):
            if remat:
                return checkpoint(fn, *args, use_reentrant=False)
            return fn(*args)

        res_states = [h]
        for blk in self.down_blocks:
            if isinstance(blk, CrossAttnDownBlockSpatioTemporal):
                h, states = run(blk, h, emb, cond, ioi)
            else:
                h, states = run(blk, h, emb, ioi)
            res_states.extend(states)
        h = run(self.mid_block, h, emb, cond, ioi)
        for blk in self.up_blocks:
            n = len(blk.resnets)
            mine = res_states[-n:]
            del res_states[-n:]
            # the blocks pop the skip list they get, so a recompute needs a
            # fresh copy: hand the states over as arguments
            if isinstance(blk, CrossAttnUpBlockSpatioTemporal):
                h = run(lambda h, *st, blk=blk: blk(h, list(st), emb, cond, ioi),
                        h, *mine)
            else:
                h = run(lambda h, *st, blk=blk: blk(h, list(st), emb, ioi),
                        h, *mine)
        h = h.reshape(b * f, *h.shape[2:])
        h = self.conv_out(F.silu(self.conv_norm_out(h)))
        return h.reshape(b, f, hh, ww, cfg.out_channels)
