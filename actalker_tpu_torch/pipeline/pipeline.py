"""Clip generation: conditioning encoders, the sliding-window sampler and the
chunked VAE decode. Twin of ``actalker_tpu/pipeline/pipeline.py`` without
the audio and VASA encoder towers: ``generate_latents`` takes audio and
VASA tokens that are already projected (``audio_tokens_per_frame`` and
``vasa_tokens`` project them).

Buffer semantics follow the reference: audio/vasa buffers past
``num_frames`` hold the unconditional tokens; masks default to all ones
(mode 2), and modes 0/1 gate the inactive branch off in the sampler.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from actalker_tpu_torch.models.pose_guider import PoseGuider
from actalker_tpu_torch.models.projections import (
    AudioProjModel, IDProjModel, VasaProjModel)
from actalker_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporalCondition
from actalker_tpu_torch.models.vae import AutoencoderKLTemporalDecoder, VAEConfig
from actalker_tpu_torch.pipeline.sampler import (
    CondBuffers, SamplerConfig, make_plan, sample_video)


@dataclasses.dataclass
class PipelineModules:
    unet: UNetSpatioTemporalCondition
    vae: AutoencoderKLTemporalDecoder
    audio_proj: AudioProjModel
    id_proj: IDProjModel
    vasa_proj: VasaProjModel
    pose_guider: PoseGuider

    @classmethod
    def create(cls, unet_config: Optional[UNetConfig] = None,
               vae_config: Optional[VAEConfig] = None,
               dtype: torch.dtype = torch.bfloat16,
               vae_dtype: torch.dtype = torch.float32,
               vasa_expression_dim: int = 1018) -> "PipelineModules":
        """``dtype`` is the UNet's compute dtype and ``vae_dtype`` the VAE's;
        the projection heads and the PoseGuider compute in fp32. Build under
        ``torch.device("meta")`` and materialize with ``io.init`` to skip
        torch's default init at full width."""
        ucfg = unet_config or UNetConfig()
        return cls(
            unet=UNetSpatioTemporalCondition(ucfg, dtype=dtype),
            vae=AutoencoderKLTemporalDecoder(vae_config or VAEConfig(),
                                             dtype=vae_dtype),
            audio_proj=AudioProjModel(),
            id_proj=IDProjModel(),
            vasa_proj=VasaProjModel(output_dim=vasa_expression_dim),
            pose_guider=PoseGuider(embedding_channels=ucfg.block_out_channels[0]),
        )

    def named(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


class ACTalkerPipeline:
    def __init__(self, modules: PipelineModules, dtype=torch.bfloat16):
        self.m = modules
        self.dtype = dtype
        self.device = next(modules.unet.parameters()).device

    def _t(self, x):
        """numpy or tensor input -> fp32 tensor on the pipeline's device."""
        if not torch.is_tensor(x):
            x = torch.tensor(np.asarray(x))
        return x.to(device=self.device, dtype=torch.float32)

    @torch.no_grad()
    def audio_tokens_per_frame(self, audio_feats: np.ndarray, num_frames: int,
                               step: int = 2):
        """(T2, 5, 384) audio-encoder states at 2 per video frame, zero-padded
        4 front / 6 back -> (cond, uncond), each (num_frames, 32, 1024)."""
        windows = np.stack([audio_feats[i * 2 * step: i * 2 * step + 10]
                            for i in range(num_frames)])
        ap = self.m.audio_proj(self._t(windows)[None])[0]
        uncond = self.m.audio_proj(
            torch.zeros(1, 1, 10, 5, 384, device=self.device))[0, 0]
        return ap, uncond[None].expand(ap.shape)

    @torch.no_grad()
    def vasa_tokens(self, expr: Optional[np.ndarray], rot: Optional[np.ndarray],
                    num_frames: int, vasa_dim: int = 1018):
        """(F, 512) expression + (F, 3) rotation -> (F, 1, vasa_dim + 6)
        tokens [proj(expr), rot, 0 * trans]; mode 0 (no driving video) gives
        zero tokens."""
        if expr is None:
            tok = torch.zeros(num_frames, 1, vasa_dim + 6, device=self.device)
            return tok, torch.zeros_like(tok)
        e, r = self._t(expr), self._t(rot)
        pose = torch.cat([r, torch.zeros_like(r)], dim=-1)
        cond = torch.cat([self.m.vasa_proj(e), pose], dim=-1)[:, None]
        unc = torch.cat([self.m.vasa_proj(torch.zeros_like(e)),
                         torch.zeros_like(pose)], dim=-1)[:, None]
        return cond, unc

    @torch.no_grad()
    def generate_latents(self, ref_image, id_embed, audio_tokens,
                         uncond_audio_tokens, vasa_tokens, uncond_vasa_tokens,
                         pose_images, config: SamplerConfig, seed: int = 0,
                         audio_mask=None, exp_mask=None, init_noise=None,
                         noise_aug=None) -> torch.Tensor:
        """ref_image (H, W, 3) in [-1, 1]; id_embed (512,); audio tokens
        (F, 32, 1024); vasa tokens (F, 1, 1024); pose_images (F, H, W, 3) in
        [0, 1]; masks (1, 1, H, W). Returns latents (F, h, w, 4) fp32.

        ``init_noise`` (buf, h, w, 4) and ``noise_aug`` (H, W, 3) replace the
        seeded draws of the initial noise and of the reference-image noise
        augmentation (tests feed both packages the same numpy noise)."""
        m = self.m
        num_frames = audio_tokens.shape[0]
        plan = make_plan(config, num_frames)
        buf = plan.buffer_len
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sf = m.vae.config.scaling_factor

        ref = self._t(ref_image)[None]
        ref_latent = m.vae.encode(ref)[0] * sf
        if noise_aug is None:
            noise_aug = torch.randn(ref.shape[1:], generator=gen,
                                    device=self.device)
        ref_aug = ref + config.noise_aug_strength * self._t(noise_aug)[None]
        image_latent = m.vae.encode(ref_aug)[0]      # unscaled

        id_tok = m.id_proj(self._t(id_embed)[None])  # (1, 1024)
        pose_idx = np.arange(buf) % num_frames
        pose_fea = m.pose_guider(self._t(pose_images)[pose_idx][None])[0]

        def pad_to_buf(cond, uncond):
            cond, uncond = self._t(cond), self._t(uncond)
            pad = uncond[:1].expand((buf - cond.shape[0],) + tuple(cond.shape[1:]))
            return torch.cat([cond, pad]), torch.cat([uncond, pad])

        audio_b, audio_u = pad_to_buf(audio_tokens, uncond_audio_tokens)
        vasa_b, vasa_u = pad_to_buf(vasa_tokens, uncond_vasa_tokens)
        hm, wm = ref_image.shape[:2]
        ones = torch.ones(1, 1, hm, wm, device=self.device)
        buffers = CondBuffers(
            id_tokens=id_tok[:, None].expand(buf, 1, id_tok.shape[-1]),
            audio_tokens=audio_b, audio_tokens_u=audio_u,
            vasa_tokens=vasa_b, vasa_tokens_u=vasa_u,
            image_latents=image_latent.expand((buf,) + tuple(image_latent.shape)),
            pose_fea=pose_fea,
            audio_mask=ones if audio_mask is None else self._t(audio_mask),
            exp_mask=ones if exp_mask is None else self._t(exp_mask),
        )
        latents = sample_video(
            m.unet, config, plan, buffers, ref_latent, generator=gen,
            dtype=self.dtype,
            init_noise=None if init_noise is None else self._t(init_noise))
        return latents[:num_frames]

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, decode_chunk_size: int = 10
                       ) -> np.ndarray:
        """(F, h, w, 4) -> (F, H, W, 3) float32 in [-1, 1], decoded in chunks
        of ``decode_chunk_size`` frames; the last chunk is decoded at its own
        length, as the reference's ``vae.decode(z, num_frames)`` does (the
        temporal decoder mixes frames, so padding it would change them)."""
        scale = 1.0 / self.m.vae.config.scaling_factor
        frames = [self.m.vae.decode(latents[i:i + decode_chunk_size][None] * scale)[0]
                  for i in range(0, latents.shape[0], decode_chunk_size)]
        return torch.cat(frames).float().cpu().numpy()
