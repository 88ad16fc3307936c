"""Clip generation: conditioning encoders, the sliding-window sampler and the
chunked VAE decode. Twin of ``actalker_tpu/pipeline/pipeline.py``: whisper
windows (``encode_audio_windows``) -> per-frame audio tokens
(``audio_tokens_per_frame``); the VASA towers over driving-video crops
(``encode_vasa_video``) -> expression tokens (``vasa_tokens``);
``generate_latents`` (VAE encode, identity and pose features, the ring
buffers, the sampler) and ``decode_latents``.

Buffer semantics follow the reference: audio/vasa buffers past
``num_frames`` hold the unconditional tokens; masks default to all ones
(mode 2), and modes 0/1 gate the inactive branch off in the sampler. With a
face-box mask in modes 0/1, ``_capacity_fracs`` turns the box into the SSM
blocks' static scan budget (their gather path).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from actalker_tpu_torch.models.attention_blocks import downsample_ip_mask
from actalker_tpu_torch.models.pose_guider import PoseGuider
from actalker_tpu_torch.models.projections import (
    AudioProjModel, IDProjModel, VasaProjModel)
from actalker_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporalCondition
from actalker_tpu_torch.models.vae import AutoencoderKLTemporalDecoder, VAEConfig
from actalker_tpu_torch.models.vasa import HeadExpression, HeadPose
from actalker_tpu_torch.models.whisper import WhisperEncoder
from actalker_tpu_torch.pipeline.sampler import (
    CondBuffers, SamplerConfig, make_plan, sample_video_batch)
from actalker_tpu_torch.pipeline.serving import stack_buffers


def budget_of(fracs):
    """The SSM blocks' budget from the (audio, expression) selected
    fractions: None (masked-dense) when either exceeds 0.75."""
    return None if max(fracs) > 0.75 else tuple(fracs)


@dataclasses.dataclass
class PipelineModules:
    unet: UNetSpatioTemporalCondition
    vae: AutoencoderKLTemporalDecoder
    audio_proj: AudioProjModel
    id_proj: IDProjModel
    vasa_proj: VasaProjModel
    pose_guider: PoseGuider
    whisper: WhisperEncoder
    # the VASA towers; None when their checkpoint is absent (modes 1 / 2
    # then take zero expression tokens)
    vasa_expression: Optional[HeadExpression] = None
    vasa_pose: Optional[HeadPose] = None

    @classmethod
    def create(cls, unet_config: Optional[UNetConfig] = None,
               vae_config: Optional[VAEConfig] = None,
               dtype: torch.dtype = torch.bfloat16,
               vae_dtype: torch.dtype = torch.float32,
               vasa_expression_dim: int = 1018) -> "PipelineModules":
        """``dtype`` is the UNet's compute dtype and ``vae_dtype`` the VAE's;
        the projection heads, the PoseGuider and the encoders compute in
        fp32. Build under
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
            whisper=WhisperEncoder(),
            vasa_expression=HeadExpression(),
            vasa_pose=HeadPose(),
        )

    def named(self):
        """name -> module, the absent VASA towers left out."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}


class ACTalkerPipeline:
    """``gather=False`` keeps the SSM blocks on their masked-dense scan
    whatever the masks (the gather's yardstick)."""

    def __init__(self, modules: PipelineModules, dtype=torch.bfloat16,
                 gather: bool = True):
        self.m = modules
        self.dtype = dtype
        self.gather = gather
        self.device = next(modules.unet.parameters()).device

    def _t(self, x):
        """numpy or tensor input -> fp32 tensor on the pipeline's device."""
        if not torch.is_tensor(x):
            x = torch.tensor(np.asarray(x))
        return x.to(device=self.device, dtype=torch.float32)

    @torch.no_grad()
    def encode_audio_windows(self, mel) -> torch.Tensor:
        """mel (B, 80, T) -> stacked whisper states (B, T // 2, 5, 384)."""
        return self.m.whisper(self._t(mel))

    @torch.no_grad()
    def encode_vasa_video(self, face_crops: np.ndarray, pose_crops: np.ndarray,
                          chunk: int = 16):
        """The VASA towers over driving-video crops, ``chunk`` frames a call
        (the last chunk padded with copies of its final crop).

        face_crops: (F, 256, 256, 3) in [0, 1] (the expression tower's
        input); pose_crops: (F, 256, 256, 3) in [0, 1] (the pose tower takes
        ``x * 2 - 1``, the reference's ``Inference.py:494``). Returns numpy
        (expr (F, 512), rot (F, 3)). Needs the VASA towers."""
        if self.m.vasa_expression is None or self.m.vasa_pose is None:
            raise RuntimeError("encode_vasa_video needs the VASA towers "
                               "(vasa_checkpoint_path)")
        exprs, rots = [], []
        n = face_crops.shape[0]
        for i in range(0, n, chunk):
            fc, pc = self._t(face_crops[i:i + chunk]), self._t(pose_crops[i:i + chunk])
            pad = chunk - fc.shape[0]
            if pad:
                fc = torch.cat([fc, fc[-1:].expand((pad,) + tuple(fc.shape[1:]))])
                pc = torch.cat([pc, pc[-1:].expand((pad,) + tuple(pc.shape[1:]))])
            keep = chunk - pad
            exprs.append(self.m.vasa_expression(fc)[:keep].float().cpu().numpy())
            rots.append(self.m.vasa_pose(pc * 2.0 - 1.0)["rotation"][:keep]
                        .float().cpu().numpy())
        return np.concatenate(exprs)[:n], np.concatenate(rots)[:n]

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

    def ssm_strides(self):
        """The latent strides the SSM blocks run at: they ride the
        cross-attention transformers, down level i at stride 2^i, up level
        i at 2^(n-1-i)."""
        ucfg = self.m.unet.config
        n_levels = len(ucfg.down_block_types)
        return sorted(
            {2 ** i for i, bt in enumerate(ucfg.down_block_types)
             if bt.startswith("CrossAttn")}
            | {2 ** (n_levels - 1 - i) for i, bt in enumerate(ucfg.up_block_types)
               if bt.startswith("CrossAttn")}) or [1]

    def _capacity_fracs(self, config: SamplerConfig, audio_mask, exp_mask,
                        latent_hw):
        return budget_of(self._mask_fracs(config, audio_mask, exp_mask,
                                          latent_hw))

    def _mask_fracs(self, config: SamplerConfig, audio_mask, exp_mask,
                    latent_hw):
        """The SSM blocks' static token budgets (``SS2DCondV10``'s
        ``capacity_frac``), computed on the host (twin of the JAX pipeline's).

        Follows the sampler's gate table (modes 0 / 1 zero one branch) and
        measures each region mask's selected fraction at every resolution
        the SSM blocks run at, with the blocks' own ``downsample_ip_mask``,
        so the budget is a true upper bound. Fractions round up to 1/16.
        Returns None (masked-dense) when either budget exceeds 0.75: K1
        walks the longest branch's rows, so the gather pays only when both
        budgets are small (mode 2's all-ones masks stay dense).
        ``_mask_fracs`` gives the two fractions before that choice
        (``budget_of`` makes it): the largest over several identities'
        masks, or over ranks, is their common budget's."""
        ga, gv = config.gate
        h8, w8 = latent_hw
        scales = self.ssm_strides()

        def frac_of(mask, gate_on):
            if not gate_on:
                return 0.0
            if mask is None:
                return 1.0
            m = torch.as_tensor(mask, dtype=torch.float32).cpu()
            if m.min() >= 1.0 - 1e-6:
                return 1.0
            worst = 0.0
            for s in scales:
                l = (h8 // s) * (w8 // s)
                sel = downsample_ip_mask(m, l)[..., 0] >= 1.0 - 1e-6
                worst = max(worst, float(sel.sum(dim=-1).max()) / l)
            return worst

        fa = min(1.0, math.ceil(frac_of(audio_mask, ga) * 16) / 16)
        fe = min(1.0, math.ceil(frac_of(exp_mask, gv) * 16) / 16)
        return (fa, fe)

    @torch.no_grad()
    def prepare_sampling(self, ref_image, id_embed, audio_tokens,
                         uncond_audio_tokens, vasa_tokens, uncond_vasa_tokens,
                         pose_images, config: SamplerConfig, seed: int = 0,
                         audio_mask=None, exp_mask=None, noise_aug=None):
        """The sampler's inputs for one identity: (plan, buffers, ref_latent
        (h, w, 4) scaled, generator). The generator, seeded with ``seed``,
        has drawn the reference-image noise augmentation (unless
        ``noise_aug`` gives it) and next draws the initial noise. Arguments
        as ``generate_latents``."""
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
        return plan, buffers, ref_latent, gen

    @torch.no_grad()
    def generate_latents(self, ref_image, id_embed, audio_tokens,
                         uncond_audio_tokens, vasa_tokens, uncond_vasa_tokens,
                         pose_images, config: SamplerConfig, seed: int = 0,
                         audio_mask=None, exp_mask=None, init_noise=None,
                         noise_aug=None, group=None) -> torch.Tensor:
        """ref_image (H, W, 3) in [-1, 1]; id_embed (512,); audio tokens
        (F, 32, 1024); vasa tokens (F, 1, 1024); pose_images (F, H, W, 3) in
        [0, 1]; masks (1, 1, H, W). Returns latents (F, h, w, 4) fp32.

        ``init_noise`` (buf, h, w, 4) and ``noise_aug`` (H, W, 3) replace the
        seeded draws of the initial noise and of the reference-image noise
        augmentation (tests feed both packages the same numpy noise). With
        face-box masks in modes 0 / 1 the SSM blocks take their gather path
        for this call (``_capacity_fracs``). With a process ``group`` its
        ranks split each denoise step's windows (``sampler.sample_video``);
        every rank passes the same inputs and returns the latents."""
        prepared = [self.prepare_sampling(
            ref_image, id_embed, audio_tokens, uncond_audio_tokens, vasa_tokens,
            uncond_vasa_tokens, pose_images, config, seed, audio_mask,
            exp_mask, noise_aug)]
        caps = budget_of(self._mask_fracs_of(config, prepared)) if self.gather else None
        return self._sample_block(
            prepared, config,
            None if init_noise is None else self._t(init_noise)[None], caps,
            window_group=group)[0]

    @torch.no_grad()
    def generate_latents_batch(self, prepared, config: SamplerConfig,
                               init_noise=None, group=None):
        """Several identities' ``prepare_sampling`` outputs (plan, buffers,
        ref_latent, generator), all of one frame count, through one
        ``sampler.sample_video_batch`` loop whose UNet calls stack them.
        Returns latents (I, F, h, w, 4) fp32; ``init_noise`` (I, buf, h, w,
        4) replaces the generators' initial draws.

        The SSM budget is one for the whole call, as under the JAX
        package's identity vmap: ``_capacity_fracs`` of the stacked masks,
        set for this call and restored after.

        With a process ``group`` (the JAX package's ``mesh=``) the call is
        collective: ``prepared`` (and ``init_noise``) hold this rank's
        contiguous block of the identities (``parallel.distributed.
        rank_block``; possibly none), the budget's fractions are the MAX
        over the ranks', so identity i comes out as in the single-process
        call, and rank 0 returns every identity's latents in rank order
        while the other ranks return None."""
        if group is None:
            caps = budget_of(self._mask_fracs_of(config, prepared)) \
                if self.gather else None
            return self._sample_block(prepared, config, init_noise, caps)
        from actalker_tpu_torch.parallel import distributed as P

        caps = None
        if self.gather:
            fr = self._mask_fracs_of(config, prepared) if prepared else (0.0, 0.0)
            caps = budget_of(tuple(P.all_reduce_max(list(fr), self.device, group)))
        block = self._sample_block(prepared, config, init_noise, caps) \
            if prepared else None
        return P.gather_blocks(block, self.device, torch.float32, group)

    def _mask_fracs_of(self, config: SamplerConfig, prepared):
        buffers = stack_buffers([p[1] for p in prepared])
        return self._mask_fracs(config, buffers.audio_mask[:, 0],
                                buffers.exp_mask[:, 0], prepared[0][2].shape[:2])

    def _sample_block(self, prepared, config: SamplerConfig, init_noise, caps,
                      window_group=None):
        """``prepared``'s identities through one sampler loop under the SSM
        budget ``caps`` (restored after), each step's windows split over
        ``window_group``'s ranks where it is given."""
        plan = prepared[0][0]
        if any(p[0].num_frames != plan.num_frames for p in prepared):
            raise ValueError("identities of one call need one frame count")
        buffers = stack_buffers([p[1] for p in prepared])
        refs = torch.stack([p[2] for p in prepared])
        unet = self.m.unet
        saved = unet.config.mask_capacity
        unet.set_mask_capacity(caps)
        try:
            latents = sample_video_batch(
                unet, config, plan, buffers, refs,
                generators=[p[3] for p in prepared], dtype=self.dtype,
                init_noise=init_noise, window_group=window_group)
        finally:
            unet.set_mask_capacity(saved)
        return latents[:, :plan.num_frames]

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
