"""Long-video sliding-window diffusion sampler, twin of
``actalker_tpu/pipeline/sampler.py``.

Reference semantics kept: the 4-way CFG batch ``[uncond, drop_audio+vasa,
drop_vasa, full]`` combined as ``u + g1(a-u) + g2(b-a) + g3(c-b)``; a latent
ring buffer of ``num_frames + frames_per_batch`` frames whose windows start
at ``range(0, buf, fpb - overlap) - shift`` with ``shift`` advancing by
``shift_offset`` each step; one Euler step per window at the step's sigma;
window outputs averaged back into the buffer; mode gating of the audio /
vasa branches.

The denoise loop is a Python loop over steps. Within a step the windows run
``windows_per_call`` at a time (0 = all in one UNet batch; the output is the
same either way), and the overlap average is an ``index_add_`` plus counts.
With churn on, each step's noise is drawn for all its windows at once, so
the chunking does not change it.

``sample_video(..., group=)`` splits each step's windows over the ranks of
a process group (the JAX sampler's ``window_sharding``: the windows of a
step read only the previous step's buffer): a rank denoises a contiguous
block of them (``parallel.distributed.rank_block``, ``windows_per_call`` at
a time), ``index_add_``s its outputs into a zero fp32 buffer, and one
all-reduce (sum) gives every rank the step's whole sum; the counts come
from the plan. Every rank draws the step's churn for all windows from its
generator and keeps its own rows, so each window gets the noise the single
process gives it.

One loop serves one identity (``sample_video``) and several
(``sample_video_batch``, the entry of ``pipeline/serving.py``): every
buffer carries a leading identity axis, and a UNet call stacks the
identities, in the batch order identity, window, CFG branch, frame.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from actalker_tpu_torch.diffusion import noise as noise_lib
from actalker_tpu_torch.diffusion import scheduler as sch
from actalker_tpu_torch.models.conditioning import Conditioning


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_inference_steps: int = 25
    frames_per_batch: int = 25       # window length
    overlap: int = 0
    shift_offset: int = 7
    fps: float = 12.5
    motion_bucket_id: float = 12.0
    motion_bucket_id_exp: float = 20.0
    noise_aug_strength: float = 0.0
    min_guidance1: float = 2.0       # appearance
    max_guidance1: float = 2.0
    guidance2: float = 7.5           # audio
    guidance3: float = 3.0           # vasa
    i2i_noise_strength: float = 1.0
    gate: Tuple[int, int] = (1, 1)   # (audio, vasa): mode 0 (1,0), 1 (0,1), 2 (1,1)
    windows_per_call: int = 0        # 0 = all windows in one UNet batch
    # ancestral churn (the production sampler keeps s_churn = 0)
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0
    noise_type: str = "random"       # churn draw: "random" | "video_fusion"
    w_ind_noise: float = 0.5
    scheduler: sch.EulerDiscreteConfig = sch.EulerDiscreteConfig()


@dataclasses.dataclass(frozen=True)
class SamplerPlan:
    """Host-computed tables of the loop."""

    sigmas: np.ndarray          # (steps + 1,)
    timesteps: np.ndarray       # (steps,) continuous EDM timesteps
    guidance1: np.ndarray       # (steps,)
    guidance2: np.ndarray
    guidance3: np.ndarray
    gammas: np.ndarray          # (steps,) churn gamma (0 = none)
    window_idx: np.ndarray      # (steps, n_windows, fpb) buffer indices
    buffer_len: int
    num_frames: int


@dataclasses.dataclass
class CondBuffers:
    """Per-frame conditioning ring buffers (length buffer_len); ``*_u`` are
    the unconditional variants."""

    id_tokens: torch.Tensor        # (buf, 1, d)
    audio_tokens: torch.Tensor     # (buf, 32, d)
    audio_tokens_u: torch.Tensor
    vasa_tokens: torch.Tensor      # (buf, 1, d)
    vasa_tokens_u: torch.Tensor
    image_latents: torch.Tensor    # (buf, h, w, 4) unscaled VAE mode
    pose_fea: torch.Tensor         # (buf, h, w, 320)
    audio_mask: Optional[torch.Tensor]   # (1, 1, H, W)
    exp_mask: Optional[torch.Tensor]
    ip_scales: Tuple[float, float] = (1.25, 1.25)


def make_plan(cfg: SamplerConfig, num_frames: int) -> SamplerPlan:
    sigmas, timesteps = sch.set_timesteps(cfg.scheduler, cfg.num_inference_steps)
    sigmas, timesteps, n = sch.i2i_truncate(
        sigmas, timesteps, cfg.num_inference_steps, cfg.i2i_noise_strength)
    fpb = cfg.frames_per_batch
    buf = num_frames + fpb
    starts0 = np.arange(0, buf, fpb - cfg.overlap)
    window_idx = np.zeros((n, len(starts0), fpb), np.int64)
    shift = 0
    for i in range(n):
        idx = (starts0 - shift)[:, None] + np.arange(fpb)[None, :]
        window_idx[i] = np.mod(idx, buf)
        shift = (shift + cfg.shift_offset) % fpb
    gam = min(cfg.s_churn / max(len(sigmas) - 1, 1), 2 ** 0.5 - 1)
    gammas = np.where((sigmas[:-1] >= cfg.s_tmin) & (sigmas[:-1] <= cfg.s_tmax),
                      gam, 0.0).astype(np.float32)
    return SamplerPlan(
        sigmas=sigmas, timesteps=timesteps,
        guidance1=np.linspace(cfg.min_guidance1, cfg.max_guidance1, n
                              ).astype(np.float32),
        guidance2=np.full((n,), cfg.guidance2, np.float32),
        guidance3=np.full((n,), cfg.guidance3, np.float32),
        gammas=gammas, window_idx=window_idx, buffer_len=buf,
        num_frames=num_frames)


def _cfg_conditioning(buffers: CondBuffers, idx: torch.Tensor,
                      cfg: SamplerConfig, dtype) -> Conditioning:
    """4-way-CFG conditioning for the windows ``idx`` (nw, fpb) of buffers
    with a leading identity axis, stacked identity-major, then window, then
    [uncond, drop_audio+vasa, drop_vasa, full], then frames: the UNet's
    (batch, frame) order. The masks keep one row per identity (Bm = I),
    which the blocks repeat over that identity's rows."""
    ga, gv = cfg.gate

    def take(t, gate=1):
        return t[:, idx].to(dtype) * gate

    id_c = take(buffers.id_tokens)                 # (I, nw, fpb, 1, d)
    au_c, au_u = take(buffers.audio_tokens, ga), take(buffers.audio_tokens_u, ga)
    va_c, va_u = take(buffers.vasa_tokens, gv), take(buffers.vasa_tokens_u, gv)

    def stack4(a, b, c, d):                        # -> (I * nw * 4 * fpb, ...)
        s = torch.stack([a, b, c, d], dim=2)
        return s.reshape(-1, *s.shape[4:])

    id_tokens = stack4(torch.zeros_like(id_c), id_c, id_c, id_c)
    audio = stack4(au_u, au_u, au_c, au_c)
    vasa = stack4(va_u, va_u, va_u, va_c)
    am, em = (None if m is None else m.reshape(-1, *m.shape[2:])
              for m in (buffers.audio_mask, buffers.exp_mask))
    if ga and not gv:
        em = None if am is None else torch.zeros_like(am)
    elif not ga:
        am = None if em is None else torch.zeros_like(em)
    return Conditioning(id_tokens=id_tokens, audio_tokens=audio,
                        vasa_tokens=vasa, audio_mask=am, exp_mask=em,
                        ip_scales=buffers.ip_scales)


def _churn_noise(cfg: SamplerConfig, shape, generator, dev) -> torch.Tensor:
    """The churn draw for windows ``shape`` (nw, fpb, h, w, 4): a standard
    normal, or with ``noise_type="video_fusion"`` one correlated draw per
    window (common over its frames, ``w_ind_noise`` of it per frame)."""
    if cfg.noise_type == "video_fusion":
        nw, fpb, h, w, c = shape
        n5 = noise_lib.video_fusion_noise(generator, (nw, fpb, c, h, w),
                                          cfg.w_ind_noise, device=dev)
        return n5.permute(0, 1, 3, 4, 2)
    if cfg.noise_type != "random":
        raise ValueError(f"noise_type {cfg.noise_type!r}: 'random' or "
                         "'video_fusion'")
    return torch.randn(shape, generator=generator, device=dev)


def _identity_axis(buffers: CondBuffers) -> CondBuffers:
    """One identity's buffers with a leading identity axis of 1."""
    return dataclasses.replace(buffers, **{
        f.name: getattr(buffers, f.name)[None] for f in dataclasses.fields(buffers)
        if torch.is_tensor(getattr(buffers, f.name))})


@torch.no_grad()
def sample_video(unet, cfg: SamplerConfig, plan: SamplerPlan,
                 buffers: CondBuffers, ref_latent: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 init_noise: Optional[torch.Tensor] = None,
                 group=None) -> torch.Tensor:
    """Runs the denoise loop for one identity; returns latents (buffer_len,
    h, w, 4) fp32.

    ``ref_latent``: (h, w, 4) scaled VAE mean. ``init_noise``: optional
    (buffer_len, h, w, 4) initial noise replacing the draw from
    ``generator`` (tests feed both packages the same numpy noise).
    ``group``: a process group whose ranks split each step's windows
    (module docstring); every rank passes the same inputs and a generator
    in the same state, and every rank returns the latents."""
    return sample_video_batch(
        unet, cfg, plan, _identity_axis(buffers), ref_latent[None],
        generators=[generator], dtype=dtype,
        init_noise=None if init_noise is None else init_noise[None],
        window_group=group)[0]


@torch.no_grad()
def sample_video_batch(unet, cfg: SamplerConfig, plan: SamplerPlan,
                       buffers: CondBuffers, ref_latents: torch.Tensor,
                       generators: Optional[Sequence[Optional[torch.Generator]]] = None,
                       dtype: torch.dtype = torch.bfloat16,
                       init_noise: Optional[torch.Tensor] = None,
                       window_group=None) -> torch.Tensor:
    """Runs the denoise loop for I identities in one loop whose UNet calls
    stack them; returns latents (I, buffer_len, h, w, 4) fp32.

    ``buffers``: every tensor field with a leading identity axis (masks
    (I, 1, 1, H, W)); ``ref_latents``: (I, h, w, 4). Identity i draws its
    initial noise (unless ``init_noise`` (I, buffer_len, h, w, 4) gives it)
    and its churn from ``generators[i]``, so it equals ``sample_video`` on
    its own buffers and generator. ``window_group``: the process group
    that splits each step's windows (``sample_video``'s ``group``)."""
    dev = ref_latents.device
    fpb, buf = cfg.frames_per_batch, plan.buffer_len
    n_id, h, w, _ = ref_latents.shape
    gens = list(generators) if generators is not None else [None] * n_id
    if len(gens) != n_id:
        raise ValueError(f"{len(gens)} generators for {n_id} identities")
    if init_noise is None:
        noise = torch.stack([torch.randn((buf, h, w, 4), generator=g, device=dev)
                             for g in gens])
    else:
        noise = init_noise.to(device=dev, dtype=torch.float32)
    latents = sch.add_noise(ref_latents.float()[:, None].expand(n_id, buf, h, w, 4),
                            noise, float(plan.sigmas[0]))
    n_win = plan.window_idx.shape[1]
    mine = range(n_win)
    if window_group is not None:
        from actalker_tpu_torch.parallel import distributed as P

        block = P.rank_block(n_win, P.world_size(window_group),
                             P.get_rank(window_group))
        mine = range(block.start, block.stop)
    per_call = cfg.windows_per_call or max(len(mine), 1)
    tids = torch.tensor([cfg.fps, cfg.motion_bucket_id,
                         cfg.motion_bucket_id_exp], dtype=dtype, device=dev)

    for i in range(len(plan.timesteps)):
        sigma, sigma_next = float(plan.sigmas[i]), float(plan.sigmas[i + 1])
        g1, g2, g3 = (float(plan.guidance1[i]), float(plan.guidance2[i]),
                      float(plan.guidance3[i]))
        gamma = float(plan.gammas[i])
        t_cont = torch.tensor(float(plan.timesteps[i]), dtype=dtype, device=dev)
        w_idx = torch.as_tensor(plan.window_idx[i], device=dev)
        churn_all = None
        if gamma > 0:            # the step's churn for every window
            churn_all = torch.stack([_churn_noise(cfg, (n_win, fpb, h, w, 4), g, dev)
                                     for g in gens])
        summed = torch.zeros_like(latents)
        for w0 in range(mine.start, mine.stop, per_call):
            w1 = min(w0 + per_call, mine.stop)
            idx = w_idx[w0:w1]                              # (nw, fpb)
            nw = idx.shape[0]
            lat = latents[:, idx]                           # (I, nw, fpb, h, w, 4)
            scaled = sch.scale_model_input(lat, sigma).to(dtype)
            img = buffers.image_latents[:, idx].to(dtype)
            inp = torch.cat([
                scaled[:, :, None].expand(n_id, nw, 4, fpb, h, w, 4),
                torch.stack([torch.zeros_like(img), img, img, img], dim=2),
            ], dim=-1).reshape(n_id * nw * 4, fpb, h, w, 8)
            pose = buffers.pose_fea[:, idx].to(dtype)[:, :, None].expand(
                n_id, nw, 4, fpb, h, w, -1).reshape(n_id * nw * 4, fpb, h, w, -1)
            cond = _cfg_conditioning(buffers, idx, cfg, dtype)
            pred = unet(inp, t_cont, cond, tids.expand(n_id * nw * 4, 3), pose)
            pred = pred.float().reshape(n_id, nw, 4, fpb, h, w, 4)
            u, a, b, c = pred.unbind(dim=2)
            noise_pred = u + g1 * (a - u) + g2 * (b - a) + g3 * (c - b)
            out = sch.step(lat, noise_pred, sigma, sigma_next,
                           cfg.scheduler.prediction_type, gamma=gamma,
                           noise=None if churn_all is None else churn_all[:, w0:w1],
                           s_noise=cfg.s_noise)
            summed.index_add_(1, idx.reshape(-1), out.reshape(n_id, nw * fpb, h, w, 4))
        if window_group is not None:
            torch.distributed.all_reduce(summed, group=window_group)
        counts = torch.bincount(w_idx.reshape(-1), minlength=buf).to(summed.dtype)
        latents = summed / counts[:, None, None, None]
    return latents
