"""Training step: EDM diffusion fine-tuning of the UNet and its conditioning
heads. Twin of ``actalker_tpu/training/trainer.py``:

    sigma ~ exp(N(P_mean, P_std))            (log-normal EDM sampling)
    x_sigma = x0 + sigma * n                  (+ offset noise)
    D(x) = c_skip x_sigma + c_out F(c_in x_sigma; 0.25 ln sigma)
    loss = lambda(sigma) * ||D(x) - x0||^2,  lambda = (1 + sigma^2) / sigma^2

with c_skip = 1/(1+sigma^2), c_out = -sigma/sqrt(1+sigma^2), c_in =
1/sqrt(1+sigma^2), per-sample conditioning dropout and raw-head batches
(the heads run inside the differentiable step, so all five trainable
artifacts get gradients). The JAX package's pre-encoded batches (UNet-only
training on ``--metadata`` tokens) are not ported.

The optimizer is ``optax.MultiSteps(chain(clip_by_global_norm, adamw), k)``
written out: gradients of k micro-steps are summed in ``.grad`` and their
mean is clipped as ``g / norm * max_norm`` when ``norm >= max_norm``, then
``torch.optim.AdamW`` (decoupled decay, the same beta / eps) applies it on
every k-th micro-step. Parameters (fp32 masters) and optimizer state are
fp32; the UNet computes in ``dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn

from actalker_tpu_torch.models.conditioning import Conditioning


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 4
    cond_dropout_prob: float = 0.10
    noise_offset: float = 0.05
    sigma_p_mean: float = 0.7
    sigma_p_std: float = 1.6


class TrainBatch(NamedTuple):
    """One raw-head batch in the JAX package's layouts (channels last): the
    conditioning fields are the inputs of the trainable heads, which run
    inside the differentiable step."""

    latents: torch.Tensor        # (B, F, h, w, 4) clean video latents
    ref_latents: torch.Tensor    # (B, h, w, 4) reference latent
    audio_feats: torch.Tensor    # (B, F, 10, 5, 384)
    id_embed: torch.Tensor       # (B, 512)
    vasa_expr: torch.Tensor      # (B, F, 512)
    vasa_rot: torch.Tensor       # (B, F, 3)
    pose_pixels: torch.Tensor    # (B[, F], H, W, 3)
    motion_buckets: torch.Tensor  # (B, 2)
    fps: torch.Tensor            # (B,)
    audio_mask: Optional[torch.Tensor] = None    # (B, 1, H, W)
    exp_mask: Optional[torch.Tensor] = None      # (B, 1, H, W)


class LossDraws(NamedTuple):
    """The four random draws of one ``diffusion_loss`` call (JAX draws them
    from ``jax.random.split(key, 4)``)."""

    sigma_normal: torch.Tensor   # (B,) standard normal
    noise: torch.Tensor          # latents' shape, standard normal
    offset: torch.Tensor         # (B, 1, 1, 1, 1) standard normal
    drop: torch.Tensor           # (B,) bool, conditioning dropped


def sample_draws(batch: TrainBatch, cfg: TrainConfig,
                 generator: torch.Generator) -> LossDraws:
    lat = batch.latents
    b, dev = lat.shape[0], lat.device
    kw = dict(generator=generator, device=dev)
    return LossDraws(torch.randn(b, **kw), torch.randn(lat.shape, **kw),
                     torch.randn(b, 1, 1, 1, 1, **kw),
                     torch.rand(b, **kw) < cfg.cond_dropout_prob)


def head_tokens(modules: Dict[str, nn.Module], batch: TrainBatch,
                keep: torch.Tensor, dtype=torch.bfloat16):
    """Run the trainable heads inside the differentiable graph. ``keep`` (B,)
    is 1.0 / 0.0; a dropped sample's raw inputs are zeroed before the
    projection, so it equals the inference pipeline's unconditional
    branch. Returns (id (B,1,d), audio (B,F,32,d), vasa (B,F,1,d),
    pose_fea (B,F,h,w,c0))."""
    b, f = batch.latents.shape[:2]
    audio = modules["audio_proj"](
        (batch.audio_feats * keep[:, None, None, None, None]).float())
    idt = modules["id_proj"](batch.id_embed * keep[:, None])[:, None, :]
    proj = modules["vasa_proj"](batch.vasa_expr * keep[:, None, None])
    rot = batch.vasa_rot * keep[:, None, None]
    # rotation + translation * 0 (reference Inference.py:498-505)
    pose6 = torch.cat([rot, torch.zeros_like(rot)], dim=-1)
    vasa = torch.cat([proj, pose6], dim=-1)[:, :, None, :]
    px = batch.pose_pixels
    if px.ndim == 4:     # one static pose image for every frame
        px = px[:, None].expand(b, f, *px.shape[1:])
    # the JAX guider computes in fp32 on the input rounded to ``dtype``
    pose_fea = modules["pose_guider"](px.to(dtype).float())
    return idt, audio, vasa, pose_fea


def diffusion_loss(modules: Dict[str, nn.Module], batch: TrainBatch,
                   cfg: TrainConfig, draws: Optional[LossDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.bfloat16):
    """Scalar loss and metrics. The random draws come from ``draws`` or, if
    it is None, from ``generator``."""
    if draws is None:
        draws = sample_draws(batch, cfg, generator)
    b, f = batch.latents.shape[:2]
    sigma = torch.exp(cfg.sigma_p_mean
                      + cfg.sigma_p_std * draws.sigma_normal.float())
    sig = sigma.reshape(b, 1, 1, 1, 1)
    noise = draws.noise.float()
    if cfg.noise_offset:
        noise = noise + cfg.noise_offset * draws.offset.float()
    x0 = batch.latents.float()
    x_sigma = x0 + sig * noise

    keep = torch.where(draws.drop, 0.0, 1.0).to(x0.device)
    id_tok, audio, vasa, pose_fea = head_tokens(modules, batch, keep, dtype)
    cond = Conditioning(
        id_tokens=id_tok.repeat_interleave(f, dim=0).to(dtype),
        audio_tokens=audio.reshape(b * f, *audio.shape[2:]).to(dtype),
        vasa_tokens=vasa.reshape(b * f, *vasa.shape[2:]).to(dtype),
        audio_mask=batch.audio_mask, exp_mask=batch.exp_mask)

    c_in = 1.0 / torch.sqrt(sig ** 2 + 1.0)
    c_skip = 1.0 / (sig ** 2 + 1.0)
    c_out = -sig / torch.sqrt(sig ** 2 + 1.0)
    t_cont = 0.25 * torch.log(sigma)
    ref = batch.ref_latents[:, None].float().expand(x0.shape)
    inp = torch.cat([c_in * x_sigma, ref], dim=-1).to(dtype)
    added = torch.stack([batch.fps, batch.motion_buckets[:, 0],
                         batch.motion_buckets[:, 1]], dim=-1).to(dtype)
    model_out = modules["unet"](inp, t_cont.to(dtype), cond, added,
                                pose_fea.to(dtype)).float()
    denoised = c_skip * x_sigma + c_out * model_out
    weight = (sig ** 2 + 1.0) / sig ** 2
    loss = torch.mean(weight * torch.square(denoised - x0))
    return loss, {"loss": loss.detach(), "sigma_mean": sigma.mean().detach()}


class Optimizer:
    """``optax.MultiSteps(chain(clip_by_global_norm(max), adamw(...)), k)``:
    call ``step()`` after every micro-step's backward. Gradients sum in
    ``.grad``; every k-th call divides by k, clips by the global norm and
    applies AdamW, then clears them. A parameter the forward never reads
    gets a zero gradient at the commit, so AdamW still decays it, as
    ``optax.adamw`` decays every parameter."""

    def __init__(self, params, cfg: TrainConfig):
        self.params = [p for p in params if p.requires_grad]
        self.k = max(1, cfg.grad_accum_steps)
        self.max_norm = cfg.max_grad_norm
        self.mini_step = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=cfg.learning_rate, betas=(cfg.adam_b1, cfg.adam_b2),
            eps=cfg.adam_eps, weight_decay=cfg.weight_decay)

    def step(self):
        """Returns (committed, global norm of the applied mean gradient or
        None)."""
        self.mini_step += 1
        if self.mini_step < self.k:
            return False, None
        self.mini_step = 0
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.k > 1:
            torch._foreach_div_(grads, float(self.k))
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        # optax: where(norm < max, g, g / norm * max)
        clip = norm >= self.max_norm
        torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
        torch._foreach_mul_(grads, torch.where(clip, self.max_norm, 1.0))
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        return True, norm


def make_optimizer(modules: Dict[str, nn.Module], cfg: TrainConfig) -> Optimizer:
    return Optimizer([p for m in modules.values() for p in m.parameters()], cfg)


class Trainer:
    """One differentiable micro-step over the trainable modules (``unet``,
    ``pose_guider``, ``audio_proj``, ``id_proj``, ``vasa_proj``; the
    IP-adapter rows live in the UNet) followed by the optimizer."""

    def __init__(self, modules: Dict[str, nn.Module], cfg: TrainConfig,
                 dtype=torch.bfloat16):
        self.modules, self.cfg, self.dtype = modules, cfg, dtype
        self.optimizer = make_optimizer(modules, cfg)

    def step(self, batch: TrainBatch, draws: Optional[LossDraws] = None,
             generator: Optional[torch.Generator] = None) -> Dict:
        loss, metrics = diffusion_loss(self.modules, batch, self.cfg, draws,
                                       generator, self.dtype)
        loss.backward()
        metrics["commit"], metrics["grad_norm"] = self.optimizer.step()
        return metrics
