"""The reference's fine-tuning step, plain fp32: the EDM diffusion loss of
SVD fine-tuning with conditioning dropout and offset noise, its gradient,
and MultiSteps(clip_by_global_norm, AdamW) over an accumulation of k
micro-steps.

    sigma = exp(P_mean + P_std n),  x_s = x0 + sigma (noise + offset o)
    D(x) = c_skip x_s + c_out F(c_in x_s; 0.25 ln sigma)
    loss = mean((1 + sigma^2) / sigma^2 (D - x0)^2)

c_skip = 1 / (1 + s^2), c_out = -s / sqrt(1 + s^2), c_in = 1 / sqrt(1 + s^2).
A dropped sample's conditioning inputs are zeroed before its heads.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference.unet import Cond


def loss_of(mods: Dict[str, torch.nn.Module], batch: dict, draws: dict,
            cfg: dict, keep_frames=None) -> torch.Tensor:
    """``batch``: latents (B, F, h, w, 4), ref_latents (B, h, w, 4),
    audio_feats (B, F, 10, 5, 384), id_embed (B, 512), vasa_expr (B, F,
    512), vasa_rot (B, F, 3), pose_pixels (B, H, W, 3), audio_mask /
    exp_mask (B, 1, H, W), motion_buckets (B, 2), fps (B,). ``draws``:
    sigma_normal (B,), noise (latents' shape), offset (B, 1, 1, 1, 1),
    drop (B,) bool. ``keep_frames`` takes the mean over the first frames
    only (a fault the check must catch)."""
    x0 = batch["latents"]
    b, f = x0.shape[:2]
    sigma = torch.exp(cfg["sigma_p_mean"] + cfg["sigma_p_std"] * draws["sigma_normal"])
    s = sigma.reshape(b, 1, 1, 1, 1)
    x_s = x0 + s * (draws["noise"] + cfg["noise_offset"] * draws["offset"])
    keep = torch.where(draws["drop"], 0.0, 1.0)
    audio = mods["audio_proj"](batch["audio_feats"] * keep[:, None, None, None, None])
    idt = mods["id_proj"](batch["id_embed"] * keep[:, None])[:, None]
    rot = batch["vasa_rot"] * keep[:, None, None]
    vasa = torch.cat([mods["vasa_proj"](batch["vasa_expr"] * keep[:, None, None]),
                      rot, torch.zeros_like(rot)], dim=-1)[:, :, None]
    px = batch["pose_pixels"]
    pose = mods["pose_guider"](px[:, None].expand(b, f, *px.shape[1:]))
    cond = Cond(idt.repeat_interleave(f, 0), audio.reshape(b * f, *audio.shape[2:]),
                vasa.reshape(b * f, *vasa.shape[2:]), batch["audio_mask"],
                batch["exp_mask"])
    c_in = 1.0 / torch.sqrt(s ** 2 + 1.0)
    ref = batch["ref_latents"][:, None].expand(x0.shape)
    added = torch.stack([batch["fps"], batch["motion_buckets"][:, 0],
                         batch["motion_buckets"][:, 1]], dim=-1)
    out = mods["unet"](torch.cat([c_in * x_s, ref], dim=-1), 0.25 * torch.log(sigma),
                       cond, added, pose)
    denoised = x_s / (s ** 2 + 1.0) - s / torch.sqrt(s ** 2 + 1.0) * out
    err = (s ** 2 + 1.0) / s ** 2 * (denoised - x0) ** 2
    return torch.mean(err if keep_frames is None else err[:, :keep_frames])


class AdamW:
    """MultiSteps(chain(clip_by_global_norm(max), adamw), k) written out:
    gradients of k micro-steps summed, their mean clipped to the global
    norm ``max`` (g max / norm when norm >= max), then AdamW with
    decoupled decay and bias correction."""

    def __init__(self, params: List[torch.Tensor], cfg: dict):
        self.params, self.cfg = params, cfg
        self.k = int(cfg["gradient_accumulation_steps"])
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = self.micro = 0
        self.first_grads = None          # the first commit's clipped mean

    @torch.no_grad()
    def step(self) -> bool:
        self.micro += 1
        if self.micro < self.k:
            return False
        self.micro = 0
        c = self.cfg
        grads = [(p.grad if p.grad is not None else torch.zeros_like(p)) / self.k
                 for p in self.params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        if norm >= c["max_grad_norm"]:
            grads = [g * (c["max_grad_norm"] / norm).float() for g in grads]
        if self.first_grads is None:
            self.first_grads = [g.norm().item() for g in grads]
        self.t += 1
        lr, b1, b2 = c["learning_rate"], c["adam_beta1"], c["adam_beta2"]
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1.0 - lr * c["adam_weight_decay"])
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (v / (1.0 - b2 ** self.t)).sqrt_().add_(c["adam_epsilon"])
            p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** self.t))
            p.grad = None
        return True
