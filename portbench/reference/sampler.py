"""The reference's sampler: SVD-XT's Euler-discrete schedule (EDM Karras
sigmas, v-prediction), the sliding windows of the long-video loop, the
4-way classifier-free guidance and one Euler step per window, the window
outputs averaged back into the latent ring buffer.

Written from the published description (diffusers'
``EulerDiscreteScheduler`` of SVD-XT 1.1 and ACTalker's sampler), float64
tables on the host, float32 tensors on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from portbench.reference.unet import Cond


@dataclasses.dataclass(frozen=True)
class Schedule:
    """SVD-XT 1.1's scheduler: Karras sigmas in [0.002, 700] with rho 7,
    continuous timesteps 0.25 ln sigma."""

    steps: int = 25
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0

    def _sigmas64(self) -> np.ndarray:
        ramp = np.linspace(0, 1, self.steps, dtype=np.float64)
        lo, hi = self.sigma_min ** (1 / self.rho), self.sigma_max ** (1 / self.rho)
        return (hi + ramp * (lo - hi)) ** self.rho

    def sigmas(self) -> np.ndarray:
        """(steps + 1,) float32, the last 0."""
        return np.concatenate([self._sigmas64(), [0.0]]).astype(np.float32)

    def timesteps(self) -> np.ndarray:
        return (0.25 * np.log(self._sigmas64())).astype(np.float32)


def window_rows(step: int, frames: int, window: int, overlap: int,
                shift_offset: int) -> np.ndarray:
    """(n_windows, window) ring-buffer indices of denoise step ``step``:
    windows start every ``window - overlap`` frames of a buffer of
    ``frames + window``, shifted back by ``shift_offset`` more each step."""
    buf = frames + window
    starts = np.arange(0, buf, window - overlap)
    shift = (step * shift_offset) % window
    return np.mod((starts - shift)[:, None] + np.arange(window)[None], buf)


def guided(pred: torch.Tensor, g: Tuple[float, float, float]) -> torch.Tensor:
    """pred (4, ...) in the order [uncond, + identity and image, + audio,
    + expression] -> u + g1 (a - u) + g2 (b - a) + g3 (c - b)."""
    u, a, b, c = pred
    return u + g[0] * (a - u) + g[1] * (b - a) + g[2] * (c - b)


def euler_v(x: torch.Tensor, v: torch.Tensor, sigma: float, sigma_next: float
            ) -> torch.Tensor:
    """One Euler step of a v-prediction model: x0 = x / (s^2 + 1) - v s /
    sqrt(s^2 + 1), x' = x + (x - x0) / s * (s' - s)."""
    x0 = x / (sigma ** 2 + 1.0) - v * sigma / (sigma ** 2 + 1.0) ** 0.5
    return x + (x - x0) / sigma * (sigma_next - sigma)


def cfg_branch(branch: int, idx, inputs, gate: Tuple[int, int]):
    """The UNet inputs of one guidance branch over the buffer rows ``idx``:
    (image latents, Cond, region masks) with the branch's zeroed parts.
    ``inputs`` holds id_tokens (buf, 1, d), audio / audio_u (buf, 32, d),
    vasa / vasa_u (buf, 1, d), image_latents (buf, h, w, 4), audio_mask /
    exp_mask (1, 1, H, W)."""
    ga, gv = gate
    img = inputs["image_latents"][idx]
    idt = inputs["id_tokens"][idx]
    au = (inputs["audio"] if branch >= 2 else inputs["audio_u"])[idx] * ga
    va = (inputs["vasa"] if branch == 3 else inputs["vasa_u"])[idx] * gv
    if branch == 0:
        img, idt = torch.zeros_like(img), torch.zeros_like(idt)
    am, em = inputs["audio_mask"], inputs["exp_mask"]
    if ga and not gv:
        em = torch.zeros_like(am)
    elif gv and not ga:
        am = torch.zeros_like(em)
    return img, Cond(idt, au, va, am, em)


@torch.no_grad()
def denoise_step(unet, inputs, x: torch.Tensor, step: int, cfg: dict,
                 schedule: Schedule, gate: Tuple[int, int], frames: int
                 ) -> torch.Tensor:
    """One denoise step of the long-video loop over the ring buffer ``x``
    (buf, h, w, 4): every window through the UNet once per guidance
    branch (one video of ``cfg["n_sample_frames"]`` frames a call), the
    4-way guidance, one Euler step, the windows averaged back. Returns the
    first ``frames`` frames (fp32)."""
    sig = schedule.sigmas()
    sigma, nxt = float(sig[step]), float(sig[step + 1])
    t = torch.tensor(float(schedule.timesteps()[step]), device=x.device)
    g = (float(cfg["min_appearance_guidance_scale"]),
         float(cfg["audio_guidance_scale"]), float(cfg["vasa_guidance_scale"]))
    tids = torch.tensor([[cfg["fps"], cfg["motion_bucket_id"],
                          cfg["motion_bucket_id_exp"]]], dtype=torch.float32,
                        device=x.device)
    summed, counts = torch.zeros_like(x), torch.zeros(x.shape[0], device=x.device)
    for rows in window_rows(step, frames, cfg["n_sample_frames"], cfg["overlap"],
                            cfg["shift_offset"]):
        idx = torch.as_tensor(rows, device=x.device)
        lat = x[idx]
        scaled = lat / float(np.sqrt(np.float32(sigma) ** 2 + np.float32(1.0)))
        preds = []
        for branch in range(4):
            img, cond = cfg_branch(branch, idx, inputs, gate)
            sample = torch.cat([scaled, img], dim=-1)[None]
            preds.append(unet(sample, t, cond, tids, inputs["pose_fea"][idx][None])[0])
        summed.index_add_(0, idx, euler_v(lat, guided(torch.stack(preds), g),
                                          sigma, nxt))
        counts.index_add_(0, idx, torch.ones(len(rows), device=x.device))
    return (summed / counts[:, None, None, None])[:frames]
