"""Euler-discrete (EDM-style) scheduler as plain functions, twin of
``actalker_tpu/diffusion/scheduler.py``.

The sigma / timestep tables are computed host-side in numpy (float64, then
float32), and each step is a function of explicit ``sigma`` /
``sigma_next``. Defaults match SVD-XT 1.1's scheduler: scaled-linear betas,
Karras sigmas in [0.002, 700], "leading" spacing, continuous timesteps
``t = 0.25 * ln(sigma)``, v-prediction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class EulerDiscreteConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"   # "linear" | "scaled_linear"
    prediction_type: str = "v_prediction"  # "epsilon" | "v_prediction" | "sample"
    interpolation_type: str = "linear"
    use_karras_sigmas: bool = True
    sigma_min: Optional[float] = 0.002
    sigma_max: Optional[float] = 700.0
    timestep_spacing: str = "leading"      # "linspace" | "leading" | "trailing"
    timestep_type: str = "continuous"      # "discrete" | "continuous"
    steps_offset: int = 1
    rho: float = 7.0


def training_sigmas(cfg: EulerDiscreteConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        betas = np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    elif cfg.beta_schedule == "scaled_linear":
        betas = np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n,
                            dtype=np.float64) ** 2
    else:
        raise ValueError(f"unknown beta_schedule {cfg.beta_schedule!r}")
    alphas_cumprod = np.cumprod(1.0 - betas)
    return np.sqrt((1 - alphas_cumprod) / alphas_cumprod)


def _karras_ramp(cfg, n, smin, smax):
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    inv_rho = 1.0 / cfg.rho
    return (smax ** inv_rho + ramp * (smin ** inv_rho - smax ** inv_rho)) ** cfg.rho


def set_timesteps(cfg: EulerDiscreteConfig, num_inference_steps: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(sigmas with a terminal 0 appended, timesteps), both float32."""
    sig_train = training_sigmas(cfg)
    nt = cfg.num_train_timesteps
    if cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, nt - 1, num_inference_steps, dtype=np.float64)[::-1]
    elif cfg.timestep_spacing == "leading":
        ratio = nt // num_inference_steps
        ts = (np.arange(num_inference_steps) * ratio).round()[::-1].astype(np.float64)
        ts += cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        ts = np.arange(nt, 0, -nt / num_inference_steps).round().astype(np.float64) - 1
    else:
        raise ValueError(f"unknown timestep_spacing {cfg.timestep_spacing!r}")

    if cfg.interpolation_type == "linear":
        sigmas = np.interp(ts, np.arange(nt), sig_train)
    elif cfg.interpolation_type == "log_linear":
        sigmas = np.exp(np.linspace(np.log(sig_train[-1]), np.log(sig_train[0]),
                                    num_inference_steps + 1))[:-1][::-1]
    else:
        raise ValueError(f"unknown interpolation_type {cfg.interpolation_type!r}")

    if cfg.use_karras_sigmas:
        smin = cfg.sigma_min if cfg.sigma_min is not None else float(sigmas[-1])
        smax = cfg.sigma_max if cfg.sigma_max is not None else float(sigmas[0])
        sigmas = _karras_ramp(cfg, num_inference_steps, smin, smax)

    if cfg.timestep_type == "continuous":
        timesteps = 0.25 * np.log(sigmas)
    elif cfg.use_karras_sigmas:
        timesteps = np.interp(np.log(sigmas), np.log(sig_train), np.arange(nt))
    else:
        timesteps = ts
    sigmas = np.concatenate([sigmas, [0.0]])
    return sigmas.astype(np.float32), timesteps.astype(np.float32)


def scale_model_input(sample: torch.Tensor, sigma: float) -> torch.Tensor:
    """c_in = 1 / sqrt(sigma^2 + 1)."""
    return sample / float(np.sqrt(np.float32(sigma) ** 2 + np.float32(1.0)))


def step(sample: torch.Tensor, model_output: torch.Tensor, sigma: float,
         sigma_next: float, prediction_type: str = "v_prediction",
         gamma: float = 0.0, noise: Optional[torch.Tensor] = None,
         s_noise: float = 1.0) -> torch.Tensor:
    """One Euler step x_t -> x_{t-1}. ``gamma`` > 0 is ancestral churn and
    needs ``noise``; with gamma == 0 the step is deterministic."""
    sigma_hat = sigma * (gamma + 1.0)
    if noise is None:
        if gamma > 0:
            raise ValueError("gamma > 0 requires noise")
    else:
        sample = sample + noise * s_noise * max(sigma_hat ** 2 - sigma ** 2, 0.0) ** 0.5

    if prediction_type == "epsilon":
        pred_x0 = sample - sigma_hat * model_output
    elif prediction_type == "v_prediction":
        pred_x0 = (model_output * (-sigma / (sigma ** 2 + 1.0) ** 0.5)
                   + sample / (sigma ** 2 + 1.0))
    elif prediction_type in ("sample", "original_sample"):
        pred_x0 = model_output
    else:
        raise ValueError(f"unknown prediction_type {prediction_type!r}")
    derivative = (sample - pred_x0) / sigma_hat
    return sample + derivative * (sigma_next - sigma_hat)


def add_noise(original: torch.Tensor, noise: torch.Tensor, sigma: float
              ) -> torch.Tensor:
    """x = x0 + sigma * n (the reference's sigma-indexed add_noise)."""
    return original + noise * sigma


def i2i_truncate(sigmas: np.ndarray, timesteps: np.ndarray,
                 num_inference_steps: int, strength: float):
    """Keep the last ``int(n * strength)`` steps (image-to-image strength)."""
    init_t = min(int(num_inference_steps * strength), num_inference_steps)
    t_start = max(num_inference_steps - init_t, 0)
    return sigmas[t_start:], timesteps[t_start:], num_inference_steps - t_start
