"""Quality metrics on the host, the port's own copy of
``actalker_tpu/evaluation/metrics.py`` (the reference's ``eval/`` tree,
SURVEY.md §2.9): PSNR / SSIM / L1 directly; FID / FVD / identity cosine
over a pluggable feature extractor (``evaluation/inception.py``,
``evaluation/i3d.py``, ``models/senet.py``); the exact Fréchet distance;
SyncNet-style shift scores; LPIPS over ``evaluation/lpips.py``. Numpy,
float64.
"""
from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np


# ------------------------------------------------------------ pixel metrics

def l1(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def _gauss_filter2d(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """Separable 'valid' gaussian filtering over the leading two axes."""
    x = np.apply_along_axis(
        lambda r: np.convolve(r, kernel, mode="valid"), 0, x)
    return np.apply_along_axis(
        lambda r: np.convolve(r, kernel, mode="valid"), 1, x)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         win_size: int = 11, sigma: float = 1.5) -> float:
    """Windowed SSIM (Wang et al. 2004: 11x11 gaussian window, sigma 1.5,
    k1 / k2 = 0.01 / 0.03) over (H, W[, C]) arrays, the mean over positions
    and channels. A window larger than the image shrinks to the largest
    odd size that fits (``np.convolve`` would otherwise swap its
    operands)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    win_size = min(win_size, min(a.shape[0], a.shape[1]))
    win_size -= 1 - win_size % 2
    half = (win_size - 1) / 2
    g = np.exp(-((np.arange(win_size) - half) ** 2) / (2 * sigma**2))
    g /= g.sum()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mu_x = _gauss_filter2d(x, g)
        mu_y = _gauss_filter2d(y, g)
        xx = _gauss_filter2d(x * x, g) - mu_x**2
        yy = _gauss_filter2d(y * y, g) - mu_y**2
        xy = _gauss_filter2d(x * y, g) - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * xy + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (xx + yy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


# ----------------------------------------------------------- distributions

def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu, sigma)."""
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Square root of a PSD matrix through its eigendecomposition."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)[None]) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The Fréchet distance of two Gaussians (``eval_fid.py:42-99``), with
    sqrtm(sigma1 sigma2) in its symmetric form (trace-equal for PSD
    inputs) and eps I added to both factors (the reference's retry)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    eye = eps * np.eye(len(sigma1))
    s1h = _sqrtm_psd(sigma1 + eye)
    covmean = _sqrtm_psd(s1h @ (sigma2 + eye) @ s1h)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def fid(real_frames: Iterable[np.ndarray], fake_frames: Iterable[np.ndarray],
        feature_fn: Callable[[np.ndarray], np.ndarray], batch: int = 32) -> float:
    """FID over frame iterables through ``feature_fn`` (N, ...) -> (N, D),
    ``batch`` frames a call."""

    def stats(frames):
        feats, buf = [], []
        for f in frames:
            buf.append(f)
            if len(buf) == batch:
                feats.append(np.asarray(feature_fn(np.stack(buf))))
                buf = []
        if buf:
            feats.append(np.asarray(feature_fn(np.stack(buf))))
        return activation_statistics(np.concatenate(feats, axis=0))

    return frechet_distance(*stats(real_frames), *stats(fake_frames))


def fvd(real_clips: np.ndarray, fake_clips: np.ndarray,
        video_feature_fn: Callable[[np.ndarray], np.ndarray]) -> float:
    """Fréchet video distance through an I3D-style clip embedder."""
    f1 = np.asarray(video_feature_fn(real_clips))
    f2 = np.asarray(video_feature_fn(fake_clips))
    return frechet_distance(*activation_statistics(f1),
                            *activation_statistics(f2))


# -------------------------------------------------------------- identity

def identity_cosine(ref_image: np.ndarray, frames: np.ndarray,
                    embed_fn: Callable[[np.ndarray], np.ndarray]) -> float:
    """Mean cosine similarity of the reference face's embedding and each
    frame's (``evaluation_faceid.py:181-266``)."""
    ref = np.asarray(embed_fn(ref_image[None]))[0]
    emb = np.asarray(embed_fn(frames))
    ref = ref / (np.linalg.norm(ref) + 1e-8)
    emb = emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-8)
    return float(np.mean(emb @ ref))


# ------------------------------------------------------------------ sync

def sync_scores(audio_emb: np.ndarray, video_emb: np.ndarray,
                vshift: int = 15) -> Tuple[int, float, float]:
    """(offset, Sync-C, Sync-D) from per-window tower embeddings by
    truncated shifts (``SyncNetInstance.py:42-148``): the mean pairwise L2
    distance at each shift in +-vshift; offset = argmin, confidence =
    median - min."""
    t = min(len(audio_emb), len(video_emb))
    audio_emb, video_emb = audio_emb[:t], video_emb[:t]
    dists = []
    for shift in range(-vshift, vshift + 1):
        a = audio_emb[max(0, shift): t + min(0, shift)]
        v = video_emb[max(0, -shift): t - max(0, shift)]
        n = min(len(a), len(v))
        if n == 0:
            dists.append(np.inf)
            continue
        dists.append(float(np.mean(np.linalg.norm(a[:n] - v[:n], axis=-1))))
    dists = np.asarray(dists)
    idx = int(np.argmin(dists))
    return idx - vshift, float(np.median(dists) - dists[idx]), float(dists[idx])


def lpips(a: np.ndarray, b: np.ndarray, net) -> float:
    """Mean LPIPS over frame pairs (N, H, W, 3) in [0, 1] through ``net``
    (``evaluation/lpips.py::LPIPSAlex``, on its device); the reference's
    ``utils/image_level_evaluation.py:12-50``."""
    import torch

    from actalker_tpu_torch.evaluation.lpips import lpips_distance

    dev = next(net.parameters()).device
    x, y = (torch.from_numpy(np.asarray(v, np.float32)).to(dev) * 2.0 - 1.0
            for v in (a, b))
    return float(lpips_distance(net, x, y).mean())
