"""Farnebäck dense optical flow and the motion bucket, in torch on the CPU
(it runs in the training loader's worker processes). Twin of
``actalker_tpu/frontend/optical_flow.py``, which follows the reference's
``cv2.calcOpticalFlowFarneback(prev, next, None, 0.5, 3, 15, 3, 5, 1.2, 0)``
and maps the per-pair mean flow magnitude (x 0.1, maxed over pairs) onto a
0..255 motion bucket (``src/utils/motion_estimation_service.py:33,61-128``).

Per pyramid level (Gaussian pre-smooth + antialiased bilinear resize of the
input, as ``jax.image.resize`` shrinks): a quadratic polynomial fit by
separable correlations with replicate borders (``_poly_exp``), then
iterations of warping the second frame's coefficients by the flow (an
explicit bilinear gather whose left index is clamped to ``w - 2``, as the
JAX function does), the 2x2 normal equations, a box filter and a per-pixel
solve; the flow is upsampled (half-pixel centres) into the next level.

Every function takes a leading batch of frame pairs: ``get_motion_score``
computes all of a clip's pairs in one pass.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _poly_inverse_entries(n: int, sigma: float):
    """Gaussian window and the four entries of the inverse Gram matrix of
    the weighted quadratic basis {1, x, y, x^2, y^2, xy} that the update
    uses (ig11, ig03, ig33, ig55, as OpenCV keeps them)."""
    k = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(k ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    m2 = float((g * k ** 2).sum())
    m4 = float((g * k ** 4).sum())
    G = np.zeros((6, 6))
    G[0, 0] = 1.0
    G[0, 3] = G[3, 0] = G[0, 4] = G[4, 0] = m2
    G[1, 1] = G[2, 2] = m2
    G[3, 3] = G[4, 4] = m4
    G[3, 4] = G[4, 3] = m2 * m2
    G[5, 5] = m2 * m2
    Gi = np.linalg.inv(G)
    return g.astype(np.float32), float(Gi[1, 1]), float(Gi[0, 3]), \
        float(Gi[3, 3]), float(Gi[5, 5])


def _sep_correlate(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray
                   ) -> torch.Tensor:
    """Separable 2-D correlation with replicate borders: rows (along W) by
    ``kx``, then columns by ``ky``; both padded by ``(len(kx) - 1) // 2``.
    img: (N, H, W) -> (N, H, W)."""
    n = (len(kx) - 1) // 2
    p = F.pad(img.float()[:, None], (n, n, n, n), mode="replicate")
    wx = torch.from_numpy(np.asarray(kx, np.float32)).view(1, 1, 1, -1)
    wy = torch.from_numpy(np.asarray(ky, np.float32)).view(1, 1, -1, 1)
    return F.conv2d(F.conv2d(p, wx.to(p.device)), wy.to(p.device))[:, 0]


def _poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Quadratic polynomial expansion (N, H, W) -> (N, H, W, 5):
    [bx, by, axx, ayy, axy]."""
    g, ig11, ig03, ig33, ig55 = _poly_inverse_entries(n, sigma)
    k = np.arange(-n, n + 1, dtype=np.float32)
    xg, xxg = k * g, (k * k) * g
    s0 = _sep_correlate(img, g, g)
    sx = _sep_correlate(img, xg, g)
    sy = _sep_correlate(img, g, xg)
    sxx = _sep_correlate(img, xxg, g)
    syy = _sep_correlate(img, g, xxg)
    sxy = _sep_correlate(img, xg, xg)
    return torch.stack([sx * ig11, sy * ig11, s0 * ig03 + sxx * ig33,
                        s0 * ig03 + syy * ig33, sxy * ig55], dim=-1)


def _bilinear_sample(grid: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
                     ) -> torch.Tensor:
    """Sample grid (N, H, W, C) at float coordinates (N, H, W) with
    replicate borders: coordinates clamp to the image, the left / top index
    to ``w - 2`` / ``h - 2`` (so the last column weighs 1 on its right
    neighbour). An explicit gather, not ``grid_sample``."""
    n, h, w, c = grid.shape
    xs = xs.clamp(0.0, w - 1.0)
    ys = ys.clamp(0.0, h - 1.0)
    x0 = xs.floor().long().clamp(0, w - 2)
    y0 = ys.floor().long().clamp(0, h - 2)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    flat = grid.reshape(n, h * w, c)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(n, h * w, 1).expand(n, h * w, c)
        return flat.gather(1, idx).reshape(n, h, w, c)

    v00, v01 = at(y0, x0), at(y0, x0 + 1)
    v10, v11 = at(y0 + 1, x0), at(y0 + 1, x0 + 1)
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def _box_filter(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """Normalized box filter over (N, H, W, C) with replicate borders."""
    k = np.ones(winsize, np.float32) / winsize
    n, h, w, c = m.shape
    out = _sep_correlate(m.permute(0, 3, 1, 2).reshape(n * c, h, w), k, k)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1)


def _flow_iteration(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                    winsize: int) -> torch.Tensor:
    """One Farnebäck update: the normal equations, the box filter and the
    2x2 solve. r0, r1 (N, H, W, 5); flow (N, H, W, 2)."""
    n, h, w, _ = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    r1w = _bilinear_sample(r1, xs + flow[..., 0], ys + flow[..., 1])

    a11 = (r0[..., 2] + r1w[..., 2]) * 0.5
    a22 = (r0[..., 3] + r1w[..., 3]) * 0.5
    a12 = (r0[..., 4] + r1w[..., 4]) * 0.25
    db_x = (r0[..., 0] - r1w[..., 0]) * 0.5 + a11 * flow[..., 0] + a12 * flow[..., 1]
    db_y = (r0[..., 1] - r1w[..., 1]) * 0.5 + a12 * flow[..., 0] + a22 * flow[..., 1]

    m = torch.stack([a11 * a11 + a12 * a12,       # g11
                     (a11 + a22) * a12,           # g12
                     a22 * a22 + a12 * a12,       # g22
                     a11 * db_x + a12 * db_y,     # h1
                     a12 * db_x + a22 * db_y],    # h2
                    dim=-1)
    g11, g12, g22, h1, h2 = _box_filter(m, winsize).unbind(-1)
    det = g11 * g22 - g12 * g12
    idet = torch.where(det.abs() > 1e-9, 1.0 / det, torch.zeros_like(det))
    return torch.stack([(g22 * h1 - g12 * h2) * idet,
                        (g11 * h2 - g12 * h1) * idet], dim=-1)


def _resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) with half-pixel centres, antialiased
    where it shrinks (``jax.image.resize(..., "bilinear")``)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    shrink = out_hw[0] < x.shape[-2] or out_hw[1] < x.shape[-1]
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False,
                         antialias=shrink)


def _smooth_resize(img: torch.Tensor, out_hw: Tuple[int, int], scale: float
                   ) -> torch.Tensor:
    """Gaussian pre-smooth (sigma from the scale step) + bilinear resize of
    (N, H, W)."""
    if scale < 1.0:
        sigma = (1.0 / scale - 1.0) * 0.5
        size = max(int(round(sigma * 5)) | 1, 3)
        k = np.arange(size, dtype=np.float64) - size // 2
        g = np.exp(-(k ** 2) / (2 * sigma ** 2))
        g = (g / g.sum()).astype(np.float32)
        img = _sep_correlate(img, g, g)
    return _resize(img[:, None], out_hw)[:, 0]


@torch.no_grad()
def farneback_flow(prev_gray: torch.Tensor, next_gray: torch.Tensor,
                   pyr_scale: float = 0.5, levels: int = 3, winsize: int = 15,
                   iterations: int = 3, poly_n: int = 5,
                   poly_sigma: float = 1.2) -> torch.Tensor:
    """Dense flow [dx, dy] from prev to next: grayscale float frames (0..255)
    of shape (H, W) or (N, H, W) -> (..., H, W, 2) fp32. Parameters as
    ``cv2.calcOpticalFlowFarneback`` (``motion_estimation_service.py:33``)."""
    single = prev_gray.ndim == 2
    p0 = torch.as_tensor(prev_gray, dtype=torch.float32)
    q0 = torch.as_tensor(next_gray, dtype=torch.float32)
    if single:
        p0, q0 = p0[None], q0[None]
    h, w = p0.shape[-2:]
    n_levels = levels
    # keep the levels where the image still holds the polynomial window
    while n_levels > 0 and min(h, w) * pyr_scale ** n_levels < 2 * poly_n + 3:
        n_levels -= 1
    flow = None
    for k in range(n_levels, -1, -1):
        scale = pyr_scale ** k
        lh = max(int(round(h * scale)), 2 * poly_n + 3)
        lw = max(int(round(w * scale)), 2 * poly_n + 3)
        r0 = _poly_exp(_smooth_resize(p0, (lh, lw), scale), poly_n, poly_sigma)
        r1 = _poly_exp(_smooth_resize(q0, (lh, lw), scale), poly_n, poly_sigma)
        if flow is None:
            flow = r0.new_zeros(r0.shape[0], lh, lw, 2)
        else:
            flow = _resize(flow.permute(0, 3, 1, 2), (lh, lw)
                           ).permute(0, 2, 3, 1) / pyr_scale
        for _ in range(iterations):
            flow = _flow_iteration(r0, r1, flow, winsize)
    return flow[0] if single else flow


def flow_magnitude_score(flow) -> float:
    """Mean |flow| * 0.1 (``motion_estimation_service.py:61-73``)."""
    flow = np.asarray(flow)
    mag = np.sqrt(np.square(flow[..., 0]) + np.square(flow[..., 1]))
    return float(np.mean(mag) * 0.1)


def magnitude_to_bucket(magnitude: float) -> int:
    """``motion_estimation_service.py:75-80``."""
    return int(min(max(round(magnitude * 255), 0), 255))


def get_motion_score(frames: np.ndarray) -> int:
    """Motion bucket of a clip (T, H, W, C uint8 / float, RGB as
    ``frontend.video.read_frames`` gives it): Farnebäck flow per
    consecutive pair (all pairs in one batch), mean magnitude per pair, max
    over pairs -> bucket (``motion_estimation_service.py:114-128``; luma
    weights of cv2.COLOR_BGR2GRAY in RGB order)."""
    if len(frames) < 2:
        return 0
    f = np.asarray(frames, np.float32)
    gray = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2] \
        if f.ndim == 4 else f
    g = torch.from_numpy(np.ascontiguousarray(gray))
    flow = farneback_flow(g[:-1], g[1:]).numpy()
    return magnitude_to_bucket(max(flow_magnitude_score(fl) for fl in flow))
