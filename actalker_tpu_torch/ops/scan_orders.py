"""Scan-order permutation tables for 2D selective scans.

The port's own copy of ``actalker_tpu/ops/scan_orders.py`` (that module
imports no JAX, but the port imports nothing of the JAX package). Parity
target: ``HSCANS`` / ``HSCANS_dynamic``
(``src/models/base/mamba_layer.py:72-184``): token orderings realized as
gather/scatter index tables — 'sweep' (identity; the production config),
boustrophedon 'scan', 'zigzag' (anti-diagonals), 'zorder' (Morton), and
'hilbert'. Orders are host-precomputed numpy tables; applying them is a
single gather (and the inverse a scatter) around the scan kernel.
"""
from __future__ import annotations

import numpy as np


def sweep_order(h: int, w: int) -> np.ndarray:
    return np.arange(h * w)


def scan_order(h: int, w: int) -> np.ndarray:
    """Boustrophedon: reverse every other row."""
    idx = np.arange(h * w).reshape(h, w)
    idx[1::2] = idx[1::2, ::-1]
    return idx.reshape(-1)


def zigzag_order(h: int, w: int) -> np.ndarray:
    """Anti-diagonal (JPEG-style) traversal."""
    out = []
    for s in range(h + w - 1):
        ys = range(max(0, s - w + 1), min(h, s + 1))
        diag = [y * w + (s - y) for y in ys]
        out.extend(diag if s % 2 else diag[::-1])
    return np.asarray(out)


def zorder_order(h: int, w: int) -> np.ndarray:
    """Morton/Z-order (power-of-two sizes; clipped otherwise)."""
    n = 1 << int(np.ceil(np.log2(max(h, w))))
    ys, xs = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")

    def interleave(v):
        v = v.astype(np.uint64)
        out = np.zeros_like(v)
        for b in range(16):
            out |= ((v >> b) & 1) << (2 * b)
        return out

    z = interleave(xs) | (interleave(ys) << 1)
    flat = np.argsort(z.reshape(-1), kind="stable")
    yy, xx = flat // n, flat % n
    keep = (yy < h) & (xx < w)
    return (yy[keep] * w + xx[keep]).astype(np.int64)


def hilbert_order(h: int, w: int) -> np.ndarray:
    """Hilbert curve for square power-of-two grids (clipped otherwise)."""
    n = 1 << int(np.ceil(np.log2(max(h, w))))

    def d2xy(d):
        # vectorized Hilbert distance -> (x, y)
        d = d.astype(np.int64)
        x = np.zeros_like(d)
        y = np.zeros_like(d)
        t = d.copy()
        s = 1
        while s < n:
            rx = 1 & (t // 2)
            ry = 1 & (t ^ rx)
            # rotate
            swap = ry == 0
            flip = swap & (rx == 1)
            x_f = np.where(flip, s - 1 - x, x)
            y_f = np.where(flip, s - 1 - y, y)
            x, y = np.where(swap, y_f, x_f), np.where(swap, x_f, y_f)
            x = x + s * rx
            y = y + s * ry
            t //= 4
            s *= 2
        return x, y

    d = np.arange(n * n)
    x, y = d2xy(d)
    keep = (y < h) & (x < w)
    return (y[keep] * w + x[keep]).astype(np.int64)


ORDERS = {
    "sweep": sweep_order,
    "scan": scan_order,
    "zigzag": zigzag_order,
    "zorder": zorder_order,
    "hilbert": hilbert_order,
}


def order_table(kind: str, h: int, w: int) -> np.ndarray:
    """Permutation p: sequence position i holds token p[i]."""
    return ORDERS[kind](h, w)


def inverse_table(p: np.ndarray) -> np.ndarray:
    inv = np.empty_like(p)
    inv[p] = np.arange(len(p))
    return inv

