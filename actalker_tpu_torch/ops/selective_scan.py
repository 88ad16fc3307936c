"""Selective scan (Mamba S6 recurrence): plain PyTorch twin and the grouped
CUDA kernel K1.

Twin of ``actalker_tpu/ops/selective_scan.py`` (the plain ``seq`` /
``blocked`` scans) and of ``ssm_scan_grouped`` in
``actalker_tpu/ops/selective_scan_pallas.py``:

    delta = softplus(delta + delta_bias)
    h_t   = exp(delta_t * A) * h_{t-1} + (delta_t * B_t) * u_t
    y_t   = <C_t, h_t> + D * u_t

All accumulation is float32 whatever the input dtype. Layouts follow the JAX
package: ``selective_scan`` takes (B, L, D) sequences with (B, L, G, N)
B/C; the grouped op takes the arranged (L, B, .) buffers of one SS2D block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from actalker_tpu_torch.ops._build import (
    Kernel, check, check_cuda_tensors, ptr, stream_of)

MASK_LANE = 126   # slab lane carrying the inactivity flag
LANES = 128       # slab lanes per group
D_STATE = 16      # the kernel's state size

KERNEL = Kernel(
    "ssm_scan_grouped",
    replaces="actalker_tpu/ops/selective_scan_pallas.py:592")


def _prep(u, delta, A, B, C, D, delta_bias, delta_softplus):
    b, l, d = u.shape
    g = B.shape[2]
    if d % g:
        raise ValueError(f"D={d} not divisible by groups G={g}")
    u32 = u.float()
    delta = delta.float()
    if delta_bias is not None:
        delta = delta + delta_bias.float()[None, None, :]
    if delta_softplus:
        delta = F.softplus(delta)
    B32 = B.float().repeat_interleave(d // g, dim=2)     # (B, L, D, N)
    C32 = C.float().repeat_interleave(d // g, dim=2)
    dA = torch.exp(delta[..., None] * A.float()[None, None])
    dBu = (delta * u32)[..., None] * B32
    skip = u32 * D.float()[None, None, :] if D is not None \
        else torch.zeros_like(u32)
    return dA, dBu, C32, skip


def _scan_seq(dA, dBu):
    h = torch.zeros_like(dA[:, 0])
    hs = []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBu[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _scan_blocked(dA, dBu, chunk: int = 64):
    """Three-phase blocked scan: in-chunk sequential prefixes for all chunks
    at once, a short scan over chunk summaries, then the prefix correction."""
    b, l, d, n = dA.shape
    pad = (-l) % chunk
    if pad:   # a = 1, bu = 0 is the identity element
        dA = torch.cat([dA, dA.new_ones(b, pad, d, n)], dim=1)
        dBu = torch.cat([dBu, dBu.new_zeros(b, pad, d, n)], dim=1)
    nc = (l + pad) // chunk
    a_c = dA.reshape(b, nc, chunk, d, n)
    b_c = dBu.reshape(b, nc, chunk, d, n)
    h = torch.zeros(b, nc, d, n, dtype=dA.dtype, device=dA.device)
    ap = torch.ones_like(h)
    h_in, ap_in = [], []
    for t in range(chunk):
        h = a_c[:, :, t] * h + b_c[:, :, t]
        ap = ap * a_c[:, :, t]
        h_in.append(h)
        ap_in.append(ap)
    h_in = torch.stack(h_in, dim=2)      # (b, nc, chunk, d, n)
    ap_in = torch.stack(ap_in, dim=2)
    entry = torch.zeros(b, d, n, dtype=dA.dtype, device=dA.device)
    entries = []
    for c in range(nc):
        entries.append(entry)
        entry = h_in[:, c, -1] + ap_in[:, c, -1] * entry
    h = h_in + ap_in * torch.stack(entries, dim=1)[:, :, None]
    return h.reshape(b, nc * chunk, d, n)[:, :l]


def selective_scan(u, delta, A, B, C, D=None, delta_bias=None,
                   delta_softplus: bool = True, impl: str = "blocked",
                   chunk: int = 64) -> torch.Tensor:
    """(B, L, D) selective scan in fp32; ``impl`` is "seq" or "blocked"."""
    dA, dBu, C32, skip = _prep(u, delta, A, B, C, D, delta_bias,
                               delta_softplus)
    if impl == "seq":
        h = _scan_seq(dA, dBu)
    elif impl == "blocked":
        h = _scan_blocked(dA, dBu, chunk=chunk)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return (h * C32).sum(-1) + skip


def ssm_scan_grouped_ref(u_g, slab_g, dtw_g, A_g, D_g, bias_g, rank: int
                         ) -> torch.Tensor:
    """Plain PyTorch version of K1 (twin of ``_grouped_xla``): for each group,
    delta = full 128-lane slab @ dtw (the -1e9 mask row rides the product),
    bias + softplus, B/C at lanes [rank, rank + 2N), odd groups right to
    left. Sequential in L with fp32 state; returns (L, B, G * Dp) in u's
    dtype."""
    lp, bp, _ = u_g.shape
    g = dtw_g.shape[0]
    dp = u_g.shape[2] // (g // 2)
    n = A_g.shape[-1]
    chunk = 64          # tokens whose exp(delta A) are formed at once
    outs = []
    for gi in range(g):
        u = u_g[:, :, (gi // 2) * dp:(gi // 2 + 1) * dp].float()
        slab = slab_g[:, :, gi * LANES:(gi + 1) * LANES].float()
        delta = F.softplus(slab @ dtw_g[gi].float() + bias_g[gi].float())
        Bm = slab[:, :, rank:rank + n]
        Cm = slab[:, :, rank + n:rank + 2 * n]
        A = A_g[gi].float()
        Dv = D_g[gi].float()
        order = list(range(lp - 1, -1, -1) if gi % 2 else range(lp))
        y = torch.empty(lp, bp, dp, dtype=torch.float32, device=u.device)
        h = torch.zeros(bp, dp, n, dtype=torch.float32, device=u.device)
        for c0 in range(0, lp, chunk):
            ts = order[c0:c0 + chunk]
            dA = torch.exp(delta[ts][..., None] * A)                  # (T, B, D, N)
            dBu = (delta[ts] * u[ts])[..., None] * Bm[ts][:, :, None]
            hs = []
            for i in range(len(ts)):
                h = dA[i] * h + dBu[i]
                hs.append(h)
            hs = torch.stack(hs)
            y[ts] = (hs * Cm[ts][:, :, None]).sum(-1) + Dv * u[ts]
        outs.append(y.to(u_g.dtype))
    return torch.cat(outs, dim=-1)


def ssm_scan_grouped(u_g: torch.Tensor,      # (L, B, G//2 * Dp) branch slabs
                     slab_g: torch.Tensor,   # (L, B, G * 128) [dts|B|C|mask]
                     dtw_g: torch.Tensor,    # (G, 128, Dp) f32; row 126 -1e9
                     A_g: torch.Tensor,      # (G, Dp, N) f32
                     D_g: torch.Tensor,      # (G, Dp) f32
                     bias_g: torch.Tensor,   # (G, Dp) f32
                     rank: int) -> torch.Tensor:
    """All (branch, direction) scans of one SS2D block in one launch (K1).

    Group g reads activations from branch slab g // 2 of ``u_g`` and scans
    left to right for even g, right to left for odd g. Returns
    (L, B, G * Dp) with each group's output in its own minor slab. Only slab
    rows [0, rank) and MASK_LANE of ``dtw_g`` may be nonzero. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if not u_g.is_cuda:
        return ssm_scan_grouped_ref(u_g, slab_g, dtw_g, A_g, D_g, bias_g,
                                    rank)
    lp, bp, cg = u_g.shape
    g = dtw_g.shape[0]
    check(g % 2 == 0 and g > 0, f"K1: group count {g} must be even")
    dp = cg // (g // 2)
    check(cg == dp * (g // 2), f"K1: u width {cg} != G/2 * Dp")
    check(tuple(slab_g.shape) == (lp, bp, g * LANES),
          f"K1: slab shape {tuple(slab_g.shape)}")
    check(tuple(dtw_g.shape) == (g, LANES, dp), f"K1: dtw {tuple(dtw_g.shape)}")
    check(tuple(A_g.shape) == (g, dp, D_STATE),
          f"K1: A {tuple(A_g.shape)} (d_state must be {D_STATE})")
    check(tuple(D_g.shape) == (g, dp) and tuple(bias_g.shape) == (g, dp),
          "K1: D / bias must be (G, Dp)")
    check(0 < rank and rank + 2 * D_STATE <= MASK_LANE,
          f"K1: rank {rank} leaves no room for B|C below lane {MASK_LANE}")
    act = (torch.bfloat16, torch.float32)
    f32 = (torch.float32,)
    check_cuda_tensors("K1", (u_g, slab_g, dtw_g, A_g, D_g, bias_g),
                       {"u": act, "slab": act, "dtw": f32, "A": f32,
                        "D": f32, "bias": f32})
    check(slab_g.dtype == u_g.dtype, "K1: slab dtype must match u")
    y = torch.empty((lp, bp, g * dp), dtype=u_g.dtype, device=u_g.device)
    fn = ("ssm_scan_grouped_bf16" if u_g.dtype == torch.bfloat16
          else "ssm_scan_grouped_f32")
    KERNEL.launch(fn, "pppppppiiiiip", ptr(u_g), ptr(slab_g), ptr(dtw_g),
                  ptr(A_g), ptr(D_g), ptr(bias_g), ptr(y), lp, bp, dp, g,
                  rank, stream_of(u_g))
    return y

