"""Selective scan (Mamba S6 recurrence): plain PyTorch twins, the grouped
CUDA kernel K1 (forward) and the adjoint kernel K6 (backward).

Twin of ``actalker_tpu/ops/selective_scan.py`` (the plain ``seq`` /
``blocked`` scans) and of ``ssm_scan_grouped`` in
``actalker_tpu/ops/selective_scan_pallas.py``:

    delta = softplus(delta + delta_bias)
    h_t   = exp(delta_t * A) * h_{t-1} + (delta_t * B_t) * u_t
    y_t   = <C_t, h_t> + D * u_t

All accumulation is float32 whatever the input dtype. Layouts follow the JAX
package: ``selective_scan`` takes (B, L, D) sequences with (B, L, G, N)
B/C; the grouped op takes the arranged (L, B, .) buffers of one SS2D block.

Gradients: ``ssm_scan_grouped`` runs ``SsmScanGroupedFn`` when autograd
needs it. Its backward follows ``_grouped_bwd`` of the JAX package: per
group the raw delta projection in a plain matmul, the adjoint of the
arranged scan (K6, ``ssm_scan_arranged_grad``; twin of
``_arranged_grad_tpu``), then the delta cotangent pushed back through the
slab matmul.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from actalker_tpu_torch.ops._build import (
    Kernel, check, check_cuda_tensors, needs_grad, ptr, stream_of)

MASK_LANE = 126   # slab lane carrying the inactivity flag
LANES = 128       # slab lanes per group
D_STATE = 16      # the kernel's state size

KERNEL = Kernel(
    "ssm_scan_grouped",
    replaces="actalker_tpu/ops/selective_scan_pallas.py:592")
# K6 replaces _boundary_kernel (:154) and _bwd_kernel (:200), both launched
# by _arranged_grad_tpu (:387, :408); one launch here runs both passes
BWD_KERNEL = Kernel(
    "ssm_scan_bwd",
    replaces="actalker_tpu/ops/selective_scan_pallas.py:154")


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


def _grouped_fwd(u_g: torch.Tensor,      # (L, B, G//2 * Dp) branch slabs
                 slab_g: torch.Tensor,   # (L, B, G * 128) [dts|B|C|mask]
                 dtw_g: torch.Tensor,    # (G, 128, Dp) f32; row 126 -1e9
                 A_g: torch.Tensor,      # (G, Dp, N) f32
                 D_g: torch.Tensor,      # (G, Dp) f32
                 bias_g: torch.Tensor,   # (G, Dp) f32
                 rank: int) -> torch.Tensor:
    """K1 forward, no autograd: see ``ssm_scan_grouped``.

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


def ssm_scan_arranged_grad_ref(u, dtr, bc, A, D, bias, dy, reverse: bool,
                               chunk: int = 64):
    """Plain adjoint of one arranged scan (twin of ``_arranged_grad_tpu``).

    u (L, B, Dp); dtr (L, B, Dp) raw delta before bias and softplus; bc
    (L, B, NB >= 2N) with B in lanes [0, N) and C in [N, 2N); A (Dp, N);
    D, bias (Dp,); dy (L, B, Dp); ``reverse`` scans right to left. Returns
    (du, ddt, dbc, dA, dD, dbias) in the dtypes of (u, dtr, bc, A, D, bias).

    Per channel d and state n, with a = exp(delta A), p = delta u:
        h_t = a_t h_{t-1} + B_t p_t ;  y_t = sum_n C_n h_n + D u_t
    and the adjoint g_t = dy_t C_t + a_{t+1} g_{t+1} (scan order) gives
        du = delta sum_n g B + D dy
        ddt = (u sum_n g B + sum_n g A a h_{t-1}) sigmoid(dtr + bias)
        dB = sum_d g p,  dC = sum_d dy h,  dA = sum_t g h_{t-1} delta a,
        dD = sum_t dy u.
    Forward states are kept only at chunk starts and recomputed per chunk
    (fp32 throughout); the adjoint recurrence is the only serial loop."""
    lp, bp, dp = u.shape
    n = A.shape[-1]
    x = dtr.float() + bias.float()
    delta, sig = F.softplus(x), torch.sigmoid(x)
    u32, dy32, A32 = u.float(), dy.float(), A.float()
    Bm, Cm = bc[..., :n].float(), bc[..., n:2 * n].float()
    order = torch.arange(lp, device=u.device)
    order = order.flip(0) if reverse else order
    chunks = [order[c0:c0 + chunk] for c0 in range(0, lp, chunk)]

    def states(ts, h):
        """(T + 1, B, Dp, N) states: the entering one, then after each t."""
        a = torch.exp(delta[ts][..., None] * A32)
        bu = (delta[ts] * u32[ts])[..., None] * Bm[ts][:, :, None]
        hs = [h]
        for i in range(len(ts)):
            hs.append(a[i] * hs[-1] + bu[i])
        return torch.stack(hs), a

    entering = []
    h = u32.new_zeros(bp, dp, n)
    for ts in chunks:
        entering.append(h)
        h = states(ts, h)[0][-1]

    du = torch.empty(lp, bp, dp, dtype=torch.float32, device=u.device)
    ddt = torch.empty_like(du)
    dbc = torch.zeros(bc.shape, dtype=torch.float32, device=u.device)
    dA = A32.new_zeros(dp, n)
    g = u32.new_zeros(bp, dp, n)
    for ts, h0 in zip(reversed(chunks), reversed(entering)):
        hs, a = states(ts, h0)
        dyc = dy32[ts][..., None] * Cm[ts][:, :, None]             # (T, B, Dp, N)
        gn = torch.empty_like(dyc)
        for i in range(len(ts) - 1, -1, -1):
            gn[i] = g + dyc[i]
            g = gn[i] * a[i]
        gb = (gn * Bm[ts][:, :, None]).sum(-1)                     # (T, B, Dp)
        gah = (gn * A32 * a * hs[:-1]).sum(-1)
        du[ts] = delta[ts] * gb + D.float() * dy32[ts]
        ddt[ts] = (u32[ts] * gb + gah) * sig[ts]
        dbc[ts, :, :n] = (gn * (delta[ts] * u32[ts])[..., None]).sum(2)
        dbc[ts, :, n:2 * n] = (dy32[ts][..., None] * hs[1:]).sum(2)
        dA += (gn * hs[:-1] * delta[ts][..., None] * a).sum((0, 1))
    dD = (dy32 * u32).sum((0, 1))
    dbias = ddt.sum((0, 1))
    return (du.to(u.dtype), ddt.to(dtr.dtype), dbc.to(bc.dtype),
            dA.to(A.dtype), dD.to(D.dtype), dbias.to(bias.dtype))


def ssm_scan_arranged_grad(u, dtr, bc, A, D, bias, dy, reverse: bool):
    """Adjoint of one arranged scan (K6). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. See
    ``ssm_scan_arranged_grad_ref`` for shapes and outputs."""
    if not u.is_cuda:
        return ssm_scan_arranged_grad_ref(u, dtr, bc, A, D, bias, dy, reverse)
    lp, bp, dp = u.shape
    n = A.shape[-1]
    nb = bc.shape[-1]
    check(n == D_STATE, f"K6: d_state {n} must be {D_STATE}")
    check(tuple(dtr.shape) == (lp, bp, dp) and tuple(dy.shape) == (lp, bp, dp),
          "K6: dtr / dy must match u")
    check(tuple(bc.shape) == (lp, bp, nb) and nb >= 2 * n,
          f"K6: bc {tuple(bc.shape)} must be (L, B, NB >= 2N)")
    check(tuple(A.shape) == (dp, n) and tuple(D.shape) == (dp,)
          and tuple(bias.shape) == (dp,), "K6: A (Dp, N), D / bias (Dp,)")
    act = (torch.bfloat16, torch.float32)
    f32 = (torch.float32,)
    check_cuda_tensors("K6", (u, dtr, bc, A, D, bias, dy),
                       {"u": act, "dtr": f32, "bc": act, "A": f32, "D": f32,
                        "bias": f32, "dy": act})
    check(bc.dtype == u.dtype and dy.dtype == u.dtype,
          "K6: bc and dy dtype must match u")
    nchunk = -(-lp // BWD_KERNEL.constant("ssm_scan_bwd_chunk"))
    nwarp = -(-dp // 32)
    dev = u.device
    f = dict(dtype=torch.float32, device=dev)
    bnd = torch.empty((nchunk, bp, n, dp), **f)          # states entering chunks
    du = torch.empty((lp, bp, dp), dtype=u.dtype, device=dev)
    ddt = torch.empty((lp, bp, dp), **f)
    dbc_part = torch.empty((lp, bp, nwarp, 2 * n), **f)  # per-warp channel sums
    da_part = torch.empty((bp, dp, n), **f)              # per-row token sums
    dd_part = torch.empty((bp, dp), **f)
    fn = "ssm_scan_bwd_bf16" if u.dtype == torch.bfloat16 else "ssm_scan_bwd_f32"
    BWD_KERNEL.launch(
        fn, "pppppppppppppiiiiip", ptr(u), ptr(dtr), ptr(bc), ptr(A), ptr(D),
        ptr(bias), ptr(dy), ptr(bnd), ptr(du), ptr(ddt), ptr(dbc_part),
        ptr(da_part), ptr(dd_part), lp, bp, dp, nb, int(reverse), stream_of(u))
    dbc = torch.zeros((lp, bp, nb), dtype=bc.dtype, device=dev)
    dbc[:, :, :2 * n] = dbc_part.sum(2)
    return (du, ddt, dbc, da_part.sum(0), dd_part.sum(0), ddt.sum((0, 1)))


class SsmScanGroupedFn(torch.autograd.Function):
    """K1 forward; backward as ``_grouped_bwd``: per group g (branch g // 2,
    odd g right to left) dtr = slab @ dtw (plain matmul), K6, then
    dslab = ddt @ dtw^T plus dbc in lanes [rank, rank + 2N), and
    ddtw = slab^T ddt."""

    @staticmethod
    def forward(ctx, u_g, slab_g, dtw_g, A_g, D_g, bias_g, rank):
        ctx.rank = rank
        ctx.save_for_backward(u_g, slab_g, dtw_g, A_g, D_g, bias_g)
        return _grouped_fwd(u_g, slab_g, dtw_g, A_g, D_g, bias_g, rank)

    @staticmethod
    def backward(ctx, gy):
        u_g, slab_g, dtw_g, A_g, D_g, bias_g = ctx.saved_tensors
        rank = ctx.rank
        g = dtw_g.shape[0]
        dp = u_g.shape[2] // (g // 2)
        n = A_g.shape[-1]
        gy = gy.contiguous()
        du_g = torch.zeros(u_g.shape, dtype=torch.float32, device=u_g.device)
        dslab_g = torch.empty_like(slab_g)
        ddtw, dA, dD, dbias = [], [], [], []
        for gi in range(g):
            br = slice((gi // 2) * dp, (gi // 2 + 1) * dp)
            lanes = slice(gi * LANES, (gi + 1) * LANES)
            slab = slab_g[:, :, lanes].float()
            dtr = slab @ dtw_g[gi]
            bc = slab_g[:, :, gi * LANES + rank:gi * LANES + rank + 2 * n]
            grads = ssm_scan_arranged_grad(
                u_g[:, :, br].contiguous(), dtr, bc.contiguous(), A_g[gi],
                D_g[gi], bias_g[gi], gy[:, :, gi * dp:(gi + 1) * dp].contiguous(),
                reverse=bool(gi % 2))
            du, ddt, dbc, da, dd, db = grads
            del dtr
            du_g[:, :, br] += du.float()
            dslab = ddt @ dtw_g[gi].t()
            dslab[:, :, rank:rank + 2 * n] += dbc.float()
            dslab_g[:, :, lanes] = dslab.to(slab_g.dtype)
            ddtw.append(torch.einsum("lbc,lbd->cd", slab, ddt))
            dA.append(da)
            dD.append(dd)
            dbias.append(db)
        return (du_g.to(u_g.dtype), dslab_g, torch.stack(ddtw),
                torch.stack(dA), torch.stack(dD), torch.stack(dbias), None)


def ssm_scan_grouped(u_g: torch.Tensor,      # (L, B, G//2 * Dp) branch slabs
                     slab_g: torch.Tensor,   # (L, B, G * 128) [dts|B|C|mask]
                     dtw_g: torch.Tensor,    # (G, 128, Dp) f32; row 126 -1e9
                     A_g: torch.Tensor,      # (G, Dp, N) f32
                     D_g: torch.Tensor,      # (G, Dp) f32
                     bias_g: torch.Tensor,   # (G, Dp) f32
                     rank: int) -> torch.Tensor:
    """All (branch, direction) scans of one SS2D block in one launch (K1),
    differentiable through ``SsmScanGroupedFn`` (K6) when autograd needs
    it; under ``no_grad`` exactly one K1 launch. Shapes and semantics as in
    ``_grouped_fwd``."""
    args = (u_g, slab_g, dtw_g, A_g, D_g, bias_g)
    if needs_grad(*args):
        return SsmScanGroupedFn.apply(*args, rank)
    return _grouped_fwd(*args, rank)
