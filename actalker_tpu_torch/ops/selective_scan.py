"""Selective scan (Mamba S6 recurrence): plain PyTorch twins, the grouped
CUDA kernel K1 (forward), the single-direction kernel K5 (forward) and the
adjoint kernel K6 (backward); and the SSM gather's scatter back
(``gather_delta_add``: ``csrc/gather_delta_add.cu``).

Twin of ``actalker_tpu/ops/selective_scan.py`` (the plain ``seq`` /
``blocked`` scans) and of ``ssm_scan_grouped``, ``ssm_scan_arranged``,
``arrange_ssm_inputs`` and ``ssm_scan`` in
``actalker_tpu/ops/selective_scan_pallas.py``:

    delta = softplus(delta + delta_bias)
    h_t   = exp(delta_t * A) * h_{t-1} + (delta_t * B_t) * u_t
    y_t   = <C_t, h_t> + D * u_t

All accumulation is float32 whatever the input dtype. Layouts follow the JAX
package: ``selective_scan`` takes (B, L, D) sequences with (B, L, G, N)
B/C; the grouped op takes the arranged (L, B, .) buffers of one SS2D block
(SS2DCondV10); ``ssm_scan_arranged`` one direction on arranged (L, B, D)
buffers with B|C packed in 128 lanes (the SS2D lineage), and ``ssm_scan``
the same on (B, L, D) sequences.

Gradients: ``ssm_scan_grouped`` runs ``SsmScanGroupedFn`` when autograd
needs it. Its backward follows ``_grouped_bwd`` of the JAX package: per
group the raw delta projection in a plain matmul, the adjoint of the
arranged scan (K6, ``ssm_scan_arranged_grad``; twin of
``_arranged_grad_tpu``), then the delta cotangent pushed back through the
slab matmul. ``ssm_scan_arranged`` runs ``SsmScanArrangedFn``: K5 forward,
K6 backward, as the JAX package's ``custom_vjp`` pairs ``_arranged_pallas``
with ``_arranged_grad_tpu``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from actalker_tpu_torch.ops._build import (
    Kernel, check, check_cuda_tensors, cuda_tensors_ok, needs_grad, ptr,
    stream_of)

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
ARRANGED_KERNEL = Kernel(
    "ssm_scan",
    replaces="actalker_tpu/ops/selective_scan_pallas.py:75")
# the SSM gather's scatter back, a port kernel with no TPU twin: the JAX
# package scatters with XLA there
DELTA_KERNEL = Kernel(
    "gather_delta_add",
    replaces="actalker_tpu/models/ssm.py:509 (XLA scatter)")
_BT = 8           # batch rows per tile of the arranged layout


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


def _scan_serial(u, delta, A, Bm, Cm, Dv, reverse: bool, chunk: int = 64
                 ) -> torch.Tensor:
    """fp32 scan of arranged (L, B, D) buffers, sequential in L (right to
    left when ``reverse``): delta already softplus'd; A (D, N); Bm / Cm
    (L, B, N); Dv (D,). exp(delta A) and delta B u are formed for ``chunk``
    tokens at once, so no (L, B, D, N) tensor exists."""
    lp, bp, d = u.shape
    order = list(range(lp - 1, -1, -1) if reverse else range(lp))
    y = torch.empty(lp, bp, d, dtype=torch.float32, device=u.device)
    h = torch.zeros(bp, d, A.shape[-1], dtype=torch.float32, device=u.device)
    for c0 in range(0, lp, chunk):
        ts = order[c0:c0 + chunk]
        dA = torch.exp(delta[ts][..., None] * A)                  # (T, B, D, N)
        dBu = (delta[ts] * u[ts])[..., None] * Bm[ts][:, :, None]
        hs = []
        for i in range(len(ts)):
            h = dA[i] * h + dBu[i]
            hs.append(h)
        y[ts] = (torch.stack(hs) * Cm[ts][:, :, None]).sum(-1) + Dv * u[ts]
    return y


def ssm_scan_grouped_ref(u_g, slab_g, dtw_g, A_g, D_g, bias_g, rank: int
                         ) -> torch.Tensor:
    """Plain PyTorch version of K1 (twin of ``_grouped_xla``): for each group,
    delta = full 128-lane slab @ dtw (the -1e9 mask row rides the product),
    bias + softplus, B/C at lanes [rank, rank + 2N), odd groups right to
    left. Sequential in L with fp32 state; returns (L, B, G * Dp) in u's
    dtype."""
    g = dtw_g.shape[0]
    dp = u_g.shape[2] // (g // 2)
    n = A_g.shape[-1]
    outs = []
    for gi in range(g):
        u = u_g[:, :, (gi // 2) * dp:(gi // 2 + 1) * dp].float()
        slab = slab_g[:, :, gi * LANES:(gi + 1) * LANES].float()
        delta = F.softplus(slab @ dtw_g[gi].float() + bias_g[gi].float())
        y = _scan_serial(u, delta, A_g[gi].float(), slab[:, :, rank:rank + n],
                         slab[:, :, rank + n:rank + 2 * n], D_g[gi].float(),
                         reverse=bool(gi % 2))
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
    rows [0, rank) and MASK_LANE of ``dtw_g`` may be nonzero; the kernel
    takes Dp a multiple of 8 (it copies u in 16-byte vectors). CPU tensors
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
    check(dp % 8 == 0, f"K1: Dp={dp} must be a multiple of 8 (16-byte copies)")
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


# K6's geometry (csrc/ssm_scan_bwd.cu): tokens per sub-chunk (the
# checkpoint spacing), warps and channels per adjoint block (two lanes a
# channel), channels per replay block
BWD_CHUNK, BWD_WARPS = 8, 4
BWD_BLOCK, BWD_REPLAY_BLOCK = 16 * BWD_WARPS, 128
# segments are at least this long; more of them only until the adjoint has
# about this many blocks
BWD_MIN_SEGMENT, BWD_TARGET_BLOCKS = 128, 4096


def bwd_plan(lp: int, bp: int, dp: int, itemsize: int) -> dict:
    """K6's launch plan for an arranged scan of L = ``lp`` tokens, ``bp``
    rows and ``dp`` channels of ``itemsize``-byte activations.

    The kernel takes channels in multiples of 8 (16-byte copies), so ``dp``
    is padded to ``dpp``. L is cut into ``nseg`` segments of ``seg_len``
    tokens (a multiple of the sub-chunk), enough for about
    ``BWD_TARGET_BLOCKS`` adjoint blocks; ``smem`` holds the replay's and
    the adjoint's dynamic shared bytes, and ``buffers`` the shapes of the
    fp32 scratch and partial-sum buffers the wrapper allocates."""
    n, t = D_STATE, BWD_CHUNK
    dpp = _round_up(dp, 8)
    nblk = -(-dpp // BWD_BLOCK)
    nseg_want = max(1, -(-BWD_TARGET_BLOCKS // (nblk * bp)))
    seg_len = max(BWD_MIN_SEGMENT, _round_up(-(-lp // nseg_want), t))
    nseg, nsub = -(-lp // seg_len), -(-lp // t)

    def slot(ch, checkpoint):
        rows = 2 * t * ch * itemsize + t * ch * 4 + t * 2 * n * itemsize
        return rows + ((n + 1) * ch * 4 if checkpoint else 0)

    adjoint_floats = (t * 2 * n + 2 * t * BWD_BLOCK + t * n * BWD_BLOCK
                      + t * BWD_WARPS * 2 * n)
    return {
        "dpp": dpp, "seg_len": seg_len, "nseg": nseg, "nsub": nsub,
        "grid": {"replay": (-(-dpp // BWD_REPLAY_BLOCK), nseg, bp),
                 "join": (-(-bp * n * dpp // 256),),
                 "adjoint": (nblk, nseg, bp)},
        "smem": {"replay": 2 * slot(BWD_REPLAY_BLOCK, False) + t * 2 * n * 4,
                 "adjoint": 2 * slot(BWD_BLOCK, True) + adjoint_floats * 4},
        "buffers": {"ck_h": (nsub, bp, n, dpp), "ck_cum": (nsub, bp, dpp),
                    "seg_h": (nseg, bp, n, dpp), "seg_e": (nseg, bp, n, dpp),
                    "seg_cum": (nseg, bp, dpp),
                    "dbc_part": (lp, bp, nblk, 2 * n),
                    "da_part": (nseg, bp, dpp, n), "dd_part": (nseg, bp, dpp),
                    "db_part": (nseg, bp, dpp)},
    }


def ssm_scan_arranged_grad(u, dtr, bc, A, D, bias, dy, reverse: bool):
    """Adjoint of one arranged scan (K6). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. See
    ``ssm_scan_arranged_grad_ref`` for shapes and outputs; the launch plan is
    ``bwd_plan``'s (channels padded to a multiple of 8 with zeros, which
    leaves every cotangent of the real channels as it is)."""
    if not u.is_cuda:
        return ssm_scan_arranged_grad_ref(u, dtr, bc, A, D, bias, dy, reverse)
    lp, bp, dp = u.shape
    n = A.shape[-1]
    nb = bc.shape[-1]
    check(n == D_STATE, f"K6: d_state {n} must be {D_STATE}")
    check(tuple(dtr.shape) == (lp, bp, dp) and tuple(dy.shape) == (lp, bp, dp),
          "K6: dtr / dy must match u")
    check(tuple(bc.shape) == (lp, bp, nb) and nb >= 2 * n and nb % 8 == 0,
          f"K6: bc {tuple(bc.shape)} must be (L, B, NB >= 2N), NB % 8 == 0")
    check(tuple(A.shape) == (dp, n) and tuple(D.shape) == (dp,)
          and tuple(bias.shape) == (dp,), "K6: A (Dp, N), D / bias (Dp,)")
    act = (torch.bfloat16, torch.float32)
    f32 = (torch.float32,)
    check_cuda_tensors("K6", (u, dtr, bc, A, D, bias, dy),
                       {"u": act, "dtr": f32, "bc": act, "A": f32, "D": f32,
                        "bias": f32, "dy": act})
    check(bc.dtype == u.dtype and dy.dtype == u.dtype,
          "K6: bc and dy dtype must match u")
    plan = bwd_plan(lp, bp, dp, u.element_size())
    dpp = plan["dpp"]
    if dpp != dp:
        u, dtr, dy = (F.pad(x, (0, dpp - dp)) for x in (u, dtr, dy))
        A = F.pad(A, (0, 0, 0, dpp - dp))
        D, bias = F.pad(D, (0, dpp - dp)), F.pad(bias, (0, dpp - dp))
    dev = u.device
    buf = {k: torch.empty(shape, dtype=torch.float32, device=dev)
           for k, shape in plan["buffers"].items()}
    du = torch.empty((lp, bp, dpp), dtype=u.dtype, device=dev)
    ddt = torch.empty((lp, bp, dpp), dtype=torch.float32, device=dev)
    fn = "ssm_scan_bwd_bf16" if u.dtype == torch.bfloat16 else "ssm_scan_bwd_f32"
    BWD_KERNEL.launch(
        fn, "p" * 18 + "i" * 8 + "p", ptr(u), ptr(dtr), ptr(bc), ptr(A),
        ptr(D), ptr(bias), ptr(dy), ptr(buf["ck_h"]), ptr(buf["ck_cum"]),
        ptr(buf["seg_h"]), ptr(buf["seg_e"]), ptr(buf["seg_cum"]), ptr(du),
        ptr(ddt), ptr(buf["dbc_part"]), ptr(buf["da_part"]),
        ptr(buf["dd_part"]), ptr(buf["db_part"]), lp, bp, dpp, nb,
        int(reverse), plan["seg_len"], plan["smem"]["replay"],
        plan["smem"]["adjoint"], stream_of(u))
    dbc = buf["dbc_part"].sum(2).to(bc.dtype)
    if nb != 2 * n:
        dbc = F.pad(dbc, (0, nb - 2 * n))
    return (du[..., :dp], ddt[..., :dp], dbc, buf["da_part"].sum((0, 1))[:dp],
            buf["dd_part"].sum((0, 1))[:dp], buf["db_part"].sum((0, 1))[:dp])


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


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pick_lc(lc: int, l: int, dp: int, np_: int, itemsize: int) -> int:
    """The L chunk of the JAX package's arranged layout (twin of
    ``_pick_lc``); ``arrange_ssm_inputs`` pads L to a multiple of it."""
    budget = 8 * 2**20
    per_row = _BT * (3 * dp + np_) * itemsize * 2
    unroll = 4 if dp <= 1280 else 2
    picked = max(unroll, min(lc, max(8, budget // per_row), _round_up(l, 8)))
    return max(unroll, picked - picked % unroll)


def ssm_scan_arranged_ref(u_a, dt_a, bc_a, A, D, bias, reverse: bool
                          ) -> torch.Tensor:
    """Plain version of K5 (twin of ``_arranged_xla``).

    u_a, dt_a (L, B, Dp) in the model dtype, dt_a the raw delta (bias and
    softplus are applied here); bc_a (L, B, NB >= 2N) with B in lanes
    [0, N) and C in [N, 2N); A (D, N); D, bias (D,), D <= Dp. fp32 state,
    right to left when ``reverse``. Returns (L, B, Dp) in u's dtype, zero in
    channels [D, Dp)."""
    d, n = A.shape
    delta = F.softplus(dt_a[:, :, :d].float() + bias.float())
    y = _scan_serial(u_a[:, :, :d].float(), delta, A.float(),
                     bc_a[..., :n].float(), bc_a[..., n:2 * n].float(),
                     D.float(), reverse)
    return F.pad(y, (0, u_a.shape[2] - d)).to(u_a.dtype)


_ACT = (torch.bfloat16, torch.float32)
_K5_DTYPES = {"u": _ACT, "dt": _ACT, "bc": _ACT, "A": (torch.float32,),
              "D": (torch.float32,), "bias": (torch.float32,)}

# K5's geometry (csrc/ssm_scan.cu): tokens a ring slot holds (a segment is
# a multiple of it), chains a block (two lanes each)
FWD_CHUNK, FWD_BLOCK = 32, 64
# the wide path (one walk a chain) from this many chains (about two waves
# of 128-chain groups on the card's 132 SMs); below it the chain is cut
# into segments of at least FWD_MIN_SEGMENT tokens, enough for about
# FWD_TARGET_BLOCKS blocks, where that makes more than two
FWD_WIDE_CHAINS, FWD_TARGET_BLOCKS, FWD_MIN_SEGMENT = 264 * 128, 1056, 32


def _fwd_smem(itemsize: int) -> int:
    """K5's dynamic shared bytes: a ring of two chunks (u, dt and the 2N
    B|C lanes), the chunk's B|C rows and deltas in fp32."""
    slot = (2 * FWD_CHUNK * FWD_BLOCK * itemsize
            + FWD_CHUNK * 2 * D_STATE * itemsize)
    return 2 * slot + FWD_CHUNK * 2 * D_STATE * 4 + FWD_CHUNK * FWD_BLOCK * 4


def _padded_f32(t, rows: int):
    """t (fp32, contiguous) with its first axis zero-padded to ``rows``:
    t itself when it already is one."""
    if t.shape[0] == rows and t.dtype is torch.float32 and t.is_contiguous():
        return t
    pad = (0, 0) * (t.ndim - 1) + (0, rows - t.shape[0])
    return F.pad(t.float(), pad).contiguous()


@functools.lru_cache(maxsize=256)
def fwd_plan(lp: int, bp: int, dp: int, itemsize: int) -> dict:
    """K5's launch plan for an arranged scan of L = ``lp`` tokens, ``bp``
    rows and ``dp`` channels of ``itemsize``-byte activations (cached: one
    dict per shape, not to be changed).

    Channels are padded to ``dpp``, a multiple of 8 (16-byte copies), and
    taken ``FWD_BLOCK`` to a block. With ``FWD_WIDE_CHAINS`` chains or more,
    or where cutting would give two segments or fewer, the path is "wide":
    one walk a chain, ``seg_len`` >= L, ``nseg`` 1. Else "segments":
    ``nseg`` segments of ``seg_len`` tokens (a multiple of the chunk), a
    replay, a join and a second walk, with the ``buffers`` the wrapper
    allocates (each segment's end state and decay product but the
    last's). ``smem``: the walks' dynamic shared bytes."""
    dpp = _round_up(dp, 8)
    nblk = -(-dpp // FWD_BLOCK)
    want = -(-FWD_TARGET_BLOCKS // (nblk * bp))
    seg_len = max(FWD_MIN_SEGMENT, _round_up(-(-lp // want), FWD_CHUNK))
    nseg = -(-lp // seg_len)
    if bp * dpp >= FWD_WIDE_CHAINS or nseg <= 2:
        return {"path": "wide", "dpp": dpp,
                "seg_len": _round_up(max(lp, 1), FWD_CHUNK), "nseg": 1,
                "grid": {"walk": (nblk, bp)}, "buffers": {},
                "smem": _fwd_smem(itemsize)}
    rec = (nseg - 1, bp, D_STATE, dpp)
    return {"path": "segments", "dpp": dpp, "seg_len": seg_len, "nseg": nseg,
            "grid": {"replay": (nblk, nseg - 1, bp),
                     "join": (-(-bp * D_STATE * dpp // 256),),
                     "walk": (nblk, nseg - 1, bp)},
            "buffers": {"seg_h": rec, "seg_p": rec}, "smem": _fwd_smem(itemsize)}


def _arranged_fwd(u_a, dt_a, bc_a, A, D, bias, reverse: bool) -> torch.Tensor:
    """K5 forward, no autograd; shapes as ``ssm_scan_arranged_ref``. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise. The launch plan is ``fwd_plan``'s (channels padded to a multiple
    of 8 with zeros, which the output drops)."""
    if not u_a.is_cuda:
        return ssm_scan_arranged_ref(u_a, dt_a, bc_a, A, D, bias, reverse)
    lp, bp, dp = u_a.shape
    d, n = A.shape
    nb = bc_a.shape[-1]
    if not (n == D_STATE and d <= dp and D.shape == (d,) and bias.shape == (d,)
            and dt_a.shape == u_a.shape and bc_a.shape[:2] == u_a.shape[:2]
            and nb >= 2 * n and nb % 8 == 0):
        check(n == D_STATE, f"K5: d_state {n} must be {D_STATE}")
        check(d <= dp and tuple(D.shape) == (d,) and tuple(bias.shape) == (d,),
              f"K5: A {tuple(A.shape)}, D / bias (D,) with D <= Dp = {dp}")
        check(tuple(dt_a.shape) == (lp, bp, dp), "K5: dt must match u")
        check(False, f"K5: bc {tuple(bc_a.shape)} must be (L, B, NB >= 2N), "
              "NB % 8 == 0")
    plan = fwd_plan(lp, bp, dp, u_a.element_size())
    dpp = plan["dpp"]
    if not (d == dp == dpp and dt_a.dtype is u_a.dtype and bc_a.dtype is u_a.dtype
            and cuda_tensors_ok((u_a, dt_a, bc_a, A, D, bias), _K5_DTYPES)):
        # pad channels get A = D = bias = 0 (as _arranged_pallas pads them)
        A, D, bias = (_padded_f32(t, dpp) for t in (A, D, bias))
        check_cuda_tensors("K5", (u_a, dt_a, bc_a, A, D, bias), _K5_DTYPES)
        if not (dt_a.dtype is u_a.dtype and bc_a.dtype is u_a.dtype):
            check(False, "K5: dt and bc dtype must match u")
        if dpp != dp:
            u_a, dt_a = (F.pad(x, (0, dpp - dp)) for x in (u_a, dt_a))
    y = torch.empty((lp, bp, dpp), dtype=u_a.dtype, device=u_a.device)
    seg_h = seg_p = None
    if plan["buffers"]:
        rec = plan["buffers"]["seg_h"]
        size = rec[0] * rec[1] * rec[2] * rec[3]
        buf = torch.empty(2 * size, dtype=torch.float32, device=u_a.device)
        seg_h = buf.data_ptr()
        seg_p = seg_h + 4 * size
    fn = "ssm_scan_bf16" if u_a.dtype == torch.bfloat16 else "ssm_scan_f32"
    ARRANGED_KERNEL.launch(
        fn, "p" * 9 + "i" * 7 + "p", u_a.data_ptr(), dt_a.data_ptr(),
        bc_a.data_ptr(), A.data_ptr(), D.data_ptr(), bias.data_ptr(),
        y.data_ptr(), seg_h, seg_p, lp, bp, dpp, nb, int(reverse),
        plan["seg_len"], plan["smem"], stream_of(u_a))
    return y if dpp == dp else y[..., :dp].contiguous()


class SsmScanArrangedFn(torch.autograd.Function):
    """K5 forward; backward the arranged adjoint ``ssm_scan_arranged_grad``
    (K6 on the card, the plain adjoint on the CPU), as ``_arranged_bwd``
    pairs them. dt reaches K6 as fp32; A / D / bias are padded to Dp and
    the pad channels' cotangents zeroed, as ``_arranged_grad_tpu`` does."""

    @staticmethod
    def forward(ctx, u_a, dt_a, bc_a, A, D, bias, reverse):
        ctx.reverse = reverse
        ctx.save_for_backward(u_a, dt_a, bc_a, A, D, bias)
        return _arranged_fwd(u_a, dt_a, bc_a, A, D, bias, reverse)

    @staticmethod
    def backward(ctx, gy):
        u_a, dt_a, bc_a, A, D, bias = ctx.saved_tensors
        d, dp = A.shape[0], u_a.shape[2]
        gy = F.pad(gy[:, :, :d].to(u_a.dtype), (0, dp - d)).contiguous()
        du, ddt, dbc, da, dd, db = ssm_scan_arranged_grad(
            u_a.contiguous(), dt_a.float().contiguous(), bc_a.contiguous(),
            F.pad(A.float(), (0, 0, 0, dp - d)).contiguous(),
            *(F.pad(t.float(), (0, dp - d)).contiguous() for t in (D, bias)),
            gy, ctx.reverse)
        return (du, ddt.to(dt_a.dtype), dbc, da[:d].to(A.dtype),
                dd[:d].to(D.dtype), db[:d].to(bias.dtype), None)


def ssm_scan_arranged(u_a: torch.Tensor,   # (L, B, Dp) arranged, zero-padded
                      dt_a: torch.Tensor,  # (L, B, Dp) raw delta; -1e9 rows inactive
                      bc_a: torch.Tensor,  # (L, B, 128) packed B | C lanes
                      A: torch.Tensor,     # (D, N)
                      D=None, delta_bias=None,
                      reverse: bool = False) -> torch.Tensor:
    """One direction of the S6 scan on arranged buffers (twin of
    ``ssm_scan_arranged``); returns (L, B, Dp) in u's dtype. Under
    ``no_grad`` exactly one K5 launch; differentiable through
    ``SsmScanArrangedFn`` (K5 forward, K6 backward) when autograd needs it."""
    d = A.shape[0]
    if D is None:
        D = torch.zeros(d, dtype=torch.float32, device=A.device)
    if delta_bias is None:
        delta_bias = torch.zeros(d, dtype=torch.float32, device=A.device)
    args = (u_a, dt_a, bc_a, A, D, delta_bias)
    if needs_grad(*args):
        return SsmScanArrangedFn.apply(*args, reverse)
    return _arranged_fwd(*args, reverse)


def arrange_ssm_inputs(u, delta, Bmat, Cmat, lc: int = 64):
    """(B, L, ...) -> padded (L, B, ...) buffers for ``ssm_scan_arranged``
    (twin of ``arrange_ssm_inputs``): D padded to a multiple of 128, B to a
    multiple of 8, L to a multiple of the JAX package's chunk. Batch pad
    rows are harmless garbage lanes; L-pad rows get delta = -30 (softplus
    ~1e-13: identity steps). B|C is cast to u's dtype."""
    b, l, d = u.shape
    n = Bmat.shape[-1]
    check(2 * n <= LANES, f"d_state {n} too large for packed B|C")
    dp, bp = _round_up(d, 128), _round_up(b, _BT)
    lp = _round_up(l, _pick_lc(lc, l, dp, LANES, u.element_size()))
    u_a = F.pad(u.transpose(0, 1), (0, dp - d, 0, bp - b, 0, lp - l))
    dt_a = F.pad(delta.transpose(0, 1), (0, dp - d, 0, bp - b))
    dt_a = F.pad(dt_a, (0, 0, 0, 0, 0, lp - l), value=-30.0)
    bc = torch.cat([Bmat, Cmat], dim=-1).to(u.dtype)
    bc_a = F.pad(bc.transpose(0, 1), (0, LANES - 2 * n, 0, bp - b, 0, lp - l))
    return u_a.contiguous(), dt_a.contiguous(), bc_a.contiguous()


def ssm_scan(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
             reverse: bool = False, lc: int = 64) -> torch.Tensor:
    """Selective scan of (B, L, D) sequences through the arranged op (twin
    of ``ssm_scan``): u, delta (B, L, D); A (D, N); Bmat, Cmat (B, L, N).
    Returns (B, L, D) in u's dtype."""
    b, l, d = u.shape
    u_a, dt_a, bc_a = arrange_ssm_inputs(u, delta, Bmat, Cmat, lc=lc)
    y = ssm_scan_arranged(u_a, dt_a, bc_a, A, D, delta_bias, reverse=reverse)
    return y[:l, :b, :d].transpose(0, 1)


def gather_delta_add_ref(y, s, u, tok, act) -> None:
    """Plain version of ``gather_delta_add`` (the difference in fp32, or
    wider, rounded to y's dtype, then an indexed add; an inactive slot adds
    an exact zero)."""
    di = y.shape[-1]
    acc = torch.promote_types(y.dtype, torch.float32)
    delta = s.unflatten(-1, (2, di)).sum(-2, dtype=acc).sub_(u).to(y.dtype)
    delta.masked_fill_(~act[..., None], 0.0)
    y.view(-1, di).index_add_(0, tok.reshape(-1), delta.view(-1, di))


def _rows_ok(t, k: int, b: int, width: int, vec: int) -> bool:
    """t (k, b, width): rows of ``width`` contiguous elements at one stride,
    a multiple of the 16-byte vector, on a 16-byte boundary."""
    return (tuple(t.shape) == (k, b, width) and t.stride(2) == 1
            and t.stride(0) == t.stride(1) * b and t.stride(1) % vec == 0
            and t.data_ptr() % 16 == 0)


def _delta_add_launch(y, s, u, tok, act) -> None:
    """``gather_delta_add``'s kernel launch on CUDA tensors, no autograd."""
    tok, act = tok.contiguous(), act.contiguous()      # (K, B): small
    check_cuda_tensors("gather_delta_add", (y, tok, act), {
        "y": _ACT, "tok": (torch.int64,), "act": (torch.bool,)})
    k, b, _ = s.shape
    di, vec = y.shape[-1], 16 // y.element_size()
    check(di % vec == 0 and s.dtype == u.dtype == y.dtype
          and _rows_ok(s, k, b, 2 * di, vec) and _rows_ok(u, k, b, di, vec),
          f"gather_delta_add: s {tuple(s.shape)} / u {tuple(u.shape)} must be "
          f"rows of 2 D / D at 16-byte strides in y's dtype (D = {di})")
    check(tuple(tok.shape) == tuple(act.shape) == (k, b),
          f"gather_delta_add: tok / act {tuple(tok.shape)} / {tuple(act.shape)}")
    if k * b == 0:
        return
    fn = ("gather_delta_add_bf16" if y.dtype == torch.bfloat16
          else "gather_delta_add_f32")
    DELTA_KERNEL.launch(fn, "pppppiiiip", ptr(y), ptr(s), ptr(u), ptr(tok),
                        ptr(act), k * b, di, s.stride(1), u.stride(1),
                        stream_of(y))


class GatherDeltaAddFn(torch.autograd.Function):
    """``gather_delta_add`` under autograd, in place on y: the forward is
    the kernel on CUDA tensors (the plain version on the CPU); the backward
    is plain gathers: y's gradient passes through, each scan direction's is
    y's gradient at the slot's token where the slot is active, u's its
    negation."""

    @staticmethod
    def forward(ctx, y, s, u, tok, act):
        if y.is_cuda:
            _delta_add_launch(y, s, u, tok, act)
        else:
            gather_delta_add_ref(y, s, u, tok, act)
        ctx.mark_dirty(y)
        ctx.save_for_backward(tok, act)
        return y

    @staticmethod
    def backward(ctx, dy):
        tok, act = ctx.saved_tensors
        di = dy.shape[-1]
        g = dy.reshape(-1, di)[tok.reshape(-1)].view(*tok.shape, di)
        g = g.masked_fill(~act[..., None], 0.0)
        return dy, torch.cat([g, g], dim=-1), -g, None, None


def gather_delta_add(y: torch.Tensor,      # (..., D) tokens, updated in place
                     s: torch.Tensor,      # (K, B, 2 D) two scan directions
                     u: torch.Tensor,      # (K, B, D) the slots' projections
                     tok: torch.Tensor,    # (K, B) int64 rows of y (..., D)
                     act: torch.Tensor,    # (K, B) bool
                     ) -> None:
    """At every active slot r: y[tok[r]] += (s[r, :D] + s[r, D:]) - u[r],
    over y's rows of D (y contiguous), the sums in fp32 and one rounding to
    y's dtype on the store; an inactive slot writes nothing. The active
    slots name distinct rows. s and u may be strided views of K1's output
    and input (rows at one stride each). CPU tensors take the plain
    version; CUDA tensors launch ``csrc/gather_delta_add.cu`` (bf16 /
    fp32; under autograd through ``GatherDeltaAddFn``) or raise."""
    if not y.is_cuda:
        gather_delta_add_ref(y, s, u, tok, act)
    elif needs_grad(y, s, u):
        GatherDeltaAddFn.apply(y, s, u, tok, act)
    else:
        _delta_add_launch(y, s, u, tok, act)
