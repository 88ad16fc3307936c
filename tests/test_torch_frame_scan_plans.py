"""PyTorch port, the designs of K3 (frame attention) and K6 (the scan
adjoint) on the CPU.

K6 cuts every chain into segments that the card runs in parallel (replay
from a zero state, a serial join over the segment boundaries, then the
adjoint per segment from its checkpoints). ``segment_adjoint`` below is a
plain-PyTorch model of that decomposition with the kernel's sub-chunk and
segment lengths; it is held against the plain adjoint
``ssm_scan_arranged_grad_ref`` and against ``jax.vjp`` of the JAX package's
``_arranged_xla``, at ragged L, masked rows and both directions.

The wrappers' host plans (``mha.frame_plan``, ``selective_scan.bwd_plan``)
are checked at every shape the UNet, training, the 576 px clip and the
SS2D lineage give the kernels: grids that cover every token / channel /
segment once, shared memory within the card's 227 KB, and the scratch and
partial-sum buffers the kernels index.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from actalker_tpu.ops import selective_scan_pallas as SP
from actalker_tpu_torch.ops import mha, selective_scan as ss

SMEM_LIMIT = 232448      # bytes of shared memory one H100 block may use
SUB = ss.BWD_CHUNK


def segment_adjoint(u, dtr, bc, A, D, bias, dy, reverse: bool, seg_len: int):
    """K6's algorithm in plain PyTorch (float64), same outputs as
    ``ssm_scan_arranged_grad_ref``.

    1. replay: each segment from a zero state, recording per sub-chunk of
       ``SUB`` tokens the local state and the delta summed so far, and at
       its end the local state, S = sum(delta) and e0 = sum_t (prod_{s<=t}
       a_s) dy_t C_t;
    2. join: the state entering each segment and the adjoint carry entering
       it from the later side, both through exp(A S);
    3. adjoint: per segment, its sub-chunks in reverse scan order, each
       started from its checkpoint h0 + exp(A cum) h_start."""
    f64 = torch.float64
    lp, bp, dp = u.shape
    n = A.shape[-1]
    x = dtr.to(f64) + bias.to(f64)
    delta, sig = F.softplus(x), torch.sigmoid(x)
    u, dy, A, D = u.to(f64), dy.to(f64), A.to(f64), D.to(f64)
    Bm, Cm = bc[..., :n].to(f64), bc[..., n:2 * n].to(f64)
    order = list(range(lp - 1, -1, -1)) if reverse else list(range(lp))
    nseg = -(-lp // seg_len)
    segs = [range(j * seg_len, min(lp, (j + 1) * seg_len)) for j in range(nseg)]

    def step(t):
        return (torch.exp(delta[t][..., None] * A),
                Bm[t][:, None, :] * (delta[t] * u[t])[..., None])

    ck_h, ck_cum, seg_h, seg_s, seg_e = {}, {}, [], [], []
    for seg in segs:
        h = torch.zeros(bp, dp, n, dtype=f64)
        prod, e = torch.ones_like(h), torch.zeros_like(h)
        cum = torch.zeros(bp, dp, dtype=f64)
        for s in seg:
            t = order[s]
            if s % SUB == 0:
                ck_h[s // SUB], ck_cum[s // SUB] = h, cum
            a, bu = step(t)
            h = a * h + bu
            prod = prod * a
            e = e + prod * dy[t][..., None] * Cm[t][:, None, :]
            cum = cum + delta[t]
        seg_h.append(h)
        seg_s.append(cum)
        seg_e.append(e)

    h_in, k_in = [None] * nseg, [None] * nseg
    h = torch.zeros(bp, dp, n, dtype=f64)
    for j in range(nseg):
        h_in[j] = h
        h = seg_h[j] + torch.exp(A * seg_s[j][..., None]) * h
    k = torch.zeros(bp, dp, n, dtype=f64)
    for j in range(nseg - 1, -1, -1):
        k_in[j] = k
        k = seg_e[j] + torch.exp(A * seg_s[j][..., None]) * k

    du = torch.zeros(lp, bp, dp, dtype=f64)
    ddt = torch.zeros_like(du)
    dbc = torch.zeros(lp, bp, bc.shape[-1], dtype=f64)
    dA = torch.zeros(dp, n, dtype=f64)
    for j, seg in enumerate(segs):
        g = k_in[j]
        for c in range(seg[-1] // SUB, seg[0] // SUB - 1, -1):
            s0, s1 = c * SUB, min(seg[-1] + 1, (c + 1) * SUB)
            h = ck_h[c] + torch.exp(A * ck_cum[c][..., None]) * h_in[j]
            states = []
            for s in range(s0, s1):
                a, bu = step(order[s])
                h = a * h + bu
                states.append(h)
            for s in range(s1 - 1, s0 - 1, -1):
                t = order[s]
                a, _ = step(t)
                hn, p = states[s - s0], delta[t] * u[t]
                gn = g + dy[t][..., None] * Cm[t][:, None, :]
                gb = (gn * Bm[t][:, None, :]).sum(-1)
                t1 = gn * (hn - Bm[t][:, None, :] * p[..., None])   # g a h_{t-1}
                dA += (delta[t][..., None] * t1).sum(0)
                du[t] = delta[t] * gb + D * dy[t]
                ddt[t] = (u[t] * gb + (A * t1).sum(-1)) * sig[t]
                dbc[t, :, :n] = (gn * p[..., None]).sum(1)
                dbc[t, :, n:2 * n] = (dy[t][..., None] * hn).sum(1)
                g = gn * a
    return du, ddt, dbc, dA, (dy * u).sum((0, 1)), ddt.sum((0, 1))


def _rel(a, b):
    a = np.asarray(a.detach() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.detach() if torch.is_tensor(b) else b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _arranged(seed, lp, bp, dp, masked):
    """One arranged scan's operands from numpy: ``masked`` of the rows
    inactive (dtr = -1e9), B|C in the first 32 of 40 lanes."""
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    dt = r(lp, bp, dp, scale=0.5)
    dt[rng.random((lp, bp)) < masked] = -1e9
    bc = np.zeros((lp, bp, 40), np.float32)
    bc[..., :32] = r(lp, bp, 32, scale=0.5)
    return (r(lp, bp, dp), dt, bc, -np.exp(r(dp, 16, scale=0.5)), r(dp),
            r(dp, scale=0.5), r(lp, bp, dp))


# (L, segment length, masked share): L on either side of one sub-chunk and
# of one or two segments, a one-token chain, every row masked
SEGMENT_CASES = [(1, 32, 0.3), (7, 32, 0.3), (8, 32, 0.0), (9, 32, 0.3),
                 (31, 32, 0.3), (33, 32, 0.3), (63, 32, 0.0), (65, 48, 0.3),
                 (97, 48, 1.0), (129, 128, 0.3)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("lp,seg_len,masked", SEGMENT_CASES)
def test_segment_model_matches_plain_adjoint_and_jax(lp, seg_len, masked, reverse):
    """The decomposition is exact algebra: against the plain adjoint (fp32
    throughout, tol 1e-5) and ``jax.vjp`` of ``_arranged_xla`` (fp32, tol
    1e-4: XLA's blocked scan sums in another order). With every row masked
    (identity steps) ddt is exactly zero and nothing is NaN."""
    args = _arranged(lp * 7 + seg_len, lp, 2, 24, masked)
    model = segment_adjoint(*map(torch.from_numpy, args), reverse, seg_len)
    ref = ss.ssm_scan_arranged_grad_ref(*map(torch.from_numpy, args), reverse)
    _, vjp = jax.vjp(lambda *p: SP._arranged_xla(*p, reverse=reverse),
                     *map(jnp.asarray, args[:6]))
    jref = vjp(jnp.asarray(args[6]))
    for name, m, r, j in zip("du ddt dbc dA dD dbias".split(), model, ref, jref):
        assert torch.isfinite(m).all(), name
        assert _rel(m, r) < 1e-5, (name, _rel(m, r))
        assert _rel(m, np.asarray(j)) < 1e-4, (name, _rel(m, np.asarray(j)))
    if masked == 1.0:
        assert not model[1].any()


# (B*F, F, S, C, heads) of every K3 launch: the window-step (4 CFG x 14
# frames) and training (25 frames) at 512 px (res-64 / -32 / -16 / -8),
# the reference's default 576 px window (4 CFG x 25 frames; S = 72^2 and
# its halvings, down to 81, no multiple of a block's 4 tokens) and its
# training window; then the card tests' edges (F = 1, F above 32)
RES = [(4096, 320, 5), (1024, 640, 10), (256, 1280, 20), (64, 1280, 20)]
RES576 = [(5184, 320, 5), (1296, 640, 10), (324, 1280, 20), (81, 1280, 20)]
K3_SHAPES = ([(56, 14, s, c, h) for s, c, h in RES]
             + [(25, 25, s, c, h) for s, c, h in RES + RES576]
             + [(100, 25, s, c, h) for s, c, h in RES576]
             + [(2, 1, 17, 128, 2), (64, 32, 81, 320, 5), (40, 40, 9, 128, 2),
                (33, 33, 5, 64, 1), (17, 17, 1, 64, 1)])


@pytest.mark.parametrize("bf,f,s,c,h", K3_SHAPES)
def test_frame_plan(bf, f, s, c, h):
    """Every (batch, token, head) gets one warp of the tensor-core kernel
    (F <= 32; m-tiles of 16 query frames cover F) or one group of 8 lanes
    of the plain kernel; shared memory holds each warp's F query, key and
    value rows of 128 bytes, within the card's limit."""
    plan = mha.frame_plan(bf, f, s, h)
    b = bf // f
    if f <= mha.FRAME_MAX_F:
        assert 16 * (plan["m_tiles"] - 1) < f <= 16 * plan["m_tiles"] <= 32
        gx, gy, gz = plan["grid"]
        assert (gy, gz) == (h, b)
        assert gx * mha.FRAME_WARPS >= s > (gx - 1) * mha.FRAME_WARPS
        assert plan["threads"] == 32 * mha.FRAME_WARPS
        assert plan["smem"] == plan["threads"] // 32 * 3 * f * 2 * mha.HEAD_DIM
        assert plan["smem"] <= SMEM_LIMIT
    else:
        assert plan["m_tiles"] == 0 and plan["smem"] == 0
        assert plan["grid"][0] * plan["threads"] >= bf * s * h * 8


# (L, Bp, Dp, itemsize) of every K6 launch: training (SS2DCondV10 at res-64
# / -32 / -16, Bp = 25 frames, bf16), the 576 px training window (L = 72^2
# and its halvings plus the 33-token tail), the SS2D lineage at the
# window-step's res-64 (Bp = 56, V5 / V6 / V9) and MambaUPNet's stages in
# fp32 (Dp = its padded widths), then the card tests' edges
K6_SHAPES = ([(hw * hw + 33, 25, dp, 2) for hw, dp in ((64, 640), (32, 1280), (16, 2560))]
             + [(hw * hw + 33, 25, dp, 2) for hw, dp in ((72, 640), (36, 1280), (18, 2560))]
             + [(4096 + 33, 56, 640, 2), (4096 + 33, 32, 640, 2)]
             + [(l, 8, dp, 4) for l, dp in ((64, 1024), (256, 512), (1024, 256), (4096, 128))]
             + [(1, 1, 200, 4), (127, 1, 200, 2), (129, 56, 200, 4), (257, 3, 2560, 2),
                (83, 3, 100, 4), (33, 2, 72, 2)])


@pytest.mark.parametrize("lp,bp,dp,item", K6_SHAPES)
def test_bwd_plan(lp, bp, dp, item):
    """Segments of whole sub-chunks cover L once; the adjoint's grid covers
    every (channel block, segment, row) and the replay's every channel; the
    join has a thread per (row, state, channel); shared memory fits; the
    scratch buffers have a checkpoint per sub-chunk and a carry per
    segment, and the dB / dC partials one row per adjoint block."""
    plan = ss.bwd_plan(lp, bp, dp, item)
    dpp, seg_len, nseg, nsub = plan["dpp"], plan["seg_len"], plan["nseg"], plan["nsub"]
    assert dpp % 8 == 0 and dp <= dpp < dp + 8
    assert seg_len % SUB == 0 and seg_len >= ss.BWD_MIN_SEGMENT
    assert (nseg - 1) * seg_len < lp <= nseg * seg_len
    assert (nsub - 1) * SUB < lp <= nsub * SUB
    nblk = -(-dpp // ss.BWD_BLOCK)
    assert plan["grid"]["adjoint"] == (nblk, nseg, bp)
    assert plan["grid"]["replay"][0] * ss.BWD_REPLAY_BLOCK >= dpp
    assert plan["grid"]["replay"][1:] == (nseg, bp)
    assert plan["grid"]["join"][0] * 256 >= bp * 16 * dpp
    if nseg > 1:   # only as many segments as the adjoint needs to fill the card
        assert nblk * bp * (nseg - 1) < ss.BWD_TARGET_BLOCKS
    for name, smem in plan["smem"].items():
        assert 0 < smem <= SMEM_LIMIT and smem % 16 == 0, name
    n = 16
    assert plan["buffers"] == {
        "ck_h": (nsub, bp, n, dpp), "ck_cum": (nsub, bp, dpp),
        "seg_h": (nseg, bp, n, dpp), "seg_e": (nseg, bp, n, dpp),
        "seg_cum": (nseg, bp, dpp), "dbc_part": (lp, bp, nblk, 2 * n),
        "da_part": (nseg, bp, dpp, n), "dd_part": (nseg, bp, dpp),
        "db_part": (nseg, bp, dpp)}


def test_bwd_plan_partials_shrink_by_the_block():
    """At the res-64 training group the dB / dC partials hold one row per
    adjoint block of 64 channels (4 warps of 16 chains, reduced in shared
    memory): a quarter of one per warp, and half of the 264 MB of a design
    with one partial per warp of 32 chains (L = 4129, Bp = 25, Dp = 640)."""
    plan = ss.bwd_plan(4129, 25, 640, 2)
    per_warp_of_32 = 4129 * 25 * (640 // 32) * 32 * 4
    got = int(np.prod(plan["buffers"]["dbc_part"])) * 4
    assert ss.BWD_BLOCK == 16 * ss.BWD_WARPS == 64
    assert got * 2 == per_warp_of_32 == 264256000
