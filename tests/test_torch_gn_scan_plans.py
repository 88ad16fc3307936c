"""PyTorch port, the designs of K7-GN (GroupNorm) and K5 (the
single-direction S6 scan) on the CPU.

K7-GN sums x per channel and per group in partial sums that the card adds
in a fixed order: per statistics block (the two-pass path) or per CTA of a
thread-block cluster (the cluster path). ``gn_partial_sums`` below models
that decomposition in plain PyTorch from ``gn_plan``'s own plan and is held
against ``gn_affine`` and the JAX package's ``_gn_xla``. ``gn_plan`` is
checked at every GroupNorm shape of the UNet and the VAE in the fused-norm
configuration: shared memory within the card's 227 KB, clusters of at most
``GN_MAX_CLUSTER`` CTAs, slices of whole groups and whole 16-byte vectors
no wider than a TMA box, and every row of an image covered once.

K5 cuts a narrow shape's chains into segments that run in parallel (a walk
from a zero state recording each segment's end state and the running
product of its decays, a serial join, a second walk).
``segment_forward`` models it and is held against ``ssm_scan_arranged_ref``
and against the JAX package's arranged scan (its Pallas kernel in
interpret mode, as ``tests/test_torch_ssm_spatial.py`` runs it), in both
directions and dtypes, with masked rows and L = 1. ``fwd_plan`` is checked
at every lineage shape.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from actalker_tpu.ops import norms as jnorms
from actalker_tpu.ops import selective_scan_pallas as SP
from actalker_tpu_torch.ops import norms, selective_scan as ss
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)

SMEM_LIMIT = 232448      # bytes of shared memory one H100 block may use


def _rel(a, b):
    a = np.asarray(a.detach().float() if torch.is_tensor(a) else a, np.float64)
    b = np.asarray(b.detach().float() if torch.is_tensor(b) else b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---- K7-GN ------------------------------------------------------------------

# (N, M, C) of every K7-GN launch in the fused-norm configuration. UNet at
# the window-step (4 CFG x 14 frames): the transformers' norms (56, HW, C),
# the temporal resnets' (4, 14 HW, C), the output norm, and K8's statistics
# at every ResnetBlock2D norm (56, HW, C_in / C_out). VAE at 512 px: the
# decoder's 14 frames and the encoder's one image, its resnets' statistics
# at every (HW, C), its temporal resnets' (1, 14 HW, C), the mid attention
# and output norms.
UNET_RES = [(4096, 320), (1024, 640), (256, 1280), (64, 1280)]
UNET_K8 = [(4096, c) for c in (320, 640, 960)] + [
    (1024, c) for c in (320, 640, 960, 1280, 1920)] + [
    (256, c) for c in (640, 1280, 1920, 2560)] + [(64, c) for c in (1280, 2560)]
VAE_HW = [64 * 64, 128 * 128, 256 * 256, 512 * 512]
GN_SHAPES = sorted(set(
    [(56, m, c) for m, c in UNET_RES + UNET_K8]
    + [(4, 14 * m, c) for m, c in UNET_RES]
    + [(n, m, c) for n in (14, 1) for m in VAE_HW for c in (128, 256, 512)]
    + [(1, 14 * m, c) for m in VAE_HW for c in (128, 256, 512)]))
# the card tests' edges: C / G = 2, 4, 10, 30, 40; one row; N = 1; ragged M
GN_EDGES = [(3, 100, 320), (2, 57, 960), (1, 6144, 128), (2, 105, 320),
            (2, 50, 64), (1, 1, 320), (3, 4096, 1280), (1, 300, 2560),
            (2, 72, 64)]


def _gn_checks(n, m, c, groups, item, plan):
    vec = 16 // item
    cg = c // groups
    st = plan["stats"]
    assert 0 < st["threads"] <= norms.GN_MAX_THREADS
    cw = min(c // vec, st["threads"])
    assert st["threads"] % cw == 0
    assert st["smem"] <= SMEM_LIMIT
    # the statistics blocks cover every row of an image once
    assert (st["chunks"] - 1) * st["rows"] < m <= st["chunks"] * st["rows"]
    assert st["chunks"] <= norms.GN_MAX_CHUNKS
    assert st["part"] == n * st["chunks"] * groups
    assert plan["apply_rows"] >= 1
    cl = plan["cluster"]
    if plan["path"] == "cluster":
        assert cl is not None
    if cl is None:
        return
    sc, p = cl["sc"], cl["p"]
    # whole groups, whole 16-byte vectors, at most one TMA box wide
    assert sc % cg == 0 and c % sc == 0 and sc * item % 16 == 0
    assert sc <= norms.GN_MAX_BOX and cl["slices"] == c // sc
    assert sc * item >= min(norms.GN_MIN_SLICE_BYTES, c * item)
    assert 1 <= p <= norms.GN_MAX_CLUSTER <= 8
    # the cluster's CTAs cover every row of the slice once (the last may
    # hold fewer rows, or none)
    assert (p - 1) * cl["rows_cta"] < m <= p * cl["rows_cta"]
    assert cl["box_rows"] % 8 == 0 and 0 < cl["box_rows"] <= norms.GN_MAX_BOX
    assert cl["nbox"] * cl["box_rows"] >= cl["rows_cta"]
    assert cl["nbox"] * cl["box_rows"] * sc * item <= norms.GN_CLUSTER_X_BYTES
    nvs = sc * item // 16
    assert 0 < cl["threads"] <= norms.GN_MAX_THREADS
    assert cl["threads"] % min(nvs, cl["threads"]) == 0
    assert cl["smem"] <= SMEM_LIMIT
    assert cl["ctas"] == n * cl["slices"] * p


@pytest.mark.parametrize("item", [2, 4])
@pytest.mark.parametrize("n,m,c", GN_SHAPES + GN_EDGES,
                         ids=[f"{n}x{m}x{c}" for n, m, c in GN_SHAPES + GN_EDGES])
def test_gn_plan_fits_and_covers(n, m, c, item):
    groups = 32 if c % 32 == 0 else 8
    plan = norms.gn_plan(n, m, c, groups, item)
    _gn_checks(n, m, c, groups, item, plan)
    # the two-pass path takes every shape; the cluster path where a cluster
    # holds an image's slice and the launch fills the card
    assert norms.gn_plan(n, m, c, groups, item, path="two_pass")["path"] == "two_pass"
    cl = plan["cluster"]
    want = ("cluster" if cl is not None and cl["ctas"] >= norms.GN_CLUSTER_MIN_CTAS
            else "two_pass")
    assert plan["path"] == want
    if cl is None:
        with pytest.raises(ValueError):
            norms.gn_plan(n, m, c, groups, item, path="cluster")


def test_gn_plan_paths_at_the_main_shapes():
    """x is read once (one launch) at the UNet's transformer shapes; the
    images too large for a cluster (temporal resnets, the VAE's 512 px
    frames) take two passes."""
    for shape in [(56, m, c) for m, c in UNET_RES]:
        assert norms.gn_plan(*shape, 32, 2)["path"] == "cluster", shape
    for shape in [(4, 14 * 4096, 320), (14, 512 * 512, 128), (1, 14 * 512 * 512, 128)]:
        assert norms.gn_plan(*shape, 32, 2)["path"] == "two_pass", shape


def gn_partial_sums(x, groups, plan, path):
    """The kernel's per-group (sum, sum of squares), (N, G, 2) fp32, added
    in its order: per channel over each block's rows (two-pass: a chunk of
    ``rows`` rows; cluster: a CTA's ``rows_cta`` rows of an sc-channel
    slice), then over the block's channels per group, then the blocks in
    their fixed order (chunk order; cluster rank order)."""
    n, m, c = x.shape
    cg = c // groups
    xf = x.float()
    sq = xf * xf
    out = torch.zeros(n, groups, 2)
    if path == "two_pass":
        rows = plan["stats"]["rows"]
        spans = [(r, min(m, r + rows)) for r in range(0, m, rows)]
        slices = [(0, c)]
    else:
        cl = plan["cluster"]
        rows = cl["rows_cta"]
        spans = [(r * rows, min(m, (r + 1) * rows)) for r in range(cl["p"])]
        slices = [(s * cl["sc"], (s + 1) * cl["sc"]) for s in range(cl["slices"])]
    for c0, c1 in slices:
        g0, g1 = c0 // cg, c1 // cg
        acc = torch.zeros(n, g1 - g0, 2)
        for r0, r1 in spans:
            s1 = xf[:, r0:r1, c0:c1].sum(1).reshape(n, g1 - g0, cg).sum(-1)
            s2 = sq[:, r0:r1, c0:c1].sum(1).reshape(n, g1 - g0, cg).sum(-1)
            acc = acc + torch.stack([s1, s2], -1)
        out[:, g0:g1] = acc
    return out


def gn_model(x, gamma, beta, groups, eps, plan, path):
    """(a, b) (N, C) and y from the partial sums, as the kernel finishes:
    mean, rsqrt of the variance clamped at 0 plus eps, the affine in fp32,
    y rounded once to x's dtype."""
    n, m, c = x.shape
    s = gn_partial_sums(x, groups, plan, path) / (m * (c // groups))
    mean, inv = s[..., 0], torch.rsqrt((s[..., 1] - s[..., 0] ** 2).clamp_min(0) + eps)
    a = inv.repeat_interleave(c // groups, 1) * gamma[None]
    b = beta[None] - mean.repeat_interleave(c // groups, 1) * a
    y = (x.float() * a[:, None] + b[:, None]).to(x.dtype)
    return a, b, y


GN_MODEL_CASES = [(3, 100, 320, 32), (2, 57, 960, 32), (1, 6144, 128, 32),
                  (2, 50, 64, 32), (1, 1, 320, 32), (3, 300, 1280, 32),
                  (2, 72, 64, 8)]


@pytest.mark.parametrize("path", ["two_pass", "cluster"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m,c,groups", GN_MODEL_CASES)
def test_gn_decomposition_matches_plain_and_jax(n, m, c, groups, dtype, path):
    """The plan's partial-sum order gives the plain version's affine (fp32,
    tol 1e-5) and the JAX package's ``_gn_xla`` output (tol 1e-5 in fp32;
    in bf16 1e-3: one rounding of the output, which a last-bit difference
    of the fp32 statistics can flip)."""
    rng = np.random.default_rng(n * 1000 + m + c)
    x = (2.0 * rng.standard_normal((n, m, c)) - 0.5).astype(np.float32)
    gamma, beta = (rng.standard_normal(c).astype(np.float32) for _ in range(2))
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td)
    item = xt.element_size()
    plan = norms.gn_plan(n, m, c, groups, item, path=path)
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    a_m, b_m, y_m = gn_model(xt, g, b, groups, 1e-6, plan, path)
    a_r, b_r = norms.gn_affine(xt, g, b, groups, 1e-6)
    assert _rel(a_m, a_r) < 1e-5 and _rel(b_m, b_r) < 1e-5
    want = jnorms._gn_xla(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(gamma),
                          jnp.asarray(beta), groups, 1e-6)
    tol = 1e-5 if dtype == "float32" else 1e-3
    assert _rel(y_m, np.asarray(want.astype(jnp.float32))) < tol
    assert _rel(y_m, norms.group_norm_ref(xt, g, b, groups, 1e-6)) < tol


# ---- K5 -----------------------------------------------------------------------


def segment_forward(u, dt, bc, A, D, bias, reverse: bool, seg_len: int):
    """K5's segment path in plain PyTorch (float64), same output as
    ``ssm_scan_arranged_ref`` (in u's dtype).

    1. each segment but the last walks from a zero state; it records its
       end state h0(j) and the running product P(j) of its decays (exactly
       1 over masked rows: softplus(-1e9) = 0, exp(0) = 1);
    2. join: h_start(j + 1) = h0(j) + P(j) h_start(j), h_start(0) = 0;
    3. each segment walks from h_start(j) and writes y."""
    f64 = torch.float64
    lp, bp, dp = u.shape
    d, n = A.shape
    delta = F.softplus(dt[..., :d].to(f64) + bias.to(f64))
    uu, A64, D64 = u[..., :d].to(f64), A.to(f64), D.to(f64)
    Bm, Cm = bc[..., :n].to(f64), bc[..., n:2 * n].to(f64)
    order = list(range(lp - 1, -1, -1)) if reverse else list(range(lp))
    nseg = -(-lp // seg_len)
    segs = [order[j * seg_len:(j + 1) * seg_len] for j in range(nseg)]

    def walk(seg, h, y=None):
        prod = torch.ones_like(h)
        for t in seg:
            a = torch.exp(delta[t][..., None] * A64)
            h = a * h + Bm[t][:, None, :] * (delta[t] * uu[t])[..., None]
            prod = prod * a
            if y is not None:
                y[t, :, :d] = (h * Cm[t][:, None, :]).sum(-1) + D64 * uu[t]
        return h, prod

    zero = torch.zeros(bp, d, n, dtype=f64)
    ends = [walk(seg, zero) for seg in segs[:-1]]
    starts, hs = [zero], zero
    for h0, prod in ends:
        hs = h0 + prod * hs
        starts.append(hs)
    y = torch.zeros(lp, bp, dp, dtype=f64)
    for seg, h in zip(segs, starts):
        walk(seg, h, y)
    return y.to(u.dtype)


def _arranged(seed, lp, bp, dp, d, masked):
    """One arranged scan's operands from numpy: channels [d, dp) padded
    (zero u), ``masked`` of the rows inactive (dt = -1e9), B|C in the first
    32 of 128 lanes."""
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    u = r(lp, bp, dp)
    u[..., d:] = 0
    dt = r(lp, bp, dp, scale=0.5)
    dt[rng.random((lp, bp)) < masked] = -1e9
    bc = np.zeros((lp, bp, 128), np.float32)
    bc[..., :32] = r(lp, bp, 32, scale=0.5)
    return u, dt, bc, -np.exp(r(d, 16, scale=0.5)), r(d), r(d, scale=0.5)


def _jax_arranged(u, dt, bc, A, D, bias, reverse, dtype):
    """The JAX package's arranged scan (its Pallas kernel, interpret mode
    on the CPU) on the operands padded with masked rows to its L chunk and
    8-row tiles; the first L rows and Bp rows back."""
    lp, bp, dp = u.shape
    lc = SP._pick_lc(64, lp, dp, bc.shape[-1], np.dtype(dtype).itemsize)
    lpp, bpp = -(-lp // lc) * lc, -(-bp // 8) * 8

    def pad(x, value=0.0):
        return np.pad(x, ((0, lpp - lp), (0, bpp - bp), (0, 0)),
                      constant_values=value)

    jd = getattr(jnp, dtype)
    y = SP.ssm_scan_arranged(jnp.asarray(pad(u), jd), jnp.asarray(pad(dt, -1e9), jd),
                             jnp.asarray(pad(bc), jd), jnp.asarray(A), jnp.asarray(D),
                             jnp.asarray(bias), reverse=reverse)
    return np.asarray(y.astype(jnp.float32))[:lp, :bp]


# (L, Bp, Dp, D, segment length, masked share): one token, L on either side
# of a 32-token chunk and of one or two segments, Dp no multiple of 8
# channels' pad, every row masked
SEGMENT_CASES = [(1, 3, 128, 100, 32, 0.3), (31, 2, 128, 128, 32, 0.3),
                 (33, 2, 128, 120, 32, 0.3), (64, 2, 128, 128, 32, 0.0),
                 (65, 1, 128, 128, 32, 0.3), (97, 2, 128, 90, 64, 0.3),
                 (96, 2, 128, 128, 32, 1.0)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lp,bp,dp,d,seg_len,masked", SEGMENT_CASES)
def test_segment_forward_matches_plain_and_jax(lp, bp, dp, d, seg_len, masked,
                                               dtype, reverse):
    """The segment decomposition is exact algebra: against the plain
    version (fp32 tol 1e-5; bf16 1e-3, one rounding of the output) and the
    JAX package's Pallas scan (the same). Pad channels come out zero; with
    every row masked y is D u alone."""
    args = _arranged(lp * 31 + d, lp, bp, dp, d, masked)
    td = getattr(torch, dtype)
    t = [torch.from_numpy(x) for x in args]
    t[:3] = [x.to(td) for x in t[:3]]
    model = segment_forward(*t, reverse, seg_len)
    ref = ss.ssm_scan_arranged_ref(*t, reverse)
    jref = _jax_arranged(*[np.asarray(x.float()) for x in t[:3]], *args[3:],
                         reverse, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-3
    assert model.dtype == td and torch.isfinite(model.float()).all()
    assert _rel(model, ref) < tol
    assert _rel(model, jref) < tol
    assert not model[..., d:].any()
    if masked == 1.0:
        skip = (t[0][..., :d].double() * t[4].double()).to(td)
        assert torch.equal(model[..., :d], skip)


# (L, Bp, Dp, itemsize) of every K5 launch of the lineage: V5 / V6 / V9 at
# the UNet's res-64 control block (4096 + 33 tokens, 56 rows, d_inner 640,
# bf16), MambaUPNet's four stages (8 images at its published dims, fp32);
# then L = 1, L around the chunk and segment lengths, Dp no multiple of 8
LINEAGE = [(4096 + 33, 56, 640, 2), (64, 8, 1024, 4), (256, 8, 512, 4),
           (1024, 8, 256, 4), (4096, 8, 128, 4)]
FWD_EDGES = [(1, 1, 128, 4), (1, 56, 640, 2), (31, 1, 200, 4), (32, 1, 200, 2),
             (33, 2, 128, 4), (63, 1, 128, 4), (64, 1, 128, 4), (65, 1, 128, 4),
             (95, 1, 1024, 2), (97, 3, 100, 4), (300, 1, 200, 2), (83, 3, 100, 2)]


@pytest.mark.parametrize("lp,bp,dp,item", LINEAGE + FWD_EDGES)
def test_fwd_plan(lp, bp, dp, item):
    """Channels padded to 16-byte copies and covered by the blocks; a wide
    walk covers every token; segments are whole chunks, at least
    FWD_MIN_SEGMENT long, three or more, each non-empty; shared memory and
    the scratch buffers as the kernel indexes them."""
    plan = ss.fwd_plan(lp, bp, dp, item)
    dpp = plan["dpp"]
    assert dpp % 8 == 0 and dp <= dpp < dp + 8
    blocks = -(-dpp // ss.FWD_BLOCK)
    assert plan["smem"] == ss._fwd_smem(item) <= SMEM_LIMIT
    assert plan["seg_len"] % ss.FWD_CHUNK == 0
    if plan["path"] == "wide":
        assert plan["nseg"] == 1 and plan["seg_len"] >= lp
        assert plan["grid"]["walk"] == (blocks, bp) and not plan["buffers"]
        return
    nseg, seg = plan["nseg"], plan["seg_len"]
    assert nseg >= 3 and seg >= ss.FWD_MIN_SEGMENT
    assert (nseg - 1) * seg < lp <= nseg * seg
    assert bp * dpp < ss.FWD_WIDE_CHAINS
    assert plan["grid"]["replay"] == plan["grid"]["walk"] == (blocks, nseg - 1, bp)
    assert plan["grid"]["join"][0] * 256 >= bp * ss.D_STATE * dpp
    assert plan["buffers"] == {"seg_h": (nseg - 1, bp, ss.D_STATE, dpp),
                               "seg_p": (nseg - 1, bp, ss.D_STATE, dpp)}


def test_fwd_plan_paths_at_the_lineage_shapes():
    """The res-64 blocks (35,840 chains) walk each chain once; MambaUPNet's
    last three stages (1,024-4,096 chains) are cut into segments, its first
    (64 tokens) is too short to cut."""
    paths = [ss.fwd_plan(*s)["path"] for s in LINEAGE]
    assert paths == ["wide", "wide", "segments", "segments", "segments"]


def test_fwd_plan_segment_model_at_the_plan_lengths():
    """The model at the segment length the plan gives a MambaUPNet-like
    narrow shape (fp32, both directions) against the plain version."""
    lp, bp, dp = 300, 1, 24
    plan = ss.fwd_plan(lp, bp, dp, 4)
    assert plan["path"] == "segments"
    args = [torch.from_numpy(x) for x in _arranged(7, lp, bp, dp, dp, 0.3)]
    for reverse in (False, True):
        model = segment_forward(*args, reverse, plan["seg_len"])
        assert _rel(model, ss.ssm_scan_arranged_ref(*args, reverse)) < 1e-5


def test_profile_step_reads_each_launch_grid(tmp_path):
    """profile_step's trace reader: device time per group, and for the
    port's own kernels per (name, launch grid), from a chrome trace."""
    import json

    from actalker_tpu_torch.tools.profile_step import device_times

    gn = ("void (anonymous namespace)::gn_cluster_kernel<__nv_bfloat16>"
          "(CUtensorMap_st, float const*, float const*, __nv_bfloat16*, int)")
    events = [{"ph": "X", "cat": "kernel", "name": gn, "dur": 100.0,
               "args": {"grid": [32, 56, 1]}},
              {"ph": "X", "cat": "kernel", "name": gn, "dur": 50.0,
               "args": {"grid": [32, 56, 1]}},
              {"ph": "X", "cat": "kernel", "name": gn, "dur": 20.0,
               "args": {"grid": [16, 56, 1]}},
              {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16",
               "dur": 200.0, "args": {"grid": [4, 1, 1]}},
              {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 5.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 9.0}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy, groups, launches = device_times(str(path))
    assert busy == pytest.approx(0.375)
    assert groups == pytest.approx({"K7-GN group norm": 0.17,
                                    "cuBLAS GEMMs": 0.2,
                                    "memcpy / memset": 0.005})
    name = "gn_cluster_kernel<__nv_bfloat16>"
    want = {("K7-GN group norm", name, (32, 56, 1)): (2, 0.15),
            ("K7-GN group norm", name, (16, 56, 1)): (1, 0.02)}
    assert set(launches) == set(want)
    for key, (count, ms) in want.items():
        assert launches[key][0] == count
        assert launches[key][1] == pytest.approx(ms)
