"""The PyTorch port's hand-written CUDA kernels (K1-K4, the single-direction
scan K5, the scan adjoint K6, the attention backward K2-bwd, LayerNorm /
GroupNorm K7-LN / K7-GN and their default-lowering variant, the fused
GroupNorm + SiLU + 3x3 conv K8 and its bisect variants) against their plain
PyTorch versions, on a CUDA card.
Skipped without one. A backward through each autograd function must launch
its kernels (it cannot silently take a plain path).

This file imports no JAX, so it runs where the card is (that machine has no
JAX; skip the JAX test configuration):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Shapes are small but ragged (edges that are no multiple of the kernels'
tiles); ``chip_smoke.py`` repeats the check at the flagship shapes.
Tolerances are relative L2 errors, stated per kernel with their reason.
"""
import math

import pytest
import torch

from actalker_tpu_torch.ops import mha, mlp, norms, resconv, selective_scan as ss


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _grouped(dev, dtype, lp=77, bp=5, dp=200, rank=13):
    gen = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    g = 4
    slab = torch.zeros(lp, bp, g * 128, device=dev)
    for gi in range(g):
        slab[:, :, gi * 128:gi * 128 + rank + 32] = 0.5 * rn(lp, bp, rank + 32)
        slab[:, :, gi * 128 + ss.MASK_LANE] = (rn(lp, bp) > 0.5).float()
    dtw = torch.zeros(g, 128, dp, device=dev)
    dtw[:, :rank] = 0.3 * rn(g, rank, dp)
    dtw[:, ss.MASK_LANE] = -1e9
    return ((rn(lp, bp, 2 * dp)).to(dtype), slab.to(dtype), dtw,
            -torch.exp(0.5 * rn(g, dp, 16)), rn(g, dp), 0.5 * rn(g, dp), rank)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-3)])
def test_k1_grouped_scan(dev, dtype, tol):
    """fp32 state in both; bf16 rounds the output (tol 1e-3), fp32 differs
    only in exp/log1p implementations (tol 1e-5)."""
    args = _grouped(dev, dtype)
    n0 = ss.KERNEL.launches
    y = ss.ssm_scan_grouped(*args)
    assert ss.KERNEL.launches == n0 + 1
    assert _rel(y, ss.ssm_scan_grouped_ref(*args)) < tol


# K1 edges: L shorter than one 32-token chunk, L and Dp no multiple of the
# chunk or of the 128-channel block, ranks 13 / 20 / 40 / 80 (the res-64 /
# res-32 / res-16 widths), one branch (G = 2)
K1_SHAPES = [(7, 3, 64, 13, 4), (100, 2, 200, 20, 4), (33, 4, 136, 80, 4),
             (65, 2, 264, 40, 2), (300, 1, 640, 20, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("lp,bp,dp,rank,g", K1_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-3)])
def test_k1_grouped_scan_edges(dev, lp, bp, dp, rank, g, dtype, tol):
    """As ``test_k1_grouped_scan`` at the edges of the chunked, staged
    design; even groups scan left to right, odd ones right to left."""
    u, slab, dtw, a, d, bias, _ = _grouped(dev, dtype, lp, bp, dp, rank)
    args = (u[..., :g // 2 * dp].contiguous(), slab[..., :g * 128].contiguous(),
            dtw[:g].contiguous(), a[:g].contiguous(), d[:g].contiguous(),
            bias[:g].contiguous(), rank)
    n0 = ss.KERNEL.launches
    y = ss.ssm_scan_grouped(*args)
    assert ss.KERNEL.launches == n0 + 1
    assert y.shape == (lp, bp, g * dp) and torch.isfinite(y.float()).all()
    assert _rel(y, ss.ssm_scan_grouped_ref(*args)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_every_token_masked(dev, dtype):
    """Every token masked: each step is an exact identity, the state stays
    0 and y = D * u (one rounding to the output dtype); no token masked:
    the plain version's tolerance as above."""
    u, slab, dtw, a, d, bias, rank = _grouped(dev, dtype, lp=70, dp=136)
    for gi in range(4):
        slab[:, :, gi * 128 + ss.MASK_LANE] = 1
    y = ss.ssm_scan_grouped(u, slab, dtw, a, d, bias, rank)
    want = torch.cat([u[..., (gi // 2) * 136:(gi // 2 + 1) * 136].float() * d[gi]
                      for gi in range(4)], dim=-1).to(dtype)
    assert torch.equal(y, want)
    for gi in range(4):
        slab[:, :, gi * 128 + ss.MASK_LANE] = 0
    y = ss.ssm_scan_grouped(u, slab, dtw, a, d, bias, rank)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert _rel(y, ss.ssm_scan_grouped_ref(u, slab, dtw, a, d, bias, rank)) < tol


@pytest.mark.cuda
def test_k1_raises_instead_of_falling_back(dev):
    """Dp must be a multiple of 8 (16-byte copies), the slab must match u's
    dtype, and every operand must be contiguous."""
    u, slab, dtw, a, d, bias, rank = _grouped(dev, torch.float32, dp=100)
    n0 = ss.KERNEL.launches
    with pytest.raises(ValueError):
        ss.ssm_scan_grouped(u, slab, dtw, a, d, bias, rank)
    u, slab, dtw, a, d, bias, rank = _grouped(dev, torch.float32)
    with pytest.raises(ValueError):
        ss.ssm_scan_grouped(u, slab.bfloat16(), dtw, a, d, bias, rank)
    with pytest.raises(ValueError):
        ss.ssm_scan_grouped(u.transpose(0, 1).contiguous().transpose(0, 1),
                            slab, dtw, a, d, bias, rank)
    assert ss.KERNEL.launches == n0


# K2 / K2-bwd shapes: ragged S (300, 1000, and 5184 = the 576 px latent,
# none a multiple of the 128-row tiles), S shorter than one tile (64, 40),
# and the res-16 / res-8 widths (C = 1280, H = 20)
K2_SHAPES = [(2, 300, 2), (3, 64, 5), (1, 1000, 1), (1, 5184, 5), (2, 256, 20),
             (1, 40, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h", K2_SHAPES)
def test_k2_mha(dev, b, s, h):
    """Probabilities are rounded to bf16 before P @ V (tol 1e-2)."""
    q, k, v = (torch.randn(b, s, 64 * h, device=dev).bfloat16() for _ in range(3))
    n0 = mha.MHA_KERNEL.launches
    o = mha.mha_tokens(q, k, v, h)
    assert mha.MHA_KERNEL.launches == n0 + 1
    assert _rel(o, mha.mha_tokens_ref(q, k, v, h)) < 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("f,s,h", [(3, 50, 2), (14, 17, 5), (25, 8, 1)])
def test_k3_frame_attention(dev, f, s, h):
    """fp32 inside both; the output is rounded to bf16 (tol 1e-3)."""
    q, k, v = (torch.randn(2 * f, s, 64 * h, device=dev).bfloat16()
               for _ in range(3))
    n0 = mha.FRAME_KERNEL.launches
    o = mha.frame_attention_tokens(q, k, v, f, h)
    assert mha.FRAME_KERNEL.launches == n0 + 1
    assert _rel(o, mha.frame_attention_tokens_ref(q, k, v, f, h)) < 1e-3


# K3 at its edges: F = 1, the window-step's 14, training's 25 (B*F = 25)
# and the reference's default window (B*F = 100), F = 32 (the last on the
# tensor cores) and F = 40 past it; S = 17, 81 (576 px res-8), 5184 (576
# px res-72); H = 20
K3_SHAPES = [(3, 1, 17, 2), (1, 14, 81, 5), (4, 14, 17, 20), (1, 25, 5184, 5),
             (4, 25, 81, 5), (4, 25, 17, 20), (2, 32, 81, 5), (1, 40, 17, 2),
             (2, 17, 33, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,f,s,h", K3_SHAPES)
def test_k3_frame_attention_shapes(dev, b, f, s, h):
    """fp32 softmax and P (bf16 hi + lo) in the kernel, fp32 throughout in
    the plain version; the output is rounded to bf16 (tol 1e-3)."""
    gen = torch.Generator(device=dev).manual_seed(f * 100 + s)
    q, k, v = (torch.randn(b * f, s, 64 * h, generator=gen, device=dev).bfloat16()
               for _ in range(3))
    n0 = mha.FRAME_KERNEL.launches
    o = mha.frame_attention_tokens(q, k, v, f, h)
    assert mha.FRAME_KERNEL.launches == n0 + 1
    assert torch.isfinite(o.float()).all()
    assert _rel(o, mha.frame_attention_tokens_ref(q, k, v, f, h)) < 1e-3


@pytest.mark.cuda
def test_k3_from_a_fresh_thread(dev):
    """A thread that has made no CUDA call yet gives the same bits."""
    import threading

    q, k, v = (torch.randn(50, 81, 320, device=dev).bfloat16() for _ in range(3))
    want = mha.frame_attention_tokens(q, k, v, 25, 5)
    got = {}

    def run():
        got["o"] = mha.frame_attention_tokens(q, k, v, 25, 5)
        torch.cuda.synchronize()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert torch.equal(got["o"], want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,cout", [(300, 64, 64), (129, 40, 18), (5, 320, 320)])
def test_k4_geglu_mlp(dev, m, c, cout):
    """h is rounded to bf16 in both; accumulation order can flip single
    roundings (tol 5e-3)."""
    x = torch.randn(m, c, device=dev).bfloat16()
    w1 = (torch.randn(8 * c, c, device=dev) * c ** -0.5).bfloat16()
    w2 = (torch.randn(cout, 4 * c, device=dev) * (4 * c) ** -0.5).bfloat16()
    b1, b2 = torch.randn(8 * c, device=dev), torch.randn(cout, device=dev)
    n0 = mlp.KERNEL.launches
    y = mlp.geglu_mlp(x, w1, b1, w2, b2)
    assert mlp.KERNEL.launches == n0 + 2          # two GEMM launches per call
    assert _rel(y, mlp.geglu_mlp_ref(x, w1, b1, w2, b2)) < 5e-3


def _mlp_args(dev, m, c, cout, seed=5):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    return (rn(m, c).bfloat16(), (rn(8 * c, c) * c ** -0.5).bfloat16(),
            0.1 * rn(8 * c), (rn(cout, 4 * c) * (4 * c) ** -0.5).bfloat16(),
            0.1 * rn(cout))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,cout", [
    (100, 320, 320), (128, 320, 320), (1000, 640, 640), (300, 1280, 1280),
    (257, 320, 640), (77, 640, 200)])
def test_k4_geglu_mlp_widths(dev, m, c, cout):
    """The UNet's widths (C = 320 / 640 / 1280, I = 4C), M below one 128-row
    tile, exactly one, and none a multiple; Cout != C, and Cout not a
    multiple of the 128-column tile (tol 5e-3, as above)."""
    args = _mlp_args(dev, m, c, cout)
    n0 = mlp.KERNEL.launches
    y = mlp.geglu_mlp(*args)
    assert mlp.KERNEL.launches == n0 + 2
    assert y.shape == (m, cout) and torch.isfinite(y.float()).all()
    assert _rel(y, mlp.geglu_mlp_ref(*args)) < 5e-3


@pytest.mark.cuda
def test_k4_views_raise_or_are_handled(dev):
    """TMA reads 16-byte-aligned rows of contiguous tensors: x misaligned by
    one element, x with rows 2C apart, or a strided weight raises and
    launches nothing. Leading dims of a contiguous x fold into M."""
    x, w1, b1, w2, b2 = _mlp_args(dev, 96, 64, 64)
    n0 = mlp.KERNEL.launches
    flat = torch.cat([x.flatten(), x.new_zeros(8)])
    shifted = flat[1:1 + x.numel()].view(x.shape)
    strided = torch.stack([x, x], dim=1)[:, 0]
    wide = torch.cat([w1, w1], dim=1)[:, ::2]           # same shape, strided
    for args in ((shifted, w1, b1, w2, b2), (strided, w1, b1, w2, b2),
                 (x, wide, b1, w2, b2)):
        with pytest.raises(ValueError):
            mlp.geglu_mlp(*args)
    assert mlp.KERNEL.launches == n0
    got = mlp.geglu_mlp(x.view(4, 24, 64), w1, b1, w2, b2)
    assert got.shape == (4, 24, 64)
    assert torch.equal(got.view(96, 64), mlp.geglu_mlp(x, w1, b1, w2, b2))


@pytest.mark.cuda
def test_k4_from_a_fresh_thread(dev):
    """K4 encodes TMA tensor maps, which want a current context: a thread
    that has made no CUDA call yet gives the same bits."""
    import threading

    args = _mlp_args(dev, 200, 64, 64)
    want = mlp.geglu_mlp(*args)
    got = {}

    def run():
        got["y"] = mlp.geglu_mlp(*args)
        torch.cuda.synchronize()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert torch.equal(got["y"], want)


@pytest.mark.cuda
def test_wrappers_raise_instead_of_falling_back(dev):
    """A CUDA tensor a kernel does not take raises; nothing falls back."""
    q = torch.zeros(1, 64, 128, device=dev)                  # fp32: K2 takes bf16
    with pytest.raises(ValueError):
        mha.mha_tokens(q, q, q, 2)
    with pytest.raises(ValueError):
        mha.frame_attention_tokens(q.bfloat16(), q.bfloat16(), q.bfloat16()[:, :, :64], 1, 2)
    x = torch.zeros(4, 36, device=dev).bfloat16()            # C % 8 != 0
    with pytest.raises(ValueError):
        mlp.geglu_mlp(x, torch.zeros(288, 36, device=dev).bfloat16(),
                      torch.zeros(288, device=dev),
                      torch.zeros(36, 144, device=dev).bfloat16(),
                      torch.zeros(36, device=dev))


def _arranged(dev, dtype, lp=83, bp=3, dp=100, rev=False):
    """One arranged scan's operands, ~30% masked tokens (dtr = -1e9)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    dtr = 0.5 * rn(lp, bp, dp)
    dtr[torch.rand(lp, bp, generator=gen, device=dev) < 0.3] = -1e9
    return (rn(lp, bp, dp).to(dtype), dtr, (0.5 * rn(lp, bp, 32)).to(dtype),
            -torch.exp(0.5 * rn(dp, 16)), rn(dp), 0.5 * rn(dp),
            rn(lp, bp, dp).to(dtype), rev)


@pytest.mark.cuda
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-3)])
def test_k6_scan_adjoint(dev, rev, dtype, tol):
    """fp32 state and sums in both; the kernel sums over channels and
    tokens in another order (fp32: 1e-4) and bf16 rounds du (1e-3)."""
    args = _arranged(dev, dtype, rev=rev)
    n0 = ss.BWD_KERNEL.launches
    got = ss.ssm_scan_arranged_grad(*args)
    assert ss.BWD_KERNEL.launches == n0 + 1
    want = ss.ssm_scan_arranged_grad_ref(*args)
    for name, a, b in zip("du ddt dbc dA dD dbias".split(), got, want):
        assert torch.isfinite(a.float()).all(), name
        assert _rel(a, b) < tol, (name, _rel(a, b))


# K6 at its edges: L = 1, around one 8-token sub-chunk and one or two
# 128-token segments (+-1), Dp = 200 (no multiple of the 64-channel block)
# and 2560, Bp = 1 and 56
K6_SHAPES = [(1, 1, 200), (7, 2, 200), (8, 1, 200), (9, 56, 200),
             (127, 2, 200), (128, 1, 2560), (129, 3, 200), (255, 1, 200),
             (257, 56, 200), (300, 2, 2560)]


@pytest.mark.cuda
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("lp,bp,dp", K6_SHAPES)
def test_k6_scan_adjoint_shapes(dev, lp, bp, dp, dtype, tol, rev):
    """As ``test_k6_scan_adjoint`` (same tolerances and reasons), at the
    sub-chunk and segment edges, ~30% of the rows masked. At L = 1 no state
    precedes the token, so dA is exactly zero in both."""
    args = _arranged(dev, dtype, lp=lp, bp=bp, dp=dp, rev=rev)
    n0 = ss.BWD_KERNEL.launches
    got = ss.ssm_scan_arranged_grad(*args)
    assert ss.BWD_KERNEL.launches == n0 + 1
    want = ss.ssm_scan_arranged_grad_ref(*args)
    for name, a, b in zip("du ddt dbc dA dD dbias".split(), got, want):
        assert torch.isfinite(a.float()).all(), name
        if b.any():
            assert _rel(a, b) < tol, (name, _rel(a, b))
        else:
            assert not a.any(), name


@pytest.mark.cuda
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("masked", [0.0, 1.0])
def test_k6_masked_rows(dev, masked, dtype, tol, rev):
    """No row masked, and every row masked: then every step is an exact
    identity (delta 0, sigmoid 0), so ddt, dB | dC, dA and dbias are exactly
    zero and du = D dy; nothing is NaN. Two segments of 128 tokens."""
    args = list(_arranged(dev, dtype, lp=200, bp=3, dp=64, rev=rev))
    gen = torch.Generator(device=dev).manual_seed(7)
    args[1] = (torch.full_like(args[1], -1e9) if masked
               else 0.5 * torch.randn(args[1].shape, generator=gen, device=dev))
    got = ss.ssm_scan_arranged_grad(*args)
    want = ss.ssm_scan_arranged_grad_ref(*args)
    for name, a, b in zip("du ddt dbc dA dD dbias".split(), got, want):
        assert torch.isfinite(a.float()).all(), name
        if masked and name in ("ddt", "dbc", "dA", "dbias"):
            assert not a.any(), name
        else:
            assert _rel(a, b) < tol, (name, _rel(a, b))


@pytest.mark.cuda
def test_k6_from_a_fresh_thread(dev):
    """A thread that has made no CUDA call yet gives the same bits (K6 sums
    in a fixed order: no atomics)."""
    import threading

    args = _arranged(dev, torch.bfloat16, lp=300, bp=2, dp=200, rev=True)
    want = ss.ssm_scan_arranged_grad(*args)
    got = {}

    def run():
        got["g"] = ss.ssm_scan_arranged_grad(*args)
        torch.cuda.synchronize()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert all(torch.equal(a, b) for a, b in zip(got["g"], want))


@pytest.mark.cuda
def test_k3_k6_refuse_a_plan_that_disagrees(dev):
    """The C entries check the wrappers' plans: K6's sub-chunk length is
    the plan's, and a launch with another shared-memory size or m-tile
    count is refused (it raises, it does not run)."""
    assert ss.BWD_KERNEL.constant("ssm_scan_bwd_chunk") == ss.BWD_CHUNK
    q = torch.zeros(25, 8, 64, device=dev).bfloat16()
    plan = mha.frame_plan(25, 25, 8, 1)
    with pytest.raises(RuntimeError):
        mha.FRAME_KERNEL.launch(
            "frame_attention_bf16", "ppppiiiifiip", q.data_ptr(), q.data_ptr(),
            q.data_ptr(), q.data_ptr(), 1, 25, 8, 1, 0.125, plan["m_tiles"],
            plan["smem"] + 16, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError):
        mha.FRAME_KERNEL.launch(
            "frame_attention_bf16", "ppppiiiifiip", q.data_ptr(), q.data_ptr(),
            q.data_ptr(), q.data_ptr(), 1, 25, 8, 1, 0.125, 1, plan["smem"],
            torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
def test_k6_through_grouped_autograd(dev):
    """A backward through SsmScanGroupedFn launches K1 once and K6 once per
    group, and agrees with autograd through the plain version."""
    args = [t.requires_grad_(True) if t.is_floating_point() else t
            for t in _grouped(dev, torch.float32)[:-1]]
    rank = 13
    gy = torch.randn(77, 5, 4 * 200, device=dev)
    n1, n6 = ss.KERNEL.launches, ss.BWD_KERNEL.launches
    got = torch.autograd.grad(ss.ssm_scan_grouped(*args, rank), args, gy)
    assert ss.KERNEL.launches == n1 + 1 and ss.BWD_KERNEL.launches == n6 + 4
    want = torch.autograd.grad(ss.ssm_scan_grouped_ref(*args, rank), args, gy)
    for i, (a, b) in enumerate(zip(got, want)):
        if i == 1:      # the mask lane's gradient carries the -1e9 row
            a, b = a[..., [j for j in range(a.shape[-1]) if j % 128 != 126]], \
                b[..., [j for j in range(b.shape[-1]) if j % 128 != 126]]
        if i == 2:
            a, b = a[:, :126], b[:, :126]
        assert _rel(a, b) < 1e-4, (i, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h", [(2, 300, 2), (1, 64, 20), (1, 5184, 5)])
def test_k2_lse_entry(dev, b, s, h):
    """The training entry writes the base-2 log-sum-exp of the scaled
    scores (fp32 sums of exp2.approx terms: atol 1e-3 on values ~10) and
    the same output as the inference entry, bit for bit."""
    q, k, v = (torch.randn(b, s, 64 * h, device=dev).bfloat16() for _ in range(3))
    n0 = mha.MHA_KERNEL.launches
    o, lse = mha._mha_fwd(q, k, v, h, with_lse=True)
    assert mha.MHA_KERNEL.launches == n0 + 1
    qh, kh = (x.float().view(b, s, h, 64).transpose(1, 2) for x in (q, k))
    want = torch.logsumexp(qh @ kh.transpose(-1, -2) / 8.0, -1) / math.log(2.0)
    assert lse.shape == (b, h, s) and torch.isfinite(lse).all()
    assert (lse - want).abs().max().item() < 1e-3
    assert torch.equal(o, mha.mha_tokens(q, k, v, h))


@pytest.mark.cuda
def test_k2_raises_on_views(dev):
    """TMA reads rows at 16-byte-aligned addresses of a contiguous (B, S,
    C) tensor: a strided view and one misaligned by one element raise in
    the wrappers, forward and backward, and launch nothing."""
    x = torch.randn(2 * 130 * 128 + 8, device=dev).bfloat16()
    strided = x[:2 * 130 * 128].view(2, 130, 128)[:, ::2]
    shifted = x[1:1 + 2 * 64 * 128].view(2, 64, 128)
    n2, nb = mha.MHA_KERNEL.launches, mha.MHA_BWD_KERNEL.launches
    for bad in (strided, shifted):
        with pytest.raises(ValueError):
            mha.mha_tokens(bad, bad, bad, 2)
        good = torch.zeros(bad.shape, device=dev).bfloat16()
        lse = torch.zeros(bad.shape[0], 2, bad.shape[1], device=dev)
        with pytest.raises(ValueError):
            mha.mha_tokens_bwd(good, good, good, good, lse, bad, 2)
    assert (mha.MHA_KERNEL.launches, mha.MHA_BWD_KERNEL.launches) == (n2, nb)


@pytest.mark.cuda
def test_k2_from_a_fresh_thread(dev):
    """The TMA tensor maps are encoded by ``cuTensorMapEncodeTiled``,
    which wants a current context: a thread that has made no CUDA call yet
    (no autograd worker, no device set) still launches both kernels."""
    import threading

    q, k, v, do = (torch.randn(2, 300, 128, device=dev).bfloat16() for _ in range(4))
    o, lse = mha._mha_fwd(q, k, v, 2, with_lse=True)
    got = {}

    def run():
        got["o"] = mha.mha_tokens(q, k, v, 2)
        got["grads"] = mha.mha_tokens_bwd(q, k, v, o, lse, do, 2)
        torch.cuda.synchronize()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert torch.equal(got["o"], o)
    for a, w in zip(got["grads"], mha.mha_tokens_bwd(q, k, v, o, lse, do, 2)):
        assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h", K2_SHAPES)
def test_k2_backward(dev, b, s, h):
    """K2-bwd against autograd through the plain version: P and dS are
    rounded to bf16 before their products (tol 1e-2)."""
    q, k, v = (torch.randn(b, s, 64 * h, device=dev).bfloat16().requires_grad_(True)
               for _ in range(3))
    do = torch.randn(b, s, 64 * h, device=dev).bfloat16()
    n2, nb = mha.MHA_KERNEL.launches, mha.MHA_BWD_KERNEL.launches
    o = mha.mha_tokens(q, k, v, h)
    got = torch.autograd.grad(o, (q, k, v), do)
    assert mha.MHA_KERNEL.launches == n2 + 1
    assert mha.MHA_BWD_KERNEL.launches == nb + 1
    want = mha.mha_tokens_bwd_ref(q.detach(), k.detach(), v.detach(), do, h)
    for name, a, w in zip("dq dk dv".split(), got, want):
        assert _rel(a, w) < 1e-2, (name, _rel(a, w))
    with torch.no_grad():       # inference launches the forward alone
        mha.mha_tokens(q, k, v, h)
    assert mha.MHA_KERNEL.launches == n2 + 2
    assert mha.MHA_BWD_KERNEL.launches == nb + 1


@pytest.mark.cuda
def test_frame_and_mlp_backward_launch_forward_kernels(dev):
    """FrameAttentionFn / GegluMlpFn run K3 / K4 forward and differentiate
    their bf16 twins of the JAX package's XLA functions; gradients match
    autograd through those twins."""
    q, k, v = (torch.randn(6, 17, 128, device=dev).bfloat16().requires_grad_(True)
               for _ in range(3))
    n3 = mha.FRAME_KERNEL.launches
    got = torch.autograd.grad(mha.frame_attention_tokens(q, k, v, 3, 2).float().sum(),
                              (q, k, v))
    assert mha.FRAME_KERNEL.launches == n3 + 1
    want = torch.autograd.grad(
        mha.frame_attention_tokens_xla(q, k, v, 3, 2).float().sum(), (q, k, v))
    assert max(_rel(a, b) for a, b in zip(got, want)) < 1e-6
    x = torch.randn(40, 64, device=dev).bfloat16().requires_grad_(True)
    w1 = (torch.randn(512, 64, device=dev) * 0.1).bfloat16().requires_grad_(True)
    w2 = (torch.randn(64, 256, device=dev) * 0.1).bfloat16().requires_grad_(True)
    b1 = torch.randn(512, device=dev, requires_grad=True)
    b2 = torch.randn(64, device=dev, requires_grad=True)
    n4 = mlp.KERNEL.launches
    got = torch.autograd.grad(mlp.geglu_mlp(x, w1, b1, w2, b2).float().sum(),
                              (x, w1, b1, w2, b2))
    assert mlp.KERNEL.launches == n4 + 2
    want = torch.autograd.grad(mlp.geglu_mlp_xla(x, w1, b1, w2, b2).float().sum(),
                               (x, w1, b1, w2, b2))
    assert max(_rel(a, b) for a, b in zip(got, want)) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,dtype", [
    (300, 320, torch.bfloat16), (77, 960, torch.bfloat16),
    (5, 2560, torch.bfloat16), (129, 1024, torch.float32),
    (64, 320, torch.float32), (1, 320, torch.bfloat16),
    (1, 640, torch.bfloat16), (333, 640, torch.bfloat16),
    (1, 1280, torch.bfloat16), (1001, 1280, torch.bfloat16),
    (1, 2560, torch.bfloat16), (1, 1024, torch.float32),
    (1, 72, torch.bfloat16), (131, 72, torch.bfloat16),
    (37, 72, torch.float32)])
def test_k7_layer_norm(dev, m, c, dtype):
    """The templated widths (C = 320 / 640 / 1280 / 2560 bf16, 1024 fp32:
    rows held in registers, several rows to a warp at C = 320 / 640) and
    the general kernel (C = 72, 960), one row and ragged row counts against
    the rows of a block. fp32 statistics and affine in both; bf16 rounds
    the output (tol 1e-3), fp32 differs in summation order only (tol
    1e-5)."""
    x = (torch.randn(m, c, device=dev) * 2 + 0.5).to(dtype)
    g, b = torch.randn(c, device=dev), torch.randn(c, device=dev)
    n0 = norms.LN_KERNEL.launches
    y = norms.layer_norm(x, g, b, 1e-5)
    assert norms.LN_KERNEL.launches == n0 + 1 and y.dtype == dtype
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    assert _rel(y, norms.layer_norm_ref(x, g, b, 1e-5)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((3, 100, 320), torch.bfloat16), ((2, 57, 960), torch.bfloat16),
    ((1, 96 * 64, 128), torch.bfloat16), ((2, 3, 5, 7, 320), torch.bfloat16),
    ((2, 50, 64), torch.float32)])
def test_k7_group_norm(dev, shape, dtype):
    """C / G = 10, 30, 4 and 2; a tall VAE-like image; the temporal
    resnets' (B, F, H, W, C). Tolerances as K7-LN; two runs give the same
    bits (no atomics)."""
    c = shape[-1]
    x = (torch.randn(*shape, device=dev) * 2 - 0.5).to(dtype)
    g, b = torch.randn(c, device=dev), torch.randn(c, device=dev)
    n0 = norms.GN_KERNEL.launches
    y = norms.group_norm(x, g, b, 32, 1e-6)
    assert norms.GN_KERNEL.launches == n0 + 1 and y.shape == x.shape
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    assert _rel(y, norms.group_norm_ref(x, g, b, 32, 1e-6)) < tol
    assert torch.equal(y, norms.group_norm(x, g, b, 32, 1e-6))
    a, bb = norms.group_norm_affine(x, g, b, 32, 1e-6)
    a_r, b_r = norms.gn_affine(x, g, b, 32, 1e-6)
    assert _rel(a, a_r) < 1e-5 and _rel(bb, b_r) < 1e-5


K8_SHAPES = [
    (2, 8, 8, 320, 320), (3, 16, 16, 960, 640), (1, 128, 16, 128, 256),
    (5, 1, 1, 32, 16), (2, 9, 7, 40, 24),
    # C = 960 / 1920 (no multiple of 128), Co = 320 (no multiple of 256)
    (2, 8, 8, 960, 320), (1, 8, 8, 1920, 640), (1, 8, 8, 2560, 1280),
    (2, 4, 4, 320, 640),
    # W = 512: a tile is part of a row (three disjoint halo windows); the
    # halo's two modes on either side of W = 136 (one TMA box)
    (1, 3, 512, 128, 128), (1, 5, 136, 64, 64), (1, 4, 137, 64, 64),
    # N * H * W ragged against the 128-pixel tile, C below one chunk
    (3, 7, 9, 64, 40)]


def _k8_args(dev, n, h, w, c, co, seed=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    x = (rn(n, h, w, c) * 1.5 + 0.3).bfloat16()
    g, b = 1 + 0.1 * rn(c), 0.5 + 0.5 * rn(c)    # SiLU(b) != 0 in the halo
    wt = (rn(co, c, 3, 3) * (9 * c) ** -0.5).bfloat16()
    return x, g, b, wt, 0.1 * rn(co)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,co", K8_SHAPES)
def test_k8_gn_silu_conv3x3(dev, n, h, w, c, co):
    """W = 8 and 16 (a tile spans images), whole 8 x 8 images, a tall
    VAE-like image, one-pixel images (all halo but the centre tap), W = 512
    (part of a row), ragged sizes, C and Co off the tile widths. beta is
    shifted so that silu(b) is far from 0: a halo filled with silu(b)
    instead of the activated tensor's zeros fails. The activation is
    rounded to bf16 in both; accumulation order can flip single roundings
    (tol 5e-3). One K7-GN statistics launch and one K8 launch per call."""
    x, g, b, wt, cb = _k8_args(dev, n, h, w, c, co)
    groups = 32 if c % 32 == 0 else 8
    n7, n8 = norms.GN_KERNEL.launches, resconv.KERNEL.launches
    y = resconv.gn_silu_conv3x3(x, g, b, groups, 1e-5, wt, cb)
    assert norms.GN_KERNEL.launches == n7 + 1
    assert resconv.KERNEL.launches == n8 + 1
    assert y.shape == (n, h, w, co) and y.dtype == torch.bfloat16
    ref = resconv.gn_silu_conv3x3_ref(x, g, b, groups, 1e-5, wt, cb)
    assert _rel(y, ref) < 5e-3, _rel(y, ref)


@pytest.mark.cuda
def test_k8_weight_layout_rebuilt_after_an_update(dev):
    """K8 reads a cached (Co, 9 C) layout of w; an in-place update of w
    moves its version, so the next call re-lays it out and the output
    follows the new weights."""
    x, g, b, w, cb = _k8_args(dev, 2, 8, 8, 64, 64)
    y0 = resconv.gn_silu_conv3x3(x, g, b, 32, 1e-5, w, cb)
    assert torch.equal(y0, resconv.gn_silu_conv3x3(x, g, b, 32, 1e-5, w, cb))
    w.add_(0.05)
    y1 = resconv.gn_silu_conv3x3(x, g, b, 32, 1e-5, w, cb)
    assert not torch.equal(y0, y1)
    assert _rel(y1, resconv.gn_silu_conv3x3_ref(x, g, b, 32, 1e-5, w, cb)) < 5e-3


@pytest.mark.cuda
def test_k8_from_a_fresh_thread(dev):
    """K8 encodes a TMA tensor map of the weights, which wants a current
    context: a thread that has made no CUDA call yet gives the same bits."""
    import threading

    args = _k8_args(dev, 2, 16, 16, 128, 160)
    want = resconv.gn_silu_conv3x3(args[0], args[1], args[2], 32, 1e-5, *args[3:])
    got = {}

    def run():
        got["y"] = resconv.gn_silu_conv3x3(args[0], args[1], args[2], 32, 1e-5,
                                           *args[3:])
        torch.cuda.synchronize()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert torch.equal(got["y"], want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,c,co", [(56, 64, 64, 320, 320),
                                        (14, 512, 512, 512, 512),
                                        (2, 9, 7, 40, 24)])
def test_k8_plan_matches_the_kernel(dev, n, h, w, c, co):
    """The wrapper's plan sizes shared memory as the kernel lays it out."""
    import ctypes

    plan = resconv.conv_plan(n, h, w, c, co)
    f = resconv.KERNEL.build().gn_silu_conv3x3_smem
    f.argtypes, f.restype = [ctypes.c_int] * 3, ctypes.c_int
    assert f(plan["bn"], plan["seg"], plan["stages"]) == plan["smem"]


@pytest.mark.cuda
def test_k7_k8_raise_instead_of_falling_back(dev):
    x = torch.zeros(2, 4, 4, 36, device=dev).bfloat16()     # C % 8 != 0
    g = torch.ones(36, device=dev)
    with pytest.raises(ValueError):
        norms.layer_norm(x, g, g)
    with pytest.raises(ValueError):
        norms.group_norm(x, g, g, 4)
    with pytest.raises(ValueError):
        resconv.gn_silu_conv3x3(x, g, g, 4, 1e-5,
                                torch.zeros(16, 36, 3, 3, device=dev), g[:16])
    x = torch.zeros(2, 4, 4, 32, device=dev)                # fp32: K8 takes bf16
    g = torch.ones(32, device=dev)
    with pytest.raises(ValueError):
        resconv.gn_silu_conv3x3(x, g, g, 8, 1e-5,
                                torch.zeros(12, 32, 3, 3, device=dev), g[:12])
    with pytest.raises(ValueError):                          # Co % 8 != 0
        resconv.gn_silu_conv3x3(x.bfloat16(), g, g, 8, 1e-5,
                                torch.zeros(12, 32, 3, 3, device=dev), g[:12])


@pytest.mark.cuda
def test_k7_k8_backward_launch_forward_kernels(dev):
    """LayerNormFn / GroupNormFn / GnSiluConv3x3Fn run the kernel forward and
    differentiate the plain version (K8: its bf16 twin of the JAX package's
    ``_gnconv_xla``); gradients match autograd through it."""
    x = torch.randn(2, 6, 6, 64, device=dev).requires_grad_(True)
    g = (1 + 0.1 * torch.randn(64, device=dev)).requires_grad_(True)
    b = (0.1 * torch.randn(64, device=dev)).requires_grad_(True)
    for fn, ref, kernel in ((norms.layer_norm, norms.layer_norm_ref, norms.LN_KERNEL),
                            (lambda *a: norms.group_norm(*a, 8),
                             lambda *a: norms.group_norm_ref(*a, 8), norms.GN_KERNEL)):
        n0 = kernel.launches
        got = torch.autograd.grad(fn(x, g, b).sum(), (x, g, b))
        assert kernel.launches == n0 + 1
        want = torch.autograd.grad(ref(x, g, b).sum(), (x, g, b))
        assert max(_rel(p, q) for p, q in zip(got, want)) < 1e-5
    xb = x.detach().bfloat16().requires_grad_(True)
    w = (0.05 * torch.randn(32, 64, 3, 3, device=dev)).bfloat16().requires_grad_(True)
    cb = torch.zeros(32, device=dev, requires_grad=True)
    n8 = resconv.KERNEL.launches
    ins = (xb, g, b, w, cb)
    got = torch.autograd.grad(
        resconv.gn_silu_conv3x3(xb, g, b, 8, 1e-5, w, cb).float().sum(), ins)
    assert resconv.KERNEL.launches == n8 + 1
    want = torch.autograd.grad(
        resconv.gn_silu_conv3x3_xla(xb, g, b, 8, 1e-5, w, cb).float().sum(), ins)
    assert max(_rel(p, q) for p, q in zip(got, want)) < 1e-5


def _k5(dev, dtype, lp=83, bp=3, dp=100, d=90, n=16, nb=128):
    """One arranged scan's K5 operands: channels [d, dp) padded (zero u),
    ~30% masked rows (dt = -1e9), B|C in the first 2N of nb lanes."""
    gen = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    u = rn(lp, bp, dp)
    u[..., d:] = 0
    dt = 0.5 * rn(lp, bp, dp)
    dt[torch.rand(lp, bp, generator=gen, device=dev) < 0.3] = -1e9
    bc = torch.zeros(lp, bp, nb, device=dev)
    bc[..., :2 * n] = 0.5 * rn(lp, bp, 2 * n)
    return (u.to(dtype), dt.to(dtype), bc.to(dtype), -torch.exp(0.5 * rn(d, n)),
            rn(d), 0.5 * rn(d))


@pytest.mark.cuda
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-3)])
def test_k5_arranged_scan(dev, rev, dtype, tol):
    """fp32 state in both; bf16 rounds the output (tol 1e-3), fp32 differs
    only in exp / log1p implementations (tol 1e-5). Masked rows are exact
    identity steps, pad channels come out zero."""
    args = _k5(dev, dtype)
    n0 = ss.ARRANGED_KERNEL.launches
    y = ss.ssm_scan_arranged(*args, reverse=rev)
    assert ss.ARRANGED_KERNEL.launches == n0 + 1
    assert y.dtype == dtype and y.shape == args[0].shape
    assert torch.isfinite(y.float()).all() and not y[..., 90:].any()
    assert _rel(y, ss.ssm_scan_arranged_ref(*args, rev)) < tol


@pytest.mark.cuda
def test_k5_raises_instead_of_falling_back(dev):
    """K5 takes N = 16 only, and one dtype for u, dt and bc."""
    u, dt, bc, a, d, bias = _k5(dev, torch.float32)
    with pytest.raises(ValueError):
        ss.ssm_scan_arranged(u, dt, bc, a[:, :4], d, bias)
    with pytest.raises(ValueError):
        ss.ssm_scan_arranged(u, dt.bfloat16(), bc, a, d, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("rev", [False, True])
def test_k5_k6_gradients(dev, rev):
    """A backward through SsmScanArrangedFn launches K5 once and K6 once and
    agrees with autograd through the plain version (fp32, tol 1e-4: sums
    over channels and tokens in another order)."""
    ins = [t.requires_grad_(True) for t in _k5(dev, torch.float32)]
    gy = torch.randn(ins[0].shape, device=dev)
    gy[..., 90:] = 0
    n5, n6 = ss.ARRANGED_KERNEL.launches, ss.BWD_KERNEL.launches
    got = torch.autograd.grad(ss.ssm_scan_arranged(*ins, reverse=rev), ins, gy)
    assert ss.ARRANGED_KERNEL.launches == n5 + 1
    assert ss.BWD_KERNEL.launches == n6 + 1
    want = torch.autograd.grad(ss.ssm_scan_arranged_ref(*ins, rev), ins, gy)
    for name, a, b in zip("u dt bc A D bias".split(), got, want):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) < 1e-4, (name, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 9, 7, 40, 24), (2, 16, 16, 320, 320)])
def test_k8_bisect_variants(dev, shape):
    """Each stage knock-out of K8 against its plain version (the bisect
    tool's check, tol 5e-3 as K8's), one K8-library launch each: the tool's
    ragged check shape, and 16 x 16 images at C = Co = 320 (tiles of eight
    rows, two 160-wide Co tiles, five channel chunks)."""
    from actalker_tpu_torch.tools import resconv_bisect

    n0 = resconv.KERNEL.launches
    rows = resconv_bisect.check_variants(torch.Generator(device=dev).manual_seed(4),
                                         shape)
    assert resconv.KERNEL.launches == n0 + len(resconv.VARIANTS)
    assert [r["variant"] for r in rows] == list(resconv.VARIANTS)
    assert all(r["ok"] for r in rows), rows


# K7-GN at the edges of its two paths: C / G = 2, 4, 10, 30 and 40; an image
# held by exactly one cluster of 8 CTAs (2048 rows of 128 channels); one
# row; M no multiple of the rows per block; N = 1
GN_SHAPES = [(2, 50, 64), (2, 2048, 128), (3, 100, 320), (2, 57, 960),
             (3, 300, 1280), (2, 1, 320), (2, 105, 320), (1, 6144, 128)]


def _gn_args(dev, shape, dtype, seed=7):
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = (torch.randn(*shape, generator=gen, device=dev) * 2 - 0.5).to(dtype)
    return (x, torch.randn(c, generator=gen, device=dev),
            torch.randn(c, generator=gen, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["cluster", "two_pass"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_k7_gn_paths(dev, shape, dtype, tol, path):
    """Both paths of K7-GN against its plain version (tol as K7-LN), one
    launch each, the same bits on a second run (partial sums added in a
    fixed order: no atomics)."""
    x, g, b = _gn_args(dev, shape, dtype)
    n, m, c = shape
    plan = norms.gn_plan(n, m, c, 32, x.element_size(), path=path)
    y, y2 = torch.empty_like(x), torch.empty_like(x)
    n0 = norms.GN_KERNEL.launches
    norms.group_norm_launch(x, g, b, 32, 1e-6, y, plan)
    norms.group_norm_launch(x, g, b, 32, 1e-6, y2, plan)
    assert norms.GN_KERNEL.launches == n0 + 2
    assert _rel(y, norms.group_norm_ref(x, g, b, 32, 1e-6)) < tol
    assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_gn_two_pass_large_images(dev, dtype):
    """Images no cluster holds (25 MB in bf16, 51 MB in fp32) take the two
    passes through the wrapper: the plain version's output, the same bits
    twice."""
    x, g, b = _gn_args(dev, (3, 40000, 320), dtype)
    assert norms.gn_plan(3, 40000, 320, 32, x.element_size())["path"] == "two_pass"
    y, y2 = norms.group_norm(x, g, b, 32, 1e-6), norms.group_norm(x, g, b, 32, 1e-6)
    tol = 1e-3 if dtype == torch.bfloat16 else 1e-5
    assert _rel(y, norms.group_norm_ref(x, g, b, 32, 1e-6)) < tol
    assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GN_SHAPES + [(56, 256, 2560)])
def test_k7_gn_statistics_alone(dev, shape, dtype):
    """K8's statistics (one launch) against ``gn_affine``, fp32 (tol 1e-5),
    twice with the same bits: the arrival counters are left zeroed."""
    x, g, b = _gn_args(dev, shape, dtype, seed=8)
    n0 = norms.GN_KERNEL.launches
    a1, b1 = norms.group_norm_affine(x, g, b, 32, 1e-6)
    a2, b2 = norms.group_norm_affine(x, g, b, 32, 1e-6)
    assert norms.GN_KERNEL.launches == n0 + 2
    ar, br = norms.gn_affine(x, g, b, 32, 1e-6)
    assert _rel(a1, ar) < 1e-5 and _rel(b1, br) < 1e-5
    assert torch.equal(a1, a2) and torch.equal(b1, b2)


@pytest.mark.cuda
def test_k7_gn_from_a_fresh_thread(dev):
    """The cluster path encodes its TMA map on the host: a thread that has
    made no CUDA call yet gives the same bits, on both paths."""
    import threading

    x, g, b = _gn_args(dev, (56, 1024, 640), torch.bfloat16)
    xt, gt, bt = _gn_args(dev, (4, 4096, 320), torch.bfloat16)
    assert norms.gn_plan(56, 1024, 640, 32, 2)["path"] == "cluster"
    want = (norms.group_norm(x, g, b, 32, 1e-6), norms.group_norm(xt, gt, bt, 32, 1e-6))
    got = {}

    def run():
        got["y"] = (norms.group_norm(x, g, b, 32, 1e-6),
                    norms.group_norm(xt, gt, bt, 32, 1e-6))
        torch.cuda.synchronize()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert all(torch.equal(a, w) for a, w in zip(got["y"], want))


@pytest.mark.cuda
def test_k7_gn_refuses_a_plan_that_disagrees(dev):
    """The C entries check the plan: another shared-memory size, a slice
    that is no whole number of groups, a cluster that misses rows, a
    statistics block of other threads; each raises and does not run."""
    x, g, b = _gn_args(dev, (2, 2048, 128), torch.bfloat16)
    y = torch.empty_like(x)
    plan = norms.gn_plan(2, 2048, 128, 32, 2, path="cluster")
    cl, st = plan["cluster"], plan["stats"]
    stream = torch.cuda.current_stream().cuda_stream

    def cluster(**kw):
        p = {**cl, **kw}
        norms.GN_KERNEL.launch(
            "group_norm_cluster_bf16", "ppppiiiiiiiiiiifp", x.data_ptr(),
            g.data_ptr(), b.data_ptr(), y.data_ptr(), 2, 2048, 128, 32, p["sc"],
            p["p"], p["rows_cta"], p["box_rows"], p["nbox"], p["threads"],
            p["smem"], 1e-6, stream)

    cluster()
    torch.cuda.synchronize()
    for bad in ({"smem": cl["smem"] + 16}, {"sc": 6}, {"rows_cta": cl["rows_cta"] - 8},
                {"box_rows": cl["box_rows"] + 4}):
        with pytest.raises(RuntimeError):
            cluster(**bad)
    ab = torch.empty(2, 2, 128, device=dev)
    part = torch.empty(2 * st["part"], device=dev)
    count = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError):
        norms.GN_KERNEL.launch(
            "gn_stats_bf16", "pppppppiiiiiiifp", x.data_ptr(), g.data_ptr(),
            b.data_ptr(), part.data_ptr(), count.data_ptr(), ab[0].data_ptr(),
            ab[1].data_ptr(), 2, 2048, 128, 32, st["rows"], st["threads"] - 1,
            st["smem"], 1e-6, stream)


# ---- K7's default-lowering variant (``io_affine``): the plain default
# branch's function, the affine rounded in the I/O dtype ----

def _ulp_keys(t):
    """bf16 values as integers in the order of the values: adjacent bf16
    values are one apart (+0 and -0 both 0)."""
    i = t.contiguous().view(torch.int16).int()
    return torch.where(i >= 0, i, -32768 - i)


def _default_branch_limits(y, want, fused, dtype):
    """The variant's output y against the plain default branch's ``want``:
    bf16 rel L2 <= 1e-3 and at most 1 ulp apart on >= 99.9% of the
    elements, fp32 rel L2 <= 1e-6; and strictly closer to ``want`` than the
    fp32-affine K7 output ``fused`` is (the default function, not the
    fused one). Only the order of the fp32 statistics' sums differs."""
    rel = _rel(y, want)
    if dtype == torch.bfloat16:
        near = ((_ulp_keys(y) - _ulp_keys(want)).abs() <= 1).float().mean().item()
        assert rel <= 1e-3 and near >= 0.999, (rel, near)
    else:
        assert rel <= 1e-6, rel
    assert rel < _rel(fused, want), (rel, _rel(fused, want))


def _affine(dev, c, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (gen, 1 + 0.3 * torch.randn(c, generator=gen, device=dev),
            0.5 * torch.randn(c, generator=gen, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,c", [(300, 320), (77, 640), (129, 1280),
                                 (5, 2560), (1001, 2560), (1, 320),
                                 (333, 960), (37, 72)])
def test_k7_ln_default_variant(dev, m, c, dtype):
    """K7-LN's variant against the plain default branch: the templated
    widths (bf16 C = 320 / 640 / 1280 / 2560, fp32 320 / 640 / 1280) and
    the general kernel (fp32 2560, C = 960 / 72), one row and ragged rows;
    one launch a call, the same bits twice."""
    gen, g, b = _affine(dev, c, 21)
    x = (torch.randn(m, c, generator=gen, device=dev) * 2 + 0.5).to(dtype)
    n0 = norms.LN_KERNEL.launches
    y = norms.layer_norm(x, g, b, 1e-5, io_affine=True)
    assert norms.LN_KERNEL.launches == n0 + 1 and y.dtype == dtype
    assert torch.equal(y, norms.layer_norm(x, g, b, 1e-5, io_affine=True))
    _default_branch_limits(y, norms.layer_norm_ref(x, g, b, 1e-5, io_affine=True),
                           norms.layer_norm(x, g, b, 1e-5), dtype)


# (shape, paths): where a cluster holds an image, both paths; the temporal
# resnets' (B, F * H * W, C) and a tall image on the two-pass path alone
GN_DEFAULT_CASES = [((3, 100, 320), ("cluster", "two_pass")),
                    ((2, 57, 960), ("cluster", "two_pass")),
                    ((3, 300, 1280), ("cluster", "two_pass")),
                    ((2, 2048, 128), ("cluster", "two_pass")),
                    ((2, 105, 320), ("cluster", "two_pass")),
                    ((4, 25 * 16 * 16, 320), ("two_pass",)),
                    ((1, 6144, 640), ("two_pass",))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,path", [(s, p) for s, ps in GN_DEFAULT_CASES
                                        for p in ps])
def test_k7_gn_default_variant(dev, shape, path, dtype):
    """K7-GN's variant on each path against the plain default branch (the
    limits of ``_default_branch_limits``); one launch a call, the same bits
    twice."""
    n, m, c = shape
    gen, g, b = _affine(dev, c, 22)
    x = (torch.randn(*shape, generator=gen, device=dev) * 2 - 0.5).to(dtype)
    plan = norms.gn_plan(n, m, c, 32, x.element_size(), path=path)
    y, y2, fused = (torch.empty_like(x) for _ in range(3))
    n0 = norms.GN_KERNEL.launches
    norms.group_norm_launch(x, g, b, 32, 1e-6, y, plan, io_affine=True)
    norms.group_norm_launch(x, g, b, 32, 1e-6, y2, plan, io_affine=True)
    assert norms.GN_KERNEL.launches == n0 + 2 and torch.equal(y, y2)
    norms.group_norm_launch(x, g, b, 32, 1e-6, fused, plan)
    _default_branch_limits(y, norms.group_norm_ref(x, g, b, 32, 1e-6, io_affine=True),
                           fused, dtype)


@pytest.mark.cuda
def test_k7_default_variant_gradients(dev):
    """The variant's autograd functions launch the kernel once and
    differentiate the plain default branch: gradients of x / gamma / beta
    within 1e-3 rel L2 of autograd through it."""
    _, g0, b0 = _affine(dev, 320, 23)
    x0 = torch.randn(2, 3, 40, 320, device=dev) * 2 + 0.5
    for dtype in (torch.bfloat16, torch.float32):
        for fn, kernel in (
                (lambda x, g, b, **k: norms.layer_norm(x, g, b, 1e-5, **k),
                 norms.LN_KERNEL),
                (lambda x, g, b, **k: norms.group_norm(x, g, b, 32, 1e-6, **k),
                 norms.GN_KERNEL)):
            ref = (norms.layer_norm_ref if kernel is norms.LN_KERNEL else
                   lambda x, g, b, **k: norms.group_norm_ref(x, g, b, 32, 1e-6, **k))
            ins = [t.detach().clone().requires_grad_(True)
                   for t in (x0.to(dtype), g0, b0)]
            cot = torch.randn(x0.shape, device=dev).to(dtype)
            n0 = kernel.launches
            got = torch.autograd.grad((fn(*ins, io_affine=True) * cot).sum(), ins)
            assert kernel.launches == n0 + 1
            want = torch.autograd.grad((ref(*ins, io_affine=True) * cot).sum(), ins)
            assert max(_rel(p, q) for p, q in zip(got, want)) < 1e-3


@pytest.mark.cuda
def test_default_modules_launch_k7_where_it_takes_the_call(dev):
    """``LayerNormF32`` / ``GroupNorm32`` under the default lowering: a call
    K7 takes launches the variant (``norm.kernel``), a bf16 affine too (the
    wrapper casts it); C = 36 runs the plain code (``norm.plain``) with no
    launch; an x at a misaligned offset raises, and runs nothing plain."""
    from actalker_tpu_torch.models import common
    from actalker_tpu_torch.utils import observability as obs

    saved = common.norm_impl()
    common.set_norm_impl("xla")
    obs.reset()
    try:
        for kind, kernel in (("layer", norms.LN_KERNEL), ("group", norms.GN_KERNEL)):
            for c, bf16_affine, taken in ((320, False, True), (36, False, False),
                                          (320, True, True)):
                m = (common.LayerNormF32(c) if kind == "layer"
                     else common.GroupNorm32(c, 4 if c == 36 else 32)).to(dev)
                if bf16_affine:
                    m = m.bfloat16()
                x = (torch.randn(2, 5, 6, c, device=dev) * 2 + 0.5).bfloat16()
                n0 = kernel.launches
                with obs.tracing(), torch.no_grad():
                    y = m(x)
                counters = obs.span_table()["counters"]
                obs.reset()
                assert kernel.launches == n0 + taken
                assert counters == {"norm.kernel" if taken else "norm.plain": 1}
                if kind == "layer":
                    want = norms.layer_norm_ref(x, m.weight, m.bias, m.eps, io_affine=True)
                else:
                    want = norms.group_norm_ref(x, m.weight, m.bias, m.groups, m.eps,
                                                io_affine=True)
                if taken:
                    assert _rel(y, want) <= 1e-3
                else:
                    assert torch.equal(y, want)
            m = (common.LayerNormF32(320) if kind == "layer"
                 else common.GroupNorm32(320)).to(dev)
            off = torch.randn(1 + 2 * 5 * 6 * 320, device=dev).bfloat16()[1:]
            with obs.tracing(), torch.no_grad(), pytest.raises(ValueError):
                m(off.view(2, 5, 6, 320))
            counters = obs.span_table()["counters"]
            obs.reset()
            assert "norm.plain" not in counters
    finally:
        common.set_norm_impl(saved)
        obs.reset()


# K5 at the edges of its two paths (``fwd_plan``): L = 1, L around the
# 32-token chunk and around whole segments (96 = three segments, 97 = a
# one-token last one), Bp = 1, Dp = 128 / 200 / 640 / 1024; the
# wide path at L <= 64 or many chains, segments otherwise
K5_SHAPES = [(1, 1, 128), (1, 3, 640), (31, 2, 200), (32, 1, 128),
             (33, 2, 640), (64, 8, 1024), (65, 1, 200), (96, 1, 128),
             (97, 3, 128), (300, 1, 200), (1100, 2, 128), (200, 4, 1024)]


def _k5_args(dev, dtype, lp, bp, dp, masked=0.3, seed=11):
    """One arranged scan's K5 operands: ``masked`` of the rows inactive
    (dt = -1e9), B|C in the first 32 of 128 lanes."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    dt = 0.5 * rn(lp, bp, dp)
    dt[torch.rand(lp, bp, generator=gen, device=dev) < masked] = -1e9
    bc = torch.zeros(lp, bp, 128, device=dev)
    bc[..., :32] = 0.5 * rn(lp, bp, 32)
    return (rn(lp, bp, dp).to(dtype), dt.to(dtype), bc.to(dtype),
            -torch.exp(0.5 * rn(dp, 16)), rn(dp), 0.5 * rn(dp))


@pytest.mark.cuda
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("lp,bp,dp", K5_SHAPES)
def test_k5_scan_shapes(dev, lp, bp, dp, dtype, tol, rev):
    """K5 on both paths against its plain version (tol as
    test_k5_arranged_scan), one launch through the wrapper."""
    args = _k5_args(dev, dtype, lp, bp, dp)
    n0 = ss.ARRANGED_KERNEL.launches
    y = ss.ssm_scan_arranged(*args, reverse=rev)
    assert ss.ARRANGED_KERNEL.launches == n0 + 1
    assert y.dtype == dtype and y.shape == (lp, bp, dp)
    assert torch.isfinite(y.float()).all()
    assert _rel(y, ss.ssm_scan_arranged_ref(*args, rev)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lp,bp,dp", [(64, 8, 1024), (300, 1, 200)])
@pytest.mark.parametrize("masked", [0.0, 1.0])
def test_k5_masked_rows(dev, masked, lp, bp, dp, dtype, rev):
    """No row masked, and every row masked (identity steps: the state stays
    zero, so y is D u rounded once, exactly as the plain version gives it),
    on the wide path and on the segment path."""
    assert {ss.fwd_plan(lp, bp, dp, 4)["path"]
            for lp, bp, dp in ((64, 8, 1024), (300, 1, 200))} == {"wide", "segments"}
    args = _k5_args(dev, dtype, lp, bp, dp, masked=masked, seed=12)
    y = ss.ssm_scan_arranged(*args, reverse=rev)
    ref = ss.ssm_scan_arranged_ref(*args, rev)
    if masked == 1.0:
        assert torch.equal(y, ref)
    else:
        assert _rel(y, ref) < (1e-5 if dtype == torch.float32 else 1e-3)


@pytest.mark.cuda
def test_k5_from_a_fresh_thread(dev):
    """A thread that has made no CUDA call yet gives the same bits, on both
    paths (no atomics)."""
    import threading

    wide = _k5_args(dev, torch.bfloat16, 200, 4, 1024)
    seg = _k5_args(dev, torch.float32, 1100, 2, 128)
    want = (ss.ssm_scan_arranged(*wide), ss.ssm_scan_arranged(*seg, reverse=True))
    got = {}

    def run():
        got["y"] = (ss.ssm_scan_arranged(*wide),
                    ss.ssm_scan_arranged(*seg, reverse=True))
        torch.cuda.synchronize()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert all(torch.equal(a, w) for a, w in zip(got["y"], want))


@pytest.mark.cuda
def test_k5_refuses_a_plan_that_disagrees(dev):
    """The C entry checks the plan: its chunk and block are the plan's; a
    launch with another shared-memory size or a segment length that is no
    whole number of chunks raises and does not run."""
    assert ss.ARRANGED_KERNEL.constant("ssm_scan_chunk") == ss.FWD_CHUNK
    assert ss.ARRANGED_KERNEL.constant("ssm_scan_block") == ss.FWD_BLOCK
    u, dt, bc, a, d, bias = _k5_args(dev, torch.float32, 300, 1, 200)
    plan = ss.fwd_plan(300, 1, 200, 4)
    y = torch.empty_like(u)
    buf = torch.empty(2 * math.prod(plan["buffers"]["seg_h"]), device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(seg_len, smem):
        ss.ARRANGED_KERNEL.launch(
            "ssm_scan_f32", "p" * 9 + "i" * 7 + "p", u.data_ptr(), dt.data_ptr(),
            bc.data_ptr(), a.data_ptr(), d.data_ptr(), bias.data_ptr(),
            y.data_ptr(), buf.data_ptr(), buf[buf.numel() // 2:].data_ptr(), 300,
            1, 200, 128, 0, seg_len, smem, stream)

    launch(plan["seg_len"], plan["smem"])
    torch.cuda.synchronize()
    assert _rel(y, ss.ssm_scan_arranged_ref(u, dt, bc, a, d, bias, False)) < 1e-5
    for seg_len, smem in ((plan["seg_len"], plan["smem"] + 16),
                          (plan["seg_len"] + 8, plan["smem"])):
        with pytest.raises(RuntimeError):
            launch(seg_len, smem)
