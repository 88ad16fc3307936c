"""The PyTorch port's hand-written CUDA kernels (K1-K4, the scan adjoint K6
and the attention backward K2-bwd) against their plain PyTorch versions, on
a CUDA card. Skipped without one. A backward through each autograd
function must launch its kernels (it cannot silently take a plain path).

This file imports no JAX, so it runs where the card is (that machine has no
JAX; skip the JAX test configuration):

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Shapes are small but ragged (edges that are no multiple of the kernels'
tiles); ``chip_smoke.py`` repeats the check at the flagship shapes.
Tolerances are relative L2 errors, stated per kernel with their reason.
"""
import pytest
import torch

from actalker_tpu_torch.ops import mha, mlp, selective_scan as ss


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h", [(2, 300, 2), (3, 64, 5), (1, 1000, 1)])
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
@pytest.mark.parametrize("b,s,h", [(2, 300, 2), (3, 64, 5), (1, 1000, 1)])
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
    the plain version; gradients match autograd through it."""
    q, k, v = (torch.randn(6, 17, 128, device=dev).bfloat16().requires_grad_(True)
               for _ in range(3))
    n3 = mha.FRAME_KERNEL.launches
    got = torch.autograd.grad(mha.frame_attention_tokens(q, k, v, 3, 2).float().sum(),
                              (q, k, v))
    assert mha.FRAME_KERNEL.launches == n3 + 1
    want = torch.autograd.grad(
        mha.frame_attention_tokens_ref(q, k, v, 3, 2).float().sum(), (q, k, v))
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
    want = torch.autograd.grad(mlp.geglu_mlp_ref(x, w1, b1, w2, b2).float().sum(),
                               (x, w1, b1, w2, b2))
    assert max(_rel(a, b) for a, b in zip(got, want)) < 1e-6
