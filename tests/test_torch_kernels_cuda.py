"""The PyTorch port's hand-written CUDA kernels (K1-K4) against their plain
PyTorch versions, on a CUDA card. Skipped without one.

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
