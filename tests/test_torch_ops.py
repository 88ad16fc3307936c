"""PyTorch port, ops layer: the plain versions of K1-K4 against the JAX
package on the same numpy inputs (fp32, CPU).

The JAX side runs as its own tests run it on the CPU: the grouped scan
``ssm_scan_grouped`` in Pallas interpret mode, and ``mha_tokens`` /
``frame_attention_tokens`` / ``geglu_mlp`` both through their XLA twins and
through ``_mha_pallas`` / ``_frame_pallas_v2`` / ``_mlp_pallas`` with
``interpret=True``. On CPU tensors the port's wrappers must take the plain
version and leave the kernel launch counters at 0.

Tolerance rtol=1e-4, atol=1e-5: both sides compute in fp32 and differ only
in summation order (and, for the interpret-mode GEGLU kernel, its 1.5e-7
erf approximation).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.ops import mha as jmha, mlp as jmlp
from actalker_tpu.ops import selective_scan as jss
from actalker_tpu.ops.selective_scan_pallas import ssm_scan_grouped as j_grouped
from actalker_tpu_torch.ops import mha, mlp, selective_scan as ss

RTOL, ATOL = 1e-4, 1e-5


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _grouped_inputs(rng, lp=64, bp=8, dp=128, rank=8, n=16, groups=4):
    u = rng.standard_normal((lp, bp, groups // 2 * dp)).astype(np.float32)
    slab = np.zeros((lp, bp, groups * 128), np.float32)
    dtw = np.zeros((groups, 128, dp), np.float32)
    for g in range(groups):
        slab[:, :, g * 128:g * 128 + rank + 2 * n] = 0.5 * rng.standard_normal(
            (lp, bp, rank + 2 * n))
        slab[:, :, g * 128 + ss.MASK_LANE] = rng.random((lp, bp)) < 0.3
        dtw[g, :rank] = 0.3 * rng.standard_normal((rank, dp))
        dtw[g, ss.MASK_LANE] = -1e9
    a = -np.exp(0.5 * rng.standard_normal((groups, dp, n))).astype(np.float32)
    d = rng.standard_normal((groups, dp)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((groups, dp))).astype(np.float32)
    return u, slab, dtw, a, d, bias, rank


def test_ssm_scan_grouped_plain_matches_pallas_interpret():
    """K1: all four (branch, direction) scans, ~30% inactive rows."""
    args = _grouped_inputs(np.random.default_rng(0))
    *arrays, rank = args
    ref = j_grouped(*map(jnp.asarray, arrays), rank=rank)
    before = ss.KERNEL.launches
    port = ss.ssm_scan_grouped(*map(torch.from_numpy, arrays), rank)
    assert ss.KERNEL.launches == before == 0
    assert port.shape == ref.shape
    _close(port, ref)


@pytest.mark.parametrize("impl", ["seq", "blocked"])
def test_selective_scan_matches_jax(impl):
    rng = np.random.default_rng(1)
    b, l, d, g, n = 2, 70, 16, 2, 8
    u = rng.standard_normal((b, l, d)).astype(np.float32)
    delta = rng.standard_normal((b, l, d)).astype(np.float32)
    a = -np.exp(rng.standard_normal((d, n))).astype(np.float32)
    bm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, g, n)).astype(np.float32)
    dsk = rng.standard_normal(d).astype(np.float32)
    bias = rng.standard_normal(d).astype(np.float32)
    ref = jss.selective_scan(*map(jnp.asarray, (u, delta, a, bm, cm, dsk, bias)),
                             impl=impl, chunk=16)
    port = ss.selective_scan(*map(torch.from_numpy, (u, delta, a, bm, cm, dsk,
                                                      bias)), impl=impl, chunk=16)
    _close(port, ref)


@pytest.mark.parametrize("s", [256, 324])
def test_mha_tokens_plain_matches_jax(s):
    """K2: the XLA twin and the interpret-mode Pallas kernel; S = 324 is not
    a multiple of 256, so the JAX kernel runs on padded rows with
    ``kv_len`` masking and the port attends over the 324 rows directly."""
    rng = np.random.default_rng(2)
    b, c, h = 2, 64, 2
    q, k, v = (rng.standard_normal((b, s, c)).astype(np.float32) for _ in range(3))
    sc = (c // h) ** -0.5
    port = mha.mha_tokens(*map(torch.from_numpy, (q, k, v)), h)
    assert mha.MHA_KERNEL.launches == 0
    _close(port, jmha.mha_tokens(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), h))
    sp = (s + 255) // 256 * 256
    pad = ((0, 0), (0, sp - s), (0, 0))
    ref = jmha._mha_pallas(*(jnp.pad(jnp.asarray(x), pad) for x in (q, k, v)),
                           h, sc, interpret=True,
                           kv_len=s if sp != s else None)[:, :s]
    _close(port, ref)


def test_frame_attention_plain_matches_jax():
    """K3: attention across F = 5 frames of each token and head."""
    rng = np.random.default_rng(3)
    b, f, s, c, h = 2, 5, 128, 64, 2
    q, k, v = (rng.standard_normal((b * f, s, c)).astype(np.float32)
               for _ in range(3))
    port = mha.frame_attention_tokens(*map(torch.from_numpy, (q, k, v)), f, h)
    assert mha.FRAME_KERNEL.launches == 0
    _close(port, jmha.frame_attention_tokens(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), f, h))
    ref = jmha._frame_pallas_v2(*(jnp.asarray(x).reshape(b, f, s, c)
                                  for x in (q, k, v)), h, (c // h) ** -0.5,
                                interpret=True)
    _close(port, ref.reshape(b * f, s, c))


def test_geglu_mlp_plain_matches_jax():
    """K4: weights in torch Linear layout on the port's side, JAX's (in, out)
    layout on the other."""
    rng = np.random.default_rng(4)
    m, c = 256, 64
    x = rng.standard_normal((m, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, 8 * c)) * c ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(8 * c)).astype(np.float32)
    w2 = (rng.standard_normal((4 * c, c)) * (4 * c) ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    port = mlp.geglu_mlp(torch.from_numpy(x), torch.from_numpy(w1.T.copy()),
                         torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
                         torch.from_numpy(b2))
    assert mlp.KERNEL.launches == 0
    jargs = tuple(map(jnp.asarray, (x, w1, b1, w2, b2)))
    _close(port, jmlp.geglu_mlp(*jargs))
    _close(port, jmlp._mlp_pallas(*jargs, interpret=True))

