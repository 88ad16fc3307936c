"""PyTorch port, the edges that the Hopper designs of K1 (grouped scan) and
K4 (GEGLU feed-forward) tile around, held on the CPU: the port's plain
versions (which the card tests hold the kernels to) against the JAX
package on the same numpy inputs, fp32.

K1's kernel stages 32-token chunks, reads only the dts lanes [0, rank), the
B|C lanes and the mask lane, and walks 128 channels a block; K4's kernel
tiles 128 rows by 80 (GEGLU) or 160 (output) columns with K slices of 64.
So the shapes here are: L shorter than a chunk and no multiple of it,
ranks 13 / 20 / 40 / 80 (the res-64 / res-32 / res-16 widths and an odd
one), one branch (G = 2), every token masked (the output is D * u, the
state stays 0) and none; M below one tile and ragged, C and I no multiple
of the K slice, Cout != C. The JAX side is its XLA twin (``_grouped_xla``,
``_mlp_xla``), which takes any shape, and for K1 also the Pallas kernel in
interpret mode where its tiling allows (L a multiple of its chunk, B of 8).

Tolerance rtol=1e-4, atol=1e-5 as ``test_torch_ops.py``: both sides
compute in fp32 and differ in summation order only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.ops import mlp as jmlp
from actalker_tpu.ops.selective_scan_pallas import (
    _grouped_xla, ssm_scan_grouped as j_grouped)
from actalker_tpu_torch.ops import mlp, selective_scan as ss

RTOL, ATOL = 1e-4, 1e-5


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _grouped_inputs(seed, lp, bp, dp, rank, groups, masked=0.3, n=16):
    """One SS2D block's operands; ``masked`` is the share of inactive
    tokens (slab lane MASK_LANE = 1 against the -1e9 dtw row)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((lp, bp, groups // 2 * dp)).astype(np.float32)
    slab = np.zeros((lp, bp, groups * 128), np.float32)
    dtw = np.zeros((groups, 128, dp), np.float32)
    for g in range(groups):
        slab[:, :, g * 128:g * 128 + rank + 2 * n] = 0.5 * rng.standard_normal(
            (lp, bp, rank + 2 * n))
        slab[:, :, g * 128 + ss.MASK_LANE] = rng.random((lp, bp)) < masked
        dtw[g, :rank] = 0.3 * rng.standard_normal((rank, dp))
        dtw[g, ss.MASK_LANE] = -1e9
    a = -np.exp(0.5 * rng.standard_normal((groups, dp, n))).astype(np.float32)
    d = rng.standard_normal((groups, dp)).astype(np.float32)
    bias = (0.5 * rng.standard_normal((groups, dp))).astype(np.float32)
    return (u, slab, dtw, a, d, bias), rank


@pytest.mark.parametrize("lp,bp,dp,rank,groups", [
    (7, 3, 16, 13, 4), (45, 2, 24, 20, 4), (33, 3, 16, 80, 2),
    (65, 2, 8, 40, 4)])
def test_k1_plain_edges_match_jax(lp, bp, dp, rank, groups):
    """Ragged L, odd and flagship ranks, one or two branches."""
    arrays, rank = _grouped_inputs(lp, lp, bp, dp, rank, groups)
    port = ss.ssm_scan_grouped(*map(torch.from_numpy, arrays), rank)
    assert ss.KERNEL.launches == 0
    assert port.shape == (lp, bp, groups * dp)
    _close(port, _grouped_xla(*map(jnp.asarray, arrays), rank=rank))


def test_k1_plain_matches_pallas_at_rank_80():
    """The res-16 rank through the interpret-mode Pallas kernel (L and B at
    its tiling)."""
    arrays, rank = _grouped_inputs(1, 16, 8, 128, 80, 4)
    port = ss.ssm_scan_grouped(*map(torch.from_numpy, arrays), rank)
    _close(port, j_grouped(*map(jnp.asarray, arrays), rank=rank))


@pytest.mark.parametrize("masked", [1.0, 0.0])
def test_k1_plain_every_or_no_token_masked(masked):
    """Every token masked: each step is an exact identity, so y = D * u,
    bit for bit, in the port and in JAX; no token masked: as above."""
    arrays, rank = _grouped_inputs(2, 40, 3, 16, 20, 4, masked=masked)
    port = ss.ssm_scan_grouped(*map(torch.from_numpy, arrays), rank)
    ref = _grouped_xla(*map(jnp.asarray, arrays), rank=rank)
    _close(port, ref)
    if masked:
        u, d = arrays[0], arrays[4]
        skip = np.concatenate([u[..., (g // 2) * 16:(g // 2 + 1) * 16] * d[g]
                               for g in range(4)], axis=-1)
        np.testing.assert_array_equal(port.numpy(), skip)


@pytest.mark.parametrize("m,c,cout", [
    (5, 64, 64), (129, 40, 18), (300, 64, 24), (257, 32, 96)])
def test_k4_plain_edges_match_jax(m, c, cout):
    """M below one 128-row tile and ragged, C = 40 (no multiple of the
    64-wide K slice), I = 4C no multiple of the 80-column GEGLU tile, Cout
    != C; the port's weights in torch Linear layout, JAX's in (in, out)."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, 8 * c)) * c ** -0.5).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(8 * c)).astype(np.float32)
    w2 = (rng.standard_normal((4 * c, cout)) * (4 * c) ** -0.5).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    port = mlp.geglu_mlp(torch.from_numpy(x), torch.from_numpy(w1.T.copy()),
                         torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
                         torch.from_numpy(b2))
    assert mlp.KERNEL.launches == 0
    assert port.shape == (m, cout)
    _close(port, jmlp._mlp_xla(*map(jnp.asarray, (x, w1, b1, w2, b2))))
