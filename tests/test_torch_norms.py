"""PyTorch port, ``ops/norms.py`` (K7-LN, K7-GN) and the fused branch of
``LayerNormF32`` / ``GroupNorm32`` against the JAX package (fp32, CPU).

The port's wrappers take their plain versions on CPU tensors. They are held
against the JAX package's Pallas kernels run in interpret mode
(``_ln_pallas`` / ``_gn_pallas``, as ``tests/test_norms.py`` runs them),
including a GroupNorm row count that is not a multiple of the JAX block
(its masked tail), and their autograd functions against ``jax.grad``
through the ``custom_vjp``s. The modules run under ``set_norm_impl("fused")``
on both sides, each switch restored afterwards.

Tolerance rtol=1e-4, atol=1e-4 (fp32 on both sides; the statistics are
sums over up to 32k elements taken in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.io.init import random_like
from actalker_tpu.models import common as jcommon
from actalker_tpu.ops import norms as jnorms
from actalker_tpu.ops.resconv import _gn_affine
from actalker_tpu_torch.models import common
from actalker_tpu_torch.ops import norms
from tests.test_torch_resconv import switches

RTOL, ATOL = 1e-4, 1e-4


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (scale * rng.standard_normal(shape) + shift).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("m,c", [(512, 320), (256, 1280), (200, 2560)])
def test_layer_norm_matches_interpret_kernel(m, c):
    rng = np.random.default_rng(0)
    x, g, b = _rand(rng, m, c, scale=3.0, shift=1.5), _rand(rng, c), _rand(rng, c)
    want = jnorms._ln_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                             1e-5, interpret=True)
    _close(norms.layer_norm(*_t(x, g, b)), want)
    _close(norms.layer_norm_ref(*_t(x, g, b)),
           jnorms._ln_xla(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5))


@pytest.mark.parametrize("m", [96, 100])      # a whole JAX block; a masked tail
def test_group_norm_matches_interpret_kernel(m):
    rng = np.random.default_rng(1)
    x = _rand(rng, 3, m, 320, scale=2.0, shift=-0.5)
    g, b = _rand(rng, 320), _rand(rng, 320)
    want = jnorms._gn_pallas(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                             32, 1e-5, interpret=True)
    _close(norms.group_norm(*_t(x, g, b), 32, 1e-5), want)


@pytest.mark.parametrize("shape,groups", [((2, 6, 5, 64), 32),
                                          ((2, 3, 4, 4, 128), 32),
                                          ((3, 7, 960), 32)])
def test_group_norm_matches_jax_on_image_and_video_shapes(shape, groups):
    """(N, H, W, C), the temporal resnets' (B, F, H, W, C) and C / G = 30."""
    rng = np.random.default_rng(2)
    x = _rand(rng, *shape, scale=1.5, shift=0.3)
    c = shape[-1]
    g, b = _rand(rng, c), _rand(rng, c)
    want = jnorms.group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                             groups, 1e-6)
    _close(norms.group_norm(*_t(x, g, b), groups, 1e-6), want)
    a_t, b_t = norms.group_norm_affine(*_t(x, g, b), groups, 1e-6)
    a_j, b_j = _gn_affine(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          groups, 1e-6)
    _close(a_t, a_j)
    _close(b_t, b_j)


def test_norm_autograd_functions_match_jax_custom_vjp():
    """``LayerNormFn`` / ``GroupNormFn`` against ``jax.grad`` through
    ``layer_norm`` / ``group_norm`` (their ``custom_vjp``s)."""
    rng = np.random.default_rng(3)
    for kind in ("layer", "group"):
        shape = (32, 64) if kind == "layer" else (2, 12, 64)
        x, g, b = _rand(rng, *shape), _rand(rng, 64), _rand(rng, 64)
        if kind == "layer":
            jfn = lambda x, g, b: jnorms.layer_norm(x, g, b)      # noqa: E731
            tfn = lambda x, g, b: norms.layer_norm(x, g, b)       # noqa: E731
        else:
            jfn = lambda x, g, b: jnorms.group_norm(x, g, b, 8)   # noqa: E731
            tfn = lambda x, g, b: norms.group_norm(x, g, b, 8)    # noqa: E731
        want = jax.grad(lambda *a: jnp.sum(jnp.tanh(jfn(*a))), argnums=(0, 1, 2))(
            *map(jnp.asarray, (x, g, b)))
        ins = [t.requires_grad_(True) for t in _t(x, g, b)]
        out = tfn(*ins)
        assert out.grad_fn is not None and "NormFn" in type(out.grad_fn).__name__
        got = torch.autograd.grad(torch.tanh(out).sum(), ins)
        for a, w in zip(got, want):
            _close(a, w)


@pytest.mark.parametrize("kind", ["layer", "group"])
def test_modules_under_fused_switch_match_jax(kind):
    """``LayerNormF32`` / ``GroupNorm32`` with the switch on, against the
    JAX modules under ``set_norm_impl("fused")``, on the same parameters."""
    rng = np.random.default_rng(4)
    if kind == "layer":
        x = _rand(rng, 4, 24, 640, scale=2.0, shift=0.5)
        jm, tm = jcommon.LayerNormF32(), common.LayerNormF32(640)
    else:
        x = _rand(rng, 2, 3, 4, 4, 320, scale=2.0, shift=0.5)
        jm, tm = jcommon.GroupNorm32(epsilon=1e-6), common.GroupNorm32(320, eps=1e-6)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x)),
                            jax.random.PRNGKey(0))
    p = random_like(shapes, scale=0.5, seed=1)
    tm.load_state_dict({"weight": torch.tensor(np.asarray(p["params"]["scale"])),
                        "bias": torch.tensor(np.asarray(p["params"]["bias"]))},
                       strict=True)
    with switches("fused", "xla"):
        want = jm.apply(p, jnp.asarray(x))
        got = tm(torch.from_numpy(x))
    _close(got, want)


def test_switch_rejects_unknown_impl():
    before = common.norm_impl()
    with pytest.raises(ValueError):
        common.set_norm_impl("pallas")
    assert common.norm_impl() == before
