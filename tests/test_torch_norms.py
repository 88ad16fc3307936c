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

The default lowering's variant (``io_affine``): ``kernel_takes`` on fake
CUDA tensors (``FakeTensorMode``: metadata alone), and, on the CPU, the
modules under "xla" bit-equal to the plain formula they ran before K7 took
the card's calls (forward and gradients), counting ``norm.plain``; the
fused lowering unchanged; the autograd functions of the variant
differentiating its plain twin.
"""
import math

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
from actalker_tpu_torch.utils import observability
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


# ------------------------------------------- the default lowering's variant

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("shape,dtype,device,transposed,groups,offset,taken", [
    ((6, 320), BF16, "cuda", False, None, 0, True),
    ((3, 7, 2560), F32, "cuda", False, None, 0, True),
    ((6, 320), BF16, "cuda", False, None, 8, True),      # an aligned view
    ((2, 10, 320), BF16, "cuda", False, 32, 0, True),
    ((2, 3, 4, 4, 640), F32, "cuda", False, 32, 0, True),
    ((6, 320), BF16, "cpu", False, None, 0, False),
    ((2, 10, 320), F32, "cpu", False, 32, 0, False),
    ((6, 36), BF16, "cuda", False, None, 0, False),      # C % 8 != 0
    ((2, 5, 36), BF16, "cuda", False, 4, 0, False),
    ((6, 320), torch.float16, "cuda", False, None, 0, False),
    ((4, 6, 320), BF16, "cuda", True, None, 0, True),    # the wrapper copies it
    ((6, 320), BF16, "cuda", False, None, 4, True),      # the wrapper refuses it
    ((0, 320), BF16, "cuda", False, None, 0, False),     # empty
    ((10, 320), BF16, "cuda", False, 32, 0, False),      # GN of rank 2
    ((2, 5, 320), BF16, "cuda", False, 30, 0, False),    # no whole groups
])
def test_kernel_takes(shape, dtype, device, transposed, groups, offset, taken):
    """The predicate reads x's metadata alone: device, dtype, C % 8, size,
    rank and groups. Layout and alignment are the wrapper's to normalize or
    refuse, not a way to the plain code."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        base = torch.empty(offset + math.prod(shape), dtype=dtype, device=device)
        x = base.as_strided(shape, torch.empty(shape, device="meta").stride(),
                            offset)
        if transposed:
            x = x.transpose(0, 1)
        assert norms.kernel_takes(x, groups) is taken


@pytest.mark.filterwarnings("ignore:Accessing the data pointer of FakeTensor")
def test_kernel_takes_refuses_gamma_off_the_card_or_of_another_width():
    """gamma / beta do not decide the route: a call K7 takes whose gamma is
    off the card or of another width is refused by the wrapper with an
    error, not run plain."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(4, 320, dtype=BF16, device="cuda")
        x3 = torch.empty(1, 4, 320, dtype=BF16, device="cuda")
        g = torch.empty(320, device="cuda")
        assert norms.kernel_takes(x) and norms.kernel_takes(x3, 32)
        for gamma, beta in ((torch.empty(320), g),
                            (g, torch.empty(640, device="cuda"))):
            with pytest.raises(ValueError):
                norms.layer_norm(x, gamma, beta, io_affine=True)
            with pytest.raises(ValueError):
                norms.group_norm(x3, gamma, beta, 32, io_affine=True)


def _old_layer_norm(m, x):
    """``LayerNormF32``'s plain branch as written before K7 took the card's
    calls."""
    mean = x.mean(dim=-1, keepdim=True, dtype=torch.float32)
    var = (x.float().square().mean(dim=-1, keepdim=True)
           - mean.square()).clamp_min(0.0)
    a = torch.rsqrt(var + m.eps) * m.weight.float()
    b = m.bias.float() - mean * a
    return x * a.to(x.dtype) + b.to(x.dtype)


def _old_group_norm(m, x):
    """``GroupNorm32``'s plain branch as written before K7 took the card's
    calls."""
    n, c = x.shape[0], x.shape[-1]
    dims = tuple(range(1, x.ndim - 1))
    s1 = x.mean(dim=dims, dtype=torch.float32)
    s2 = x.float().square().mean(dim=dims)
    mean_g = s1.reshape(n, m.groups, -1).mean(-1)
    var_g = (s2.reshape(n, m.groups, -1).mean(-1)
             - mean_g.square()).clamp_min(0.0)
    inv_c = torch.rsqrt(var_g + m.eps).repeat_interleave(c // m.groups, dim=1)
    mean_c = mean_g.repeat_interleave(c // m.groups, dim=1)
    a = inv_c * m.weight.float()
    b = m.bias.float() - mean_c * a
    shape = (n,) + (1,) * (x.ndim - 2) + (c,)
    return x * a.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)


def _module(kind, c, seed):
    g = torch.Generator().manual_seed(seed)
    m = common.LayerNormF32(c) if kind == "layer" else common.GroupNorm32(c, eps=1e-6)
    with torch.no_grad():
        m.weight.copy_(1 + 0.3 * torch.randn(c, generator=g))
        m.bias.copy_(0.5 * torch.randn(c, generator=g))
    return m, g


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("kind,shape", [("layer", (4, 9, 320)),
                                        ("layer", (5, 36)),
                                        ("group", (2, 3, 4, 4, 320)),
                                        ("group", (2, 5, 20))])
def test_default_modules_on_the_cpu_keep_the_plain_formula(kind, shape, dtype):
    """Under "xla" a CPU call is the plain formula bit for bit, forward and
    gradients of x / weight / bias, and counts one ``norm.plain``."""
    m, g = _module(kind, shape[-1], 5)
    old = _old_layer_norm if kind == "layer" else _old_group_norm
    x = (2 * torch.randn(*shape, generator=g) + 0.5).to(dtype).requires_grad_(True)
    cot = torch.randn(*shape, generator=g).to(dtype)
    saved = common.norm_impl()
    common.set_norm_impl("xla")
    observability.reset()
    try:
        with observability.tracing():
            y = m(x)
        counters = observability.span_table()["counters"]
    finally:
        common.set_norm_impl(saved)
        observability.reset()
    want = old(m, x)
    assert y.dtype == dtype and torch.equal(y, want)
    assert counters == {"norm.plain": 1}
    ins = (x, m.weight, m.bias)
    got = torch.autograd.grad((y * cot).sum(), ins)
    for a, w in zip(got, torch.autograd.grad((want * cot).sum(), ins)):
        assert torch.equal(a, w)


@pytest.mark.parametrize("kind", ["layer", "group"])
def test_fused_modules_on_the_cpu_are_unchanged(kind):
    """Under "fused" a CPU call is the fp32-affine plain version of K7, bit
    for bit, and counts one ``norm.plain``."""
    m, g = _module(kind, 320, 6)
    x = (2 * torch.randn(2, 4, 6, 320, generator=g) + 0.5).bfloat16()
    if kind == "layer":
        want = norms.layer_norm_ref(x, m.weight, m.bias, m.eps)
    else:
        want = norms.group_norm_ref(x, m.weight, m.bias, m.groups, m.eps)
    saved = common.norm_impl()
    common.set_norm_impl("fused")
    observability.reset()
    try:
        with observability.tracing(), torch.no_grad():
            y = m(x)
        counters = observability.span_table()["counters"]
    finally:
        common.set_norm_impl(saved)
        observability.reset()
    assert torch.equal(y, want) and counters == {"norm.plain": 1}
    # the two lowerings are two functions: bf16 output rounded once or
    # three times
    assert not torch.equal(want, (_old_layer_norm if kind == "layer"
                                  else _old_group_norm)(m, x))


@pytest.mark.parametrize("kind", ["layer", "group"])
def test_variant_autograd_functions_differentiate_the_plain_twin(kind):
    """``layer_norm`` / ``group_norm`` with ``io_affine`` go through their
    autograd function when a gradient is needed; on the CPU its forward is
    the plain twin and its backward differentiates it: the same bits as
    autograd through the twin."""
    rng = np.random.default_rng(7)
    x, g, b = _rand(rng, 2, 12, 64, scale=2.0), _rand(rng, 64), _rand(rng, 64)
    ins = [t.to(torch.bfloat16).float().requires_grad_(True) for t in _t(x, g, b)]
    if kind == "layer":
        fn = lambda *a, **k: norms.layer_norm(*a, **k)            # noqa: E731
        ref = lambda *a: norms.layer_norm_ref(*a, io_affine=True)  # noqa: E731
    else:
        fn = lambda *a, **k: norms.group_norm(*a, 8, **k)          # noqa: E731
        ref = lambda *a: norms.group_norm_ref(*a, 8, io_affine=True)  # noqa: E731
    out = fn(*ins, io_affine=True)
    assert "NormFn" in type(out.grad_fn).__name__
    want = ref(*ins)
    assert torch.equal(out, want)
    cot = torch.from_numpy(_rand(rng, 2, 12, 64))
    got = torch.autograd.grad((out * cot).sum(), ins)
    for a, w in zip(got, torch.autograd.grad((want * cot).sum(), ins)):
        assert torch.equal(a, w)
