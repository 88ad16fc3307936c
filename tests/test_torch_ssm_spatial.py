"""PyTorch port, the SS2D lineage against the JAX package (CPU): the plain
version of the single-direction scan K5 and its gradient, ``SS2DUnit``,
``SS2DSpatial``, ``SS2DCondV5`` / ``V6`` / ``V9``, ``MambaUPNet``, the
scan-order tables and the lineage's initializers.

The JAX side runs as its own tests run it on the CPU: ``ssm_scan`` and the
modules with ``scan_impl="pallas"`` take the Pallas kernel in interpret
mode (gradients through its ``custom_vjp``, i.e. ``_arranged_xla``);
``MambaUPNet`` (28 scans) takes the package's plain blocked scan. Parameters
come from the JAX modules' own ``init`` and reach the port through
``io/jax_export.export_lineage``, loaded with ``strict=True``. On CPU
tensors the port's wrappers take the plain versions and launch nothing.

Tolerances: fp32 rtol 2e-4 / atol 2e-5 (the JAX oracle tests' own: fp32 on
both sides, differing in summation order); bf16 a relative L2 error of 2e-2
(both sides round activations to bf16, at places and in orders that
differ).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.io.init import random_like
from actalker_tpu.models import ssm as jssm, ssm_spatial as jsp
from actalker_tpu.ops import scan_orders as jso
from actalker_tpu.ops import selective_scan_pallas as jsp_ops
from actalker_tpu_torch.io.init import cast_params_bf16_, lineage_init_
from actalker_tpu_torch.io.jax_export import export_lineage
from actalker_tpu_torch.io.weights import to_torch
from actalker_tpu_torch.models import ssm, ssm_spatial as sp
from actalker_tpu_torch.ops import scan_orders, selective_scan as ss

RTOL, ATOL = 2e-4, 2e-5
BF16_REL = 2e-2


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else \
        np.asarray(jnp.asarray(x, jnp.float32))


def _close(port, ref):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=RTOL, atol=ATOL)


def _rel(port, ref):
    a, b = _np(port), _np(ref)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port(module, jparams):
    """The port module with the JAX module's parameters."""
    module.load_state_dict(to_torch(export_lineage(jparams)), strict=True)
    return module


def _launches():
    return ss.ARRANGED_KERNEL.launches, ss.BWD_KERNEL.launches


# ------------------------------------------------------------ scan orders

@pytest.mark.parametrize("kind", sorted(jso.ORDERS))
def test_scan_order_tables_match_jax(kind):
    for h, w in ((4, 4), (5, 3), (8, 8), (6, 10)):
        p = scan_orders.order_table(kind, h, w)
        np.testing.assert_array_equal(p, jso.order_table(kind, h, w))
        np.testing.assert_array_equal(scan_orders.inverse_table(p),
                                      jso.inverse_table(p))


@pytest.mark.parametrize("k,scan_type", [(2, "scan"), (4, "scan"),
                                         (8, "sweep"), (4, "zigzag")])
def test_direction_perms_match_jax(k, scan_type):
    for got, want in zip(sp.direction_perms(6, 6, k, scan_type),
                         jsp.direction_perms(6, 6, k, scan_type), strict=True):
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- K5 plain version

def _scan_inputs(n, seed=0, b=3, l=37, d=40):
    """(B, L, D) scan operands; L = 37 pads to the JAX chunk, D = 40 to 128;
    ~30% of the rows carry delta = -1e9 (masked tokens)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, l, d)).astype(np.float32)
    delta = (0.5 * rng.standard_normal((b, l, d))).astype(np.float32)
    delta[rng.random((b, l)) < 0.3] = -1e9
    a = (-np.exp(0.3 * rng.standard_normal((d, n)))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, l, n)).astype(np.float32)
              for _ in range(2))
    dsk = rng.standard_normal(d).astype(np.float32)
    bias = (0.2 * rng.standard_normal(d)).astype(np.float32)
    return u, delta, a, bm, cm, dsk, bias


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_arranged_scan_plain_matches_pallas(reverse, dtype, n):
    """``ssm_scan`` (arrange + K5's plain version) against the JAX
    ``ssm_scan`` (arrange + the Pallas kernel, interpret mode); u, delta
    and B / C in ``dtype``, the arranged buffers equal element for
    element."""
    u, delta, a, bm, cm, dsk, bias = _scan_inputs(n)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(t, jd) for t in (u, delta, bm, cm)]
    tx = [torch.from_numpy(t).to(td) for t in (u, delta, bm, cm)]
    for got, want in zip(ss.arrange_ssm_inputs(*tx),
                         jsp_ops.arrange_ssm_inputs(*jx), strict=True):
        assert tuple(got.shape) == want.shape and got.dtype == td
        np.testing.assert_array_equal(_np(got), _np(want))
    rest = (a, dsk, bias)
    want = jsp_ops.ssm_scan(jx[0], jx[1], jnp.asarray(a), jx[2], jx[3],
                            *map(jnp.asarray, rest[1:]), reverse=reverse)
    n0 = _launches()
    got = ss.ssm_scan(tx[0], tx[1], torch.from_numpy(a), tx[2], tx[3],
                      *map(torch.from_numpy, rest[1:]), reverse=reverse)
    assert _launches() == n0 == (0, 0)
    assert got.dtype == td and tuple(got.shape) == want.shape
    if dtype == "float32":
        _close(got, want)
    else:
        assert _rel(got, want) < BF16_REL


@pytest.mark.parametrize("reverse", [False, True])
def test_arranged_scan_grads_match_jax(reverse):
    """Gradients of sum(y * cot) through ``SsmScanArrangedFn`` (the plain
    adjoint, K6's plain version, on the CPU) against ``jax.grad`` of the JAX
    ``ssm_scan`` (its ``custom_vjp``), for all seven inputs."""
    ins = _scan_inputs(16, seed=1)
    cot = np.random.default_rng(2).standard_normal(ins[0].shape).astype(np.float32)

    def loss(u, delta, a, bm, cm, dsk, bias):
        y = jsp_ops.ssm_scan(u, delta, a, bm, cm, dsk, bias, reverse=reverse)
        return jnp.sum(y * cot)

    want = jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, ins))
    tx = [torch.from_numpy(t).requires_grad_(True) for t in ins]
    y = ss.ssm_scan(*tx, reverse=reverse)
    got = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), tx)
    assert _launches() == (0, 0)
    for name, g, w in zip("u delta A B C D bias".split(), got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


# ----------------------------------------------------------------- modules

@pytest.mark.parametrize("masked", [False, True])
def test_ss2d_unit_matches_jax(masked):
    """Both directions, with and without a transparency mask (~30% of the
    tokens identity steps)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 37, 24)).astype(np.float32)
    tm = (rng.random((3, 37)) > 0.3) if masked else None
    jm = jssm.SS2DUnit(24, d_state=4, scan_impl="pallas")
    jargs = (jnp.asarray(x),) + (() if tm is None else (jnp.asarray(tm),))
    p = jm.init(jax.random.PRNGKey(0), *jargs)
    tmod = _port(ssm.SS2DUnit(24, d_state=4), p)
    targs = (torch.from_numpy(x),) + (() if tm is None else (torch.from_numpy(tm),))
    _close(tmod(*targs), jm.apply(p, *jargs))
    assert _launches() == (0, 0)


@pytest.mark.parametrize("k_total,scan_type", [(2, "scan"), (4, "scan"),
                                               (8, "sweep"), (4, "zigzag")])
def test_ss2d_spatial_matches_jax(k_total, scan_type):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    jm = jsp.SS2DSpatial(8, d_state=4, num_direction=k_total,
                         scan_type=scan_type, scan_impl="pallas")
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    tmod = _port(sp.SS2DSpatial(8, d_state=4, num_direction=k_total,
                                scan_type=scan_type), p)
    _close(tmod(torch.from_numpy(x)), jm.apply(p, jnp.asarray(x)))


def _box(h=8, w=8):
    m = np.zeros((1, 1, h, w), np.float32)
    m[..., 2:6, 1:5] = 1.0
    return m


def _cond_case(kind, rng):
    """(JAX module, port module, numpy inputs) of one conditional block."""
    b, l, dm, dc = 2, 16, 8, 16
    x = rng.standard_normal((b, l, dm)).astype(np.float32)
    if kind == "v9":
        args = (x, rng.standard_normal((b, 1, dc)).astype(np.float32),
                rng.standard_normal((b, 3, dc)).astype(np.float32),
                rng.standard_normal((b, 1, dc)).astype(np.float32),
                _box(), 1.0 - _box())
        return (jsp.SS2DCondV9(dm, d_cond=dc, d_state=4, scan_impl="pallas"),
                sp.SS2DCondV9(dm, d_cond=dc, d_state=4), args)
    cond = rng.standard_normal((b, 3, dc)).astype(np.float32)
    if kind == "v5":
        return (jsp.SS2DCondV5(dm, d_cond=dc, d_state=4, scan_impl="pallas"),
                sp.SS2DCondV5(dm, d_cond=dc, d_state=4), (x, cond))
    return (jsp.SS2DCondV6(dm, d_cond=dc, d_state=4, scan_impl="pallas"),
            sp.SS2DCondV6(dm, d_cond=dc, d_state=4), (x, cond))


@pytest.mark.parametrize("kind,dtype", [("v5", "float32"), ("v6", "float32"),
                                        ("v9", "float32"), ("v9", "bfloat16")])
def test_ss2d_cond_matches_jax(kind, dtype):
    """V9 with a box audio mask and its complement as the expression mask
    (soft multiply); V5 / V6 over [tokens | 3 cond tokens]. The bf16 case
    runs the JAX module with ``dtype=bfloat16`` and the port on bf16
    inputs (fp32 parameters in both, cast where they are used)."""
    jm, tmod, args = _cond_case(kind, np.random.default_rng(5))
    p = jm.init(jax.random.PRNGKey(2), *map(jnp.asarray, args))
    tmod = _port(tmod, p)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    if dtype == "bfloat16":
        jm = jm.clone(dtype=jnp.bfloat16)
    # token and condition tensors in dtype, the region masks fp32
    jargs = [jnp.asarray(a, jd if a.ndim == 3 else jnp.float32) for a in args]
    targs = [torch.from_numpy(a).to(td if a.ndim == 3 else torch.float32)
             for a in args]
    want = jm.apply(p, *jargs)
    got = tmod(*targs)
    assert _launches() == (0, 0)
    if dtype == "float32":
        _close(got, want)
    else:
        assert got.dtype == torch.bfloat16 and _rel(got, want) < BF16_REL


def test_mamba_upnet_matches_jax():
    """Three stages (32 @ 4x4 -> 16 @ 8x8 -> 8 @ 16x16); depths 3, 2, 2
    take both of LSSLayerUp's depth rules. Every stage output is held.
    Parameters are ``random_like`` draws (N(0, 0.2^2); the 28 scans'
    initializers would cost a second compile of the stack)."""
    x = np.random.default_rng(6).standard_normal((2, 4, 4, 32)).astype(np.float32)
    jm = jsp.MambaUPNet(dims_decoder=(32, 16, 8), depths_decoder=(3, 2, 2),
                        d_state=4, scan_impl="blocked")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(3), jnp.asarray(x))
    p = random_like(shapes, scale=0.2, seed=3)
    tmod = _port(sp.MambaUPNet((32, 16, 8), (3, 2, 2), d_state=4), p)
    want = jax.jit(jm.apply)(p, jnp.asarray(x))
    got = tmod(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == \
        [(2, 16, 16, 8), (2, 8, 8, 16)]
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------- initializers

def test_lineage_init_follows_jax_recipes():
    """``lineage_init_`` gives every parameter of a V9 the JAX package's
    recipe (A_logs, Ds and the norms as the JAX init's, the rest in its
    ranges and spread), repeats from its seed, and ``cast_params_bf16_``
    keeps the scan's A_logs / dt_projs_* fp32."""
    dm, dc = 64, 96
    jm = jsp.SS2DCondV9(dm, d_cond=dc, d_state=16)
    x, e = jnp.zeros((1, 16, dm)), jnp.zeros((1, 1, dc))
    want = to_torch(export_lineage(jax.jit(
        lambda key: jm.init(key, x, e, e, e, None, None))(jax.random.PRNGKey(0))))

    def make(seed):
        with torch.device("meta"):
            m = sp.SS2DCondV9(dm, d_cond=dc)
        return lineage_init_(m, seed=seed, device="cpu")

    got = make(3).state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, leaf = got[k], k.rsplit(".", 1)[-1]
        assert g.shape == w.shape, k
        if leaf in ("A_logs", "Ds") or g.ndim == 1 and "norm" in k:
            # XLA's and torch's fp32 log differ by one ulp at log(7)
            torch.testing.assert_close(g, w, rtol=2e-7, atol=0, msg=k)
        elif leaf in ("x_proj_weight", "dt_projs_weight"):
            bound = g.shape[-1] ** -0.5
            assert g.abs().max() <= bound and g.abs().max() > 0.9 * bound, k
        elif leaf == "dt_projs_bias":
            dt = torch.nn.functional.softplus(g)
            assert dt.min() >= 1e-4 and dt.max() <= 0.1 + 1e-6, k
        else:                        # lecun-normal dense kernels
            assert abs(g.std() / w.std() - 1) < 0.1, k
            assert g.abs().max() <= 2.01 * g.shape[1] ** -0.5 / 0.8796, k
    again = make(3).state_dict()
    assert all(torch.equal(got[k], again[k]) for k in got)
    fp32 = {k for k, v in cast_params_bf16_(make(3)).state_dict().items()
            if v.dtype == torch.float32}
    assert {k for k in fp32 if k.endswith(("A_logs", "dt_projs_weight",
                                           "dt_projs_bias", "Ds"))} == \
        {k for k in got if k.endswith(("A_logs", "dt_projs_weight",
                                       "dt_projs_bias", "Ds"))}
    assert not any(k.endswith("x_proj_weight") for k in fp32)


def test_chip_smoke_derives_lineage_launches(monkeypatch):
    """The K5 launches ``chip_smoke.py`` phase 8 derives from a module
    (``lineage_launches``: one per direction of every scan unit) equal the
    calls of K5's forward one forward makes, for each module it runs."""
    import chip_smoke

    calls = []
    fwd = ss._arranged_fwd
    monkeypatch.setattr(ss, "_arranged_fwd",
                        lambda *a: calls.append(1) or fwd(*a))
    rng = np.random.default_rng(8)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x, c = rand(2, 16, 8), rand(2, 3, 16)
    box = torch.from_numpy(_box())
    cases = ((sp.SS2DCondV9(8, d_cond=16, d_state=4), (x, c[:, :1], c, c[:, :1], box, box)),
             (sp.SS2DCondV5(8, d_cond=16, d_state=4, n_ssd_unit=3), (x, c)),
             (sp.SS2DCondV6(8, d_cond=16, d_state=4), (x, c)),
             (sp.MambaUPNet((16, 8), (3, 4), d_state=4), (rand(1, 2, 2, 16),)))
    for mod, args in cases:
        calls.clear()
        with torch.no_grad():
            mod(*args)
        assert len(calls) == chip_smoke.lineage_launches(mod) > 0
    assert chip_smoke.lineage_launches(sp.MambaUPNet()) == 64
