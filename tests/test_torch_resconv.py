"""PyTorch port, ``ops/resconv.py`` (K8 with K7-GN's statistics) and the
fused branch of the resnet blocks against the JAX package (fp32, CPU).

``gn_silu_conv3x3`` (its plain version on CPU tensors) against the JAX
package's Pallas kernel run in interpret mode on ``_gn_affine``'s (a, b),
as ``tests/test_resconv.py`` runs it: C == Co, C != Co, and one-pixel
images, several to a tile. ``GnSiluConv3x3Fn``'s gradients against
``jax.grad`` through ``gn_silu_conv3x3``'s ``custom_vjp``. The blocks
(``ResnetBlock2D`` with and without a time embedding,
``TemporalResnetBlock``, ``SpatioTemporalResBlock``) under each switch
against the JAX modules under the same switches, and the parameter trees:
one state dict serves every switch on both sides.

Tolerance: atol=2e-5, rtol=1e-4 for the op (as ``tests/test_resconv.py``);
rtol=1e-4, atol=3e-5 for the blocks (as ``tests/test_torch_blocks.py``'s
resnet test). fp32 on both sides, sums in different orders.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.io import weights as W
from actalker_tpu.models import common as jcommon, resnet as jres
from actalker_tpu.ops import resconv as jresconv
from actalker_tpu_torch.models import common, resnet
from actalker_tpu_torch.ops import resconv
from tests.test_torch_blocks import _export, _init, _rand

SWITCHES = [("fused", "xla"), ("xla", "pallas"), ("fused", "pallas")]


@contextlib.contextmanager
def switches(norm: str, conv: str):
    """Both packages' norm and resnet-conv switches, restored afterwards."""
    prev = (jcommon._NORM_IMPL, jres._RESCONV, common.norm_impl(),
            resnet.resconv_impl())
    for set_norm, set_conv in ((jcommon.set_norm_impl, jres.set_resconv_impl),
                               (common.set_norm_impl, resnet.set_resconv_impl)):
        set_norm(norm)
        set_conv(conv)
    try:
        yield
    finally:
        jcommon.set_norm_impl(prev[0])
        jres.set_resconv_impl(prev[1])
        common.set_norm_impl(prev[2])
        resnet.set_resconv_impl(prev[3])


def _close(port, ref, rtol=1e-4, atol=2e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _op_args(seed, n, h, w, c, co):
    rng = np.random.default_rng(seed)
    return (_rand(rng, n, h, w, c, scale=1.5), 1.0 + _rand(rng, c, scale=0.1),
            _rand(rng, c, scale=0.1), _rand(rng, 3, 3, c, co, scale=0.05),
            _rand(rng, co, scale=0.1))


def _torch_op_args(x, gamma, beta, wk, cb):
    """JAX's HWIO kernel -> torch's (Co, C, 3, 3)."""
    return (torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
            torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1))),
            torch.from_numpy(cb))


@pytest.mark.parametrize("n,h,w,c,co,groups", [
    (2, 8, 8, 32, 32, 8),       # C == Co
    (2, 8, 6, 64, 48, 32),      # C != Co, W != H
    (5, 1, 1, 32, 16, 8),       # one-pixel images: every tap but the centre is halo
])
def test_op_matches_interpret_kernel(n, h, w, c, co, groups):
    x, gamma, beta, wk, cb = _op_args(0, n, h, w, c, co)
    ja = [jnp.asarray(t) for t in (x, gamma, beta)]
    a, b = jresconv._gn_affine(*ja, groups, 1e-5)
    want = jresconv._gnconv_pallas(ja[0], a, b, jnp.asarray(wk), jnp.asarray(cb),
                                   interpret=True)
    tx, tg, tb, tw, tcb = _torch_op_args(x, gamma, beta, wk, cb)
    _close(resconv.gn_silu_conv3x3(tx, tg, tb, groups, 1e-5, tw, tcb), want)
    ta, tbb = resconv.gn_affine(tx, tg, tb, groups, 1e-5)
    _close(ta, a, atol=1e-6)
    _close(tbb, b, atol=1e-6)


def test_op_gradients_match_jax_custom_vjp():
    x, gamma, beta, wk, cb = _op_args(1, 1, 6, 6, 32, 16)
    want = jax.grad(
        lambda *a: jnp.sum(jnp.square(jresconv.gn_silu_conv3x3(
            a[0], a[1], a[2], 8, 1e-5, a[3], a[4]))),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, gamma, beta, wk, cb)))
    ins = [t.requires_grad_(True) for t in _torch_op_args(x, gamma, beta, wk, cb)]
    out = resconv.gn_silu_conv3x3(ins[0], ins[1], ins[2], 8, 1e-5, ins[3], ins[4])
    assert type(out.grad_fn).__name__.startswith("GnSiluConv3x3Fn")
    got = torch.autograd.grad(out.square().sum(), ins)
    got = list(got[:3]) + [got[3].permute(2, 3, 1, 0), got[4]]   # -> HWIO
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-4, atol=1e-5 * float(jnp.abs(b).max()))


@pytest.mark.parametrize("norm,conv", SWITCHES)
@pytest.mark.parametrize("cin,cout,temb", [(32, 32, True), (32, 64, False)])
def test_resnet_block_2d_under_switches(norm, conv, cin, cout, temb):
    rng = np.random.default_rng(2)
    x = _rand(rng, 3, 8, 8, cin)
    t = _rand(rng, 3, 24) if temb else None
    jargs = (jnp.asarray(x),) + ((jnp.asarray(t),) if temb else ())
    jm = jres.ResnetBlock2D(cout, eps=1e-6, use_temb=temb)
    p = _init(jm, *jargs)
    tm = resnet.ResnetBlock2D(cin, cout, 24 if temb else None, eps=1e-6)
    tm.load_state_dict(_export(W._resnet2d, p, temb=temb), strict=True)
    with switches(norm, conv):
        want = jm.apply(p, *jargs)
        got = tm(*(torch.from_numpy(a) for a in (x, t) if a is not None))
    _close(got, want, atol=3e-5)


@pytest.mark.parametrize("norm,conv", SWITCHES)
def test_spatio_temporal_res_block_under_switches(norm, conv):
    """The temporal block reaches K7-GN through its GroupNorm32 modules, the
    spatial block K8 through ResnetBlock2D."""
    rng = np.random.default_rng(3)
    b, f, h, cin, cout = 2, 3, 4, 32, 64
    x, temb = _rand(rng, b, f, h, h, cin), _rand(rng, b * f, 24)
    ind = np.zeros((b, f), np.float32)
    jm = jres.SpatioTemporalResBlock(cout, eps=1e-6)
    jargs = tuple(map(jnp.asarray, (x, temb, ind)))
    p = _init(jm, *jargs)
    tm = resnet.SpatioTemporalResBlock(cin, cout, 24, eps=1e-6)
    tm.load_state_dict(_export(W._st_resblock, p), strict=True)
    with switches(norm, conv):
        want = jm.apply(p, *jargs)
        got = tm(*map(torch.from_numpy, (x, temb, ind)))
    _close(got, want, atol=3e-5)


def test_param_trees_are_one_contract_under_every_switch():
    """The JAX UNet's parameter tree under each switch equals the default
    tree, and it loads with ``strict=True`` into the port's UNet, whose
    state dict is the same under every switch."""
    import dataclasses

    from actalker_tpu.models.conditioning import Conditioning as JCond
    from actalker_tpu.models.unet import (
        UNetConfig as JConfig, UNetSpatioTemporalCondition as JUNet)
    from actalker_tpu_torch.io import weights as TW
    from actalker_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporalCondition

    jcfg = dataclasses.replace(JConfig().micro(), block_out_channels=(32, 64))
    z = jnp.zeros
    jargs = (z((1, 2, 8, 8, 8)), 0.5,
             JCond(z((2, 1, 1024)), z((2, 32, 1024)), z((2, 1, 1024)),
                   jnp.ones((1, 1, 64, 64)), jnp.ones((1, 1, 64, 64))),
             z((1, 3)), z((1, 2, 8, 8, 32)))

    def tree(norm, conv):
        with switches(norm, conv):
            shapes = jax.eval_shape(lambda k: JUNet(jcfg).init(k, *jargs),
                                    jax.random.PRNGKey(0))
        return jax.tree.map(lambda s: (s.shape, str(s.dtype)), shapes)

    default = tree("xla", "xla")
    for norm, conv in SWITCHES:
        assert tree(norm, conv) == default
    tcfg = dataclasses.replace(UNetConfig().micro(), block_out_channels=(32, 64))
    shapes = jax.eval_shape(lambda k: JUNet(jcfg).init(k, *jargs),
                            jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    unet_sd, adapter_sd = TW.unet_state_dicts_from_jax(params, tcfg)
    for norm, conv in [("xla", "xla")] + SWITCHES:
        with switches(norm, conv):
            TW.load_unet(UNetSpatioTemporalCondition(tcfg), unet_sd, adapter_sd)


def test_switch_rejects_unknown_impl():
    before = resnet.resconv_impl()
    with pytest.raises(ValueError):
        resnet.set_resconv_impl("fused")
    assert resnet.resconv_impl() == before


def _jax_bisect_tool():
    """``tools/micro_resconv_bisect.py`` (the TPU tool; ``tools/`` is no
    package) as a module."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
        "micro_resconv_bisect.py"
    spec = importlib.util.spec_from_file_location("micro_resconv_bisect", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", resconv.VARIANTS)
def test_bisect_variant_plain_matches_jax_tool(variant):
    """The bisect tool's plain version of each K8 stage knock-out
    (``tools/resconv_bisect.variant_ref``) against the TPU tool's kernel of
    that variant in interpret mode, bf16 as the tool runs it (x, the weights
    and the output bf16; a, b, cb fp32). Both round the activation to bf16
    before fp32 sums in different orders, so a single rounding can flip:
    relative L2 5e-3, K8's tolerance."""
    import functools

    from jax.experimental import pallas as pl

    from actalker_tpu_torch.tools.resconv_bisect import variant_ref

    tool = _jax_bisect_tool()
    rng = np.random.default_rng(7)
    n, h, w, c, co = 2, 4, 8, 16, 24
    x = (1.5 * rng.standard_normal((n, h, w, c)) + 0.3).astype(np.float32)
    a = (1 + 0.1 * rng.standard_normal((n, c))).astype(np.float32)
    b = (0.5 * rng.standard_normal((n, c))).astype(np.float32)
    wt = ((9 * c) ** -0.5 * rng.standard_normal((co, c, 3, 3))).astype(np.float32)
    cb = (0.1 * rng.standard_normal(co)).astype(np.float32)
    xb = jnp.asarray(x.reshape(n, h * w, c), jnp.bfloat16)
    # w2[ky][kx * C + c, o] = w[o, c, ky, kx]: the tool's three row-shifted
    # products over its [dx = -1 | 0 | +1] operand columns
    w2 = jnp.asarray(wt.transpose(2, 3, 1, 0).reshape(3, 3 * c, co), jnp.bfloat16)
    want = pl.pallas_call(
        functools.partial(tool.kernel, H=h, W=w, variant=variant),
        grid=(n,), interpret=True,
        in_specs=[pl.BlockSpec((1, h * w, c), lambda i: (i, 0, 0)),
                  pl.BlockSpec((n, c), lambda i: (0, 0)),
                  pl.BlockSpec((n, c), lambda i: (0, 0)),
                  pl.BlockSpec((3, 3 * c, co), lambda i: (0, 0, 0)),
                  pl.BlockSpec((co,), lambda i: (0,))],
        out_specs=pl.BlockSpec((1, h * w, co), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, h * w, co), jnp.bfloat16),
        scratch_shapes=[tool.pltpu.VMEM(((h + 2) * w, 3 * c), jnp.bfloat16)],
    )(xb, jnp.asarray(a), jnp.asarray(b), w2, jnp.asarray(cb))
    want = np.asarray(want.astype(jnp.float32)).reshape(n, h, w, co)
    got = variant_ref(variant, torch.from_numpy(x).bfloat16(), torch.from_numpy(a),
                      torch.from_numpy(b), torch.from_numpy(wt).bfloat16(),
                      torch.from_numpy(cb))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, h, w, co)
    got = got.float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-3
