"""PyTorch port, gradients against ``jax.grad`` / ``jax.vjp`` of the JAX
package (fp32, CPU), on the same numpy inputs and cotangents.

On CPU tensors the port's autograd functions take the plain versions: the
grouped scan's backward runs the plain adjoint ``ssm_scan_arranged_grad_ref``
(the kernel K6's twin), the token attention's backward differentiates
``mha_tokens_ref`` (K2-bwd's twin); the JAX side runs its own CPU rules
(``jax.vjp`` through the XLA twins). JAX parameter gradients come across
through the same exporters as the parameters: the layout transposes are
linear, so they apply to gradients unchanged.

Tolerances: relative L2 per tensor. The adjoint against JAX's backward of
the arranged scan: 2e-3 (as the JAX package's own scan-gradient test).
Op and block gradients: 1e-4 (fp32, summation order only). UNet: 1e-4
for the whole flattened gradient and 1e-3 per tensor (fp32 through ~40
layers whose sums run in other orders), or an absolute error below 1e-5 of
the whole gradient's norm for tensors whose gradient is a small cancelling
sum (the scalar ``mix_factor``s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.io import weights as W
from actalker_tpu.io.init import random_like
from actalker_tpu.models import ssm as jssm
from actalker_tpu.models.conditioning import Conditioning as JCond
from actalker_tpu.models.unet import (
    UNetConfig as JConfig, UNetSpatioTemporalCondition as JUNet)
from actalker_tpu.ops import mha as jmha, mlp as jmlp
from actalker_tpu.ops import selective_scan_pallas as SP
from actalker_tpu_torch.io import weights as TW
from actalker_tpu_torch.io.weights import to_torch
from actalker_tpu_torch.models import ssm
from actalker_tpu_torch.models.conditioning import Conditioning
from actalker_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporalCondition
from actalker_tpu_torch.ops import mha, mlp, selective_scan as ss


def _rel(port, ref):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(port - ref) / max(np.linalg.norm(ref), 1e-30))


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(*arrays, grad=True):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


# ------------------------------------------------------ K6 plain adjoint

def _arranged(rng, lp, bp, dp, n, masked=0.3):
    dt = _rand(rng, lp, bp, dp, scale=0.5)
    dt[rng.random((lp, bp)) < masked] = -1e9        # inactive tokens
    bc = np.zeros((lp, bp, 128), np.float32)
    bc[:, :, :2 * n] = _rand(rng, lp, bp, 2 * n, scale=0.5)
    return (_rand(rng, lp, bp, dp), dt, bc,
            -np.exp(_rand(rng, dp, n, scale=0.5)), _rand(rng, dp),
            _rand(rng, dp, scale=0.5), _rand(rng, lp, bp, dp))


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_adjoint_matches_jax_backward(reverse):
    """du, ddt, dbc, dA, dD, dbias against jax.vjp of ``_arranged_xla``; the
    JAX buffers carry 40 of Dp = 48 channels (pad channels with zero
    cotangent), the port gets the 40 real ones."""
    rng = np.random.default_rng(0)
    lp, bp, dp, d, n = 75, 3, 48, 40, 16
    u, dt, bc, a, dsk, bias, dy = _arranged(rng, lp, bp, dp, n)
    dy[:, :, d:] = 0.0
    _, vjp = jax.vjp(lambda *p: SP._arranged_xla(*p, reverse=reverse),
                     *map(jnp.asarray, (u, dt, bc, a[:d], dsk[:d], bias[:d])))
    ref = vjp(jnp.asarray(dy))
    crop = lambda x: np.ascontiguousarray(x[..., :d])  # noqa: E731
    port = ss.ssm_scan_arranged_grad_ref(
        *_t(crop(u), crop(dt), bc, a[:d], dsk[:d], bias[:d], crop(dy),
            grad=False), reverse=reverse)
    assert ss.BWD_KERNEL.launches == 0
    for name, p, r in zip(("du", "ddt"), port[:2], ref[:2]):
        assert _rel(p, np.asarray(r)[..., :d]) < 2e-3, name
    for name, p, r in zip(("dbc", "dA", "dD", "dbias"), port[2:], ref[2:]):
        assert _rel(p, r) < 2e-3, name
        assert np.isfinite(p.numpy()).all()


def test_scan_adjoint_matches_pallas_adjoint_interpret():
    """One tiny case against ``_arranged_grad_tpu`` itself (the boundary
    and adjoint Pallas kernels K6 ports, in interpret mode)."""
    rng = np.random.default_rng(1)
    lp, bp, dp, n = 24, 8, 128, 4
    args = _arranged(rng, lp, bp, dp, n)
    for reverse in (False, True):
        ref = SP._arranged_grad_tpu(*map(jnp.asarray, args[:6]),
                                    jnp.asarray(args[6]), reverse)
        port = ss.ssm_scan_arranged_grad_ref(*_t(*args, grad=False), reverse)
        for name, p, r in zip("du ddt dbc dA dD dbias".split(), port, ref):
            assert _rel(p, r) < 2e-3, (reverse, name)


# ----------------------------------------------------------- op gradients

def _grouped_inputs(rng, lp=64, bp=8, dp=128, rank=6, n=16, groups=4):
    u = _rand(rng, lp, bp, groups // 2 * dp)
    slab = np.zeros((lp, bp, groups * 128), np.float32)
    dtw = np.zeros((groups, 128, dp), np.float32)
    for g in range(groups):
        slab[:, :, g * 128:g * 128 + rank + 2 * n] = _rand(
            rng, lp, bp, rank + 2 * n, scale=0.5)
        slab[:, :, g * 128 + ss.MASK_LANE] = rng.random((lp, bp)) < 0.3
        dtw[g, :rank] = _rand(rng, rank, dp, scale=0.3)
        dtw[g, ss.MASK_LANE] = -1e9
    return (u, slab, dtw, -np.exp(_rand(rng, groups, dp, n, scale=0.5)),
            _rand(rng, groups, dp), _rand(rng, groups, dp, scale=0.5)), rank


def _check_grads(port_fn, jax_fn, arrays, cot, tol=1e-4):
    ins = _t(*arrays)
    out = port_fn(*ins)
    got = torch.autograd.grad(out, ins, torch.from_numpy(cot))
    _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, arrays))
    for i, (g, r) in enumerate(zip(got, vjp(jnp.asarray(cot)))):
        assert _rel(g, r) < tol, (i, _rel(g, r))


def test_grouped_scan_gradients_match_jax():
    """SsmScanGroupedFn (K1 forward, plain K6 backward on CPU) against
    jax.vjp of ``ssm_scan_grouped``: both directions, rank lanes, mask lane."""
    rng = np.random.default_rng(2)
    arrays, rank = _grouped_inputs(rng)
    cot = _rand(rng, 64, 8, 4 * 128)
    _check_grads(lambda *a: ss.ssm_scan_grouped(*a, rank),
                 lambda *a: SP.ssm_scan_grouped(*a, rank=rank), arrays, cot)
    assert ss.KERNEL.launches == 0 and ss.BWD_KERNEL.launches == 0


@pytest.mark.parametrize("s", [64, 90])
def test_mha_tokens_gradients_match_jax(s):
    rng = np.random.default_rng(3)
    arrays = [_rand(rng, 2, s, 128) for _ in range(3)]
    _check_grads(lambda q, k, v: mha.mha_tokens(q, k, v, 2),
                 lambda q, k, v: jmha.mha_tokens(q, k, v, 2), arrays,
                 _rand(rng, 2, s, 128))
    assert mha.MHA_KERNEL.launches == 0 and mha.MHA_BWD_KERNEL.launches == 0


def test_frame_attention_gradients_match_jax():
    rng = np.random.default_rng(4)
    arrays = [_rand(rng, 2 * 5, 24, 128) for _ in range(3)]
    _check_grads(lambda q, k, v: mha.frame_attention_tokens(q, k, v, 5, 2),
                 lambda q, k, v: jmha.frame_attention_tokens(q, k, v, 5, 2),
                 arrays, _rand(rng, 10, 24, 128))


def test_geglu_mlp_gradients_match_jax():
    """Weights cross in torch Linear layout; their gradients come back
    transposed."""
    rng = np.random.default_rng(5)
    m, c = 48, 32
    x = _rand(rng, m, c)
    w1, b1 = _rand(rng, c, 8 * c, scale=c ** -0.5), _rand(rng, 8 * c, scale=0.1)
    w2, b2 = _rand(rng, 4 * c, c, scale=(4 * c) ** -0.5), _rand(rng, c, scale=0.1)
    cot = _rand(rng, m, c)
    ins = _t(x, w1.T, b1, w2.T, b2)
    got = torch.autograd.grad(mlp.geglu_mlp(*ins), ins, torch.from_numpy(cot))
    _, vjp = jax.vjp(jmlp.geglu_mlp, *map(jnp.asarray, (x, w1, b1, w2, b2)))
    ref = vjp(jnp.asarray(cot))
    for g, r, tr in zip(got, ref, (False, True, False, True, False)):
        assert _rel(g, np.asarray(r).T if tr else r) < 1e-4


# -------------------------------------------------------- SS2D block

def _box_mask(h=64, w=64):
    m = np.zeros((1, 1, h, w), np.float32)
    m[..., 10:42, 12:52] = 1.0          # 31% of the image
    return m


def _export(spec_fn, tree, **kw):
    def convert(sd):
        spec_fn({}, "m", sd, "m", **kw)

    sd = W.export_state_dict(convert, {"m": tree["params"]})
    return to_torch({k[len("m."):]: v for k, v in sd.items()})


@pytest.mark.parametrize("d_model", [64, 32])
def test_ss2d_block_gradients_match_jax(d_model):
    """SS2DCondV10 with a face-box audio mask: gradients of the input and of
    every parameter against jax.grad of the JAX block."""
    rng = np.random.default_rng(6)
    b, l = 2, 64
    x = _rand(rng, b, l, d_model)
    conds = (_rand(rng, b, 1, 48), _rand(rng, b, 32, 48), _rand(rng, b, 1, 48))
    masks = (_box_mask(), np.ones((1, 1, 64, 64), np.float32))
    cot = _rand(rng, b, l, d_model)
    jm = jssm.SS2DCondV10(d_model=d_model, d_cond=48)
    jargs = tuple(map(jnp.asarray, (x,) + conds + masks))
    shapes = jax.eval_shape(lambda k: jm.init(k, *jargs), jax.random.PRNGKey(0))
    p = random_like(shapes, scale=0.3, seed=0)

    def jloss(params, x):
        return jnp.sum(jm.apply(params, x, *jargs[1:]) * cot)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(p, jargs[0])
    tm = ssm.SS2DCondV10(d_model, d_cond=48)
    tm.load_state_dict(_export(W._mamba_v10, p), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tm(xt, *map(torch.from_numpy, conds + masks))
     * torch.from_numpy(cot)).sum().backward()
    assert _rel(xt.grad, gx) < 1e-4
    want = _export(W._mamba_v10, gp)
    for name, prm in tm.named_parameters():
        assert _rel(prm.grad, want[name]) < 1e-4, name


# -------------------------------------------------------------- UNet

B, F, HW = 2, 2, 8


@pytest.fixture(scope="module")
def unet_grads():
    """JAX micro UNet (64 wide: the SSM blocks take the grouped scan) loss
    sum(out * cot) and its parameter gradients, exported."""
    rng = np.random.default_rng(7)
    mask = np.zeros((1, 1, 64, 64), np.float32)
    mask[..., 8:40, 16:56] = 1.0
    ins = dict(sample=_rand(rng, B, F, HW, HW, 8), id=_rand(rng, B * F, 1, 1024),
               audio=_rand(rng, B * F, 32, 1024), vasa=_rand(rng, B * F, 1, 1024),
               mask=mask, tids=_rand(rng, B, 3), pose=_rand(rng, B, F, HW, HW, 64),
               cot=_rand(rng, B, F, HW, HW, 4))
    jcfg = dataclasses.replace(JConfig().micro(), block_out_channels=(64, 64))
    junet = JUNet(jcfg)
    jcond = JCond(jnp.asarray(ins["id"]), jnp.asarray(ins["audio"]),
                  jnp.asarray(ins["vasa"]), jnp.asarray(mask),
                  jnp.ones((1, 1, 64, 64)))
    jargs = (jnp.asarray(ins["sample"]), 0.5, jcond, jnp.asarray(ins["tids"]),
             jnp.asarray(ins["pose"]))
    shapes = jax.eval_shape(lambda k: junet.init(k, *jargs), jax.random.PRNGKey(0))
    params = random_like(shapes, scale=0.1, seed=1)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(junet.apply(p, *jargs) * ins["cot"])))(params)
    tcfg = dataclasses.replace(UNetConfig().micro(), block_out_channels=(64, 64))
    kw = W.unet_block_kwargs(tcfg)
    want = {**W.export_unet(grads, **kw)}
    return ins, params, float(loss), want, tcfg


def _port_unet_grads(ins, params, cfg):
    unet = UNetSpatioTemporalCondition(cfg)
    TW.load_unet(unet, *TW.unet_state_dicts_from_jax(params, cfg))
    cond = Conditioning(*(torch.from_numpy(ins[k]) for k in ("id", "audio", "vasa")),
                        audio_mask=torch.from_numpy(ins["mask"]),
                        exp_mask=torch.ones(1, 1, 64, 64))
    out = unet(torch.from_numpy(ins["sample"]), torch.tensor(0.5), cond,
               torch.from_numpy(ins["tids"]), torch.from_numpy(ins["pose"]))
    loss = (out * torch.from_numpy(ins["cot"])).sum()
    loss.backward()
    return loss.item(), {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                         for n, p in unet.named_parameters()}


def test_unet_loss_and_parameter_gradients_match_jax(unet_grads):
    ins, params, jloss, want, tcfg = unet_grads
    loss, got = _port_unet_grads(ins, params, tcfg)
    assert abs(loss - jloss) <= 1e-4 * abs(jloss)
    assert set(got) == set(want)
    flat = lambda d: np.concatenate([np.ravel(np.asarray(  # noqa: E731
        d[k].detach() if torch.is_tensor(d[k]) else d[k])) for k in want])
    assert _rel(flat(got), flat(want)) < 1e-4
    scale = np.linalg.norm(flat(want))
    for k in want:
        err = np.linalg.norm(got[k].detach().numpy() - want[k])
        assert err < max(1e-3 * np.linalg.norm(want[k]), 1e-5 * scale), k
    for k in want:              # exporter-filled q / k rows: never read
        if not np.any(want[k]):
            assert not got[k].any(), k


def test_unet_gradient_checkpointing_changes_nothing(unet_grads):
    ins, params, _, _, tcfg = unet_grads
    loss0, plain = _port_unet_grads(ins, params, tcfg)
    loss1, remat = _port_unet_grads(
        ins, params, dataclasses.replace(tcfg, gradient_checkpointing=True))
    assert loss0 == loss1
    for k in plain:
        torch.testing.assert_close(remat[k], plain[k], rtol=1e-6, atol=1e-9)
