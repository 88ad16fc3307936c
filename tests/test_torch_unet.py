"""PyTorch port, the full UNet against the JAX package (fp32, CPU), through
the reference-keyed export bridge (``export_unet`` + ``export_adapter_modules``)
loaded with ``strict=True``.

Config: ``UNetConfig().micro()`` with both levels 64 wide, so every SS2D
block has d_inner = 128 and the JAX side runs its grouped Pallas scan K1
(interpret mode) there; K2-K4 run through its XLA twins. Conditioning has a
face-box audio mask, so the masked IP branches and the SSM token selection
are both exercised.

Tolerance: max |port - jax| <= 1e-3 * max |jax| (fp32 through ~40 layers
whose sums run in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.io.init import random_like
from actalker_tpu.models.conditioning import Conditioning as JCond
from actalker_tpu.models.unet import (
    UNetConfig as JConfig, UNetSpatioTemporalCondition as JUNet)
from actalker_tpu_torch.io import weights as TW
from actalker_tpu_torch.models.conditioning import Conditioning
from actalker_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporalCondition

B, F, HW = 2, 2, 8


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    mask = np.zeros((1, 1, 64, 64), np.float32)
    mask[..., 8:40, 16:56] = 1.0
    inputs = dict(sample=arr(B, F, HW, HW, 8), id=arr(B * F, 1, 1024),
                  audio=arr(B * F, 32, 1024), vasa=arr(B * F, 1, 1024),
                  mask=mask, tids=arr(B, 3), pose=arr(B, F, HW, HW, 64))
    jcfg = dataclasses.replace(JConfig().micro(), block_out_channels=(64, 64))
    junet = JUNet(jcfg)
    jcond = JCond(jnp.asarray(inputs["id"]), jnp.asarray(inputs["audio"]),
                  jnp.asarray(inputs["vasa"]), jnp.asarray(mask),
                  jnp.ones((1, 1, 64, 64)))
    jargs = (jnp.asarray(inputs["sample"]), 0.5, jcond,
             jnp.asarray(inputs["tids"]), jnp.asarray(inputs["pose"]))
    shapes = jax.eval_shape(lambda k: junet.init(k, *jargs),
                            jax.random.PRNGKey(0))
    params = random_like(shapes, scale=0.1, seed=1)
    ref = np.asarray(junet.apply(params, *jargs))
    tcfg = dataclasses.replace(UNetConfig().micro(), block_out_channels=(64, 64))
    return inputs, params, ref, tcfg


def _port_forward(unet, inputs):
    cond = Conditioning(*(torch.from_numpy(inputs[k]) for k in ("id", "audio", "vasa")),
                        audio_mask=torch.from_numpy(inputs["mask"]),
                        exp_mask=torch.ones(1, 1, 64, 64))
    with torch.no_grad():
        return unet(torch.from_numpy(inputs["sample"]), torch.tensor(0.5), cond,
                    torch.from_numpy(inputs["tids"]),
                    torch.from_numpy(inputs["pose"])).numpy()


def test_unet_forward_matches_jax(setup):
    inputs, params, ref, tcfg = setup
    unet = UNetSpatioTemporalCondition(tcfg)
    unet_sd, adapter_sd = TW.unet_state_dicts_from_jax(params, tcfg)
    TW.load_unet(unet, unet_sd, adapter_sd)            # strict=True inside
    out = _port_forward(unet, inputs)
    assert out.shape == ref.shape == (B, F, HW, HW, 4)
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()


def test_adapter_modules_load_in_attn_processor_order(setup):
    """The ``adapter_module-*.pth`` door alone restores every IP row: zero
    them, apply the adapter dict, and the forward matches again."""
    inputs, params, ref, tcfg = setup
    unet = UNetSpatioTemporalCondition(tcfg)
    unet_sd, adapter_sd = TW.unet_state_dicts_from_jax(params, tcfg)
    TW.load_unet(unet, unet_sd)
    attn2 = list(unet.attn2_modules())
    assert len(attn2) == len(adapter_sd) // 4 == 8   # 4 transformers x 2 blocks
    with torch.no_grad():
        for a in attn2:
            for p in a.processor.parameters():
                p.zero_()
    TW.load_adapter_modules(unet, adapter_sd)
    out = _port_forward(unet, inputs)
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()



# ------------------------------------ the fused-norm configuration (K7, K8)

def _jax_forward(inputs, params):
    """The JAX UNet applied afresh (traced under the switches as they are
    now, never through an earlier trace)."""
    jcfg = dataclasses.replace(JConfig().micro(), block_out_channels=(64, 64))
    jcond = JCond(jnp.asarray(inputs["id"]), jnp.asarray(inputs["audio"]),
                  jnp.asarray(inputs["vasa"]), jnp.asarray(inputs["mask"]),
                  jnp.ones((1, 1, 64, 64)))
    return np.asarray(JUNet(jcfg).apply(
        params, jnp.asarray(inputs["sample"]), 0.5, jcond,
        jnp.asarray(inputs["tids"]), jnp.asarray(inputs["pose"])))


def test_unet_forward_matches_jax_fused_configuration(setup, monkeypatch):
    """ACTALKER_NORM=fused and ACTALKER_RESCONV=pallas on both sides, at
    rtol=1e-4 / atol=1e-5 (this micro UNet reads 5e-7 in either
    configuration, a twentieth of that). Counting the port's K7 / K8 call sites in the
    same forward checks ``chip_smoke.fused_launches``, which derives the
    card's launch counts from the model: one K7-LN per LayerNormF32, one
    K7-GN per GroupNorm32 (the resnet pairs' statistics included), one K8
    per GroupNorm / SiLU / conv pair of a ResnetBlock2D."""
    import chip_smoke
    from actalker_tpu_torch.models import common, resnet
    from tests.test_torch_resconv import switches

    inputs, params, _, tcfg = setup
    unet = UNetSpatioTemporalCondition(tcfg)
    unet_sd, adapter_sd = TW.unet_state_dicts_from_jax(params, tcfg)
    TW.load_unet(unet, unet_sd, adapter_sd)
    calls = {"layer_norm": 0, "group_norm": 0, "gn_silu_conv3x3": 0}

    def counting(name, fn, also=None):
        def wrapped(*a, **kw):
            calls[name] += 1
            if also:
                calls[also] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(common, "layer_norm", counting("layer_norm", common.layer_norm))
    monkeypatch.setattr(common, "group_norm", counting("group_norm", common.group_norm))
    monkeypatch.setattr(resnet, "gn_silu_conv3x3", counting(
        "gn_silu_conv3x3", resnet.gn_silu_conv3x3, also="group_norm"))
    with switches("fused", "pallas"):
        ref = _jax_forward(inputs, params)
        out = _port_forward(unet, inputs)
    assert out.shape == ref.shape == (B, F, HW, HW, 4)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    assert calls == chip_smoke.fused_launches(unet)
    assert all(calls.values())
