"""PyTorch port, UNet block layouts and ablations against the JAX package
(fp32, CPU), through the reference-keyed export bridge with ``strict=True``:

  * ``tiny()``: four levels, three downsamples, so the skip-state
    bookkeeping of every up block is exercised (SSM blocks ablated to their
    projections, ``"ssd"``, to keep the JAX compile short);
  * ``micro()`` with ``("vasa", "id")``: one IP adapter and scans without
    the identity token.

Tolerance: max |port - jax| <= 1e-3 * max |jax| (fp32 through the whole
UNet, sums in different orders).
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

HW = 8


@pytest.mark.parametrize("layout,ablate", [
    ("tiny", ("ssd",)),
    ("micro", ("vasa", "id")),
])
def test_unet_layouts_and_ablations_match_jax(layout, ablate):
    rng = np.random.default_rng(3)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    jcfg = dataclasses.replace(getattr(JConfig(), layout)(), ablate=ablate)
    tcfg = dataclasses.replace(getattr(UNetConfig(), layout)(), ablate=ablate)
    sample, pose = arr(1, 2, HW, HW, 8), arr(1, 2, HW, HW, jcfg.block_out_channels[0])
    tokens = (arr(2, 1, 1024), arr(2, 32, 1024), arr(2, 1, 1024))
    tids = arr(1, 3)
    mask = np.zeros((1, 1, 64, 64), np.float32)
    mask[..., 8:40, 16:56] = 1.0

    junet = JUNet(jcfg)
    jcond = JCond(*map(jnp.asarray, tokens), jnp.asarray(mask),
                  jnp.ones((1, 1, 64, 64)))
    jargs = (jnp.asarray(sample), 0.5, jcond, jnp.asarray(tids), jnp.asarray(pose))
    shapes = jax.eval_shape(lambda k: junet.init(k, *jargs),
                            jax.random.PRNGKey(0))
    params = random_like(shapes, scale=0.1, seed=2)
    ref = np.asarray(junet.apply(params, *jargs))

    unet = UNetSpatioTemporalCondition(tcfg)
    TW.load_unet(unet, *TW.unet_state_dicts_from_jax(params, tcfg))
    cond = Conditioning(*map(torch.from_numpy, tokens),
                        audio_mask=torch.from_numpy(mask),
                        exp_mask=torch.ones(1, 1, 64, 64))
    with torch.no_grad():
        out = unet(torch.from_numpy(sample), torch.tensor(0.5), cond,
                   torch.from_numpy(tids), torch.from_numpy(pose)).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()
