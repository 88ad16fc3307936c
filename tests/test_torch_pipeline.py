"""PyTorch port, the clip slice against the JAX package (fp32, CPU):
``generate_latents`` (2 denoise steps, 3 frames in windows of 2, so 3
windows per step over a 5-frame ring buffer) and ``decode_latents``, plus
the weight bridge's round trip.

Both pipelines get the same parameters (JAX init, exported through the
reference-keyed state dicts and loaded with ``strict=True``), the same
numpy inputs, the same initial noise (``init_noise``) and the same
reference-image noise augmentation: the JAX pipeline draws it from its
seed, the test reproduces that draw and hands it to the port's
``noise_aug`` hook.

Mode 2 runs with all-on masks. Mode 0 gates the expression branch off and
gives the audio branch a face-box mask: the JAX side then takes its
static-capacity gather path in the SSM blocks, the port its masked-dense
scan, which must give the same latents.

Tolerance: max |port - jax| <= 1e-3 * max |jax| for latents and frames
(fp32; guidance 7.5 amplifies differences in the UNet outputs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.io import weights as W
from actalker_tpu.io.init import init_pipeline_params
from actalker_tpu.models.unet import UNetConfig as JUNetConfig
from actalker_tpu.models.vae import VAEConfig as JVAEConfig
from actalker_tpu.pipeline.pipeline import (
    ACTalkerPipeline as JPipeline, PipelineModules as JModules)
from actalker_tpu.pipeline.sampler import SamplerConfig as JSamplerConfig
from actalker_tpu_torch.io import weights as TW
from actalker_tpu_torch.models.unet import UNetConfig
from actalker_tpu_torch.models.vae import VAEConfig
from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline, PipelineModules
from actalker_tpu_torch.pipeline.sampler import SamplerConfig

PX, NF, SEED = 64, 3, 1
SAMPLER = dict(num_inference_steps=2, frames_per_batch=2, overlap=0,
               shift_offset=1, noise_aug_strength=0.02)


def _rel_close(port, ref, rel=1e-3):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    assert np.abs(port - ref).max() <= rel * np.abs(ref).max()


@pytest.fixture(scope="module")
def pipes():
    jmods = JModules.create(
        unet_config=dataclasses.replace(JUNetConfig().micro(),
                                        block_out_channels=(64, 64)),
        vae_config=JVAEConfig().tiny(), dtype=jnp.float32)
    params = init_pipeline_params(jmods, jax.random.PRNGKey(0),
                                  image_size=(PX, PX), latent_size=(8, 8),
                                  use_eval_shape=True)
    # 0.1-scale UNet weights so its output moves the latents visibly
    params["unet"] = jax.tree.map(lambda x: x * 5.0, params["unet"])
    jpipe = JPipeline(jmods, params, dtype=jnp.float32)

    tmods = PipelineModules.create(
        unet_config=dataclasses.replace(UNetConfig().micro(),
                                        block_out_channels=(64, 64)),
        vae_config=VAEConfig().tiny(), dtype=torch.float32)
    TW.load_pipeline_from_jax(tmods, params)
    for m in tmods.named().values():
        m.eval()
    return jpipe, ACTalkerPipeline(tmods, dtype=torch.float32), params


def _inputs():
    rng = np.random.default_rng(0)
    return dict(
        ref=rng.uniform(-1, 1, (PX, PX, 3)).astype(np.float32),
        id=rng.standard_normal(512).astype(np.float32),
        audio=rng.standard_normal((NF, 32, 1024)).astype(np.float32),
        vasa=rng.standard_normal((NF, 1, 1024)).astype(np.float32),
        pose=rng.uniform(0, 1, (NF, PX, PX, 3)).astype(np.float32),
        noise=rng.standard_normal((NF + 2, 8, 8, 4)).astype(np.float32))


def _jax_noise_aug(seed):
    """The reference-image noise the JAX pipeline draws (pipeline.py:266-278)."""
    _, k_aug = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(jax.random.normal(k_aug, (1, PX, PX, 3)))[0]


def _run_both(jpipe, tpipe, gate, audio_mask=None, windows_per_call=0):
    x = _inputs()
    jcfg = JSamplerConfig(gate=gate, **SAMPLER)
    lat_j = jpipe.generate_latents(
        x["ref"], x["id"], jnp.asarray(x["audio"]),
        jnp.zeros_like(jnp.asarray(x["audio"])), jnp.asarray(x["vasa"]),
        jnp.zeros_like(jnp.asarray(x["vasa"])), x["pose"], jcfg, seed=SEED,
        audio_mask=audio_mask, init_noise=x["noise"])
    tcfg = SamplerConfig(gate=gate, windows_per_call=windows_per_call, **SAMPLER)
    lat_t = tpipe.generate_latents(
        x["ref"], x["id"], x["audio"], np.zeros_like(x["audio"]), x["vasa"],
        np.zeros_like(x["vasa"]), x["pose"], tcfg, seed=SEED,
        audio_mask=audio_mask, init_noise=x["noise"],
        noise_aug=_jax_noise_aug(SEED))
    return lat_j, lat_t


def test_generate_and_decode_mode2(pipes):
    jpipe, tpipe, _ = pipes
    lat_j, lat_t = _run_both(jpipe, tpipe, gate=(1, 1))
    assert lat_t.shape == (NF, 8, 8, 4) and torch.isfinite(lat_t).all()
    _rel_close(lat_t, lat_j)
    frames_j = jpipe.decode_latents(lat_j, decode_chunk_size=2)
    frames_t = tpipe.decode_latents(torch.tensor(np.asarray(lat_j)),
                                    decode_chunk_size=2)
    assert frames_t.shape == (NF, PX, PX, 3)
    _rel_close(frames_t, frames_j)


def test_generate_mode0_face_box_masked_dense_matches_gather(pipes):
    """Mode 0 with a face-box audio mask: the JAX side takes the SSM
    static-capacity gather; the port's masked-dense scan must agree. One
    window per UNet call on the port side (the output does not depend on
    how windows are batched)."""
    jpipe, tpipe, _ = pipes
    box = np.zeros((1, 1, PX, PX), np.float32)
    box[..., 8:40, 8:56] = 1.0
    assert jpipe._capacity_fracs(JSamplerConfig(gate=(1, 0)), box, None,
                                 (8, 8)) is not None
    lat_j, lat_t = _run_both(jpipe, tpipe, gate=(1, 0), audio_mask=box,
                             windows_per_call=1)
    _rel_close(lat_t, lat_j)


def test_audio_and_vasa_token_heads(pipes):
    """``audio_tokens_per_frame`` (AudioProjModel over 10-step windows) and
    ``vasa_tokens`` (VasaProjModel + rotation, and mode 0's zero tokens)."""
    jpipe, tpipe, _ = pipes
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((30, 5, 384)).astype(np.float32)
    for port, ref in zip(tpipe.audio_tokens_per_frame(feats, 5),
                         jpipe.audio_tokens_per_frame(feats, 5)):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
    expr = rng.standard_normal((4, 512)).astype(np.float32)
    rot = rng.standard_normal((4, 3)).astype(np.float32)
    for e, r in ((expr, rot), (None, None)):
        for port, ref in zip(tpipe.vasa_tokens(e, r, 4),
                             jpipe.vasa_tokens(e, r, 4)):
            np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-5)


def test_weight_bridge_round_trip(pipes):
    """JAX params -> reference-keyed dicts -> port modules (strict) -> the
    port's state dicts -> the JAX package's converters: every JAX leaf comes
    back unchanged."""
    _, tpipe, params = pipes
    m = tpipe.m

    def np_sd(module):
        return {k: v.numpy() for k, v in module.state_dict().items()}

    cfg = m.unet.config
    back = {
        "unet": W.convert_unet(np_sd(m.unet), **W.unet_block_kwargs(cfg)),
        "vae": W.convert_vae(np_sd(m.vae),
                             block_out_channels=m.vae.config.block_out_channels,
                             layers_per_block=m.vae.config.layers_per_block),
        "audio_proj": W.convert_audio_proj(np_sd(m.audio_proj)),
        "id_proj": W.convert_id_proj(np_sd(m.id_proj)),
        "vasa_proj": W.convert_vasa_proj(np_sd(m.vasa_proj)),
        "pose_guider": W.convert_pose_guider(np_sd(m.pose_guider)),
    }
    for name, tree in back.items():
        got = W._flatten_params(tree["params"])
        want = W._flatten_params(params[name]["params"])
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], np.asarray(leaf),
                                          err_msg=f"{name}/{path}")
