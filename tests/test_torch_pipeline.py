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
from actalker_tpu.models.vae import (
    AutoencoderKLTemporalDecoder, VAEConfig as JVAEConfig)
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


def _jax_decode(jpipe, latents):
    """The JAX VAE's ``decode`` of one chunk of latents at its own length."""
    z = latents[None] / jpipe.m.vae.config.scaling_factor
    out = jpipe.m.vae.apply(jpipe.params["vae"], z,
                            method=AutoencoderKLTemporalDecoder.decode)[0]
    return np.asarray(out, np.float32)


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
    # NF = 3 in chunks of 2 leaves a 1-frame remainder: the port decodes it
    # at its own length, the JAX pipeline pads it with copies of its last
    # frame, so the JAX pipeline is the reference for the full chunk and the
    # JAX VAE's decode of the unpadded remainder for the last frame
    frames_j = jpipe.decode_latents(lat_j, decode_chunk_size=2)
    frames_t = tpipe.decode_latents(torch.tensor(np.asarray(lat_j)),
                                    decode_chunk_size=2)
    assert frames_t.shape == (NF, PX, PX, 3)
    _rel_close(frames_t[:2], frames_j[:2])
    _rel_close(frames_t[2:], _jax_decode(jpipe, lat_j[2:]))


def test_decode_last_chunk_at_its_own_length(pipes):
    """``decode_latents`` decodes the remainder chunk unpadded: its frames
    are the VAE's decode of that chunk alone, bit for bit, and differ from
    those of the chunk padded with copies of its last frame, which the
    temporal decoder mixes in."""
    _, tpipe, _ = pipes
    lat = torch.from_numpy(_inputs()["noise"][:NF])
    frames = tpipe.decode_latents(lat, decode_chunk_size=2)
    z = lat[2:] * (1.0 / tpipe.m.vae.config.scaling_factor)
    with torch.no_grad():
        alone = tpipe.m.vae.decode(z[None])[0].numpy()
        padded = tpipe.m.vae.decode(torch.cat([z, z])[None])[0][:1].numpy()
    np.testing.assert_array_equal(frames[2:], alone)
    assert np.abs(alone - padded).max() > 1e-3 * np.abs(alone).max()


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


def test_generate_and_decode_mode2_fused_configuration(pipes, monkeypatch):
    """ACTALKER_NORM=fused and ACTALKER_RESCONV=pallas on both sides: the
    UNet, the VAE's encode and decode and the id head take K7 / K8's plain
    versions here, the JAX package its XLA twins, traced afresh (a new JAX
    pipeline, so no trace made under the default switches is reused).

    The port's K7 / K8 call sites are counted over the clip: the count must
    be what ``chip_smoke.py`` phase 5b derives from the model (per UNet
    call, two VAE encodes, per decode chunk, the heads run once).

    Latents at the file's tolerance (guidance 7.5 over two steps: the
    default configuration reads 2.0e-4 of a 1.27 maximum here, this one
    1.2e-4); the decoded frames at rtol=1e-4 / atol=1e-5, the last
    (a 1-frame remainder chunk) against the JAX VAE's decode of it."""
    import chip_smoke
    from actalker_tpu_torch.models import common, resnet
    from tests.test_torch_resconv import switches

    jpipe, tpipe, params = pipes
    calls = dict.fromkeys(chip_smoke.FUSED_KERNELS, 0)
    for mod, name, kinds in ((common, "layer_norm", ("layer_norm",)),
                             (common, "group_norm", ("group_norm",)),
                             (resnet, "gn_silu_conv3x3",
                              ("gn_silu_conv3x3", "group_norm"))):
        def counted(*a, _fn=getattr(mod, name), _kinds=kinds, **kw):
            for k in _kinds:
                calls[k] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    unet_calls = []
    hook = tpipe.m.unet.register_forward_pre_hook(lambda *_: unet_calls.append(1))
    try:
        with switches("fused", "pallas"):
            fresh = JPipeline(jpipe.m, params, dtype=jnp.float32)
            lat_j, lat_t = _run_both(fresh, tpipe, gate=(1, 1))
            _rel_close(lat_t, lat_j)
            frames_j = fresh.decode_latents(lat_j, decode_chunk_size=2)
            frames_t = tpipe.decode_latents(torch.tensor(np.asarray(lat_j)),
                                            decode_chunk_size=2)
            last_j = _jax_decode(fresh, lat_j[2:])
    finally:
        hook.remove()
    m, fl = tpipe.m, chip_smoke.fused_launches
    parts = ((len(unet_calls), fl(m.unet)), (2, fl(m.vae.encoder)),
             (-(-NF // 2), fl(m.vae.decoder)), (1, fl(m.id_proj, m.pose_guider)))
    assert calls == {k: sum(n * per[k] for n, per in parts) for k in calls}
    # the full chunk against the JAX pipeline, the unpadded remainder
    # against the JAX VAE's decode of it (as in the default configuration)
    np.testing.assert_allclose(frames_t[:2], np.asarray(frames_j)[:2],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(frames_t[2:], last_j, rtol=1e-4, atol=1e-5)
