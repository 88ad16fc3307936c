"""PyTorch port, the conditioning encoders against the JAX package (fp32,
CPU): Whisper-tiny at full width on a (1, 80, 3000) mel, the VASA towers
(HeadExpression, HeadPose) on (2, 256, 256, 3), ArcFace's iresnet50 on (1,
112, 112, 3), and the pipeline's ``encode_audio_windows`` and
``encode_vasa_video`` (its last chunk padded).

JAX parameters (seeded: kernels N(0, 1 / fan-in), norm scales near 1,
biases and ArcFace's BatchNorm statistics perturbed) go through the port's exporters (``io/jax_export.py``) into
reference-keyed state dicts, which the port's modules load with
``strict=True``. Tolerance: rtol=1e-4 with atol 1e-5 of the output's
largest magnitude (fp32 both sides, differing in summation order; the
ResNets' GroupNorm statistics are two-pass in torch and E[x^2] - E[x]^2 in
flax).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.models.arcface import iresnet50 as jiresnet50
from actalker_tpu.models.unet import UNetConfig as JUNetConfig
from actalker_tpu.models.vasa import HeadExpression as JHeadExpression
from actalker_tpu.models.vasa import HeadPose as JHeadPose
from actalker_tpu.models.whisper import WhisperEncoder as JWhisperEncoder
from actalker_tpu.pipeline.pipeline import (
    ACTalkerPipeline as JPipeline, PipelineModules as JModules)
from actalker_tpu_torch.io import jax_export as X
from actalker_tpu_torch.io.init import vasa_state_dicts, whisper_state_dict
from actalker_tpu_torch.io.weights import to_torch
from actalker_tpu_torch.models.arcface import iresnet50
from actalker_tpu_torch.models.unet import UNetConfig
from actalker_tpu_torch.models.vae import VAEConfig
from actalker_tpu_torch.models.vasa import HeadExpression, HeadPose
from actalker_tpu_torch.models.whisper import WhisperEncoder
from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline, PipelineModules
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)


def _close(port, ref, rtol=1e-4, atol=1e-5):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=atol * max(np.abs(ref).max(), 1.0))


def _seeded(module, *args, seed=0):
    """Parameters of ``module`` for ``args``, drawn in numpy without running
    flax's initializers: kernels N(0, 1 / fan-in), scales 1 + N(0, 0.1^2),
    variances in [0.5, 1.5], every other leaf N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def make(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


@pytest.fixture(scope="module")
def params():
    """JAX parameters of the four encoders and the port's modules loaded
    from their reference-keyed exports."""
    img = jnp.zeros((1, 64, 64, 3))
    p = {"whisper": _seeded(JWhisperEncoder(), jnp.zeros((1, 80, 100))),
         "vasa_expression": _seeded(JHeadExpression(), img, seed=1),
         "vasa_pose": _seeded(JHeadPose(), img, seed=2),
         "arcface": _seeded(jiresnet50(), jnp.zeros((1, 112, 112, 3)), seed=3)}

    # the files' own layouts: whisper's encoder.* entries with a decoder
    # entry beside them, the MX31c generator dict with other entries
    mx = {"generator": {**to_torch(X.export_vasa_expression(p["vasa_expression"])),
                        "other_model.weight": torch.zeros(3)},
          "pose_model": to_torch(X.export_vasa_pose(p["vasa_pose"]))}
    whisper_file = {**to_torch(X.export_whisper(p["whisper"])),
                    "decoder.embed_tokens.weight": torch.zeros(2, 2)}
    mods = {"whisper": WhisperEncoder(), "vasa_expression": HeadExpression(),
            "vasa_pose": HeadPose(), "arcface": iresnet50()}
    mods["whisper"].load_state_dict(whisper_state_dict(whisper_file), strict=True)
    for name, sd in vasa_state_dicts(mx).items():
        mods[name].load_state_dict(sd, strict=True)
    mods["arcface"].load_state_dict(to_torch(X.export_arcface(p["arcface"])),
                                    strict=True)
    for m in mods.values():
        m.eval()
    return p, mods


def test_whisper_full_width(params):
    p, mods = params
    mel = np.random.default_rng(0).standard_normal((1, 80, 3000)).astype(np.float32)
    ref = JWhisperEncoder().apply(p["whisper"], jnp.asarray(mel))
    with torch.no_grad():
        port = mods["whisper"](torch.from_numpy(mel))
    assert port.shape == (1, 1500, 5, 384)
    _close(port.numpy(), ref)


@pytest.mark.parametrize("tower", ["vasa_expression", "vasa_pose"])
def test_vasa_towers(params, tower):
    p, mods = params
    x = np.random.default_rng(1).random((2, 256, 256, 3)).astype(np.float32)
    jm = JHeadExpression() if tower == "vasa_expression" else JHeadPose()
    ref = jm.apply(p[tower], jnp.asarray(x))
    with torch.no_grad():
        port = mods[tower](torch.from_numpy(x))
    if tower == "vasa_expression":
        assert port.shape == (2, 512)
        _close(port.numpy(), ref)
    else:
        for k in ("rotation", "translation"):
            _close(port[k].numpy(), ref[k])


def test_arcface_iresnet50(params):
    p, mods = params
    x = np.random.default_rng(2).uniform(-1, 1, (1, 112, 112, 3)).astype(np.float32)
    ref = jiresnet50().apply(p["arcface"], jnp.asarray(x))
    with torch.no_grad():
        port = mods["arcface"](torch.from_numpy(x))
    assert port.shape == (1, 512)
    _close(port.numpy(), ref)


def test_arcface_ignores_the_files_batch_counters(params):
    """insightface's BatchNorms carry ``num_batches_tracked``: the strict
    load takes the file with them."""
    p, mods = params
    sd = to_torch(X.export_arcface(p["arcface"]))
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
               for k in list(sd) if k.endswith("running_mean")})
    iresnet50().load_state_dict(sd, strict=True)


@pytest.fixture(scope="module")
def pipes(params):
    p, mods = params
    micro = dataclasses.replace(JUNetConfig().micro(), block_out_channels=(64, 64))
    jpipe = JPipeline(JModules.create(unet_config=micro),
                      {k: p[k] for k in ("whisper", "vasa_expression", "vasa_pose")})
    tmods = PipelineModules.create(
        unet_config=dataclasses.replace(UNetConfig().micro(),
                                        block_out_channels=(64, 64)),
        vae_config=VAEConfig().tiny(), dtype=torch.float32)
    for name in ("whisper", "vasa_expression", "vasa_pose"):
        setattr(tmods, name, mods[name])
    return jpipe, ACTalkerPipeline(tmods, dtype=torch.float32)


def test_encode_audio_windows(pipes):
    jpipe, tpipe = pipes
    mel = np.random.default_rng(3).standard_normal((2, 80, 400)).astype(np.float32)
    ref = jpipe.encode_audio_windows(jnp.asarray(mel))
    port = tpipe.encode_audio_windows(mel)
    assert port.shape == (2, 200, 5, 384)
    _close(port.numpy(), ref)


@pytest.mark.parametrize("n", [6, 8])
def test_encode_vasa_video(pipes, n):
    """Chunks of 4: n = 6 pads its last chunk with copies of its final crop,
    n = 8 needs none; the expression and the rotation of every frame."""
    jpipe, tpipe = pipes
    rng = np.random.default_rng(4)
    face = rng.random((n, 64, 64, 3)).astype(np.float32)
    pose = rng.random((n, 64, 64, 3)).astype(np.float32)
    ref_e, ref_r = jpipe.encode_vasa_video(face, pose, chunk=4)
    port_e, port_r = tpipe.encode_vasa_video(face, pose, chunk=4)
    assert port_e.shape == (n, 512) and port_r.shape == (n, 3)
    _close(port_e, ref_e)
    _close(port_r, ref_r)


def test_encode_vasa_video_needs_the_towers(pipes):
    _, tpipe = pipes
    saved = tpipe.m.vasa_expression
    tpipe.m.vasa_expression = None
    try:
        with pytest.raises(RuntimeError, match="VASA towers"):
            tpipe.encode_vasa_video(np.zeros((1, 8, 8, 3)), np.zeros((1, 8, 8, 3)))
    finally:
        tpipe.m.vasa_expression = saved


def test_whisper_layer_norms_follow_the_norm_switch(params, monkeypatch):
    """Under ACTALKER_NORM=fused the encoder's nine LayerNorms go through
    K7-LN's entry (its plain version on the CPU) at C = 384, fp32."""
    from actalker_tpu_torch.models import common

    p, mods = params
    seen = []
    real = common.layer_norm

    def spy(x, *a, **k):
        seen.append((x.shape[-1], x.dtype))
        return real(x, *a, **k)

    monkeypatch.setattr(common, "layer_norm", spy)
    mel = torch.randn(1, 80, 200)
    with torch.no_grad():
        plain = mods["whisper"](mel)
        saved = common.norm_impl()
        common.set_norm_impl("fused")
        try:
            fused = mods["whisper"](mel)
        finally:
            common.set_norm_impl(saved)
    assert seen == [(384, torch.float32)] * 9
    torch.testing.assert_close(fused, plain, rtol=1e-4, atol=1e-4)
