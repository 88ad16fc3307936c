"""PyTorch port, video decoding without the native libav runtime against the
JAX package (CPU): with ``media_native.lib`` patched to ``None`` on both
sides, the port's ``read_frames`` takes OpenCV's decoder as the JAX
package's does, and equals it bit for bit, with and without ``limit``; and
the CLI's driving-video step (mode 1: the first frame's face box, the
square crop, 256 px, the VASA towers, ``vasa_tokens``) gives the same
expression tokens through the port's CLI as through the JAX CLI's stages on
the port's parameters (converted by the JAX package's own converters).

The clips are mp4s written here: by the runtime where it loads, else by
``cv2.VideoWriter``. Tolerance of the tokens: rtol=1e-4, atol=1e-5 of their
largest magnitude (fp32 towers on both sides, differing in summation order
only; as ``test_torch_encoders.py``).
"""
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.frontend import face as JF
from actalker_tpu.frontend import media_native as JM
from actalker_tpu.frontend import preprocess as JP
from actalker_tpu.frontend import video as JV
from actalker_tpu.io import weights as JW
from actalker_tpu.models.unet import UNetConfig as JUNetConfig
from actalker_tpu.models.vae import VAEConfig as JVAEConfig
from actalker_tpu.pipeline.pipeline import (
    ACTalkerPipeline as JPipeline, PipelineModules as JModules)
from actalker_tpu_torch import cli
from actalker_tpu_torch.frontend import media_native as TM
from actalker_tpu_torch.frontend import video as TV
from tests.test_torch_cli import BOX, _args, inputs  # noqa: F401 (fixture)
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)


def write_clip(path, frames, fps=25.0):
    """frames (F, H, W, 3) uint8 RGB -> an mp4 at ``path``: the runtime's
    H.264 where it loads, else OpenCV's MPEG-4 part 2."""
    if TM.lib() is not None:
        TM.write_video(path, frames, fps=fps)
        return
    import cv2

    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))
    writer.release()


@pytest.fixture
def no_runtime(monkeypatch):
    monkeypatch.setattr(TM, "lib", lambda: None)
    monkeypatch.setattr(JM, "lib", lambda: None)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """Nine 48 x 64 frames of seeded 8-pixel colour blocks moving 3 px a
    frame (blocks, so that the codecs' chroma subsampling keeps them)."""
    rng = np.random.default_rng(5)
    tex = (rng.random((6, 12, 3)) * 255).astype(np.uint8).repeat(8, 0).repeat(8, 1)
    frames = np.stack([tex[:, 3 * i:3 * i + 64] for i in range(9)])
    path = str(tmp_path_factory.mktemp("decode") / "clip.mp4")
    write_clip(path, frames)
    return path, frames


@pytest.mark.parametrize("limit", [None, 1, 4, 9, 20])
def test_read_frames_equals_jax_without_the_runtime(clip, no_runtime, limit):
    path, frames = clip
    port = TV.read_frames(path, limit=limit)
    ref = JV.read_frames(path, limit=limit)
    assert port.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(port, ref)
    assert port.shape == (min(limit or 9, 9), 48, 64, 3)
    # RGB order, not OpenCV's BGR: the decoded clip stays near what was
    # written, its channels reversed far from it
    err = np.abs(port.astype(int) - frames[:len(port)]).mean()
    assert err < 12 < np.abs(port[..., ::-1].astype(int) - frames[:len(port)]).mean()
    assert TV.get_fps(path) == JV.get_fps(path) == pytest.approx(25.0)


def test_read_frames_runs_no_ffmpeg_binary(clip, no_runtime, monkeypatch):
    """Where an ``ffmpeg`` binary is on the path, the decoder is still
    OpenCV's, as in the JAX package (the port's writer may run it)."""
    def refuse(*args, **kwargs):
        raise AssertionError("read_frames started a process")

    monkeypatch.setattr(shutil, "which", lambda name: f"/usr/bin/{name}")
    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    port = TV.read_frames(clip[0], limit=3)
    assert port.shape == (3, 48, 64, 3)
    assert np.array_equal(port, JV.read_frames(clip[0], limit=3))


def test_read_frames_without_a_clip_raises_as_jax(tmp_path, no_runtime):
    missing = str(tmp_path / "missing.mp4")
    for read in (TV.read_frames, JV.read_frames):
        with pytest.raises(RuntimeError, match="no frames decoded"):
            read(missing)


def test_mode1_vasa_tokens_equal_the_jax_cli_stages(inputs, no_runtime, tmp_path):
    """Mode 1 of ``test_cli_modes`` on a clip decoded by OpenCV: the port's
    CLI against the JAX CLI's driving-video stages (``actalker_tpu/cli.py``)
    on the port CLI's VASA towers and head."""
    video = str(tmp_path / "drive.mp4")
    rng = np.random.default_rng(6)
    write_clip(video, (rng.random((12, 96, 96, 3)) * 255).astype(np.uint8))
    cfg = cli.load_config(inputs["config"])
    pipe = cli.build_pipeline(cfg, True, torch.device("cpu"))
    run = cli.generate_frames(cfg, _args(inputs, 1, video=video),
                              cli.MODE_GATES[1], {(64, 64, "cpu"): pipe},
                              detector=lambda img: BOX)
    nf = run["num_frames"]
    assert nf == 4 and run["masks"]["exp_mask"] is not None

    m = pipe.m

    def sd(module):
        return {k: v.float().numpy() for k, v in module.state_dict().items()}

    jpipe = JPipeline(JModules.create(unet_config=JUNetConfig().micro(),
                                      vae_config=JVAEConfig().tiny(),
                                      dtype=jnp.float32, vae_dtype=jnp.float32),
                      {"vasa_expression": JW.convert_vasa_expression(sd(m.vasa_expression)),
                       "vasa_pose": JW.convert_vasa_pose(sd(m.vasa_pose)),
                       "vasa_proj": JW.convert_vasa_proj(sd(m.vasa_proj))},
                      dtype=jnp.float32)
    # the JAX CLI's stages (actalker_tpu/cli.py, the driving-video branch)
    frames = JV.read_frames(video, limit=nf * cfg.step)
    assert frames.shape[0] == 8
    fh, fw = frames.shape[1:3]
    vbox = JF.detect_face(frames[0], lambda img: BOX) or (0, 0, fw, fh)
    x1, y1, x2, y2 = [int(max(v, 0)) for v in JP.process_bbox(list(vbox), 1.0, fh, fw)]
    x2, y2 = min(x2, fw), min(y2, fh)
    crops = np.stack([JP.resize_image(f[y1:y2, x1:x2], (256, 256)).astype(np.float32)
                      / 255.0 for f in frames[::cfg.step][:nf]])
    expr, rot = jpipe.encode_vasa_video(crops, crops)
    want = jpipe.vasa_tokens(expr, rot, nf, cfg.vasa_expression_dim)
    got = run["tokens"][2:]
    assert got[0].abs().max() > 0 and torch.isfinite(got[0]).all()
    for port, ref in zip(got, want):
        ref = np.asarray(ref)
        assert port.shape == ref.shape == (nf, 1, cfg.vasa_expression_dim + 6)
        np.testing.assert_allclose(port.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0))
