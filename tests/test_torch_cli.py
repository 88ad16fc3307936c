"""PyTorch port, the inference CLI end to end on the CPU
(``python -m actalker_tpu_torch.cli ... --device cpu --random-weights`` on
the micro model: 64 px, windows of 2 frames, 2 denoise steps), modes 0, 1
and 2, with a WAV and a portrait (mode 1 with a driving video, decoded by
the native runtime where it loads); and the slice as a whole against the
JAX package: the JAX CLI's stages (``preprocess_reference_image``,
``whisper_features``, ``encode_audio_windows``, ``audio_tokens_per_frame``,
``vasa_tokens``, ``generate_latents`` with the port's initial noise,
``decode_latents``) on the port CLI's parameters (converted by the JAX
package's own converters) and inputs, in mode 0 with a fixed face box, so
both take the SSM gather.

Tolerances: the numpy frontend exactly; audio tokens rtol=1e-4 / atol=1e-5
of their largest magnitude; latents and frames within 1e-3 of the largest
JAX value (fp32; guidance 7.5 amplifies UNet differences, as in
test_torch_pipeline.py).
"""
import argparse
import os
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from actalker_tpu.config import InferenceConfig as JInferenceConfig
from actalker_tpu.frontend import audio as JA
from actalker_tpu.frontend import preprocess as JP
from actalker_tpu.io import weights as JW
from actalker_tpu.models.unet import UNetConfig as JUNetConfig
from actalker_tpu.models.vae import VAEConfig as JVAEConfig
from actalker_tpu.pipeline.pipeline import (
    ACTalkerPipeline as JPipeline, PipelineModules as JModules)
from actalker_tpu_torch import cli
from actalker_tpu_torch.frontend import media_native as TM
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)

BOX = (14.0, 20.0, 50.0, 62.0)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    t = np.arange(int(1.3 * 16000)) / 16000
    pcm = (0.3 * np.sin(2 * np.pi * 220 * t) * 32767).astype(np.int16)
    with wave.open(str(d / "speech.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    rng = np.random.default_rng(0)
    Image.fromarray((rng.random((80, 64, 3)) * 255).astype(np.uint8)).save(d / "face.png")
    video = None
    if TM.lib() is not None:
        video = str(d / "drive.mp4")
        TM.write_video(video, (rng.random((8, 96, 96, 3)) * 255).astype(np.uint8), fps=25)
    (d / "micro.yaml").write_text(
        "data:\n  n_sample_frames: 2\nnum_inference_steps: 2\nimage_size: 64\n"
        "decode_chunk_size: 2\nseed: 3\nweight_dtype: 'fp32'\n"
        f"output_dir: '{d / 'out'}'\nexp_name: 'e'\nmicro_model: true\n"
        "arcface_checkpoint_path: ''\n")
    return dict(dir=d, wav=str(d / "speech.wav"), ref=str(d / "face.png"),
                video=video, config=str(d / "micro.yaml"))


def _args(inputs, mode, **kw):
    a = dict(config=inputs["config"], ref=inputs["ref"], audio=inputs["wav"],
             video=inputs["video"], mode=mode, batch=False, random_weights=True,
             frame_limit=8, device="cpu")
    a.update(kw)
    return argparse.Namespace(**a)


@pytest.fixture(scope="module")
def pipes():
    """One pipeline cache for the module's direct CLI runs (the models
    depend on neither the mode nor the inputs)."""
    return {}


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_cli_modes(inputs, pipes, mode):
    """``generate_frames`` then ``write_outputs``, as ``_run_single`` runs
    them: the frames, the tokens and masks each mode takes, every stage
    timed, the mp4 written (where this machine has an encoder)."""
    cfg = cli.load_config(inputs["config"])
    args = _args(inputs, mode)
    run = cli.generate_frames(cfg, args, cli.MODE_GATES[mode], pipes,
                              detector=lambda img: BOX)
    assert run["frames01"].shape == (4, 64, 64, 3)
    assert np.isfinite(run["frames01"]).all()
    assert set(run["seconds"]) == {"detect", "preprocess", "mel", "whisper", "tokens",
                                   "generate_latents", "decode"}
    vasa = run["tokens"][2]
    if mode != 0 and inputs["video"]:
        assert vasa.abs().max() > 0            # the towers ran on its crops
    else:
        assert vasa.abs().max() == 0
    masks = run["masks"]
    assert (masks["audio_mask"] is not None) == (mode == 0)
    assert (masks["exp_mask"] is not None) == (mode == 1)
    if TM.lib() is not None:
        path = cli.write_outputs(cfg, args, run)
        assert path.endswith("face.png_audio.mp4") and "write" in run["seconds"]
        assert TM.video_info(path)[:2] == (64, 64)


def test_cli_main_end_to_end(inputs, capsys):
    """``python -m actalker_tpu_torch.cli`` as a user runs it: mode 1 with
    the driving video (the VASA towers on its crops), to the mp4s."""
    argv = ["--config", inputs["config"], "--ref", inputs["ref"], "--audio",
            inputs["wav"], "--mode", "1", "--random-weights",
            "--frame-limit", "8", "--device", "cpu"]
    if inputs["video"]:
        argv += ["--video", inputs["video"]]
    cli.main(argv)
    out = capsys.readouterr().out
    assert "(4 frames)" in out and "generate_latents" in out
    if TM.lib() is not None:
        path = os.path.join(inputs["dir"], "out", "e", "face.png_audio.mp4")
        assert TM.video_info(path)[:2] == (64, 64)


def test_cli_batch_and_rerun_loop(inputs, monkeypatch, tmp_path):
    calls = []
    real = cli.generate_frames

    def spy(cfg, args, gate, pipes, detector=None):
        calls.append((args.ref, args.audio, len(pipes)))
        return real(cfg, args, gate, pipes, detector)

    monkeypatch.setattr(cli, "generate_frames", spy)
    cli.main(["--config", inputs["config"], "--batch", "--ref",
              f"{inputs['ref']},{inputs['ref']}", "--audio", inputs["wav"],
              "--mode", "2", "--random-weights", "--frame-limit", "4",
              "--device", "cpu"])
    assert [c[:2] for c in calls] == [(inputs["ref"], inputs["wav"])] * 2
    assert calls[1][2] == 1                          # the models were reused
    # one re-run from a new config, then Enter
    answers = iter([inputs["config"], ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    cli.main(["--config", inputs["config"], "--ref", inputs["ref"], "--audio",
              inputs["wav"], "--mode", "0", "--random-weights", "--frame-limit",
              "4", "--device", "cpu"])
    if TM.lib() is not None:
        assert os.path.exists(os.path.join(inputs["dir"], "out", "e",
                                           "face.png_rerun.mp4"))


def test_cli_refuses_a_missing_card_and_names_unported_passes(inputs, pipes,
                                                              monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.resolve_device("cuda")
    # the post-passes are ported: one asked for without its checkpoint is
    # skipped, as in the JAX CLI, and nothing is said to be unported
    cfg = cli.load_config(inputs["config"])
    cfg.use_teeth_enhance = True
    run = cli.generate_frames(cfg, _args(inputs, 2, frame_limit=4), (1, 1), pipes,
                              detector=lambda img: None)
    out = capsys.readouterr()
    assert "not ported" not in out.out + out.err and "teeth" not in run["seconds"]


def _jax_params(pipe):
    """The port pipeline's modules -> the JAX pipeline's parameters, through
    the JAX package's own converters."""
    m = pipe.m

    def sd(module):
        return {k: v.float().numpy() for k, v in module.state_dict().items()}

    return {
        "unet": JW.convert_unet(sd(m.unet), **JW.unet_block_kwargs(m.unet.config)),
        "vae": JW.convert_vae(sd(m.vae), block_out_channels=m.vae.config.block_out_channels,
                              layers_per_block=m.vae.config.layers_per_block),
        "audio_proj": JW.convert_audio_proj(sd(m.audio_proj)),
        "id_proj": JW.convert_id_proj(sd(m.id_proj)),
        "vasa_proj": JW.convert_vasa_proj(sd(m.vasa_proj)),
        "pose_guider": JW.convert_pose_guider(sd(m.pose_guider)),
        "whisper": JW.convert_whisper_encoder(
            {f"encoder.{k}": v for k, v in sd(m.whisper).items()}),
    }


def test_the_slice_against_the_jax_stages(inputs):
    cfg = cli.load_config(inputs["config"])
    gate = cli.MODE_GATES[0]
    # the CLI's seeded pipeline, its UNet weights scaled to N(0, 0.1^2) so
    # that its output moves the latents visibly (as in
    # test_torch_pipeline.py), handed to the CLI through its model cache
    pipe = cli.build_pipeline(cfg, True, torch.device("cpu"))
    with torch.no_grad():
        for prm in pipe.m.unet.parameters():
            prm.mul_(5.0)
    run = cli.generate_frames(cfg, _args(inputs, 0), gate,
                              {(64, 64, "cpu"): pipe},
                              detector=lambda img: BOX)
    assert run["pipe"] is pipe
    pre = run["pre"]
    jcfg = JInferenceConfig.from_yaml(inputs["config"])
    jpipe = JPipeline(JModules.create(unet_config=JUNetConfig().micro(),
                                      vae_config=JVAEConfig().tiny(),
                                      dtype=jnp.float32, vae_dtype=jnp.float32),
                      _jax_params(pipe), dtype=jnp.float32)

    # preprocess and mel: numpy, exactly
    img = np.asarray(Image.open(inputs["ref"]).convert("RGB"))
    jpre = JP.preprocess_reference_image(
        img, BOX, image_size=jcfg.image_size, area=jcfg.area, crop=jcfg.crop,
        expand_ratio=jcfg.expand_ratio, aspect_type=jcfg.aspect_type)
    for name in ("ref_img", "pose_img", "head_crop"):
        np.testing.assert_array_equal(getattr(pre, name), getattr(jpre, name))
    mel, audio_len = JA.whisper_features(inputs["wav"])
    nf = min(8, audio_len) // jcfg.step
    assert nf == run["num_frames"] == 4

    # whisper windows -> audio tokens
    feats = np.concatenate([np.asarray(jpipe.encode_audio_windows(
        jnp.asarray(mel[None, :, i:i + 3000])))[0]
        for i in range(0, mel.shape[-1], 3000)])[:audio_len * 2]
    feats = np.concatenate([np.zeros_like(feats[:4]), feats, np.zeros_like(feats[:6])])
    a_tok, a_unc = jpipe.audio_tokens_per_frame(feats, nf, step=jcfg.step)
    v_tok, v_unc = jpipe.vasa_tokens(None, None, nf, jcfg.vasa_expression_dim)
    for port, ref in zip(run["tokens"], (a_tok, a_unc, v_tok, v_unc)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(ref).max(), 1.0))

    # generate_latents on the port's own initial noise (its generator's
    # second draw, after the reference-image noise augmentation's)
    gen = torch.Generator().manual_seed(jcfg.seed)
    torch.randn((64, 64, 3), generator=gen)
    buf = nf + jcfg.n_sample_frames
    noise = torch.randn((buf, 8, 8, 4), generator=gen).numpy()
    face_mask = jpre.pose_img[None, None, :, :, 0].astype(np.float32)
    scfg = jcfg.sampler_config(gate)
    assert jpipe._capacity_fracs(scfg, face_mask, None, (8, 8)) is not None
    lat = jpipe.generate_latents(
        jpre.ref_img, np.zeros(512, np.float32), a_tok, a_unc, v_tok, v_unc,
        np.repeat(jpre.pose_img[None], nf, axis=0), scfg, seed=jcfg.seed,
        audio_mask=face_mask, init_noise=noise)
    lat = np.asarray(lat)
    assert np.abs(run["latents"].numpy() - lat).max() <= 1e-3 * np.abs(lat).max()

    frames = np.clip(jpipe.decode_latents(lat, jcfg.decode_chunk_size) * 0.5 + 0.5, 0, 1)
    assert np.abs(run["frames01"] - frames).max() <= 1e-3 * max(np.abs(frames).max(), 1e-6)
