"""PyTorch port, the real-data training and batched-serving slice against
the JAX package (fp32, CPU):

* ``BatchBuilder``'s ``TrainBatch`` against the JAX builder's
  (``raw_heads=True``, the one mode its train.py uses) on shared micro-width
  VAE / whisper / heads, the VASA towers and ArcFace;
* ``sample_video_batch`` with two identities on the micro UNet, each with
  its own masks, against the JAX package's ``sample_video_batch``
  (``mesh=None``, its initial noise drawn from the same keys) and against
  the port's ``sample_video`` of that identity alone;
* ``training.train.main --metadata --micro-model --device cpu`` end to end
  on a written mp4 + WAV corpus through two loader workers, and a resume.

Parameters go JAX -> port through the exporters (``strict=True``).
Tolerances: the builder's fields rtol 1e-4 with atol 1e-5 of the largest
magnitude (fp32 both sides, summation order). The sampler's latents against
the JAX package within 1e-3 of the largest latent, as in
test_torch_pipeline.py: fp32 rounding differences in the UNet outputs grow
through guidance 7.5 (they read 3.4e-4 here). A batched identity against
the same identity alone: the UNet computes in float64 there, so the two
differ only by the fp32 latents' roundings (1e-6 of the largest latent);
in fp32 a UNet call with both identities stacked sums in another order
than one with one, by the same 3.7e-4 of the largest latent.
"""
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.models.arcface import iresnet50 as jiresnet50
from actalker_tpu.pipeline import sampler as jsampler
from actalker_tpu.pipeline import serving as jserving
from actalker_tpu.training.batch_builder import BatchBuilder as JBuilder
from actalker_tpu_torch.frontend import media_native as TM
from actalker_tpu_torch.io import checkpoint as ckpt
from actalker_tpu_torch.io import jax_export as X
from actalker_tpu_torch.io.init import vasa_state_dicts, whisper_state_dict
from actalker_tpu_torch.io.weights import to_torch
from actalker_tpu_torch.models.arcface import iresnet50
from actalker_tpu_torch.pipeline import sampler as tsampler
from actalker_tpu_torch.pipeline import serving as tserving
from actalker_tpu_torch.training import train as TR
from actalker_tpu_torch.training.batch_builder import BatchBuilder
from tests.test_torch_encoders import _seeded
from tests.test_torch_pipeline import pipes  # noqa: F401 (fixture)
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)


def _close(port, ref, rtol=1e-4, atol=1e-5):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=atol * max(np.abs(ref).max(), 1.0))


@pytest.fixture(scope="module")
def encoders(pipes):  # noqa: F811
    """The micro pipelines with the whisper and VASA towers of the JAX
    pipeline's parameters loaded into the port's, and a seeded ArcFace."""
    jpipe, tpipe, params = pipes
    tpipe.m.whisper.load_state_dict(whisper_state_dict(
        to_torch(X.export_whisper(params["whisper"]))), strict=True)
    mx = {"generator": to_torch(X.export_vasa_expression(params["vasa_expression"])),
          "pose_model": to_torch(X.export_vasa_pose(params["vasa_pose"]))}
    for name, sd in vasa_state_dicts(mx).items():
        getattr(tpipe.m, name).load_state_dict(sd, strict=True)
    p_arc = _seeded(jiresnet50(), jnp.zeros((1, 112, 112, 3)), seed=3)
    arc = iresnet50()
    arc.load_state_dict(to_torch(X.export_arcface(p_arc)), strict=True)
    return jpipe, tpipe, (jiresnet50(), p_arc), arc.eval()


def _samples(f=2, px=64):
    rng = np.random.default_rng(0)
    out = []
    for i in range(2):
        box = np.zeros((px, px), np.float32)
        box[8 + 4 * i:48, 12:52 - 6 * i] = 1.0
        mouth = np.zeros_like(box)
        mouth[30:48, 20:44] = 1.0
        out.append(dict(
            frames=rng.uniform(-1, 1, (f, px, px, 3)).astype(np.float32),
            ref_frame=rng.uniform(-1, 1, (px, px, 3)).astype(np.float32),
            pose_mask=box, mouth_mask=mouth, exp_mask=box - mouth,
            head_crop=rng.uniform(-1, 1, (112, 112, 3)).astype(np.float32),
            vasa_face=rng.random((f, 64, 64, 3)).astype(np.float32),
            vasa_pose=rng.random((f, 64, 64, 3)).astype(np.float32),
            # one 30 s window, and a whole-clip mel encoded in two windows
            audio_features=rng.standard_normal((80, 400 if i == 0 else 3200)
                                               ).astype(np.float32),
            audio_offset=3 + 5 * i, audio_step=2, fps=12.5,
            motion_bucket=10 + i, motion_bucket_exp=20 + i,
            motion_bucket_flow=5))
    return out


def test_batch_builder_matches_jax(encoders):
    jpipe, tpipe, j_arc, arc = encoders
    samples = _samples()
    want = JBuilder(jpipe, arcface=j_arc, raw_heads=True, encode_chunk=3)(samples)
    got = BatchBuilder(tpipe, arcface=arc, encode_chunk=3)(samples)
    for k, v in want._asdict().items():
        if v is None:                  # the pre-encoded fields
            assert getattr(got, k) is None, k
        else:
            _close(getattr(got, k), v)
    assert got.latents.shape == (2, 2, 8, 8, 4)


def test_pre_encoded_batch_builder_matches_jax(encoders):
    """``raw_heads=False`` (the JAX builder's default): the builder runs the
    heads too, and the batch carries id / audio / VASA tokens and pose
    features over every frame, equal to the JAX builder's; no raw field."""
    jpipe, tpipe, j_arc, arc = encoders
    samples = _samples()
    want = JBuilder(jpipe, arcface=j_arc, raw_heads=False, encode_chunk=3)(samples)
    got = BatchBuilder(tpipe, arcface=arc, encode_chunk=3, raw_heads=False)(samples)
    for k, v in want._asdict().items():
        if v is None:
            assert getattr(got, k) is None, k
        else:
            _close(getattr(got, k), v)
    assert got.audio_tokens.shape == (2, 2, 32, 1024)
    assert got.vasa_tokens.shape == (2, 2, 1, 1024)
    assert got.pose_fea.shape[:2] == (2, 2) and got.id_tokens.shape == (2, 1, 1024)


# ------------------------------------------------------------- serving

def _unet64(unet):
    """The UNet's parameters in a copy that computes in float64."""
    with torch.device("meta"):
        u = type(unet)(unet.config, dtype=torch.float64)
    u.load_state_dict(unet.state_dict(), assign=True)
    return u.double().eval()


def _buffers(rng, buf, hw, c0, px, box):
    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    mask = np.zeros((1, 1, px, px), np.float32)
    y0, x0, y1, x1 = box
    mask[..., y0:y1, x0:x1] = 1.0
    return dict(id_tokens=r(buf, 1, 1024), audio_tokens=r(buf, 32, 1024),
                audio_tokens_u=np.zeros((buf, 32, 1024), np.float32),
                vasa_tokens=r(buf, 1, 1024),
                vasa_tokens_u=np.zeros((buf, 1, 1024), np.float32),
                image_latents=r(buf, hw, hw, 4), pose_fea=0.1 * r(buf, hw, hw, c0),
                audio_mask=mask, exp_mask=1.0 - mask)


def test_sample_video_batch_matches_jax_and_each_identity_alone(pipes):  # noqa: F811
    """Two identities with their own masks: the batch against the JAX
    package; in float64, the batch run two windows a UNet call against each
    identity alone with all three windows in one call (the sampler's output
    is the same either way)."""
    jpipe, tpipe, params = pipes
    kw = dict(num_inference_steps=2, frames_per_batch=2, overlap=0, shift_offset=1)
    jcfg = jsampler.SamplerConfig(**kw)
    tcfg = tsampler.SamplerConfig(**kw)
    nf, hw, px = 3, 8, 64
    plan = tsampler.make_plan(tcfg, nf)
    buf = plan.buffer_len
    c0 = tpipe.m.unet.config.block_out_channels[0]
    rng = np.random.default_rng(4)
    ids = [_buffers(rng, buf, hw, c0, px, box)
           for box in ((0, 0, px, px), (16, 12, 52, 48))]
    refs = np.stack([rng.standard_normal((hw, hw, 4)).astype(np.float32) for _ in ids])
    keys = jax.random.split(jax.random.PRNGKey(7), len(ids))
    noise = np.stack([np.asarray(jax.random.normal(k, (buf, hw, hw, 4))) for k in keys])

    jbufs = jsampler.CondBuffers(**{k: jnp.asarray(np.stack([d[k] for d in ids]))
                                    for k in ids[0]})
    want = np.asarray(jserving.sample_video_batch(
        jpipe.m.unet.apply, params["unet"], jcfg, jsampler.make_plan(jcfg, nf), jbufs,
        jnp.asarray(refs), keys, mesh=None, dtype=jnp.float32))
    per_id = [tsampler.CondBuffers(**{k: torch.from_numpy(v) for k, v in d.items()})
              for d in ids]
    got = tserving.sample_video_batch(
        tpipe.m.unet, tcfg, plan, tserving.stack_buffers(per_id),
        torch.from_numpy(refs), init_noise=torch.from_numpy(noise),
        dtype=torch.float32)
    assert got.shape == (2, buf, hw, hw, 4)
    _close(got, want, rtol=0, atol=1e-3)
    u64 = _unet64(tpipe.m.unet)
    batch = tserving.sample_video_batch(
        u64, tsampler.SamplerConfig(windows_per_call=2, **kw), plan,
        tserving.stack_buffers(per_id), torch.from_numpy(refs),
        init_noise=torch.from_numpy(noise), dtype=torch.float64)
    for i, b in enumerate(per_id):
        alone = tsampler.sample_video(u64, tcfg, plan, b, torch.from_numpy(refs[i]),
                                      dtype=torch.float64,
                                      init_noise=torch.from_numpy(noise[i]))
        _close(batch[i], alone, rtol=0, atol=1e-6)
    # the identities' own masks reached the UNet: swapping them changes both
    swapped = tserving.stack_buffers([
        tsampler.CondBuffers(**{**{k: torch.from_numpy(v) for k, v in ids[i].items()},
                                "audio_mask": torch.from_numpy(ids[1 - i]["audio_mask"]),
                                "exp_mask": torch.from_numpy(ids[1 - i]["exp_mask"])})
        for i in range(2)])
    other = tserving.sample_video_batch(tpipe.m.unet, tcfg, plan, swapped,
                                        torch.from_numpy(refs),
                                        init_noise=torch.from_numpy(noise),
                                        dtype=torch.float32)
    assert all((other[i] - got[i]).abs().max() > 1e-3 * got[i].abs().max()
               for i in range(2))


def test_sample_video_batch_draws_each_identity_from_its_generator(pipes):  # noqa: F811
    _, tpipe, _ = pipes
    tcfg = tsampler.SamplerConfig(num_inference_steps=1, frames_per_batch=2,
                                  s_churn=1.0)
    plan = tsampler.make_plan(tcfg, 2)
    assert plan.gammas[0] > 0
    rng = np.random.default_rng(5)
    c0 = tpipe.m.unet.config.block_out_channels[0]
    per_id = [tsampler.CondBuffers(**{k: torch.from_numpy(v) for k, v in
                                      _buffers(rng, plan.buffer_len, 8, c0, 64,
                                               (0, 0, 64, 64)).items()})
              for _ in range(2)]
    refs = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))

    def gens():
        return [torch.Generator().manual_seed(s) for s in (11, 12)]

    u64 = _unet64(tpipe.m.unet)
    got = tserving.sample_video_batch(u64, tcfg, plan, tserving.stack_buffers(per_id),
                                      refs, generators=gens(), dtype=torch.float64)
    for i, g in enumerate(gens()):
        alone = tsampler.sample_video(u64, tcfg, plan, per_id[i], refs[i],
                                      generator=g, dtype=torch.float64)
        _close(got[i], alone, rtol=0, atol=1e-6)
    assert (got[0] - got[1]).abs().max() > 1e-2
    with pytest.raises(ValueError, match="generators"):
        tserving.sample_video_batch(tpipe.m.unet, tcfg, plan,
                                    tserving.stack_buffers(per_id), refs,
                                    generators=gens()[:1], dtype=torch.float32)


def _prepared(pipe, cfg, i, box, nf=3, px=64):
    """``prepare_sampling`` for identity i: its own tokens, seed and a face
    box of side ``box`` as the audio mask (mode 0)."""
    rng = np.random.default_rng(30 + i)
    mask = np.zeros((1, 1, px, px), np.float32)
    mask[..., 8:8 + box, 12:12 + box] = 1.0
    return pipe.prepare_sampling(
        rng.uniform(-1, 1, (px, px, 3)).astype(np.float32),
        rng.standard_normal(512).astype(np.float32),
        rng.standard_normal((nf, 32, 1024)).astype(np.float32),
        np.zeros((nf, 32, 1024), np.float32),
        rng.standard_normal((nf, 1, 1024)).astype(np.float32),
        np.zeros((nf, 1, 1024), np.float32),
        rng.uniform(0, 1, (nf, px, px, 3)).astype(np.float32), cfg, seed=i,
        audio_mask=mask), mask


def test_generate_latents_batch_gathers_with_one_budget(pipes, monkeypatch):  # noqa: F811
    """Two identities with face boxes of different sizes in mode 0, in
    float64: ``generate_latents_batch`` sets one SSM budget that covers both
    masks (the gather path, K1 on the compacted rows), and each identity
    equals itself alone under its own budget. A budget that covers only
    identity 0 turns identity 1 NaN and leaves identity 0 as it was."""
    import dataclasses

    from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline

    _, tpipe, _ = pipes
    u64 = _unet64(tpipe.m.unet)
    p64 = ACTalkerPipeline(dataclasses.replace(tpipe.m, unet=u64), dtype=torch.float64)
    cfg = tsampler.SamplerConfig(num_inference_steps=2, frames_per_batch=2, overlap=0,
                                 shift_offset=1, gate=(1, 0))
    boxes = (16, 40)
    caps = [p64._capacity_fracs(cfg, _prepared(p64, cfg, i, b)[1], None, (8, 8))
            for i, b in enumerate(boxes)]
    assert all(c is not None for c in caps) and caps[0][0] < caps[1][0]
    seen = []
    real = u64.set_mask_capacity
    monkeypatch.setattr(u64, "set_mask_capacity",
                        lambda c: (seen.append(c), real(c))[1])
    batch = p64.generate_latents_batch(
        [_prepared(p64, cfg, i, b)[0] for i, b in enumerate(boxes)], cfg)
    assert seen == [caps[1], None] and u64.config.mask_capacity is None
    assert batch.shape == (2, 3, 8, 8, 4) and torch.isfinite(batch).all()
    alone = [p64.generate_latents_batch([_prepared(p64, cfg, i, b)[0]], cfg)[0]
             for i, b in enumerate(boxes)]
    assert seen[2:] == [caps[0], None, caps[1], None]
    for i in range(2):
        _close(batch[i], alone[i], rtol=0, atol=1e-6)
    # the stacked call on identity 0's budget: identity 1 overflows it
    prep = [_prepared(p64, cfg, i, b)[0] for i, b in enumerate(boxes)]
    u64.set_mask_capacity(caps[0])
    try:
        over = tserving.sample_video_batch(
            u64, cfg, prep[0][0], tserving.stack_buffers([p[1] for p in prep]),
            torch.stack([p[2] for p in prep]), generators=[p[3] for p in prep],
            dtype=torch.float64)
    finally:
        u64.set_mask_capacity(None)
    assert torch.isnan(over[1]).all()
    _close(over[0, :3], alone[0], rtol=0, atol=1e-6)


# ------------------------------------------------------ train --metadata

def _write_corpus(d, n_clips=2, n_frames=10, hw=(72, 96)):
    rng = np.random.default_rng(0)
    h, w = hw
    clips = []
    for c in range(n_clips):
        base = rng.integers(0, 255, (h + 8, w + 8, 3)).astype(np.uint8)
        frames = np.stack([base[t % 4:t % 4 + h, t % 3:t % 3 + w] for t in range(n_frames)])
        video = str(d / f"clip{c}.mp4")
        TM.write_video(video, frames, fps=25)
        audio = str(d / f"clip{c}.wav")
        t = np.arange(int(n_frames / 25 * 16000)) / 16000
        with wave.open(audio, "wb") as wv:
            wv.setnchannels(1)
            wv.setsampwidth(2)
            wv.setframerate(16000)
            wv.writeframes((0.3 * np.sin(2 * np.pi * (200 + 60 * c) * t) * 32767)
                           .astype(np.int16).tobytes())
        box = [w * 0.25, h * 0.2, w * 0.75, h * 0.85]
        clips.append(dict(
            video_path=video, audio_path=audio, frames=n_frames, fps=25.0,
            bboxes=[[v + rng.uniform(-1, 1) for v in box] for _ in range(n_frames)],
            landmarks=[np.stack([rng.uniform(box[0], box[2], 68),
                                 rng.uniform(box[1], box[3], 68)], -1).tolist()
                       for _ in range(n_frames)]))
    (d / "clips.json").write_text(json.dumps(clips))
    (d / "train.yaml").write_text(
        "data:\n  train_bs: 2\n  n_sample_frames: 2\n  num_workers: 2\n"
        "solver:\n  gradient_accumulation_steps: 2\n")
    return str(d / "clips.json"), str(d / "train.yaml")


@pytest.mark.skipif(TM.lib() is None, reason="needs the native libav runtime "
                    "(runtime/libactalker_media.so) to write and read mp4s")
def test_train_main_metadata_cpu_end_to_end_and_resume(tmp_path):
    meta, cfg = _write_corpus(tmp_path)
    out = str(tmp_path / "run")
    res = TR.main(["--config", cfg, "--metadata", meta, "--micro-model",
                   "--steps", "2", "--device", "cpu", "--output", out])
    recs = res["records"]
    assert [r["step"] for r in recs] == [0, 1] and res["final_step"] == 2
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert [r["commit"] for r in recs] == [False, True]
    assert all(r["encode_seconds"] > 0 and r["load_seconds"] >= 0 for r in recs)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert [x["step"] for x in lines] == [0, 1] and all("ts" in x for x in lines)
    assert ckpt.list_checkpoints(out) == [2]
    saved = ckpt.restore_checkpoint(out)["params"]["audio_proj"]
    res2 = TR.main(["--config", cfg, "--metadata", meta, "--micro-model",
                    "--steps", "3", "--device", "cpu", "--output", out],
                   observe=lambda trainer, rec: rec is None and [
                       torch.testing.assert_close(
                           trainer.modules["audio_proj"].state_dict()[k], v)
                       for k, v in saved.items()])
    assert res2["start_step"] == 2 and res2["final_step"] == 3
    assert np.isfinite(res2["records"][0]["loss"])
    assert ckpt.list_checkpoints(out) == [2, 3]
