"""PyTorch port, the data tools and the remnants against the JAX package on
the CPU:

* ``tools/curate_data.py``: the port's records on written mp4 clips equal
  the JAX tool's (every field; floats within 1e-6), both packages'
  ``load_metadata`` read them, a ``.npy`` frame stack gives the JAX tool's
  record on the same frames (its audio the ``.wav`` beside it), the
  host errors drop a clip and say why, and ``--yoloface`` makes one
  network pass a frame;
* ``tools/loader_throughput.py`` on a tiny corpus, its JSON line;
* ``ops/resize.resize_with_antialiasing``: relative L2 5e-5 and max abs
  1e-4 of the JAX one on N(0, 1) images (a torch conv and bicubic against
  the JAX package's fp32 weight matrices);
* ``utils/observability``: ``device_trace``, ``seed_everything``;
* pre-encoded batches: ``synthetic_batches(raw_heads=False)`` equals the
  JAX generator's, and the loss and every UNet gradient of the port's
  step over ``{"unet": unet}`` equal the JAX step's on a bare UNet apply
  (``diffusion_loss`` under ``jax.value_and_grad``, the four draws from
  the same keys), with samples dropped and with none: loss rel 1e-5,
  gradients rel L2 1e-4, as the raw-head test in ``test_torch_train.py``.
"""
import importlib.util
import json
import os
import random
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.io import weights as W
from actalker_tpu.io.init import init_pipeline_params
from actalker_tpu.models.unet import UNetConfig as JUNetConfig
from actalker_tpu.ops.resize import resize_with_antialiasing as j_resize
from actalker_tpu.pipeline.pipeline import PipelineModules as JModules
from actalker_tpu.training import data as JData
from actalker_tpu.training import trainer as JT
from actalker_tpu.training.train import synthetic_batches as j_batches
from actalker_tpu_torch.frontend import media_native as TM
from actalker_tpu_torch.frontend import video as TV
from actalker_tpu_torch.io import weights as TW
from actalker_tpu_torch.models import yoloface as TY
from actalker_tpu_torch.models.unet import UNetConfig
from actalker_tpu_torch.ops.resize import resize_with_antialiasing
from actalker_tpu_torch.tools import curate_data as TC
from actalker_tpu_torch.tools import eval_weights, loader_throughput
from actalker_tpu_torch.training import data as TData
from actalker_tpu_torch.training import train as TR
from actalker_tpu_torch.training import trainer as T
from actalker_tpu_torch.utils import observability as O
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_codec = pytest.mark.skipif(TM.lib() is None,
                                 reason="native media runtime unavailable")


def _jax_tool():
    """The JAX package's ``tools/curate_data.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_curate_data", os.path.join(ROOT, "tools", "curate_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _face_frames(n, hw, seed, drift=1):
    """The loader tool's toy face (a bright block with eyes and a mouth)
    moving ``drift`` px a frame, with grain."""
    s = hw // 64
    rng = np.random.default_rng(seed)
    frames = np.full((n, hw, hw, 3), 40, np.uint8)
    for i in range(n):
        x = (14 + i * drift % 6) * s
        frames[i, 10 * s:54 * s, x:x + 36 * s] = 180
        frames[i, 20 * s:28 * s, x + 6 * s:x + 14 * s] = 60
        frames[i, 20 * s:28 * s, x + 22 * s:x + 30 * s] = 60
        frames[i, 38 * s:46 * s, x + 10 * s:x + 26 * s] = 90
    return np.clip(frames.astype(np.int16) + rng.integers(-12, 12, frames.shape,
                                                          np.int16), 0, 255).astype(np.uint8)


def _wav(path, seconds=1.0):
    t = np.arange(int(16000 * seconds)) / 16000
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((0.2 * np.sin(2 * np.pi * 220 * t) * 32767).astype(np.int16).tobytes())


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], float):
                assert abs(g[k] - w[k]) <= 1e-6 * max(1.0, abs(w[k])), k
            elif k in ("bboxes", "landmarks"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6, err_msg=k)
            else:
                assert g[k] == w[k], k


# ------------------------------------------------------------ curate_data

@needs_codec
def test_curate_data_matches_the_jax_tool(tmp_path, capsys):
    clips = []
    for c, (hw, n) in enumerate(((128, 10), (96, 7))):
        path = str(tmp_path / f"clip{c}.mp4")
        TV.write_video(path, _face_frames(n, hw, c).astype(np.float32) / 255.0, fps=25.0)
        clips.append(path)
    bad = str(tmp_path / "broken.mp4")
    with open(bad, "wb") as f:
        f.write(b"not a video")
    argv = clips + [bad, "--stride", "2", "--max-frames", "4"]
    got = TC.main([str(tmp_path / "port.json")] + argv + ["--device", "cpu"])
    assert got["dropped"] == 1
    assert "skip" in capsys.readouterr().err
    _jax_tool().main([str(tmp_path / "jax.json")] + argv)
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    _same_records(got["clips"], want)
    assert [r["frames"] for r in want] == [4, 4]
    # both packages' loaders read the port's file
    port = TData.load_metadata([str(tmp_path / "port.json")])
    jax_read = JData.load_metadata([str(tmp_path / "port.json")])
    _same_records(port, want)
    _same_records(jax_read, want)


def test_curate_data_reads_npy_stacks(tmp_path, monkeypatch, capsys):
    """A ``.npy`` stack (the card's machine has no video decoder): the JAX
    tool's record on the same frames, with the ``.wav`` beside it as the
    audio and ``--npy-fps`` as the rate; a stack without its WAV, one of a
    single frame and a missing file are dropped with their reasons."""
    frames = _face_frames(9, 64, 5)
    npy = str(tmp_path / "clip.npy")
    np.save(npy, frames)
    _wav(str(tmp_path / "clip.wav"))
    np.save(str(tmp_path / "nowav.npy"), frames)
    np.save(str(tmp_path / "one.npy"), frames[:1])
    _wav(str(tmp_path / "one.wav"))
    out = TC.main([str(tmp_path / "m.json"), npy, str(tmp_path / "nowav.npy"),
                   str(tmp_path / "one.npy"), str(tmp_path / "missing.mp4"),
                   "--npy-fps", "12.5", "--device", "cpu"])
    err = capsys.readouterr().err
    assert out["dropped"] == 3
    assert "no nowav.wav" in err and "1 frame(s)" in err and "no such file" in err
    rec, = out["clips"]
    assert rec["audio_path"] == os.path.abspath(str(tmp_path / "clip.wav"))
    assert rec["fps"] == 12.5 and rec["frames"] == 9
    jtool = _jax_tool()
    from actalker_tpu.frontend import video as JV

    monkeypatch.setattr(JV, "read_frames", lambda path, limit=None: frames[:limit])
    monkeypatch.setattr(JV, "get_fps", lambda path: 12.5)
    from actalker_tpu.frontend.face import detect_face

    want = jtool.curate_video(npy, lambda img: detect_face(img), None)
    want["audio_path"] = rec["audio_path"]
    _same_records([rec], [want])


def test_curate_data_yoloface_one_pass_a_frame(tmp_path):
    """``--yoloface`` with a seeded yolov5m-face file (its objectness and
    face logits lifted so that every frame has detections): one network
    pass a frame gives the box (the best score) and the 5 landmarks (the
    best overlap by score), as the detector gives them; without a card,
    ``--device cuda`` (the default) raises."""
    net = eval_weights.seeded(TY.YoloFaceNet, 3)
    with torch.no_grad():
        for conv in net.model[23].m:
            conv.bias.view(3, 16)[:, 4].add_(8.0)
            conv.bias.view(3, 16)[:, 15].add_(8.0)
    path = str(tmp_path / "yolov5m-face.pth")
    torch.save(net.state_dict(), path)
    frames = _face_frames(3, 64, 7)
    np.save(str(tmp_path / "c.npy"), frames)
    _wav(str(tmp_path / "c.wav"))
    out = TC.main([str(tmp_path / "m.json"), str(tmp_path / "c.npy"),
                   "--yoloface", path, "--device", "cpu"])
    assert out["detector"].passes == 3
    rec, = out["clips"]
    det = TY.YoloFaceDetector(net)
    for fr, box, lm in zip(frames, rec["bboxes"], rec["landmarks"]):
        bboxes, kpss, scores = det.detect(fr[..., ::-1])
        x, y, w, h = bboxes[np.argmax(scores)]
        np.testing.assert_allclose(box, [x, y, x + w, y + h], rtol=0, atol=1e-4)
        assert len(lm) == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.main([str(tmp_path / "m2.json"), str(tmp_path / "c.npy")])


# ------------------------------------------------------- loader_throughput

def test_loader_throughput_prints_its_json_line(capsys):
    out = loader_throughput.main(
        ["--device", "cpu", "--micro-model", "--size", "64", "--batch", "2",
         "--frames", "2", "--batches", "2", "--workers", "1", "--clips", "2",
         "--clip-frames", "12"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert line["metric"] == "loader_samples_per_s_64px_2f_bs2_w1"
    assert line["value"] > 0 and line["sec_per_global_batch"] > 0
    assert line["card"] is None


# ----------------------------------------------------------------- remnants

@pytest.mark.parametrize("shape,out", [((2, 3, 64, 48), (24, 20)),
                                       ((1, 3, 256, 256), (112, 112)),
                                       ((3, 40, 40), (60, 30))])
def test_resize_with_antialiasing_matches_jax(shape, out):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = resize_with_antialiasing(torch.from_numpy(x), *out).numpy()
    ref = np.asarray(j_resize(jnp.asarray(x), *out))
    assert got.shape == ref.shape == shape[:-2] + out
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 5e-5
    assert np.abs(got - ref).max() < 1e-4


def test_device_trace_and_seeding(tmp_path):
    with O.device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert prof.trace_path == str(tmp_path / "trace" / "trace.json")
    assert any("mm" in str(e.get("name", "")) for e in events)

    def draws():
        return (random.random(), float(np.random.rand()), float(torch.rand(1)))

    O.seed_everything(7)
    first = draws()
    O.seed_everything(7)
    assert draws() == first
    O.seed_everything(8)
    assert draws() != first


# ------------------------------------------------------ pre-encoded batches

def test_pre_encoded_synthetic_batches_equal_jax():
    jb = next(j_batches(2, 2, 8, 32, seed=4, raw_heads=False))
    pb = next(TR.synthetic_batches(2, 2, 8, seed=4, raw_heads=False, c0=32))
    for k, v in jb._asdict().items():
        if v is None:
            assert getattr(pb, k) is None, k
        else:
            np.testing.assert_array_equal(getattr(pb, k).numpy(), np.asarray(v), err_msg=k)
    assert pb.audio_tokens.shape == (2, 2, 32, 1024) and pb.pose_fea.shape == (2, 2, 8, 8, 32)


@pytest.fixture(scope="module")
def micro_unet():
    jmods = JModules.create(unet_config=JUNetConfig(scan_impl="blocked").micro(),
                            dtype=jnp.float32)
    full = init_pipeline_params(jmods, jax.random.PRNGKey(0), image_size=(64, 64),
                                latent_size=(8, 8), use_eval_shape=True, seed=0)
    ucfg = UNetConfig().micro()
    unet = TR.build_modules(ucfg, "cpu", torch.float32)["unet"]
    TW.load_unet(unet, *TW.unet_state_dicts_from_jax(full["unet"], ucfg))
    return jmods, full["unet"], unet, ucfg


def _keys_by_drop(cfg, b):
    """A key whose dropout draw drops some but not all of ``b`` samples, and
    one that drops none."""
    found = {}
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        drop = np.asarray(jax.random.bernoulli(jax.random.split(key, 4)[3],
                                               cfg.cond_dropout_prob, (b,)))
        kind = "none" if not drop.any() else "some" if not drop.all() else None
        if kind and kind not in found:
            found[kind] = key
        if len(found) == 2:
            return found
    raise AssertionError("no keys found")


def test_pre_encoded_step_matches_jax(micro_unet):
    jmods, jparams, unet, ucfg = micro_unet
    cfg, jcfg = T.TrainConfig(cond_dropout_prob=0.5), JT.TrainConfig(cond_dropout_prob=0.5)
    jbatch = next(j_batches(2, 2, 8, 32, seed=6, raw_heads=False))
    pbatch = T.TrainBatch(**{k: torch.from_numpy(np.array(v))
                             for k, v in jbatch._asdict().items() if v is not None})
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, key: JT.diffusion_loss(jmods.unet.apply, p, jbatch, key, jcfg,
                                         dtype=jnp.float32), has_aux=True))
    kwargs = W.unet_block_kwargs(ucfg)
    for kind, key in sorted(_keys_by_drop(jcfg, 2).items()):
        (jloss, _), jgrads = grad_fn(jparams, key)
        k_sig, k_noise, k_off, k_drop = jax.random.split(key, 4)
        draws = T.LossDraws(*(torch.from_numpy(np.array(x)) for x in (
            jax.random.normal(k_sig, (2,)), jax.random.normal(k_noise, jbatch.latents.shape),
            jax.random.normal(k_off, (2, 1, 1, 1, 1)),
            jax.random.bernoulli(k_drop, 0.5, (2,)))))
        assert draws.drop.any() == (kind == "some")
        unet.zero_grad(set_to_none=True)
        loss, _ = T.diffusion_loss({"unet": unet}, pbatch, cfg, draws=draws,
                                   dtype=torch.float32)
        loss.backward()
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss)), kind
        want = W.export_unet(jgrads, **kwargs)
        got = dict(unet.named_parameters())
        flat = np.concatenate([np.zeros(got[k].numel(), np.float32) if got[k].grad is None
                               else got[k].grad.numpy().ravel() for k in want])
        ref = np.concatenate([np.ravel(g) for g in want.values()])
        assert np.linalg.norm(flat - ref) / np.linalg.norm(ref) < 1e-4, kind
    # the trainer over the UNet alone takes the batch and commits
    trainer = T.Trainer({"unet": unet}, T.TrainConfig(grad_accum_steps=1), torch.float32)
    m = trainer.step(pbatch, draws=draws)
    assert m["commit"] and np.isfinite(float(m["loss"]))
