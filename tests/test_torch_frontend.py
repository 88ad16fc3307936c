"""PyTorch port, the host frontend and the inference config against the JAX
package (CPU): ``preprocess_reference_image``, the bbox helpers,
``log_mel_spectrogram`` (numpy and native paths), ``load_audio`` on a WAV
(the native and the scipy decoders), video read / write, face detection,
``InferenceConfig`` from ``configs/inference.yaml`` and from a ``.py``
config, ``MODE_GATES`` and ``sampler_config``.

The port keeps its own copies of these numpy functions, so they are held to
the JAX package's output exactly; the image readers are held to PIL's
decode exactly.
"""
import dataclasses
import os
import shutil
import wave

import numpy as np
import pytest
from PIL import Image

from actalker_tpu import config as jconfig
from actalker_tpu.frontend import audio as JA
from actalker_tpu.frontend import face as JF
from actalker_tpu.frontend import media_native as JM
from actalker_tpu.frontend import preprocess as JP
from actalker_tpu.frontend import video as JV
from actalker_tpu.frontend import viola_jones as JVJ
from actalker_tpu_torch import config as tconfig
from actalker_tpu_torch.frontend import audio as TA
from actalker_tpu_torch.frontend import face as TF
from actalker_tpu_torch.frontend import media_native as TM
from actalker_tpu_torch.frontend import preprocess as TP
from actalker_tpu_torch.frontend import video as TV
from actalker_tpu_torch.frontend import viola_jones as TVJ
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(h=96, w=80, seed=0):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


def _wav(path, seconds=1.3, rate=16000, channels=1):
    t = np.arange(int(seconds * rate)) / rate
    sig = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.sin(2 * np.pi * 3100 * t))
    pcm = (np.repeat(sig[:, None], channels, 1) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return str(path)


# ---------------------------------------------------------------- images

@pytest.mark.parametrize("bbox", [None, (10.0, 12.0, 60.0, 70.0), (0.0, 30.0, 79.0, 95.0),
                                  (20.5, 8.25, 50.75, 44.5)])
@pytest.mark.parametrize("crop,aspect", [(False, "1:1"), (True, "1:1"), (True, "9:16"),
                                         (True, "16:9")])
def test_preprocess_reference_image_equals_jax(bbox, crop, aspect):
    img = _image()
    kw = dict(image_size=64, area=1.2, crop=crop, expand_ratio=0.9,
              aspect_type=aspect)
    ref = JP.preprocess_reference_image(img, bbox, **kw)
    port = TP.preprocess_reference_image(img, bbox, **kw)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(np.asarray(getattr(port, f.name)),
                                      np.asarray(getattr(ref, f.name)), err_msg=f.name)


@pytest.mark.parametrize("bbox", [(10, 12, 60, 70), (0, 0, 80, 40), (30, 5, 35, 90),
                                  (70, 80, 79, 95)])
@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_bbox_helpers_equal_jax(bbox, ratio):
    assert TP.expand_bbox(bbox, ratio, 96, 80) == JP.expand_bbox(bbox, ratio, 96, 80)
    assert TP.process_bbox(list(bbox), ratio, 96, 80) == \
        JP.process_bbox(list(bbox), ratio, 96, 80)
    for aspect in ("1:1", "16:9", "9:16"):
        assert TP.get_bbox_by_aspect(bbox, aspect, 80, 96) == \
            JP.get_bbox_by_aspect(bbox, aspect, 80, 96)


@pytest.mark.parametrize("hw", [(112, 112), (64, 128), (7, 5)])
def test_resize_image_equals_jax(hw):
    img = _image()
    np.testing.assert_array_equal(TP.resize_image(img, hw), JP.resize_image(img, hw))
    np.testing.assert_array_equal(TP.resize_to_64_multiple(img, 64),
                                  JP.resize_to_64_multiple(img, 64))


def test_resize_without_pil_is_the_nearest_fallback_and_says_so(monkeypatch, capsys):
    img = _image()
    monkeypatch.setattr(TP, "HAVE_PIL", False)
    monkeypatch.setattr(JP, "HAVE_PIL", False)
    monkeypatch.setattr(TP, "_WARNED", [])
    a = TP.resize_image(img, (40, 30))
    b = TP.resize_image(img, (50, 20))
    np.testing.assert_array_equal(a, JP.resize_image(img, (40, 30)))
    np.testing.assert_array_equal(b, JP.resize_image(img, (50, 20)))
    assert capsys.readouterr().err.count("PIL is not installed") == 1


@pytest.mark.parametrize("fmt", ["png", "jpg"])
def test_read_image_equals_pil(tmp_path, fmt, monkeypatch):
    """PIL's decode; without PIL the native runtime's: the same pixels for
    a PNG, within 2 levels on average for a JPEG (libav's chroma upsampling
    differs from PIL's; a smooth image); with neither, a clear error."""
    yy, xx = np.mgrid[:37, :41]
    img = np.stack([yy * 6, xx * 5, (yy + xx) * 3], -1).astype(np.uint8)
    path = str(tmp_path / f"a.{fmt}")
    Image.fromarray(img).save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(TP.read_image(path), want)
    monkeypatch.setattr(TP, "HAVE_PIL", False)
    if TM.lib() is not None:
        got = TP.read_image(path)
        assert got.shape == want.shape
        err = np.abs(got.astype(int) - want)
        assert (err.max() == 0) if fmt == "png" else (err.mean() <= 2)
    monkeypatch.setattr(TM, "lib", lambda: None)
    with pytest.raises(RuntimeError, match="no image decoder"):
        TP.read_image(path)


# ----------------------------------------------------------------- audio

@pytest.mark.parametrize("seconds", [0.7, 2.0, 31.0])
def test_log_mel_numpy_path_equals_jax(seconds):
    a = np.random.default_rng(1).standard_normal(int(seconds * 16000)).astype(np.float32) * 0.1
    np.testing.assert_array_equal(TA.log_mel_spectrogram(a, use_native=False),
                                  JA.log_mel_spectrogram(a, use_native=False))


@pytest.mark.parametrize("seconds", [0.7, 31.0])
def test_log_mel_native_path_equals_jax(seconds):
    if TA.native_lib() is None:
        pytest.skip("runtime/libactalker_mel.so does not load on this machine")
    a = np.random.default_rng(2).standard_normal(int(seconds * 16000)).astype(np.float32) * 0.1
    port = TA.log_mel_spectrogram(a)
    np.testing.assert_array_equal(port, JA.log_mel_spectrogram(a))
    # the native path against the numpy path, as the JAX package holds it
    np.testing.assert_allclose(port, TA.log_mel_spectrogram(a, use_native=False),
                               atol=2e-3)


def test_mel_filterbank_equals_jax():
    np.testing.assert_array_equal(TA.mel_filterbank(), JA.mel_filterbank())


@pytest.mark.parametrize("channels", [1, 2])
def test_load_audio_wav_native_and_scipy(tmp_path, monkeypatch, channels):
    path = _wav(tmp_path / "a.wav", channels=channels)
    np.testing.assert_array_equal(TA.load_audio(path), JA.load_audio(path))
    # no libav runtime and no ffmpeg binary: the scipy branch on both sides
    monkeypatch.setattr(TM, "lib", lambda: None)
    monkeypatch.setattr(JM, "lib", lambda: None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    port = TA.load_audio(path)
    np.testing.assert_array_equal(port, JA.load_audio(path))
    assert port.dtype == np.float32 and len(port) == int(1.3 * 16000)
    mel, frames = TA.whisper_features(path)
    jmel, jframes = JA.whisper_features(path)
    assert frames == jframes == int(1.3 * 16000) // 640
    np.testing.assert_array_equal(mel, jmel)


def test_load_audio_without_a_decoder_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(TM, "lib", lambda: None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no audio decoder"):
        TA.load_audio(str(tmp_path / "a.mp3"))


# ----------------------------------------------------------------- video

def test_video_round_trip_equals_jax(tmp_path):
    if TM.lib() is None:
        pytest.skip("runtime/libactalker_media.so does not load on this machine")
    frames = np.zeros((6, 48, 64, 3), np.uint8)
    for i in range(6):
        frames[i, :, 8 * i:8 * i + 16] = 200
    path = str(tmp_path / "v.mp4")
    TV.write_video(path, frames, fps=12.5)
    got = TV.read_frames(path)
    np.testing.assert_array_equal(got, JV.read_frames(path))
    assert got.shape == frames.shape
    assert np.abs(got.astype(int) - frames).mean() < 4
    np.testing.assert_array_equal(TV.read_frames(path, limit=2), got[:2])
    audio = _wav(tmp_path / "a.wav", seconds=0.5)
    TV.write_video(str(tmp_path / "va.mp4"), frames.astype(np.float32) / 255,
                   audio_path=audio)
    assert TM.video_info(str(tmp_path / "va.mp4"))[:2] == (64, 48)


def test_video_without_an_encoder_raises(tmp_path, monkeypatch):
    """Without the runtime and an ffmpeg binary nothing encodes; OpenCV
    still decodes, as in the JAX package, and only without it too does
    ``read_frames`` raise."""
    import sys

    import cv2

    monkeypatch.setattr(TM, "lib", lambda: None)
    monkeypatch.setattr(JM, "lib", lambda: None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert not TV.have_encoder()
    with pytest.raises(RuntimeError, match="no video encoder"):
        TV.write_video(str(tmp_path / "v.mp4"), np.zeros((1, 8, 8, 3), np.uint8))
    path = str(tmp_path / "c.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (32, 16))
    for i in range(3):
        frame = np.zeros((16, 32, 3), np.uint8)
        frame[:, 8 * i:8 * i + 8] = (40, 120, 220)
        w.write(frame)
    w.release()
    got = TV.read_frames(path)
    assert got.shape == (3, 16, 32, 3)
    np.testing.assert_array_equal(got, JV.read_frames(path))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="no video decoder"):
        TV.read_frames(path)


# ------------------------------------------------------------------ faces

def test_detect_face_takes_any_callable():
    img = _image()
    assert TF.detect_face(img, lambda im: (1.0, 2.0, 3.0, 4.0)) == (1.0, 2.0, 3.0, 4.0)
    assert TF.detect_face(img, lambda im: None) is None

    def broken(im):
        raise ValueError("bad image")

    assert TF.detect_face(img, broken) is None


def test_cascade_detector_equals_jax():
    path = next((p for p in TF.CascadeFaceDetector.CASCADE_PATHS
                 if os.path.exists(p)), None)
    if path is None:
        pytest.skip("no haarcascade model on this machine")
    # a bright oval with two dark eyes and a mouth: enough structure for
    # the cascade's early stages; both evaluators must agree either way
    yy, xx = np.mgrid[:120, :100]
    img = np.full((120, 100), 60.0)
    img[((yy - 60) / 40) ** 2 + ((xx - 50) / 30) ** 2 < 1] = 190
    for cy, cx in ((48, 38), (48, 62)):
        img[cy - 4:cy + 4, cx - 6:cx + 6] = 40
    img[80:86, 38:62] = 70
    port = TVJ.ViolaJones(TVJ.CascadeModel.load(path)).detect(img, min_size=24)
    ref = JVJ.ViolaJones(JVJ.CascadeModel.load(path)).detect(img, min_size=24)
    assert port == ref
    rgb = np.repeat(img[..., None], 3, 2).astype(np.uint8)
    assert TF.CascadeFaceDetector()(rgb) == JF.CascadeFaceDetector()(rgb)
    assert isinstance(TF.resolve_face_detector(), TF.CascadeFaceDetector)


# ----------------------------------------------------------------- config

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_inference_config_from_the_repo_yaml_equals_jax():
    path = os.path.join(ROOT, "configs", "inference.yaml")
    assert _fields(tconfig.load_config(path)) == _fields(jconfig.InferenceConfig.from_yaml(path))


def test_inference_config_from_a_py_file_and_ablation_paths(tmp_path):
    py = tmp_path / "conf.py"
    py.write_text("cfg = {'num_inference_steps': 7, 'fps': 10.0, 'micro_model': True,\n"
                  "       'unet_cls': 'x.v10_wo_audio_wo_id.U',\n"
                  "       'data': {'n_sample_frames': 14},\n"
                  "       'model_paths': {'whisper_model': 'w'}}\n")
    port = tconfig.load_config(str(py))
    ref = jconfig.InferenceConfig.from_dict(jconfig.import_filename(str(py)).cfg)
    assert _fields(port) == _fields(ref)
    assert port.ablate == ("audio", "id") and port.n_sample_frames == 14
    assert port.extras == {"micro_model": True, "unet_cls": "x.v10_wo_audio_wo_id.U"}
    yml = tmp_path / "conf.yaml"
    yml.write_text("num_inference_steps: 9  # steps\nablate: [ssd, id]\n")
    port = tconfig.load_config(str(yml))
    assert port.num_inference_steps == 9 and port.ablate == ("ssd", "id")
    assert _fields(port) == _fields(jconfig.InferenceConfig.from_yaml(str(yml)))


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_mode_gates_and_sampler_config_equal_jax(mode):
    assert tconfig.MODE_GATES == jconfig.MODE_GATES
    cfg = dataclasses.replace(tconfig.InferenceConfig(), num_inference_steps=11,
                              overlap=2, windows_per_call=3, noise_aug_strength=0.02)
    jcfg = dataclasses.replace(jconfig.InferenceConfig(), num_inference_steps=11,
                               overlap=2, windows_per_call=3, noise_aug_strength=0.02)
    port = cfg.sampler_config(tconfig.MODE_GATES[mode])
    ref = jcfg.sampler_config(jconfig.MODE_GATES[mode])
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name)
        got = getattr(port, f.name)
        if f.name == "scheduler":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name


def test_train_and_inference_share_one_reader():
    from actalker_tpu_torch.training import train

    assert train.read_config is tconfig.read_config
