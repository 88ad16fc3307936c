"""PyTorch port, the training data slice against the JAX package (CPU):
the Farnebäck flow and the motion bucket (``frontend/optical_flow.py``),
``PortraitAudioDataset`` and its helpers (``training/data.py``), the
worker-process loader (``training/loader.py``) and the observability
helpers (``utils/observability.py``).

Tolerances: the flow within 1e-3 px of the JAX function's (fp32 both
sides; separable convolutions summed in another order); dataset samples
bitwise on the integer fields and within 1e-5 on the floats (the same numpy
and PIL arithmetic, the same draws from one seed). In the dataset test each
package's ``motion_bucket_from_flow`` is patched to one shared score, so a
rounding edge in the flow cannot change which clip the resample gate picks;
the flow is held on its own above.
"""
import json
import logging
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter, shift

from actalker_tpu.frontend import audio as JA
from actalker_tpu.frontend import optical_flow as JF
from actalker_tpu.training import data as JD
from actalker_tpu.training import loader as JL
from actalker_tpu_torch.frontend import optical_flow as TF
from actalker_tpu_torch.training import data as TD
from actalker_tpu_torch.training import loader as TL
from actalker_tpu_torch.utils import observability as O
from tests.torch_loader_fixtures import IndexDataset, StillFrames
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)


# ------------------------------------------------------------------ flow

def _pair(kind, hw):
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
    if kind == "random":
        return (rng.uniform(0, 255, hw).astype(np.float32),
                rng.uniform(0, 255, hw).astype(np.float32))
    base = gaussian_filter(rng.uniform(0, 255, hw), 2.0)
    return (base.astype(np.float32),
            shift(base, (1.3, -2.1), mode="nearest").astype(np.float32))


@pytest.mark.parametrize("kind,hw", [("translated", (80, 96)),
                                     ("translated", (128, 128)),
                                     ("random", (40, 52)),
                                     ("random", (16, 16))])
def test_farneback_flow_matches_jax(kind, hw):
    a, b = _pair(kind, hw)
    ref = np.asarray(JF.farneback_flow(jnp.asarray(a), jnp.asarray(b)))
    port = TF.farneback_flow(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert port.shape == hw + (2,)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-3)
    if kind == "translated":     # the flow finds the shift
        assert abs(ref[20:-20, 20:-20, 0].mean() + 2.1) < 0.3


def test_farneback_flow_batches_pairs():
    """A batch of pairs gives each pair's flow (the convolutions sum in
    another order at another batch size: the same 1e-3 px)."""
    a, b = _pair("translated", (80, 96))
    c, d = _pair("random", (80, 96))
    both = TF.farneback_flow(torch.from_numpy(np.stack([a, c])),
                             torch.from_numpy(np.stack([b, d])))
    for i, (p, q) in enumerate(((a, b), (c, d))):
        one = TF.farneback_flow(torch.from_numpy(p), torch.from_numpy(q))
        torch.testing.assert_close(both[i], one, rtol=0, atol=1e-3)


@pytest.mark.parametrize("hw,motion", [((32, 40), 0), ((48, 48), 3), ((64, 48), 9)])
def test_get_motion_score_matches_jax(hw, motion):
    rng = np.random.default_rng(motion)
    base = (gaussian_filter(rng.uniform(0, 255, (hw[0] + 40, hw[1] + 40, 3)),
                            (2, 2, 0))).astype(np.uint8)
    frames = np.stack([base[motion * t % 20:motion * t % 20 + hw[0],
                            (2 * motion * t) % 20:(2 * motion * t) % 20 + hw[1]]
                       for t in range(5)])
    assert TF.get_motion_score(frames) == JF.get_motion_score(frames)
    assert TF.get_motion_score(frames[:1]) == 0


# ------------------------------------------------------------- dataset

class _Frames:
    """Seeded frames of a path, drifting by a pixel a frame."""

    def __call__(self, path, idxs):
        rng = np.random.default_rng(sum(map(ord, path)))
        base = rng.integers(0, 255, (72 + 60, 96 + 60, 3)).astype(np.uint8)
        return np.stack([base[i % 60:i % 60 + 72, (i * 2) % 60:(i * 2) % 60 + 96]
                         for i in idxs])


def _audio(path, start):
    rng = np.random.default_rng(sum(map(ord, path)) + start)
    return rng.standard_normal((80, 200)).astype(np.float32), start % 7


def _lmks(rng, n, pts, box):
    return [np.stack([rng.uniform(box[0], box[2], pts), rng.uniform(box[1], box[3], pts)],
                     -1).tolist() for _ in range(n)]


def _clips():
    rng = np.random.default_rng(0)
    box = [20.0, 10.0, 70.0, 66.0]
    boxes = lambda n: [[v + rng.uniform(-2, 2) for v in box] for _ in range(n)]  # noqa: E731
    return [
        dict(video_path="a.mp4", audio_path="a.wav", frames=30, bboxes=boxes(30),
             landmarks=_lmks(rng, 30, 68, box), valid_clip=[2, 28], fps=25.0),
        dict(video_path="b.mp4", frames=12, bboxes=[box]),
        dict(video_path="c.mp4", audio_path="c.wav", frames=40, bboxes=boxes(40),
             landmarks=_lmks(rng, 40, 256, box), fps=30.0),
        dict(video_path="d.mp4", frames=3, bboxes=[box]),     # too short: retried
    ]


def _shared_score(frames, max_value=255):
    """A score in 0..149 from the pixels: about one clip in seven crosses
    the resample gate at 128."""
    return min(int(np.asarray(frames, np.float64).mean() * 100) % 150, max_value)


@pytest.mark.parametrize("deterministic", [False, True])
def test_dataset_samples_equal_jax(monkeypatch, deterministic):
    monkeypatch.setattr(JD, "motion_bucket_from_flow", _shared_score)
    monkeypatch.setattr(TD, "motion_bucket_from_flow", _shared_score)
    kw = dict(n_sample_frames=4, image_size=256, vasa_image_size=64,
              deterministic_shape=deterministic)
    jds = JD.PortraitAudioDataset(_clips(), JD.DataConfig(**kw), _Frames(),
                                  audio_feature_reader=_audio, rng=random.Random(5))
    tds = TD.PortraitAudioDataset(_clips(), TD.DataConfig(**kw), _Frames(),
                                  audio_feature_reader=_audio, rng=random.Random(5))
    gated, load = [], tds._load
    tds._load = lambda i: (lambda r: gated.append(r is None) or r)(load(i))
    got = list(TL.prefetch_batches(tds, 2, list, num_workers=0, num_batches=4,
                                   start=1, stride=3))
    want = list(JL.prefetch_batches(jds, 2, list, num_workers=0, num_batches=4,
                                    start=1, stride=3))
    for gb, wb in zip(got, want, strict=True):
        for g, w in zip(gb, wb, strict=True):
            assert set(g) == set(w)
            for k, v in w.items():
                if isinstance(v, np.ndarray):
                    assert g[k].shape == v.shape and g[k].dtype == v.dtype, k
                    np.testing.assert_allclose(g[k], v, rtol=0, atol=1e-5, err_msg=k)
                else:
                    assert g[k] == v, k
            if deterministic:
                assert g["frames"].shape == (4, 256, 256, 3)
    assert tds.rng.getstate() == jds.rng.getstate()
    assert any(gated)            # the resample gate fired, in both alike


def _unreadable(path, idxs):
    raise OSError(f"cannot decode {path}")


def test_dataset_retries_are_bounded():
    cfg = TD.DataConfig(n_sample_frames=4, retry=3)
    ds = TD.PortraitAudioDataset([_clips()[3]], cfg, _Frames())
    with pytest.raises(RuntimeError, match="retries exhausted") as short:
        ds[0]
    assert ds.resampled == 3 and short.value.__cause__ is not None
    # a reader that fails: the last draw's exception is the cause
    ds = TD.PortraitAudioDataset(_clips()[:2], cfg, _unreadable)
    with pytest.raises(RuntimeError, match="the last raised") as err:
        ds[0]
    assert isinstance(err.value.__cause__, OSError)
    assert "cannot decode" in str(err.value.__cause__) and ds.resampled == 3


@pytest.mark.parametrize("start,n", [(0, 16000 * 4), (700, 16000 * 70),
                                     (745, 16000 * 70), (1490, 16000 * 65),
                                     (60, 16000 * 2)])
def test_slice_audio_window_matches_jax(start, n):
    audio = np.random.default_rng(start).standard_normal(n).astype(np.float32)
    got, off = TD.slice_audio_window(audio, start)
    want, woff = JD.slice_audio_window(audio, start)
    assert off == woff
    np.testing.assert_array_equal(got, want)


def test_readers(tmp_path):
    import wave

    frames = np.random.default_rng(1).integers(0, 255, (6, 8, 10, 3)).astype(np.uint8)
    np.save(tmp_path / "clip.npy", frames)
    np.testing.assert_array_equal(
        TD.NpyFrameReader()(str(tmp_path / "clip.npy"), [4, 1]), frames[[4, 1]])
    t = np.arange(16000 * 3) / 16000
    with wave.open(str(tmp_path / "a.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((0.3 * np.sin(2 * np.pi * 300 * t) * 32767).astype(np.int16).tobytes())
    mel, off = TD.AudioWindowReader()(str(tmp_path / "a.wav"), 10)
    window, woff = JD.slice_audio_window(JA.load_audio(str(tmp_path / "a.wav")), 10)
    assert off == woff and mel.shape == (80, 3000)
    np.testing.assert_allclose(mel, JA.log_mel_spectrogram(window)[:, :3000],
                               rtol=0, atol=1e-5)


def test_load_metadata(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps([{"video_path": "x"}]))
    (tmp_path / "b.json").write_text(json.dumps({"clips": [{"video_path": "y"}]}))
    paths = [str(tmp_path / "a.json"), str(tmp_path / "b.json")]
    assert TD.load_metadata(paths) == JD.load_metadata(paths)


# -------------------------------------------------------------- loader

def _indices(batches):
    return [[k for k, _, _ in b] for b in batches]


@pytest.mark.parametrize("start,stride", [(0, None), (3, 5)])
def test_loader_order_does_not_depend_on_workers(start, stride):
    want = [[(start + i * (stride or 3) + j) % 7 for j in range(3)] for i in range(5)]
    sync = list(TL.prefetch_batches(IndexDataset(7), 3, list, num_workers=0,
                                    num_batches=5, start=start, stride=stride))
    assert _indices(sync) == want
    # the dataset's own rng, drawn in order: the JAX loader's draws
    jax_sync = list(JL.prefetch_batches(IndexDataset(7), 3, list, num_workers=0,
                                        num_batches=5, start=start, stride=stride))
    assert sync == jax_sync
    two = list(TL.prefetch_batches(IndexDataset(7), 3, list, num_workers=2,
                                   num_batches=5, start=start, stride=stride))
    assert _indices(two) == want
    pids = {p for b in two for _, _, p in b}
    assert len(pids) == 2 and not pids & {p for b in sync for _, _, p in b}


def test_loader_stops_its_workers_when_closed():
    gen = TL.prefetch_batches(IndexDataset(4), 1, list, num_workers=2)
    first = next(gen)
    gen.close()
    assert _indices([first]) == [[0]]
    import multiprocessing

    for child in multiprocessing.active_children():
        child.join(timeout=10)
    assert not multiprocessing.active_children()


def test_two_workers_draw_different_augmentations():
    clip = dict(video_path="still.mp4", frames=20, bboxes=[[12.0, 8.0, 52.0, 44.0]])
    ds = TD.PortraitAudioDataset([clip], TD.DataConfig(n_sample_frames=4, image_size=128,
                                                       vasa_image_size=32),
                                 StillFrames())
    b0, b1 = TL.prefetch_batches(ds, 1, list, num_workers=2, num_batches=2, seed=3)
    s0, s1 = b0[0], b1[0]
    # batch 0 comes from worker 0, batch 1 from worker 1: their rngs were
    # seeded apart, so the crop / jitter draws differ
    assert not np.array_equal(s0["vasa_face"], s1["vasa_face"])
    assert s0["motion_bucket_flow"] == s1["motion_bucket_flow"] == 0
    assert TL.worker_seed(3, 0) != TL.worker_seed(3, 1)
    for s in (s0, s1):
        assert not any(torch.is_tensor(v) for v in s.values())


# -------------------------------------------------------- observability

def test_metrics_emitter_and_logger(tmp_path, caplog):
    path = tmp_path / "m.jsonl"
    em = O.MetricsEmitter(str(path))
    rec = em.emit(step=1, loss=0.5)
    em.emit(step=2, loss=0.25, ts=7.0)
    em.close()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0] == rec and lines[0]["step"] == 1 and "ts" in lines[0]
    assert lines[1] == {"step": 2, "loss": 0.25, "ts": 7.0}
    logger = O.get_logger()
    assert O.get_logger("other") is logger      # one logger, as in the JAX module
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.INFO, logger=logger.name):
            O.MetricsEmitter().emit(step=2)
    finally:
        logger.removeHandler(caplog.handler)
    assert "metric" in caplog.text and "'step': 2" in caplog.text
