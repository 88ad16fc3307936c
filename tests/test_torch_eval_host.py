"""PyTorch port, the evaluation harness's host side and entry point against
the JAX package (CPU):

* metrics (PSNR, SSIM, L1, the Fréchet distance, FID / FVD through a
  plugged extractor, identity cosine, shift scores), MFCC, scene cuts,
  tracks, face tubes, ``calc_pdist`` / ``score_tube``: the port's copies
  on the same numpy inputs, equal to 1e-12 (float64 host code);
* ``SyncEvaluator.evaluate_tube`` on a seeded 30-frame tube with one
  SyncNet file: the same offset, confidence and distance to rel 1e-4 (the
  towers' fp32 tolerance of ``test_torch_evaluation.py``);
* ``pose_metrics`` through the port's HeadPose on the JAX tower's
  exported parameters (rel 1e-4) and ``compose`` (its frames equal);
* ``run_eval.run`` end to end on written mp4 clips (with audio), reference
  clips and images, and the six seeded weight files
  (``tools/eval_weights.py``): every record equal to the JAX ``run``'s on
  the same files (rel 1e-3 of each rounded score; FID over four frames of
  2048 features, FVD over two clips); a missing file skips its metric
  alone; a corrupt file raises.
"""
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from actalker_tpu.evaluation import compose as JC
from actalker_tpu.evaluation import metrics as JM
from actalker_tpu.evaluation import pose_metrics as JP
from actalker_tpu.evaluation import run_eval as JR
from actalker_tpu.evaluation import sync_eval as JS
from actalker_tpu.evaluation.syncnet import convert_syncnet
from actalker_tpu.models.vasa import HeadPose as JHeadPose
from actalker_tpu_torch.evaluation import compose as C
from actalker_tpu_torch.evaluation import metrics as M
from actalker_tpu_torch.evaluation import pose_metrics as PM
from actalker_tpu_torch.evaluation import run_eval as R
from actalker_tpu_torch.evaluation import sync_eval as S
from actalker_tpu_torch.evaluation.syncnet import SyncNet
from actalker_tpu_torch.frontend import media_native, video as V
from actalker_tpu_torch.io.jax_export import export_vasa_pose
from actalker_tpu_torch.io.weights import to_torch
from actalker_tpu_torch.models.vasa import HeadPose
from actalker_tpu_torch.tools.eval_weights import seeded, write_seeded_weights
from tests.torch_parity import rel_l2, seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)

needs_codec = pytest.mark.skipif(media_native.lib() is None,
                                 reason="no video encoder on this machine")


def _rng(seed):
    return np.random.default_rng(seed)


def test_metrics_equal_jax():
    r = _rng(0)
    a, b = r.uniform(0, 1, (20, 17, 3)), r.uniform(0, 1, (20, 17, 3))
    for fn in ("psnr", "ssim", "l1"):
        assert getattr(M, fn)(a, b) == pytest.approx(getattr(JM, fn)(a, b), rel=1e-12)
    x, y = r.standard_normal((300, 6)), r.standard_normal((300, 6)) + 0.3
    sx, sy = M.activation_statistics(x), M.activation_statistics(y)
    assert M.frechet_distance(*sx, *sy) == pytest.approx(
        JM.frechet_distance(*JM.activation_statistics(x), *JM.activation_statistics(y)),
        rel=1e-12)
    feats = lambda f: np.asarray(f).reshape(len(f), -1)  # noqa: E731
    real = [r.standard_normal((2, 2, 3)) for _ in range(40)]
    fake = [r.standard_normal((2, 2, 3)) + 0.5 for _ in range(40)]
    assert M.fid(real, fake, feats, batch=7) == pytest.approx(
        JM.fid(real, fake, feats, batch=7), rel=1e-12)
    clips = r.standard_normal((6, 3, 2, 2, 3)), r.standard_normal((6, 3, 2, 2, 3))
    assert M.fvd(*clips, feats) == pytest.approx(JM.fvd(*clips, feats), rel=1e-12)
    ref = r.standard_normal((4, 4, 3))
    frames = r.standard_normal((5, 4, 4, 3))
    assert M.identity_cosine(ref, frames, feats) == pytest.approx(
        JM.identity_cosine(ref, frames, feats), rel=1e-12)
    emb = r.standard_normal((30, 8))
    assert M.sync_scores(emb, np.roll(emb, 3, 0), 6) == JM.sync_scores(
        emb, np.roll(emb, 3, 0), 6)


def test_sync_host_steps_equal_jax():
    r = _rng(1)
    sig = (r.standard_normal(16000) * 3000).astype(np.int16)
    np.testing.assert_allclose(S.mfcc(sig), JS.mfcc(sig), rtol=1e-12, atol=1e-12)
    clip = np.concatenate([np.full((20, 48, 64, 3), 40, np.uint8),
                           r.integers(0, 255, (25, 48, 64, 3), dtype=np.uint8)])
    assert S.scene_detect(clip, min_scene_len=5) == JS.scene_detect(clip, min_scene_len=5)
    faces = [[] if i in (40, 41) else
             [{"frame": i, "bbox": [10 + i, 20, 130 + i, 140], "conf": 1.0},
              {"frame": i, "bbox": [300, 300, 330, 330], "conf": 0.9}]
             for i in range(130)]
    got, want = S.track_shot(faces), JS.track_shot(faces)
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0]["frame"], want[0]["frame"])
    np.testing.assert_array_equal(got[0]["bbox"], want[0]["bbox"])
    frames = r.integers(0, 255, (14, 120, 160, 3), dtype=np.uint8)
    track = {"frame": np.arange(14), "bbox": np.tile([50.0, 30.0, 110.0, 90.0], (14, 1))
             + r.uniform(-3, 3, (14, 4))}
    np.testing.assert_array_equal(S.crop_face_tube(frames, track),
                                  JS.crop_face_tube(frames, track))
    f1, f2 = r.standard_normal((30, 16)), r.standard_normal((30, 16))
    np.testing.assert_array_equal(S.calc_pdist(f1, f2, 5), JS.calc_pdist(f1, f2, 5))
    assert S.score_tube(f1, f2, 5) == JS.score_tube(f1, f2, 5)


def test_evaluate_tube_matches_jax():
    """A seeded 30-frame tube and its 1.2 s of audio through both packages'
    SyncEvaluator; a tube shorter than one window raises ValueError in
    both."""
    net = seeded(SyncNet, 4)
    r = _rng(2)
    tube = r.integers(0, 255, (30, 224, 224, 3), dtype=np.uint8)
    audio = (r.standard_normal(int(30 / 25 * 16000)) * 3000).astype(np.int16)
    got = S.SyncEvaluator(syncnet=net).evaluate_tube(tube, audio)
    params = convert_syncnet({k: v.numpy() for k, v in net.state_dict().items()})
    want = JS.SyncEvaluator(syncnet_params=params).evaluate_tube(tube, audio)
    assert got[0] == want[0]
    assert got[1:] == pytest.approx(want[1:], rel=1e-4)
    with pytest.raises(ValueError, match="too short"):
        S.SyncEvaluator(syncnet=net).evaluate_tube(tube[:5], audio[:3200])


def test_pose_metrics_through_the_port_tower():
    spec = jax.eval_shape(JHeadPose().init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 256, 256, 3)))
    params = seeded_params(spec, 3)
    tower = HeadPose()
    tower.load_state_dict(to_torch(export_vasa_pose(params)), strict=True)
    r = _rng(3)
    gen, drv = r.uniform(0, 1, (2, 4, 256, 256, 3)).astype(np.float32)
    jt = jax.jit(lambda x: JHeadPose().apply(params, x))
    pt = PM.tower_apply(tower.eval())
    for clip in (gen, drv):
        g, w = PM.pose_trajectory(clip, pt, batch=3), JP.pose_trajectory(clip, jt, batch=3)
        for k in ("rotation", "translation"):
            assert rel_l2(g[k], w[k]) < 1e-4, k
    got, want = PM.evaluate_pose(gen, drv, pt), JP.evaluate_pose(gen, drv, jt)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-4), k
    traj = {"rotation": r.standard_normal((9, 3)), "translation": r.standard_normal((9, 3))}
    assert PM.pose_metrics(traj, traj) == JP.pose_metrics(traj, traj)


@needs_codec
def test_compose_equals_jax(tmp_path):
    r = _rng(4)
    frames = r.integers(0, 255, (5, 32, 24, 3), dtype=np.uint8)
    clip = str(tmp_path / "c.mp4")
    V.write_video(clip, frames, fps=8.0)
    image = r.integers(0, 255, (20, 30, 3), dtype=np.uint8)
    got = C.concat_video_with_image(clip, image, str(tmp_path / "p.mp4"))
    want = JC.concat_video_with_image(clip, image, str(tmp_path / "j.mp4"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(V.read_frames(str(tmp_path / "p.mp4")),
                                  V.read_frames(str(tmp_path / "j.mp4")))


# ---------------------------------------------------------------- run_eval

def _wav(path, seconds, seed):
    t = np.arange(int(seconds * 16000)) / 16000
    tone = 0.3 * np.sin(2 * np.pi * (200 + 50 * seed) * t)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((tone * 32767).astype(np.int16).tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two generated clips and their references (16 frames at 128 px, 25
    fps, a tone as audio), a reference image each, and the six seeded
    weight files."""
    if media_native.lib() is None:
        pytest.skip("no video encoder on this machine")
    root = tmp_path_factory.mktemp("eval")
    dirs = {k: root / k for k in ("gen", "ref", "img")}
    for d in dirs.values():
        d.mkdir()
    for i in range(2):
        r = _rng(10 + i)
        base = r.integers(30, 220, (1, 128, 128, 3))
        wav = str(root / f"a{i}.wav")
        _wav(wav, 16 / 25, i)
        for kind, shift in (("gen", 0), ("ref", 6)):
            drift = (np.arange(16) % 5)[:, None, None, None] * 3 + shift
            clip = np.clip(base + drift, 0, 255).astype(np.uint8)
            V.write_video(str(dirs[kind] / f"clip{i}.mp4"), clip, fps=25.0,
                          audio_path=wav)
        from PIL import Image

        Image.fromarray(r.integers(0, 255, (96, 80, 3), dtype=np.uint8)).save(
            str(dirs["img"] / f"clip{i}.png"))
    weights = str(root / "weights")
    write_seeded_weights(weights, seed=0)
    return {k: str(v) for k, v in dirs.items()}, weights


def _close_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), (g.keys(), w.keys())
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=1e-3, abs=2e-4), (k, g[k], v)
            else:
                assert g[k] == v, k


def test_run_eval_equals_jax_run(corpus, tmp_path):
    dirs, weights = corpus
    args = (dirs["gen"], dirs["ref"], dirs["img"], weights)
    got = R.run(*args, str(tmp_path / "p.jsonl"), fid_frames_per_clip=1, device="cpu")
    want = JR.run(*args, str(tmp_path / "j.jsonl"), fid_frames_per_clip=1)
    _close_records(got, want)
    summary = got[-1]
    assert all(summary[k] is not None for k in ("id_cosine", "psnr", "l1", "lpips",
                                                "fid", "fvd"))
    assert all(r["sync_note"] == "no face track" for r in got[:-1])
    with open(tmp_path / "p.jsonl") as f:
        assert [json.loads(x) for x in f] == got


def test_run_eval_skips_only_a_missing_file(corpus, tmp_path, capsys):
    dirs, weights = corpus
    some = tmp_path / "w"
    some.mkdir()
    os.symlink(os.path.join(weights, "lpips_alex.pth"), some / "lpips_alex.pth")
    recs = R.main(["--video_dir", dirs["gen"], "--ref_video_dir", dirs["ref"],
                   "--weights_dir", str(some), "--out", str(tmp_path / "o.jsonl"),
                   "--device", "cpu"])
    summary = recs[-1]
    assert summary["lpips"] is not None and summary["psnr"] is not None
    assert all(summary.get(k) is None for k in ("sync_c", "id_cosine", "fid", "fvd"))
    err = capsys.readouterr().err
    for name in ("syncnet_v2.model", "pt_inception-2015-12-05.pth",
                 "i3d_rgb_charades.pt"):
        assert name in err and "metric skipped" in err


def test_run_eval_raises_on_a_corrupt_file(corpus, tmp_path):
    dirs, weights = corpus
    bad = tmp_path / "w"
    bad.mkdir()
    (bad / "pt_inception-2015-12-05.pth").write_bytes(b"not a checkpoint")
    with pytest.raises(Exception) as info:
        R.run(dirs["gen"], dirs["ref"], None, str(bad), str(tmp_path / "o.jsonl"),
              device="cpu")
    assert not isinstance(info.value, SystemExit)


def test_run_eval_reads_npy_clips_with_wavs(corpus, tmp_path):
    """``--npy``: the clips as .npy stacks with their WAVs beside give the
    decoded mp4s' records."""
    dirs, weights = corpus
    npy = {k: tmp_path / k for k in ("gen", "ref")}
    for k, d in npy.items():
        d.mkdir()
        for i in range(2):
            src = os.path.join(dirs[k], f"clip{i}.mp4")
            np.save(d / f"clip{i}.npy", V.read_frames(src))
            _wav(str(d / f"clip{i}.wav"), 16 / 25, i)
    some = tmp_path / "w"
    some.mkdir()
    os.symlink(os.path.join(weights, "lpips_alex.pth"), some / "lpips_alex.pth")
    got = R.main(["--video_dir", str(npy["gen"]), "--ref_video_dir", str(npy["ref"]),
                  "--weights_dir", str(some), "--out", str(tmp_path / "n.jsonl"),
                  "--device", "cpu", "--npy"])
    want = R.run(dirs["gen"], dirs["ref"], None, str(some), str(tmp_path / "v.jsonl"),
                 device="cpu")
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        g["clip"] = w["clip"] = None
        assert g == w
