"""PyTorch port, the CLI's face stack against the JAX package on the CPU:
YOLOv5-face, SCRFD and RTMPose (the face6 geometry: 106 keypoints, 256 x
256) at narrow widths, their host tails, the landmark estimators, the
order in which ``resolve_face_detector`` / ``resolve_landmark_estimator``
take them, and the CLI end to end with every pass on. Seeded JAX
parameters (``tests/torch_parity.py``) go through the port's exporters
into reference-keyed state dicts, which load with ``strict=True``; the
same seeded numpy inputs go through both packages.

Tolerances (fp32 on both sides):
  * the raw network outputs (yolo's (N, 16) predictions, SCRFD's per-stride
    score / box / kps maps, RTMPose's SimCC logits): relative L2 1e-5. On
    seeded weights the detections themselves are arbitrary, and an fp32
    summation order can move a SimCC argmax, so the tails are held
    separately:
  * the host tails (letterbox, NMS, ``distance2*``, anchor centres, the
    confidence filter, the rescale, the top-down crop, the SimCC decode, the
    5-point reductions) exactly, on fixed arrays given to both packages;
    the yolo letterbox (a resize on the device in the port; the two
    resizers compute their fp32 weights differently) max abs 5e-5 on [0, 1],
    an eightieth of a grey level;
  * SCRFD's GroupNorm: the port keeps mmdet's eps 1e-5, the JAX package
    flax's 1e-6. Held at 1e-5 with the port's eps set to 1e-6, and at 1e-3
    as it stands.
At published widths, each port module's state dict round-trips through its
exporter and converter to the JAX ``init``'s shapes (``jax.eval_shape``).
"""
import argparse
import functools
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from actalker_tpu.frontend import face as JF
from actalker_tpu.frontend import landmarks as JL
from actalker_tpu.models import rtmpose as JR
from actalker_tpu.models import scrfd as JS
from actalker_tpu.models import yoloface as JY
from actalker_tpu_torch import cli
from actalker_tpu_torch.frontend import face as TF
from actalker_tpu_torch.frontend import landmarks as TL
from actalker_tpu_torch.frontend import media_native as TM
from actalker_tpu_torch.io import jax_export as X
from actalker_tpu_torch.models import rife as TRI
from actalker_tpu_torch.models import rtmpose as TR
from actalker_tpu_torch.models import scrfd as TS
from actalker_tpu_torch.models import stylegan2 as TG
from actalker_tpu_torch.models import teeth as TT
from actalker_tpu_torch.models import yoloface as TY
from tests.torch_parity import load, rel_l2, seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)

YOLO_SMALL = dict(width_multiple=0.25, depth_multiple=0.34)
RTM_FACE_SMALL = dict(widen=0.25, deepen=0.34, num_keypoints=106,
                      input_size=(256, 256), gau_hidden=64, gau_s=32)


class Fixed(torch.nn.Module):
    """A network stand-in that returns fixed outputs (the tails' inputs)."""

    def __init__(self, out, cfg=None):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.out, self.cfg = out, cfg

    def forward(self, x):
        return self.out


def _image(h, w, seed):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


# ------------------------------------------------------------ YOLOv5-face

def test_yoloface_matches_jax():
    jnet = JY.YoloFaceNet(JY.YoloFaceConfig(**YOLO_SMALL))
    x = np.random.default_rng(0).random((1, 64, 96, 3)).astype(np.float32)
    params = seeded_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x), 0)
    net = TY.YoloFaceNet(TY.YoloFaceConfig(**YOLO_SMALL))
    load(net, X.export_yoloface(params, net.state_dict().keys()))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    ref = np.asarray(jnet.apply(params, x))
    assert got.shape == ref.shape == (1, 3 * (8 * 12 + 4 * 6 + 2 * 3), 16)
    assert rel_l2(got, ref) < 1e-5
    # the JAX converter on the port's (reference-keyed) state dict: the
    # same network
    jparams = JY.convert_yoloface({k: v.numpy() for k, v in net.state_dict().items()})
    assert rel_l2(got, jnet.apply(jparams, x)) < 1e-5


def test_yoloface_tail_matches_jax():
    """Letterbox, confidence filter, NMS and rescale on fixed predictions."""
    rng = np.random.default_rng(1)
    n = 400
    xy = rng.uniform(0, 400, (n, 2))
    wh = rng.uniform(10, 120, (n, 2))
    pred = np.concatenate([xy, wh, rng.uniform(0.3, 1, (n, 1)),
                           rng.uniform(0, 400, (n, 10)), rng.uniform(0.4, 1, (n, 1))],
                          1).astype(np.float32)
    img = _image(300, 380, 2)
    jdet = JY.YoloFaceDetector(params={}, cfg=JY.YoloFaceConfig(**YOLO_SMALL))
    jdet._apply = lambda p, x: pred[None]
    tdet = TY.YoloFaceDetector(Fixed(torch.from_numpy(pred)[None]))
    for got, ref in zip(tdet.detect(img), jdet.detect(img)):
        np.testing.assert_array_equal(got, ref)
    assert len(tdet.detect(img)[0]) > 1
    assert tdet(img[..., ::-1]) == jdet(img[..., ::-1])
    boxes = np.concatenate([xy, xy + wh], 1)
    np.testing.assert_array_equal(TY.nms_xyxy(boxes, pred[:, 4], 0.45),
                                  JY.nms_xyxy(boxes, pred[:, 4], 0.45))
    # the letterbox (416 short side, multiples of 32): bilinear with
    # antialiasing, as jax.image.resize
    x = tdet.letterbox(img).numpy()[0]
    ref = np.asarray(jax.image.resize(jnp.asarray(img[..., ::-1].astype(np.float32)),
                                      x.shape, "bilinear")) / 255.0
    assert x.shape == (416, 544, 3)
    np.testing.assert_allclose(x, ref, atol=5e-5, rtol=0)


# ------------------------------------------------------------------ SCRFD

def test_scrfd_matches_jax():
    jcfg = JS.ScrfdConfig().micro()
    jnet = JS.ScrfdNet(jcfg)
    x = np.random.default_rng(3).uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    params = seeded_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(3), x), 3)
    net = TS.ScrfdNet(TS.ScrfdConfig().micro())
    load(net, X.export_scrfd(params, net.state_dict().keys()))
    ref = jnet.apply(params, x)

    def outputs():
        with torch.no_grad():
            return [[t.numpy() for t in level] for level in net(torch.from_numpy(x))]

    as_is = outputs()
    for m in net.modules():
        if isinstance(m, torch.nn.GroupNorm):
            m.eps = 1e-6
    matched = outputs()
    for lv, (got, same_eps, want) in enumerate(zip(as_is, matched, ref)):
        for g, s, w in zip(got, same_eps, want):
            assert g.shape == w.shape == (1, (8 >> lv) ** 2 * 2, g.shape[-1])
            assert rel_l2(s, w) < 1e-5
            assert rel_l2(g, w) < 1e-3
    jparams = JS.convert_scrfd({k: v.numpy() for k, v in net.state_dict().items()}, jcfg)
    for got, want in zip(matched, jnet.apply(jparams, x)):
        assert all(rel_l2(g, w) < 1e-5 for g, w in zip(got, want))


def test_scrfd_tail_matches_jax():
    """Keep-ratio letterbox, anchor centres, ``distance2*``, the rescale and
    NMS on fixed maps."""
    for shape in ((50, 70), (70, 50), (60, 60)):
        img = _image(*shape, 4)
        for got, ref in zip(TS.resize_image_keep_ratio(img, 64, 64),
                            JS.resize_image_keep_ratio(img, 64, 64)):
            np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(TS.anchor_centers(5, 7, 8), JS.anchor_centers(5, 7, 8))
    rng = np.random.default_rng(5)
    pts, dist = rng.uniform(0, 60, (30, 2)), rng.uniform(0, 9, (30, 10))
    np.testing.assert_array_equal(TS.distance2bbox(pts, dist), JS.distance2bbox(pts, dist))
    np.testing.assert_array_equal(TS.distance2kps(pts, dist), JS.distance2kps(pts, dist))
    jcfg = JS.ScrfdConfig().micro()
    outs = [(rng.uniform(0.2, 1, (1, n, 1)).astype(np.float32),
             rng.uniform(0, 3, (1, n, 4)).astype(np.float32),
             rng.normal(0, 2, (1, n, 10)).astype(np.float32))
            for n in (8 * 8 * 2, 4 * 4 * 2, 2 * 2 * 2)]
    img = _image(50, 70, 6)
    jdet = JS.ScrfdDetector(params={}, cfg=jcfg, input_size=64)
    jdet._apply = lambda p, x: outs
    tdet = TS.ScrfdDetector(Fixed([tuple(torch.from_numpy(a) for a in lv) for lv in outs],
                                  TS.ScrfdConfig().micro()), input_size=64)
    got, ref = tdet.detect(img), jdet.detect(img)
    assert len(got[0]) > 1
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert tdet(img[..., ::-1]) == jdet(img[..., ::-1])


# ---------------------------------------------------------------- RTMPose

def test_rtmpose_face_geometry_matches_jax():
    jnet = JR.RTMPoseNet(JR.RTMPoseConfig(**RTM_FACE_SMALL))
    x = np.random.default_rng(7).standard_normal((1, 256, 256, 3)).astype(np.float32)
    params = seeded_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(7), x), 7)
    net = TR.RTMPoseNet(TR.RTMPoseConfig(**RTM_FACE_SMALL))
    load(net, X.export_rtmpose(params, net.state_dict().keys()))
    with torch.no_grad():
        sx, sy = (t.numpy() for t in net(torch.from_numpy(x)))
    jx, jy = (np.asarray(t) for t in jnet.apply(params, x))
    assert sx.shape == (1, 106, 512) and sy.shape == (1, 106, 512)
    assert rel_l2(sx, jx) < 1e-5 and rel_l2(sy, jy) < 1e-5
    # the decode exactly, on one shared set of logits
    for got, ref in zip(TR.simcc_decode(jx, jy), JR.simcc_decode(jx, jy)):
        np.testing.assert_array_equal(got, ref)
    jparams = JR.convert_rtmpose({k: v.numpy() for k, v in net.state_dict().items()})
    assert rel_l2(sx, jnet.apply(jparams, x)[0]) < 1e-5


def test_rtmpose_tails_match_jax():
    box = np.array([12.0, 20.0, 70.0, 95.0], np.float32)
    for got, ref in zip(TR.bbox_xyxy2cs(box), JR.bbox_xyxy2cs(box)):
        np.testing.assert_array_equal(got, ref)
    c, s = JR.bbox_xyxy2cs(box)
    np.testing.assert_array_equal(TR.get_warp_matrix(c, s, 0, (64, 64)),
                                  JR.get_warp_matrix(c, s, 0, (64, 64)))
    img = _image(110, 90, 8).astype(np.float32)
    for got, ref in zip(TR.top_down_affine((64, 64), s, c, img),
                        JR.top_down_affine((64, 64), s, c, img)):
        np.testing.assert_array_equal(got, ref)
    # the engine's crop -> decode -> rescale on fixed logits
    rng = np.random.default_rng(9)
    sx = rng.standard_normal((1, 106, 512)).astype(np.float32)
    sy = rng.standard_normal((1, 106, 512)).astype(np.float32)
    cfg = JR.RTMPoseConfig(**RTM_FACE_SMALL)
    jeng = JR.RTMPoseWholebody(params={}, cfg=cfg)
    jeng._apply = lambda p, x: (sx, sy)
    teng = TR.RTMPoseWholebody(Fixed((torch.from_numpy(sx), torch.from_numpy(sy)),
                                     TR.RTMPoseConfig(**RTM_FACE_SMALL)))
    bgr = _image(110, 90, 10)
    for boxes in ([list(box)], []):
        for got, ref in zip(teng(bgr, boxes), jeng(bgr, boxes)):
            np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------------- landmarks

def test_landmark_estimators_match_jax():
    # the cascade parts (or the box prior, where the system lacks them)
    yy, xx = np.mgrid[:120, :100]
    gray = np.full((120, 100), 60.0)
    gray[((yy - 60) / 40) ** 2 + ((xx - 50) / 30) ** 2 < 1] = 190
    for cy, cx in ((48, 38), (48, 62)):
        gray[cy - 4:cy + 4, cx - 6:cx + 6] = 40
    gray[80:86, 38:62] = 70
    rgb = np.repeat(gray[..., None], 3, 2).astype(np.uint8)
    for box in ((20.0, 20.0, 80.0, 100.0), (5.0, 5.0, 20.0, 20.0)):
        np.testing.assert_allclose(TL.LandmarkEstimator()(rgb, box),
                                   JL.LandmarkEstimator()(rgb, box), rtol=0, atol=1e-4)
    # a detector's 5 points: the best overlap with the box, by score
    rng = np.random.default_rng(11)
    dets = (np.array([[10, 10, 40, 50], [30, 20, 60, 60], [0, 0, 20, 20]], float),
            rng.uniform(0, 100, (3, 5, 2)), np.array([0.9, 0.6, 0.99]))

    class Stub:
        def detect(self, bgr):
            return dets

    for box in ((12.0, 12.0, 48.0, 58.0), (35.0, 25.0, 90.0, 80.0)):
        np.testing.assert_array_equal(TL.YoloFaceLandmarks(Stub())(rgb, box),
                                      JL.YoloFaceLandmarks(Stub())(rgb, box))
    Stub.detect = lambda self, bgr: (np.zeros((0, 4)), np.zeros((0, 5, 2)), np.zeros(0))
    with pytest.raises(TL.NoFaceError):
        TL.YoloFaceLandmarks(Stub())(rgb, (0, 0, 10, 10))
    # the dense head's 106 points -> 5, LaPa groups
    kpts = rng.uniform(0, 100, (1, 106, 2)).astype(np.float32)
    jlm = JL.RTMFaceLandmarker(params={}, **{k: RTM_FACE_SMALL[k] for k in
                                             ("num_keypoints", "input_size")})
    jlm.engine = lambda bgr, boxes: (kpts, np.ones((1, 106)))
    tlm = TL.RTMFaceLandmarker(Fixed(None, TR.RTMPoseConfig(**RTM_FACE_SMALL)))
    tlm.engine = jlm.engine
    np.testing.assert_array_equal(tlm(rgb, (0, 0, 50, 50)), jlm(rgb, (0, 0, 50, 50)))
    assert TL.LAPA_106_TO_5 == JL.LAPA_106_TO_5


# -------------------------------------------- published widths, the order

@pytest.fixture(scope="module")
def face_files(tmp_path_factory):
    """Seeded checkpoints at the published widths, keyed as the reference's
    files: yolov5m-face, SCRFD-10G-bnkps, the RTMPose-m face6 head."""
    d = tmp_path_factory.mktemp("face")
    paths = {}
    for i, (name, build) in enumerate((("det", TY.YoloFaceNet), ("scrfd", TS.ScrfdNet),
                                       ("lmk", lambda: TR.RTMPoseNet(TL.face6_config())))):
        torch.manual_seed(i)
        paths[name] = str(d / f"{name}.pth")
        torch.save(build().state_dict(), paths[name])
    return paths


def test_resolve_order_matches_jax(face_files, capsys):
    """YOLOv5-face, then SCRFD, then the cascade with its warning; the
    landmarker: the RTMPose face head, then a detector's points, then the
    cascade parts. The JAX package takes the same order."""
    det, scrfd, lmk = face_files["det"], face_files["scrfd"], face_files["lmk"]
    cpu = torch.device("cpu")
    for paths, kind in (((det, scrfd), TY.YoloFaceDetector),
                        (("", scrfd), TS.ScrfdDetector),
                        (("", ""), TF.CascadeFaceDetector)):
        got = TF.resolve_face_detector(*paths, device=cpu)
        assert type(got) is kind
        assert type(JF.resolve_face_detector(*paths)).__name__ == kind.__name__
    assert "Viola-Jones" in capsys.readouterr().err
    for paths, kind, inner in (((det, scrfd, lmk), TL.RTMFaceLandmarker, None),
                               ((det, scrfd, ""), TL.YoloFaceLandmarks, TY.YoloFaceDetector),
                               (("", scrfd, ""), TL.YoloFaceLandmarks, TS.ScrfdDetector),
                               (("", "", ""), TL.LandmarkEstimator, None)):
        got = TL.resolve_landmark_estimator(*paths, device=cpu)
        ref = JL.resolve_landmark_estimator(*paths)
        assert type(got) is kind and type(ref).__name__ == kind.__name__
        if inner is not None:
            assert type(got.detector) is inner
            assert type(ref.detector).__name__ == inner.__name__
    # the loaded networks hold the files' weights
    net = TF.resolve_face_detector("", scrfd, device=cpu).net
    want = torch.load(scrfd, weights_only=True)
    assert all(torch.equal(v, want[k]) for k, v in net.state_dict().items())
    bboxes, kpss, scores = TF.resolve_face_detector("", scrfd, device=cpu).detect(_image(90, 70, 12))
    assert bboxes.shape[1:] == (4,) and kpss.shape[1:] == (5, 2) and scores.ndim == 1


@pytest.mark.parametrize("name", ["yoloface", "scrfd", "rtmpose"])
def test_published_widths_round_trip(name):
    """yolov5m-face (0.75 / 0.67), SCRFD-10G-bnkps and RTMPose-m face6: the
    JAX init's shapes -> the port's exporter -> the port module's keys and
    shapes -> the port's converter -> the JAX init's shapes."""
    if name == "yoloface":
        jnet, tnet, size = JY.YoloFaceNet(), TY.YoloFaceNet(), (1, 416, 416, 3)
        export, conv = X.export_yoloface, X.convert_yoloface
    elif name == "scrfd":
        jnet, tnet, size = JS.ScrfdNet(), TS.ScrfdNet(), (1, 640, 640, 3)
        export, conv = X.export_scrfd, X.convert_scrfd
    else:
        jcfg = JR.RTMPoseConfig(widen=0.75, deepen=0.67, num_keypoints=106,
                                input_size=(256, 256))
        jnet, tnet, size = JR.RTMPoseNet(jcfg), TR.RTMPoseNet(TL.face6_config()), \
            (1, 256, 256, 3)
        export, conv = X.export_rtmpose, X.convert_rtmpose
    spec = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros(size))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), spec)
    sd = export(params, tnet.state_dict().keys())
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in tnet.state_dict().items()}
    tnet.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}, strict=True)
    shapes = {k: v.shape for k, v in X._flatten_params(conv(sd)["params"]).items()}
    assert shapes == {k: v.shape for k, v in X._flatten_params(params["params"]).items()}


# ------------------------------------------------------- the CLI, every pass

@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory, face_files):
    """A WAV, a portrait and a micro-model config with every pass on: the
    learned detector and landmark head (published widths), GPEN at 512 px
    (style 16, 2 MLP layers, multiplier 1), the teeth net, RIFE at c = 16."""
    d = tmp_path_factory.mktemp("cli_all")
    t = np.arange(int(1.3 * 16000)) / 16000
    with wave.open(str(d / "speech.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((0.3 * np.sin(2 * np.pi * 220 * t) * 32767).astype(np.int16).tobytes())
    Image.fromarray(_image(80, 64, 13)).save(d / "face.png")
    paths = dict(face_files)
    for i, (name, build) in enumerate((
            ("bfr", functools.partial(TG.GPENGenerator, style_dim=16, n_mlp=2,
                                      channel_multiplier=1)),
            ("teeth", TT.TeethEnhancer), ("rife", functools.partial(TRI.IFNet, 16)))):
        torch.manual_seed(10 + i)
        paths[name] = str(d / f"{name}.pth")
        torch.save(build().state_dict(), paths[name])
    (d / "all.yaml").write_text(
        "data:\n  n_sample_frames: 2\nnum_inference_steps: 2\nimage_size: 64\n"
        "decode_chunk_size: 2\nseed: 3\nweight_dtype: 'fp32'\n"
        f"output_dir: '{d / 'out'}'\nexp_name: 'e'\nmicro_model: true\n"
        "arcface_checkpoint_path: ''\nuse_bfr: true\nuse_teeth_enhance: true\n"
        "use_interframe: true\nuse_bfr_frames: true\n"
        f"det_checkpoint_path: '{paths['det']}'\nscrfd_checkpoint_path: '{paths['scrfd']}'\n"
        f"face_landmark_checkpoint_path: '{paths['lmk']}'\n"
        f"bfr_checkpoint_path: '{paths['bfr']}'\nteeth_checkpoint_path: '{paths['teeth']}'\n"
        f"rife_checkpoint_path: '{paths['rife']}'\n")
    return dict(dir=d, config=str(d / "all.yaml"), wav=str(d / "speech.wav"),
                ref=str(d / "face.png"))


def test_cli_every_pass_end_to_end(cli_inputs, capsys):
    """``python -m actalker_tpu_torch.cli --device cpu`` with every pass on:
    2F - 1 frames, every stage timed, nothing said to be unported."""
    cli.main(["--config", cli_inputs["config"], "--ref", cli_inputs["ref"], "--audio",
              cli_inputs["wav"], "--mode", "2", "--random-weights", "--frame-limit",
              "8", "--device", "cpu"])
    out = capsys.readouterr()
    assert "not ported" not in out.out + out.err
    for stage in ("detect", "landmarks", "bfr_ref", "teeth", "bfr_frames", "rife"):
        assert f"'{stage}'" in out.out
    if TM.lib() is not None:
        path = cli_inputs["dir"] / "out" / "e" / "face.png.mp4"
        assert TM.read_video(str(path)).shape == (7, 64, 64, 3)


def test_cli_skips_a_pass_without_its_checkpoint(cli_inputs):
    """The same run with RIFE's file absent: no rife stage, F frames; the
    decoded frames went through teeth and frame BFR."""
    cfg = cli.load_config(cli_inputs["config"])
    cfg.rife_checkpoint_path = str(cli_inputs["dir"] / "absent.pkl")
    args = argparse.Namespace(config=cli_inputs["config"], ref=cli_inputs["ref"],
                              audio=cli_inputs["wav"], video=None, mode=2, batch=False,
                              random_weights=True, frame_limit=8, device="cpu")
    run = cli.generate_frames(cfg, args, cli.MODE_GATES[2], {})
    assert run["frames01"].shape == (4, 64, 64, 3)
    assert "rife" not in run["seconds"] and "teeth" in run["seconds"]
    assert run["landmarks"] is not None and run["landmarks"].shape == (5, 2)
    assert np.abs(run["frames01"] - run["decoded"]).max() > 0
