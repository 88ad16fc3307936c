"""PyTorch port, the DWPose path against the JAX package on the CPU: the
YOLOX person detector (network, decode, NMS, letterbox), the OpenPose
rendering and the pose-sequence rescale, and the two-stage ``Wholebody``
(narrow YOLOX + narrow RTMPose-l geometry: 133 keypoints, 288 x 384). The
port's YOLOX is seeded in torch (its BatchNorms are real eval-mode ones);
its state dict goes through the JAX package's ``convert_yolox``, which
folds them, so both packages run one network.

Tolerances (fp32 on both sides):
  * the raw YOLOX rows: relative L2 1e-5;
  * decode, NMS, multiclass NMS and the rescale exactly (1e-12 for the
    rescale's least-squares fit) on arrays given to both;
  * the letterbox (a torch resize here, ``jax.image.resize`` there; their
    fp32 weights differ): max abs 2e-2 on 0..255 pixels, a fiftieth of a
    grey level;
  * the detector's boxes and ``Wholebody``'s keypoints: 1e-4 px; the
    rendered canvases byte for byte.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.frontend import pose_draw as JD
from actalker_tpu.models import rtmpose as JR
from actalker_tpu.models import yolox as JX
from actalker_tpu_torch.frontend import pose_draw as TD
from actalker_tpu_torch.io import init as TI
from actalker_tpu_torch.io import jax_export as X
from actalker_tpu_torch.models import rtmpose as TR
from actalker_tpu_torch.models import yolox as TX
from actalker_tpu_torch.tools import eval_weights
from tests.torch_parity import load, rel_l2, seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)

YOLOX_SMALL = dict(depth=0.33, width=0.25)
RTM_WHOLE_SMALL = dict(widen=0.25, deepen=0.34, gau_hidden=64, gau_s=32)


def _image(h, w, seed):
    return (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)


def _yolox(seed=0, person_bias=0.0):
    """A narrow port YOLOX with seeded weights and BatchNorm statistics;
    ``person_bias`` lifts the objectness and person logits so that a
    detector keeps some boxes."""
    net = eval_weights.seeded(lambda: TX.YoloXNet(TX.YoloXConfig(**YOLOX_SMALL)), seed)
    with torch.no_grad():
        for i in range(3):
            net.head.obj_preds[i].bias.add_(person_bias)
            net.head.cls_preds[i].bias[0].add_(person_bias)
    return net


def _numpy_sd(net):
    return {k: v.numpy() for k, v in net.state_dict().items()}


# ------------------------------------------------------------------ YOLOX

def test_yolox_matches_jax():
    net = _yolox()
    sd = _numpy_sd(net)
    jparams = JX.convert_yolox(sd)
    # the port's converter folds as the JAX package's does
    mine = X.convert_yolox(sd)
    assert jax.tree.structure(mine) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(1).uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    ref = np.asarray(JX.YoloXNet(JX.YoloXConfig(**YOLOX_SMALL)).apply(jparams, x))
    assert got.shape == ref.shape == (1, 8 * 12 + 4 * 6 + 2 * 3, 85)
    assert rel_l2(got, ref) < 1e-5


def test_yolox_tails_match_jax():
    rng = np.random.default_rng(2)
    raw = rng.standard_normal((1, 8 * 8 + 4 * 4 + 2 * 2, 85)).astype(np.float32)
    np.testing.assert_array_equal(TX.decode_predictions(raw, (64, 64)),
                                  JX.decode_predictions(raw, (64, 64)))
    n = 300
    xy = rng.uniform(0, 200, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (n, 2))], 1).astype(np.float32)
    scores = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    assert TX.nms_plus1(boxes, scores[:, 0], 0.45) == JX.nms_plus1(boxes, scores[:, 0], 0.45)
    got, ref = (m.multiclass_nms(boxes, scores, 0.45, 0.1) for m in (TX, JX))
    np.testing.assert_array_equal(got, ref)
    assert len(got) > 3 and set(got[:, 5]) == {0, 1, 2}
    assert TX.multiclass_nms(boxes, scores * 0.05, 0.45, 0.1) is None


@pytest.mark.parametrize("hw", [(48, 40), (200, 120), (96, 64)])
def test_letterbox_matches_jax(hw):
    """Growing, shrinking, and exactly twice the input on one side."""
    img = _image(*hw, 3)
    got, r = TX.letterbox(img, (64, 64))
    ref, r_ref = JX.letterbox(img, (64, 64))
    assert r == r_ref and got.shape == ref.shape == (64, 64, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)


def test_letterbox_departs_from_the_reference_when_it_shrinks():
    """The reference's ``onnxdet.py`` letterboxes with
    ``cv2.resize(INTER_LINEAR)``, which does not antialias; the port
    follows ``jax.image.resize`` (as the port's yolov5-face letterbox
    does). On a 1280 x 720 frame (shrunk by 0.5) the two differ by grey
    levels on a noisy image; a 512 px frame grows into 640, where they
    agree within 1e-2 (OpenCV's interpolation weights are rounded)."""
    big = _image(720, 1280, 4)
    got, r = TX.letterbox(big, (640, 640))
    nh, nw = int(720 * r), int(1280 * r)
    cv = cv2.resize(big.astype(np.float32), (nw, nh), interpolation=cv2.INTER_LINEAR)
    assert np.abs(got[:nh, :nw] - cv).max() > 20.0
    small = _image(512, 512, 5)
    got, r = TX.letterbox(small, (640, 640))
    cv = cv2.resize(small.astype(np.float32), (640, 640), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(got, cv, rtol=0, atol=1e-2)


@pytest.fixture(scope="module")
def dwpose_pair():
    """The narrow detector and pose model, in the port and in the JAX
    package on the same parameters."""
    net = _yolox(seed=6, person_bias=2.0)
    jdet = JX.YoloXPersonDetector(JX.convert_yolox(_numpy_sd(net)),
                                  JX.YoloXConfig(**YOLOX_SMALL), input_size=(64, 64))
    tdet = TX.YoloXPersonDetector(net, input_size=(64, 64))
    jnet = JR.RTMPoseNet(JR.RTMPoseConfig(**RTM_WHOLE_SMALL))
    spec = jax.eval_shape(jnet.init, jax.random.PRNGKey(7), jnp.zeros((1, 384, 288, 3)))
    params = seeded_params(spec, 7)
    pnet = TR.RTMPoseNet(TR.RTMPoseConfig(**RTM_WHOLE_SMALL))
    load(pnet, X.export_rtmpose(params, pnet.state_dict().keys()))
    jpose = JR.RTMPoseWholebody(params, JR.RTMPoseConfig(**RTM_WHOLE_SMALL))
    return (tdet, TR.RTMPoseWholebody(pnet)), (jdet, jpose)


def test_person_detector_and_wholebody_match_jax(dwpose_pair):
    (tdet, tpose), (jdet, jpose) = dwpose_pair
    img = _image(90, 120, 8)
    boxes, ref = tdet(img), jdet(img)
    assert boxes.shape == ref.shape and len(boxes) >= 1
    np.testing.assert_allclose(boxes, ref, rtol=0, atol=1e-4)
    kp, sc = TD.Wholebody(tdet, tpose)(img)
    jkp, jsc = JD.Wholebody(jdet, jpose)(img)
    assert kp.shape == jkp.shape == (len(boxes), 134, 2)
    np.testing.assert_allclose(kp, jkp, rtol=0, atol=1e-4)
    np.testing.assert_allclose(sc, jsc, rtol=0, atol=1e-5)


def test_wholebody_neck_and_remap():
    """The glue on fixed stage outputs: the neck is the shoulders' mean,
    scored 1 only when both exceed 0.3, and the mmpose body indices land
    at OpenPose's."""
    rng = np.random.default_rng(9)
    kps = rng.uniform(0, 100, (2, 133, 2))
    scores = rng.uniform(0, 1, (2, 133))
    scores[0, 5:7] = (0.9, 0.8)
    scores[1, 5:7] = (0.9, 0.1)
    det = lambda img: np.zeros((2, 4), np.float32)  # noqa: E731
    pose = lambda img, boxes: (kps.copy(), scores.copy())  # noqa: E731
    got = TD.Wholebody(det, pose)(None)
    ref = JD.Wholebody(det, pose)(None)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0][:, 1], kps[:, [5, 6]].mean(1))
    np.testing.assert_array_equal(got[1][:, 1], [1.0, 0.0])


# -------------------------------------------------------- rendering, rescale

def _pose(rng, n_people=2):
    cand = rng.uniform(0.05, 0.95, (18 * n_people, 2))
    subset = np.arange(18 * n_people, dtype=np.float64).reshape(n_people, 18)
    subset[0, 3] = -1
    score = rng.uniform(0.2, 1.0, (n_people, 18))
    return {"bodies": {"candidate": cand, "subset": subset, "score": score},
            "hands": rng.uniform(0.0, 1.0, (2 * n_people, 21, 2)),
            "hands_score": rng.uniform(0, 1, (2 * n_people, 21)),
            "faces": rng.uniform(0.0, 1.0, (n_people, 68, 2)),
            "faces_score": rng.uniform(0, 1, (n_people, 68))}


@pytest.mark.parametrize("include_face", [True, False])
def test_draw_pose_matches_jax(include_face):
    pose = _pose(np.random.default_rng(10))
    got = TD.draw_pose(pose, 96, 80, include_face=include_face)
    ref = JD.draw_pose(pose, 96, 80, include_face=include_face)
    assert got.dtype == np.uint8 and got.shape == (3, 96, 80)
    assert got.any()
    np.testing.assert_array_equal(got, ref)


def test_rescale_pose_sequence_matches_jax():
    rng = np.random.default_rng(11)
    seq = [_pose(rng, 1) for _ in range(4)]
    ref_body = rng.uniform(0.1, 0.9, (18, 2))
    got = TD.rescale_pose_sequence(seq, ref_body, (720, 1280), (512, 512))
    ref = JD.rescale_pose_sequence(seq, ref_body, (720, 1280), (512, 512))
    for a, b in zip(got, ref):
        for key in ("faces", "hands"):
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-12)
        np.testing.assert_allclose(a["bodies"]["candidate"], b["bodies"]["candidate"],
                                   rtol=0, atol=1e-12)


# ------------------------------------------------------- the published files

def test_dwpose_files_load_at_published_widths(tmp_path):
    """YOLOX-L and RTMPose-l wholebody, seeded and saved as the reference's
    files: each loads with ``strict=True`` and converts to the JAX init's
    shapes (``jax.eval_shape``)."""
    paths = eval_weights.write_seeded_dwpose(str(tmp_path))
    assert sorted(p.rsplit("/", 1)[1] for p in paths.values()) == [
        "dw-ll_ucoco_384.pth", "yolox_l.pth"]
    det = TI.load_yolox(paths["yolox"], "cpu")
    pose = TI.load_dwpose(paths["dwpose"], "cpu")
    assert det.cfg == TX.YoloXConfig() and pose.cfg == TR.RTMPoseConfig()
    for net, conv, jnet, size in (
            (det, X.convert_yolox, JX.YoloXNet(JX.YoloXConfig()), (1, 640, 640, 3)),
            (pose, X.convert_rtmpose, JR.RTMPoseNet(JR.RTMPoseConfig()), (1, 384, 288, 3))):
        spec = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros(size))
        got = {k: v.shape for k, v in X._flatten_params(
            conv(_numpy_sd(net))["params"]).items()}
        zeros = jax.tree.map(lambda a: np.broadcast_to(np.float32(0), a.shape), spec)
        assert got == {k: v.shape for k, v in X._flatten_params(zeros["params"]).items()}
    # Megvii's own checkpoint wraps the state dict in "model"
    torch.save({"model": det.state_dict(), "start_epoch": 300}, tmp_path / "megvii.pth")
    again = TI.load_yolox(str(tmp_path / "megvii.pth"), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                                  det.state_dict().values()))
