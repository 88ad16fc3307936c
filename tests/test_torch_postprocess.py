"""PyTorch port, the post-processing slice against the JAX package on the
CPU: ``ops/upfirdn2d.py``, the GPEN generator (``models/stylegan2.py``),
the teeth enhancer, RIFE (with the transposed-conv flip the JAX converter
lacks), the enhance glue and ``cli.postprocess_frames`` with every pass on.
Seeded JAX parameters (``tests/torch_parity.py``) go through the port's
exporters into reference-keyed state dicts, which load with
``strict=True``; the same seeded numpy inputs go through both packages.

Tolerances (fp32 on both sides; only summation order differs):
  * upfirdn2d, the resizes and the warp: max abs 1e-5 on O(1) values;
  * GPEN (size 32), teeth (32 x 32, no resize), RIFE (c = 16, 32 x 32):
    relative L2 1e-5;
  * the enhance glue on one shared numpy "network": exact (uint8), the
    JAX ``enhance_face``'s mask given in float32 (as it stands, it pastes
    nothing: a test records that);
  * ``postprocess_frames``: each frame within 2 / 255 of the JAX CLI's (the
    glue rounds to uint8 after teeth and after BFR, so a 1e-6 network
    difference can move a pixel by one level each time), mean abs 1e-4;
  * the unflipped JAX converter: relative L2 above 1e-2 (the fault shows
    at O(1)).
At published widths, each port module's state dict round-trips through its
exporter and converter to the JAX ``init``'s shapes (``jax.eval_shape``,
no forward).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu import cli as jcli
from actalker_tpu.config import InferenceConfig as JInferenceConfig
from actalker_tpu.frontend import enhance as JE
from actalker_tpu.io import weights as JW
from actalker_tpu.models import rife as JR
from actalker_tpu.models import stylegan2 as JG
from actalker_tpu.models import teeth as JT
from actalker_tpu.ops import upfirdn2d as JU
from actalker_tpu_torch import cli
from actalker_tpu_torch.config import InferenceConfig
from actalker_tpu_torch.frontend import enhance as TE
from actalker_tpu_torch.io import jax_export as X
from actalker_tpu_torch.models import rife as TR
from actalker_tpu_torch.models import stylegan2 as TG
from actalker_tpu_torch.models import teeth as TT
from actalker_tpu_torch.ops import upfirdn2d as TU
from tests.torch_parity import load, rel_l2, seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)

GPEN_SMALL = dict(size=32, style_dim=16, n_mlp=2, channel_multiplier=1)
# the CLI's GPEN: 512 px crops, narrowed where the file allows it
GPEN_CLI = dict(style_dim=16, n_mlp=2, channel_multiplier=1)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------- upfirdn2d

@pytest.mark.parametrize("case", ["up", "down", "blur", "up_pad", "leaky"])
def test_upfirdn2d_matches_jax(case):
    x = np.random.default_rng(0).standard_normal((2, 9, 7, 3)).astype(np.float32)
    k = JU.make_kernel((1, 3, 3, 1))
    np.testing.assert_array_equal(TU.make_kernel((1, 3, 3, 1)), k)
    if case == "up":
        got, ref = TU.upsample2x(nchw(x)), JU.upsample2x(x)
    elif case == "down":
        got, ref = TU.downsample2x(nchw(x)), JU.downsample2x(x)
    elif case == "blur":
        got, ref = TU.blur(nchw(x), pad=(1, 2), upsample_factor=2), \
            JU.blur(x, pad=(1, 2), upsample_factor=2)
    elif case == "up_pad":
        got, ref = TU.upfirdn2d(nchw(x), k * 4, up=2, down=2, pad=(3, 1)), \
            JU.upfirdn2d(x, k * 4, up=2, down=2, pad=(3, 1))
    else:
        b = np.linspace(-1, 1, 3).astype(np.float32)
        got = TU.fused_leaky_relu(nchw(x), torch.from_numpy(b))
        ref = JU.fused_leaky_relu(x, jnp.asarray(b))
    assert nhwc(got).shape == ref.shape
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5, rtol=0)


# ------------------------------------------------------------------ GPEN

def test_gpen_matches_jax():
    jg = JG.GPENGenerator(**GPEN_SMALL)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    params = seeded_params(jax.eval_shape(jg.init, jax.random.PRNGKey(1), x), 1)
    tg = TG.GPENGenerator(**GPEN_SMALL)
    load(tg, X.export_bfr(params, tg.state_dict().keys()))
    with torch.no_grad():
        got = tg(torch.from_numpy(x)).numpy()
    ref = np.asarray(jg.apply(params, x))
    assert got.shape == (2, 32, 32, 3)
    assert rel_l2(got, ref) < 1e-5
    np.testing.assert_array_equal(TG.feathered_box_mask(64, 5, 4.0),
                                  JG.feathered_box_mask(64, 5, 4.0))


def test_gpen_ignores_the_files_filter_buffers():
    """The reference keeps each Blur / Upsample FIR filter as a ``kernel``
    buffer: a file holding them loads strictly and they change nothing."""
    tg = TG.GPENGenerator(**GPEN_SMALL)
    sd = dict(tg.state_dict())
    sd["ecd1.0.0.kernel"] = torch.ones(4, 4)
    sd["generator.convs.0.conv.blur.kernel"] = torch.ones(4, 4)
    sd["generator.to_rgbs.0.upsample.kernel"] = torch.ones(4, 4)
    TG.GPENGenerator(**GPEN_SMALL).load_state_dict(sd, strict=True)


# ----------------------------------------------------------------- teeth

def test_teeth_matches_jax():
    jt = JT.TeethEnhancer(resize_input=False)
    x = np.random.default_rng(2).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    params = seeded_params(jax.eval_shape(jt.init, jax.random.PRNGKey(2), x), 2)
    tt = load(TT.TeethEnhancer(resize_input=False), X.export_teeth(params))
    with torch.no_grad():
        rgb, alpha = tt(torch.from_numpy(x))
    jrgb, jalpha = jt.apply(params, x)
    assert rgb.shape == (1, 32, 32, 3) and alpha.shape == (1, 32, 32, 1)
    assert rel_l2(rgb.numpy(), jrgb) < 1e-5
    assert rel_l2(alpha.numpy(), jalpha) < 1e-5


@pytest.mark.parametrize("side", [40, 700])
def test_teeth_resize_matches_jax(side):
    """The 512 px input resize alone, up (40) and down (700): Keys cubic
    with antialiasing as jax.image.resize; plain bicubic would not match."""
    x = np.random.default_rng(3).uniform(-1, 1, (1, side, side, 3)).astype(np.float32)
    ref = np.asarray(JT._bicubic_512(x))
    got = nhwc(TT.bicubic_512(nchw(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ RIFE

@pytest.fixture(scope="module")
def rife():
    jnet = JR.IFNet(c=16)
    rng = np.random.default_rng(4)
    f0, f1 = (rng.random((2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    params = seeded_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(4), f0, f1), 4)
    sd = X.export_rife(params)
    return dict(jnet=jnet, params=params, sd=sd, net=load(TR.IFNet(16), sd),
                f0=f0, f1=f1)


def test_rife_matches_jax_given_the_flipped_kernel(rife):
    with torch.no_grad():
        got = rife["net"](torch.from_numpy(rife["f0"]), torch.from_numpy(rife["f1"]))
    ref = rife["jnet"].apply(rife["params"], rife["f0"], rife["f1"])
    assert rel_l2(got.numpy(), ref) < 1e-5
    frames = np.random.default_rng(5).random((3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = TR.interpolate_pairs(rife["net"], torch.from_numpy(frames)).numpy()
    ref = np.asarray(JR.interpolate_pairs(rife["jnet"].apply, rife["params"], frames))
    assert got.shape == (5, 32, 32, 3)
    np.testing.assert_array_equal(got[0::2], frames)
    assert rel_l2(got, ref) < 1e-5


def test_jax_convert_rife_lacks_the_flip(rife):
    """``actalker_tpu/io/weights.py::convert_rife`` copies the reference's
    ConvTranspose2d kernels into flax's ConvTranspose unflipped: on one
    layer it departs from torch's ConvTranspose2d(4, 2, 1), and the JAX
    IFNet on its params departs from the port; the port's converter flips."""
    import flax.linen as fnn

    rng = np.random.default_rng(6)
    w = rng.standard_normal((3, 2, 4, 4)).astype(np.float32)
    x = rng.standard_normal((1, 6, 6, 3)).astype(np.float32)
    ref = nhwc(torch.nn.functional.conv_transpose2d(nchw(x), torch.from_numpy(w),
                                                    stride=2, padding=1))
    layer = fnn.ConvTranspose(2, (4, 4), strides=(2, 2), padding="SAME", use_bias=False)

    def flax_out(kernel):
        return np.asarray(layer.apply({"params": {"kernel": kernel}}, x))

    assert rel_l2(flax_out(np.transpose(w, (2, 3, 0, 1))), ref) > 1e-1
    assert rel_l2(flax_out(X._KINDS["convT_flip"][0](w)), ref) < 1e-5

    jparams = JW.convert_rife(rife["sd"])
    with torch.no_grad():
        got = rife["net"](torch.from_numpy(rife["f0"]), torch.from_numpy(rife["f1"]))
    assert rel_l2(got.numpy(), rife["jnet"].apply(jparams, rife["f0"], rife["f1"])) > 1e-2


def test_warp_matches_jax():
    """grid_sample (border, align_corners) for the JAX package's clamped
    bilinear gather, flows reaching past every border."""
    rng = np.random.default_rng(7)
    img = rng.random((2, 12, 16, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 12, 16, 2)) * 6).astype(np.float32)
    got = nhwc(TR.warp(nchw(img), nchw(flow)))
    np.testing.assert_allclose(got, np.asarray(JR.warp(img, flow)), atol=1e-5, rtol=0)


# ------------------------------------------------------------ enhance glue

def _glue_net(x):
    """One numpy "network" both packages' glue calls."""
    return np.tanh(1.3 * x[..., ::-1] + 0.1)


def _jax_mask_float32(monkeypatch):
    """The JAX glue with its feathered mask in float32, so that OpenCV
    writes the warped mask into its float32 ``dst``."""
    monkeypatch.setattr(JE, "feathered_box_mask",
                        lambda size: JG.feathered_box_mask(size).astype(np.float32))


def test_enhance_face_matches_jax(monkeypatch):
    rng = np.random.default_rng(8)
    img = (rng.random((96, 80, 3)) * 255).astype(np.uint8)
    box = (18.0, 22.0, 66.0, 80.0)
    np.testing.assert_array_equal(TE.MEAN_FACE_5P, JE.MEAN_FACE_5P)
    np.testing.assert_array_equal(TE.box_to_landmarks(box), JE.box_to_landmarks(box))
    lm = JE.box_to_landmarks(box) + rng.normal(0, 2, (5, 2)).astype(np.float32)
    np.testing.assert_array_equal(TE.similarity_transform(lm, JE.MEAN_FACE_5P),
                                  JE.similarity_transform(lm, JE.MEAN_FACE_5P))
    _jax_mask_float32(monkeypatch)
    for landmarks in (None, lm):
        got = TE.enhance_face(img, box, _glue_net, landmarks=landmarks)
        ref = JE.enhance_face(img, box, _glue_net, landmarks=landmarks)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
        assert (got != img).mean() > 0.1


def test_jax_enhance_face_pastes_nothing():
    """The JAX package's ``enhance_face`` as it stands: its float64 mask
    never reaches the float32 ``dst``, so the restored face is not pasted
    and the image comes back unchanged."""
    img = (np.random.default_rng(8).random((96, 80, 3)) * 255).astype(np.uint8)
    box = (18.0, 22.0, 66.0, 80.0)
    np.testing.assert_array_equal(JE.enhance_face(img, box, _glue_net), img)
    assert (TE.enhance_face(img, box, _glue_net) != img).any()


def test_enhance_teeth_matches_jax():
    rng = np.random.default_rng(9)
    img = (rng.random((96, 80, 3)) * 255).astype(np.uint8)

    def teeth(x):
        return _glue_net(x), (x[..., :1] + 1) / 2

    for mouth in ((18.0, 50.0, 66.0, 80.0), (70.0, 90.0, 74.0, 93.0)):
        np.testing.assert_array_equal(TE.enhance_teeth(img, mouth, teeth),
                                      JE.enhance_teeth(img, mouth, teeth))


# --------------------------------------------------- postprocess_frames

@pytest.fixture(scope="module")
def post_files(tmp_path_factory):
    """Seeded checkpoints of the three frame passes, keyed as the
    reference's files: the teeth net, a GPEN at 512 px (narrowed: style 16,
    2 MLP layers, channel multiplier 1) and RIFE at c = 16 (with
    flownet.pkl's ``module.`` prefix)."""
    d = tmp_path_factory.mktemp("post")
    paths = {}
    for i, (name, build, prefix) in enumerate((
            ("teeth", TT.TeethEnhancer, ""),
            ("bfr", functools.partial(TG.GPENGenerator, **GPEN_CLI), ""),
            ("rife", functools.partial(TR.IFNet, 16), "module."))):
        torch.manual_seed(i)
        paths[name] = str(d / f"{name}.pth")
        torch.save({prefix + k: v for k, v in build().state_dict().items()},
                   paths[name])
    return paths


def _strip_module(sd):
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _configs(paths, **flags):
    kw = dict(use_teeth_enhance=True, use_interframe=True,
              teeth_checkpoint_path=paths["teeth"], bfr_checkpoint_path=paths["bfr"],
              rife_checkpoint_path=paths["rife"])
    kw.update(flags)
    extras = {"use_bfr_frames": True}
    return InferenceConfig(**kw, extras=dict(extras)), \
        JInferenceConfig(**kw, extras=dict(extras))


def test_postprocess_frames_matches_jax(post_files, monkeypatch):
    """Teeth, frame BFR (on landmarks) and RIFE on two micro-model-sized
    frames, against the JAX CLI's ``postprocess_frames`` on the same files
    (its GPEN and IFNet built at the files' widths, its RIFE converter the
    port's, which flips the transposed convs, given the file's entries
    without their ``module.`` prefix, which the JAX CLI does not strip; its
    BFR mask in float32, so that it pastes the restored face)."""
    monkeypatch.setattr(JG, "GPENGenerator", functools.partial(JG.GPENGenerator, **GPEN_CLI))
    monkeypatch.setattr(JR, "IFNet", functools.partial(JR.IFNet, c=16))
    monkeypatch.setattr(JW, "convert_rife", lambda sd: X.convert_rife(_strip_module(sd)))
    _jax_mask_float32(monkeypatch)
    cfg, jcfg = _configs(post_files)
    rng = np.random.default_rng(13)
    frames = rng.random((2, 64, 64, 3)).astype(np.float32)
    box = (10.0, 8.0, 54.0, 60.0)
    lm = JE.box_to_landmarks(box) + rng.normal(0, 1.5, (5, 2)).astype(np.float32)
    stages = cli._Stages(torch.device("cpu"))
    got = cli.postprocess_frames(cfg, frames, box, landmarks=lm,
                                 device=torch.device("cpu"), stages=stages)
    ref = jcli.postprocess_frames(jcfg, frames, box, landmarks=lm)
    assert got.shape == (3, 64, 64, 3) and set(stages.seconds) == {
        "teeth", "bfr_frames", "rife"}
    assert np.abs(got - ref).max() <= 2 / 255 + 1e-6
    assert np.abs(got - ref).mean() < 1e-4


def test_postprocess_frames_skips_what_it_lacks(post_files):
    """A pass asked for without its checkpoint is skipped, as in the JAX
    CLI; nothing asked for returns the frames as they are."""
    frames = np.random.default_rng(14).random((2, 32, 32, 3)).astype(np.float32)
    box = (4.0, 4.0, 28.0, 28.0)
    cfg, _ = _configs(post_files, teeth_checkpoint_path="", rife_checkpoint_path="/no/file")
    cfg.extras["use_bfr_frames"] = False
    assert cli.postprocess_frames(cfg, frames, box, device=torch.device("cpu")) is frames
    cfg = InferenceConfig(use_teeth_enhance=False, use_interframe=True,
                          rife_checkpoint_path=post_files["rife"])
    out = cli.postprocess_frames(cfg, frames, box, device=torch.device("cpu"))
    assert out.shape == (3, 32, 32, 3)


# ------------------------------------------- published widths, shapes only

def _zeros_like_tree(tree):
    return jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)


def _shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in X._flatten_params(
        tree.get("params", tree)).items()}


@pytest.mark.parametrize("name", ["bfr", "teeth", "rife"])
def test_published_widths_round_trip(name):
    """GPEN-512 (style 512, 8 MLP layers, multiplier 2), the teeth net and
    IFNet (c = 90): the JAX init's shapes -> the port's exporter -> a state
    dict whose keys and shapes are the port module's -> the port's
    converter -> the JAX init's shapes again."""
    if name == "bfr":
        jnet, tnet = JG.GPENGenerator(), TG.GPENGenerator()
        spec = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3)))
        export, conv = functools.partial(X.export_bfr, keys=tnet.state_dict().keys()), \
            X.convert_bfr
    elif name == "teeth":
        jnet, tnet = JT.TeethEnhancer(), TT.TeethEnhancer()
        spec = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
        export, conv = X.export_teeth, X.convert_teeth
    else:
        jnet, tnet = JR.IFNet(), TR.IFNet()
        z = jnp.zeros((1, 64, 64, 3))
        spec = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), z, z)
        export, conv = X.export_rife, X.convert_rife
    params = _zeros_like_tree(spec)
    sd = export(params)
    want = {k: tuple(v.shape) for k, v in tnet.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert _shapes(conv(sd)) == _shapes(params)
