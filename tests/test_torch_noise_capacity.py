"""PyTorch port against the JAX package (fp32, CPU): video-fusion noise, the
churned sampler's draw, the SSM blocks' static-capacity gather
(``_capacity_fracs``, ``SS2DCondV10`` with ``capacity_frac``, the overflow
poison) and ``generate_latents`` in mode 0 with a face box.

Parameters go JAX -> port through the JAX package's exporters and load with
``strict=True``; inputs are seeded numpy arrays. Tolerances: exact where the
arithmetic is the same (the noise mix, the capacity fractions);
rtol=1e-4 / atol=1e-5 for the blocks and the sampler (fp32 both sides,
summation order); 1e-3 of the largest latent for ``generate_latents``
(guidance 7.5 amplifies UNet differences, as in test_torch_pipeline.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.diffusion import noise as jnoise
from actalker_tpu.io import weights as W
from actalker_tpu.models import ssm as jssm
from actalker_tpu.models.unet import UNetConfig as JUNetConfig
from actalker_tpu.pipeline import sampler as jsampler
from actalker_tpu.pipeline.pipeline import (
    ACTalkerPipeline as JPipeline, PipelineModules as JModules)
from actalker_tpu_torch.diffusion import noise as tnoise
from actalker_tpu_torch.models import ssm
from actalker_tpu_torch.models.unet import UNetConfig
from actalker_tpu_torch.pipeline import sampler as tsampler
from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline, PipelineModules
from tests.test_torch_blocks import _export, _init, _rand
from tests.test_torch_pipeline import _run_both, pipes  # noqa: F401 (fixture)
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 1e-5


# ------------------------------------------------------------------ noise

@pytest.mark.parametrize("w_ind", [0.0, 0.3, 0.5, 1.0])
def test_video_fusion_noise_on_injected_draws_is_exact(w_ind):
    rng = np.random.default_rng(0)
    shape = (2, 5, 4, 6, 7)
    common = _rand(rng, 2, 1, 4, 6, 7)
    ind = _rand(rng, *shape)
    ref = jnoise.video_fusion_noise(
        jax.random.PRNGKey(0), shape, w_ind, initial_common_noise=jnp.asarray(common),
        initial_ind_noise=jnp.asarray(ind))
    port = tnoise.video_fusion_noise(
        None, shape, w_ind, initial_common_noise=torch.from_numpy(common),
        initial_ind_noise=torch.from_numpy(ind))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_noise_draws_follow_their_generator():
    """Without injected draws: the shapes, the seed repeats the draw, the
    noise offset is one constant per (batch, channel), and
    ``w_ind_noise`` = 0 makes every frame the common draw."""
    def gen(seed):
        return torch.Generator().manual_seed(seed)

    shape = (2, 5, 4, 6, 7)
    a = tnoise.video_fusion_noise(gen(1), shape, 0.5)
    assert a.shape == shape
    torch.testing.assert_close(a, tnoise.video_fusion_noise(gen(1), shape, 0.5),
                               rtol=0, atol=0)
    same = tnoise.video_fusion_noise(gen(1), shape, 0.0)
    torch.testing.assert_close(same, same[:, :1].expand(shape), rtol=0, atol=0)
    base = tnoise.random_noise(gen(2), shape)
    off = tnoise.random_noise(gen(2), shape, noise_offset=0.1)
    shift = off - base
    torch.testing.assert_close(shift, shift[:, :1, :, :1, :1].expand(shape))
    assert shift.abs().max() > 0


def test_churned_sampler_video_fusion_matches_jax(monkeypatch):
    """``s_churn`` > 0 with ``noise_type="video_fusion"``: the same injected
    common / per-frame draws in every window and step on both sides (the
    JAX sampler gets them through its own ``video_fusion_noise``). The JAX
    churn hands ``moveaxis(n5[0], 0, -1)``, a (C, h, w, F) array, where the
    Euler step wants (F, h, w, C) (ROADMAP queue 3, reference problems);
    the patched JAX draw is laid out so that its result is the (F, h, w, C)
    draw the port takes."""
    fpb, h, w, nf = 2, 4, 4, 3
    kw = dict(num_inference_steps=3, frames_per_batch=fpb, shift_offset=1,
              s_churn=2.0, noise_type="video_fusion", w_ind_noise=0.3,
              gate=(1, 0))
    jcfg, tcfg = jsampler.SamplerConfig(**kw), tsampler.SamplerConfig(**kw)
    plan = tsampler.make_plan(tcfg, nf)
    assert (plan.gammas > 0).all()
    rng = np.random.default_rng(3)
    common, ind = _rand(rng, 1, 1, 4, h, w), _rand(rng, 1, fpb, 4, h, w)
    buf = plan.buffer_len
    arrays = dict(id_tokens=_rand(rng, buf, 1, 8), audio_tokens=_rand(rng, buf, 32, 8),
                  audio_tokens_u=_rand(rng, buf, 32, 8), vasa_tokens=_rand(rng, buf, 1, 8),
                  vasa_tokens_u=_rand(rng, buf, 1, 8),
                  image_latents=_rand(rng, buf, h, w, 4), pose_fea=_rand(rng, buf, h, w, 4))
    ref_latent = _rand(rng, h, w, 4)
    init = _rand(rng, buf, h, w, 4)
    ones = np.ones((1, 1, 8 * h, 8 * w), np.float32)

    orig_j = jnoise.video_fusion_noise

    def jax_draw(key, shape, w_ind, dtype=jnp.float32):
        n5 = orig_j(key, shape, w_ind, initial_common_noise=jnp.asarray(common),
                    initial_ind_noise=jnp.asarray(ind))
        want = jnp.moveaxis(n5[0], 1, -1)                 # (F, h, w, C)
        return jnp.moveaxis(want, -1, 0)[None]            # undone by moveaxis(0, -1)

    orig_t = tnoise.video_fusion_noise

    def port_draw(gen, shape, w_ind, **kw_):
        nw = shape[0]
        return orig_t(gen, shape, w_ind,
                      initial_common_noise=torch.from_numpy(common).expand(nw, -1, -1, -1, -1),
                      initial_ind_noise=torch.from_numpy(ind).expand(nw, -1, -1, -1, -1),
                      device=kw_.get("device"))

    monkeypatch.setattr(jnoise, "video_fusion_noise", jax_draw)
    monkeypatch.setattr(tnoise, "video_fusion_noise", port_draw)

    def j_unet(params, sample, t, cond, tids, pose):
        b, f = sample.shape[:2]
        a = cond.audio_tokens.reshape(b, f, -1).mean(-1)[:, :, None, None, None]
        return (0.3 * sample[..., :4] - 0.2 * sample[..., 4:8] + 0.05 * a
                + 0.1 * pose.mean(-1, keepdims=True))

    def t_unet(sample, t, cond, tids, pose):
        b, f = sample.shape[:2]
        a = cond.audio_tokens.reshape(b, f, -1).mean(-1)[:, :, None, None, None]
        return (0.3 * sample[..., :4] - 0.2 * sample[..., 4:8] + 0.05 * a
                + 0.1 * pose.mean(-1, keepdim=True))

    jbufs = jsampler.CondBuffers(**{k: jnp.asarray(v) for k, v in arrays.items()},
                                 audio_mask=jnp.asarray(ones), exp_mask=jnp.asarray(ones))
    ref = jsampler.sample_video(j_unet, None, jcfg, jsampler.make_plan(jcfg, nf), jbufs,
                                jnp.asarray(ref_latent), jax.random.PRNGKey(0),
                                dtype=jnp.float32, init_noise=jnp.asarray(init))
    tbufs = tsampler.CondBuffers(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                                 audio_mask=torch.from_numpy(ones),
                                 exp_mask=torch.from_numpy(ones))
    port = tsampler.sample_video(t_unet, tcfg, plan, tbufs, torch.from_numpy(ref_latent),
                                 dtype=torch.float32, init_noise=torch.from_numpy(init))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_sampler_refuses_an_unknown_noise_type():
    cfg = tsampler.SamplerConfig(noise_type="pink")
    with pytest.raises(ValueError, match="noise_type"):
        tsampler._churn_noise(cfg, (1, 2, 2, 2, 4), None, "cpu")


# ------------------------------------------------------- capacity fractions

def _box(px, y0, y1, x0, x1, rows=1):
    m = np.zeros((rows, 1, px, px), np.float32)
    m[..., y0:y1, x0:x1] = 1.0
    return m


_UNETS = {"default": ((JUNetConfig(), UNetConfig())),
          "micro": ((JUNetConfig().micro(), UNetConfig().micro()))}
_MASKS = {
    "box 31%": lambda px: _box(px, px // 4, px // 4 + int(px * 0.56),
                               px // 5, px // 5 + int(px * 0.56)),
    "box small": lambda px: _box(px, px // 8, px // 8 + px // 4, px // 3, px // 3 + px // 4),
    "box tall": lambda px: _box(px, 0, px, px // 3, px // 2),
    "box 80%": lambda px: _box(px, 0, int(px * 0.9), 0, int(px * 0.9)),
    "all ones": lambda px: np.ones((1, 1, px, px), np.float32),
    "none": lambda px: None,
}


@pytest.fixture(scope="module")
def capacity_pipes():
    """(JAX pipeline, port pipeline) pairs holding only their UNet configs
    (``_capacity_fracs`` reads nothing else)."""
    out = {}
    for name, (jc, tc) in _UNETS.items():
        with torch.device("meta"):
            tm = PipelineModules.create(unet_config=tc)
        out[name] = (JPipeline(JModules.create(unet_config=jc), {}),
                     ACTalkerPipeline(tm))
    return out


@pytest.mark.parametrize("unet", sorted(_UNETS))
@pytest.mark.parametrize("mask", sorted(_MASKS))
@pytest.mark.parametrize("gate", [(1, 0), (0, 1), (1, 1)])
@pytest.mark.parametrize("px", [64, 512, 576])
def test_capacity_fracs_equal_jax(capacity_pipes, unet, mask, gate, px):
    jp, tp = capacity_pipes[unet]
    m = _MASKS[mask](px)
    audio, exp = (m, None) if gate == (1, 0) else (None, m) if gate == (0, 1) else (m, m)
    args = (audio, exp, (px // 8, px // 8))
    assert tp._capacity_fracs(tsampler.SamplerConfig(gate=gate), *args) == \
        jp._capacity_fracs(jsampler.SamplerConfig(gate=gate), *args)


def test_capacity_fracs_of_a_31_percent_box_gather():
    """The C9 box (about 31% of a 512 px image) gives a 6/16 budget in mode
    0 (its worst resolution, res-16, selects 33% of the tokens) and none
    for the gated-off branch."""
    with torch.device("meta"):
        tp = ACTalkerPipeline(PipelineModules.create())
    box = _MASKS["box 31%"](512)
    assert 0.30 <= box.mean() <= 0.32
    assert tp._capacity_fracs(tsampler.SamplerConfig(gate=(1, 0)), box, None,
                              (64, 64)) == (0.375, 0.0)


# ---------------------------------------------------------- gather blocks

def _ragged_boxes(px, rows):
    """One face box per row, of different sizes (ragged selected counts)."""
    m = np.zeros((rows, 1, px, px), np.float32)
    for r in range(rows):
        m[r, :, 4 + r:30 + 3 * r, 8:20 + 5 * r] = 1.0
    return m


_GATHER_CASES = {
    # name: (gate, audio mask, exp mask, capacity)
    "mode0 box": ((1, 0), _box(64, 10, 42, 14, 50), np.zeros((1, 1, 64, 64), np.float32),
                  (0.375, 0.0)),
    "mode1 box": ((0, 1), np.zeros((1, 1, 64, 64), np.float32), _box(64, 8, 40, 16, 48),
                  (0.0, 0.3125)),
    "mode0 ragged rows": ((1, 0), _ragged_boxes(64, 4), np.zeros((1, 1, 64, 64), np.float32),
                          (0.5, 0.0)),
    "mode1 ragged rows": ((0, 1), np.zeros((1, 1, 64, 64), np.float32), _ragged_boxes(64, 4),
                          (0.0, 0.5)),
    "mode0 empty box": ((1, 0), np.zeros((1, 1, 64, 64), np.float32),
                        np.zeros((1, 1, 64, 64), np.float32), (0.0625, 0.0)),
    "both branches small": ((1, 1), _box(64, 10, 42, 14, 50), _box(64, 8, 40, 16, 48),
                            (0.375, 0.3125)),
}


def _gather_pair(capacity, overflow="nan", d_model=64, seed=0):
    rng = np.random.default_rng(seed)
    b, l = 4, 64
    ins = (_rand(rng, b, l, d_model), _rand(rng, b, 1, 48), _rand(rng, b, 32, 48),
           _rand(rng, b, 1, 48))
    jm = jssm.SS2DCondV10(d_model=d_model, d_cond=48, capacity_frac=capacity,
                          capacity_overflow=overflow)
    ones = jnp.ones((1, 1, 64, 64))
    p = _init(jm, *map(jnp.asarray, ins), ones, ones, scale=0.3)
    tm = ssm.SS2DCondV10(d_model, d_cond=48, capacity_frac=capacity,
                         capacity_overflow=overflow)
    tm.load_state_dict(_export(W._mamba_v10, p), strict=True)
    return jm, p, tm, ins


@pytest.mark.parametrize("case", sorted(_GATHER_CASES))
def test_ss2d_gather_matches_jax_and_masked_dense(case):
    """The port's gather against the JAX package's (which runs K1's Pallas
    kernel in interpret mode at d_inner 128), and against the port's own
    masked-dense scan of the same block (capacity None)."""
    _, audio_mask, exp_mask, capacity = _GATHER_CASES[case]
    jm, p, tm, ins = _gather_pair(capacity)
    ref = jm.apply(p, *map(jnp.asarray, ins + (audio_mask, exp_mask)))
    targs = tuple(map(torch.from_numpy, ins + (audio_mask, exp_mask)))
    with torch.no_grad():
        port = tm(*targs)
        tm.capacity_frac = None
        dense = tm(*targs)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.numpy(), dense.numpy(), rtol=RTOL, atol=ATOL)


def test_gather_scans_the_compacted_rows(monkeypatch):
    """K1's call sees max(K + tail) rows per branch, not L + tail: 24 + 33
    rows for a 3/8 budget of 64 tokens (the gated-off branch scans only its
    2-row tail), one call per block."""
    _, audio_mask, exp_mask, capacity = _GATHER_CASES["mode0 box"]
    _, _, tm, ins = _gather_pair(capacity)
    seen = []
    real = ssm.ssm_scan_grouped

    def spy(u_g, *a):
        seen.append(tuple(u_g.shape))
        return real(u_g, *a)

    monkeypatch.setattr(ssm, "ssm_scan_grouped", spy)
    with torch.no_grad():
        tm(*map(torch.from_numpy, ins + (audio_mask, exp_mask)))
    assert seen == [(24 + 33, 4, 2 * 128)]


def test_compact_rows_keeps_token_order_and_drops_overflow():
    sel = torch.tensor([[0, 1, 1, 0, 1, 1],
                        [1, 0, 0, 0, 0, 0],
                        [0, 0, 0, 0, 0, 0]], dtype=torch.bool)
    rows, act = ssm._compact_rows(sel, 3)
    b, l = sel.shape
    tok = torch.where(act, rows % l, torch.full_like(rows, -1)).t()
    assert tok.tolist() == [[1, 2, 4], [0, -1, -1], [-1, -1, -1]]
    assert (rows[~act] % l == l - 1).all()
    assert ((rows // l) == torch.arange(b).expand(3, b)).all()


@pytest.mark.parametrize("overflow", ["nan", "drop"])
def test_overflowed_capacity(overflow):
    """A box larger than the budget: "nan" poisons the whole output on both
    sides; "drop" leaves the tokens past the budget unscanned, on both
    sides alike."""
    box = _box(64, 0, 48, 0, 48)                 # ~56% of the tokens
    zeros = np.zeros((1, 1, 64, 64), np.float32)
    jm, p, tm, ins = _gather_pair((0.125, 0.0), overflow=overflow)
    ref = np.asarray(jm.apply(p, *map(jnp.asarray, ins + (box, zeros))))
    with torch.no_grad():
        port = tm(*map(torch.from_numpy, ins + (box, zeros))).numpy()
    if overflow == "nan":
        assert np.isnan(ref).all() and np.isnan(port).all()
    else:
        assert np.isfinite(port).all()
        np.testing.assert_allclose(port, ref, rtol=RTOL, atol=ATOL)


def test_unet_mask_capacity_reaches_every_block():
    unet = UNetConfig().micro()
    from actalker_tpu_torch.models.unet import UNetSpatioTemporalCondition

    with torch.device("meta"):
        m = UNetSpatioTemporalCondition(dataclasses.replace(unet, mask_capacity=(0.25, 0.0)))
    blocks = [x for x in m.modules() if isinstance(x, ssm.SS2DCondV10)]
    assert blocks and all(x.capacity_frac == (0.25, 0.0) for x in blocks)
    m.set_mask_capacity(None)
    assert m.config.mask_capacity is None
    assert all(x.capacity_frac is None for x in blocks)


# --------------------------------------------------------- generate_latents

def test_generate_latents_mode0_gather(pipes, monkeypatch):  # noqa: F811
    """Mode 0 with a face box: the port's ``generate_latents`` takes the
    gather (every SS2D block sees the budget, and K1 the compacted rows)
    and matches the JAX package's gather and the port's own masked-dense
    run (``gather=False``)."""
    jpipe, tpipe, _ = pipes
    box = np.zeros((1, 1, 64, 64), np.float32)
    box[..., 8:40, 8:56] = 1.0
    caps = []
    real = ssm.SS2DCondV10.forward

    def spy(self, x, *a):
        caps.append((self.capacity_frac, x.shape[1]))
        return real(self, x, *a)

    monkeypatch.setattr(ssm.SS2DCondV10, "forward", spy)
    lat_j, lat_t = _run_both(jpipe, tpipe, gate=(1, 0), audio_mask=box)
    assert caps and all(c == (0.375, 0.0) for c, _ in caps)
    assert tpipe.m.unet.config.mask_capacity is None       # restored
    ref = np.asarray(lat_j)
    tol = 1e-3 * np.abs(ref).max()
    assert np.abs(lat_t.numpy() - ref).max() <= tol
    tpipe.gather = False
    try:
        caps.clear()
        _, lat_d = _run_both(jpipe, tpipe, gate=(1, 0), audio_mask=box)
    finally:
        tpipe.gather = True
    assert caps and all(c is None for c, _ in caps)
    assert np.abs(lat_t.numpy() - lat_d.numpy()).max() <= tol
