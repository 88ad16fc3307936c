"""PyTorch port, block layer against the JAX package (fp32, CPU): scheduler
tables and ``step``; embeddings; ``downsample_ip_mask``; ``Attention`` with
region-masked IP branches; both transformer blocks; the spatio-temporal
resnet; and ``SS2DCondV10`` with a face-box mask.

Parameters go JAX -> port through the JAX package's own exporters (the
reference-keyed state dicts), loaded with ``strict=True``. ``SS2DCondV10``
runs at two widths: d_model = 64 (d_inner 128), where the JAX side takes
the grouped Pallas scan K1 (interpret mode), and d_model = 32 (d_inner 64),
where it takes ``SS2DUnit``'s per-direction Pallas scan; the port computes
both with its one grouped op.

Tolerance rtol=1e-4, atol=1e-5 unless stated: fp32 on both sides, differing
only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.diffusion import scheduler as jsch
from actalker_tpu.io import weights as W
from actalker_tpu.io.init import random_like
from actalker_tpu.models import attention_blocks as jab, embeddings as jemb
from actalker_tpu.models import resnet as jres, ssm as jssm
from actalker_tpu_torch.diffusion import scheduler as sch
from actalker_tpu_torch.io.weights import to_torch
from actalker_tpu_torch.models import attention_blocks as ab, embeddings as emb
from actalker_tpu_torch.models import resnet, ssm

RTOL, ATOL = 1e-4, 1e-5


def _close(port, ref, rtol=RTOL, atol=ATOL):
    if torch.is_tensor(port):
        port = port.detach().numpy()
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


def _init(module, *args, scale=0.2, seed=0):
    """Random JAX params (normal * scale) of ``module`` for ``args``."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args),
                            jax.random.PRNGKey(0))
    return random_like(shapes, scale=scale, seed=seed)


def _export(spec_fn, params, **kw):
    """JAX block params -> the reference-keyed torch state dict, through the
    JAX package's converter spec for that block (``io/weights.py``)."""
    def convert(sd):
        spec_fn({}, "m", sd, "m", **kw)

    sd = W.export_state_dict(convert, {"m": params["params"]})
    W._complete_attn_qk(sd)
    return to_torch({k[len("m."):]: v for k, v in sd.items()})


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------------------------------------- scheduler

_SCHED_VARIANTS = [
    {},
    {"timestep_spacing": "linspace"},
    {"timestep_spacing": "trailing", "beta_schedule": "linear"},
    {"use_karras_sigmas": False, "interpolation_type": "log_linear"},
    {"timestep_type": "discrete"},
    {"timestep_type": "discrete", "use_karras_sigmas": False},
]


@pytest.mark.parametrize("variant", _SCHED_VARIANTS)
@pytest.mark.parametrize("n,strength", [(25, 1.0), (10, 0.6)])
def test_scheduler_tables(variant, n, strength):
    js, jt = jsch.set_timesteps(jsch.EulerDiscreteConfig(**variant), n)
    ts, tt = sch.set_timesteps(sch.EulerDiscreteConfig(**variant), n)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tt, jt)
    for a, b in zip(sch.i2i_truncate(ts, tt, n, strength),
                    jsch.i2i_truncate(js, jt, n, strength)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    {},
    {"num_inference_steps": 6, "frames_per_batch": 4, "overlap": 1,
     "shift_offset": 3, "i2i_noise_strength": 0.7, "min_guidance1": 1.0,
     "max_guidance1": 3.0, "s_churn": 2.0, "s_tmin": 0.5, "s_tmax": 50.0},
])
def test_make_plan_matches_jax(kw):
    from actalker_tpu.pipeline.sampler import SamplerConfig as JCfg, make_plan as jplan
    from actalker_tpu_torch.pipeline.sampler import SamplerConfig, make_plan

    port, ref = make_plan(SamplerConfig(**kw), 9), jplan(JCfg(**kw), 9)
    for field in ("sigmas", "timesteps", "guidance1", "guidance2", "guidance3",
                  "gammas", "window_idx", "buffer_len", "num_frames"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field),
                                      err_msg=field)


def test_sampler_churn_is_seeded():
    """With churn on, the noise comes from the sampler's generator: the same
    seed repeats the latents, another seed changes them. (A stand-in UNet
    keeps this a test of the loop, not of the model.)"""
    from actalker_tpu_torch.pipeline.sampler import (
        CondBuffers, SamplerConfig, make_plan, sample_video)

    cfg = SamplerConfig(num_inference_steps=3, frames_per_batch=2,
                        shift_offset=1, s_churn=3.0)
    plan = make_plan(cfg, 3)
    assert (plan.gammas > 0).all()
    buf = plan.buffer_len
    bufs = CondBuffers(
        id_tokens=torch.zeros(buf, 1, 8), audio_tokens=torch.zeros(buf, 32, 8),
        audio_tokens_u=torch.zeros(buf, 32, 8), vasa_tokens=torch.zeros(buf, 1, 8),
        vasa_tokens_u=torch.zeros(buf, 1, 8), image_latents=torch.zeros(buf, 2, 2, 4),
        pose_fea=torch.zeros(buf, 2, 2, 8), audio_mask=None, exp_mask=None)

    def unet(inp, t, cond, tids, pose):
        return 0.1 * inp[..., :4]

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return sample_video(unet, cfg, plan, bufs, torch.ones(2, 2, 4),
                            generator=gen, dtype=torch.float32)

    a, b, c = run(0), run(0), run(1)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)


@pytest.mark.parametrize("pred", ["v_prediction", "epsilon", "sample"])
@pytest.mark.parametrize("gamma", [0.0, 0.3])
def test_scheduler_step_and_noise(pred, gamma):
    rng = np.random.default_rng(0)
    x, out, noise = (_rand(rng, 3, 4, 4, 4) for _ in range(3))
    sigma, sigma_next = np.float32(3.7), np.float32(1.2)
    churn = noise if gamma else None
    port = sch.step(torch.from_numpy(x), torch.from_numpy(out), float(sigma),
                    float(sigma_next), pred, gamma=gamma,
                    noise=None if churn is None else torch.from_numpy(churn),
                    s_noise=1.0)
    ref = jsch.step(jnp.asarray(x), jnp.asarray(out), sigma, sigma_next, pred,
                    gamma=gamma, noise=None if churn is None else jnp.asarray(churn))
    _close(port, ref)
    _close(sch.scale_model_input(torch.from_numpy(x), float(sigma)),
           jsch.scale_model_input(jnp.asarray(x), sigma))
    _close(sch.add_noise(torch.from_numpy(x), torch.from_numpy(noise), float(sigma)),
           jsch.add_noise(jnp.asarray(x), jnp.asarray(noise), sigma))


# ------------------------------------------------------------ embeddings

def test_embeddings_and_alpha_blender():
    t = np.array([0.0, 1.5, -2.25, 700.0], np.float32)
    for dim in (64, 65):
        _close(emb.sinusoidal_embedding(torch.from_numpy(t), dim),
               jemb.sinusoidal_embedding(jnp.asarray(t), dim))
    rng = np.random.default_rng(1)
    x = _rand(rng, 4, 32)
    jm = jemb.TimestepEmbedding(48, out_dim=16)
    p = _init(jm, jnp.asarray(x))
    tm = emb.TimestepEmbedding(32, 48, 16)
    tm.load_state_dict(_export(
        lambda d, pre, sd, src: (W._linear(d, f"{pre}/linear_1", sd, f"{src}.linear_1"),
                                 W._linear(d, f"{pre}/linear_2", sd, f"{src}.linear_2")),
        p), strict=True)
    _close(tm(torch.from_numpy(x)), jm.apply(p, jnp.asarray(x)))
    xs, xt = _rand(rng, 2, 3, 4, 4, 8), _rand(rng, 2, 3, 4, 4, 8)
    ind = np.array([[0, 1, 0], [0, 0, 0]], np.float32)
    jb = jemb.AlphaBlender(alpha_init=0.3)
    pb = jb.init(jax.random.PRNGKey(0), xs, xt, ind)
    tb = emb.AlphaBlender(0.3)
    _close(tb(*map(torch.from_numpy, (xs, xt, ind))),
           jb.apply(pb, *map(jnp.asarray, (xs, xt, ind))))


# ------------------------------------------------------------- attention

def _box_mask(h=64, w=64):
    m = np.zeros((1, 1, h, w), np.float32)
    m[..., 10:42, 14:50] = 1.0
    return m


@pytest.mark.parametrize("num_queries", [64, 256, 100])
def test_downsample_ip_mask_and_selection(num_queries):
    """The resize must match exactly enough that the SSM's >= 1 - 1e-6 token
    selection agrees token for token."""
    mask = _box_mask(64, 48)
    port = ab.downsample_ip_mask(torch.from_numpy(mask), num_queries)
    ref = jab.downsample_ip_mask(jnp.asarray(mask), num_queries)
    _close(port, ref)
    np.testing.assert_array_equal(port.numpy() >= 1 - 1e-6,
                                  np.asarray(ref) >= 1 - 1e-6)


def test_attention_with_masked_ip_branches():
    """Self-attention (K2 path) and cross-attention over id tokens with two
    IP branches (32 audio tokens, 1 vasa token), each region-masked."""
    rng = np.random.default_rng(2)
    b, s, c, heads = 4, 64, 32, 2
    x = _rand(rng, b, s, c)
    ctx, aud, vas = _rand(rng, b, 1, 48), _rand(rng, b, 32, 48), _rand(rng, b, 1, 48)
    masks = [_box_mask(), np.ones((1, 1, 64, 64), np.float32)]
    jself = jab.Attention(heads, c // heads)
    ps = _init(jself, jnp.asarray(x))
    tself = ab.Attention(c, heads, c // heads)
    tself.load_state_dict(_export(W._attention, ps), strict=True)
    _close(tself(torch.from_numpy(x)), jself.apply(ps, jnp.asarray(x)))

    jx = jab.Attention(heads, c // heads, context_dim=48, num_adapters=2)
    jargs = (jnp.asarray(x), jnp.asarray(ctx), [jnp.asarray(aud), jnp.asarray(vas)],
             (1.25, 0.75), [jnp.asarray(m) for m in masks])
    px = _init(jx, *jargs)
    tx = ab.Attention(c, heads, c // heads, context_dim=48, num_adapters=2)
    tx.load_state_dict(_export(W._attention, px, num_adapters=2), strict=True)
    port = tx(torch.from_numpy(x), torch.from_numpy(ctx),
              [torch.from_numpy(aud), torch.from_numpy(vas)], (1.25, 0.75),
              [torch.from_numpy(m) for m in masks])
    _close(port, jx.apply(px, *jargs))


def test_basic_and_temporal_transformer_blocks():
    rng = np.random.default_rng(3)
    b, f, s, c, heads = 1, 3, 16, 32, 2
    x = _rand(rng, b * f, s, c)
    ctx, aud, vas = (_rand(rng, b * f, n, 48) for n in (1, 32, 1))
    masks = [_box_mask(), None]
    jb = jab.BasicTransformerBlock(heads, c // heads, context_dim=48,
                                   num_adapters=2)
    jargs = (jnp.asarray(x), jnp.asarray(ctx), [jnp.asarray(aud), jnp.asarray(vas)],
             (1.25, 1.25), [jnp.asarray(masks[0]), None])
    pb = _init(jb, *jargs)
    tb = ab.BasicTransformerBlock(c, heads, c // heads, 48, 2)
    tb.load_state_dict(_export(W._basic_block, pb), strict=True)
    _close(tb(torch.from_numpy(x), torch.from_numpy(ctx),
              [torch.from_numpy(aud), torch.from_numpy(vas)], (1.25, 1.25),
              [torch.from_numpy(masks[0]), None]), jb.apply(pb, *jargs))

    pooled = [t.reshape(b, f, *t.shape[1:]).mean(1) for t in (ctx, aud, vas)]
    jt = jab.TemporalBasicTransformerBlock(heads, c // heads, context_dim=48,
                                           num_adapters=2)
    targs = (jnp.asarray(x), f, jnp.asarray(pooled[0]),
             [jnp.asarray(pooled[1]), jnp.asarray(pooled[2])], (1.25, 1.25))
    pt = _init(jt, *targs)
    tt = ab.TemporalBasicTransformerBlock(c, heads, c // heads, 48, 2)
    tt.load_state_dict(_export(W._temporal_block, pt), strict=True)
    _close(tt(torch.from_numpy(x), f, torch.from_numpy(pooled[0]),
              [torch.from_numpy(pooled[1]), torch.from_numpy(pooled[2])],
              (1.25, 1.25)), jt.apply(pt, *targs))


@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 32)])
def test_spatio_temporal_res_block(cin, cout):
    rng = np.random.default_rng(4)
    b, f, h = 2, 3, 8
    x, temb = _rand(rng, b, f, h, h, cin), _rand(rng, b * f, 24)
    ind = np.zeros((b, f), np.float32)
    jm = jres.SpatioTemporalResBlock(cout, eps=1e-6)
    p = _init(jm, jnp.asarray(x), jnp.asarray(temb), jnp.asarray(ind))
    tm = resnet.SpatioTemporalResBlock(cin, cout, 24, eps=1e-6)
    tm.load_state_dict(_export(W._st_resblock, p), strict=True)
    _close(tm(*map(torch.from_numpy, (x, temb, ind))),
           jm.apply(p, *map(jnp.asarray, (x, temb, ind))), rtol=1e-4, atol=3e-5)


# ------------------------------------------------------------------ SSM

@pytest.mark.parametrize("d_model", [64, 32])
def test_ss2d_cond_v10_box_mask(d_model):
    """Masked-dense SS2DCondV10 with a face-box audio mask (some tokens
    deselected) and an all-on expression branch; identity + 32 audio / 1
    vasa tail tokens."""
    rng = np.random.default_rng(5)
    b, l = 4, 64
    x = _rand(rng, b, l, d_model)
    id_emb, aud, vas = _rand(rng, b, 1, 48), _rand(rng, b, 32, 48), _rand(rng, b, 1, 48)
    masks = (_box_mask(), np.ones((1, 1, 64, 64), np.float32))
    jm = jssm.SS2DCondV10(d_model=d_model, d_cond=48)
    jargs = tuple(map(jnp.asarray, (x, id_emb, aud, vas) + masks))
    p = _init(jm, *jargs, scale=0.3)
    tm = ssm.SS2DCondV10(d_model, d_cond=48)
    tm.load_state_dict(_export(W._mamba_v10, p), strict=True)
    port = tm(*map(torch.from_numpy, (x, id_emb, aud, vas) + masks))
    _close(port, jm.apply(p, *jargs))


def test_init_and_bf16_cast_follow_jax_rules():
    """``cast_params_bf16_`` makes bf16 exactly the leaves the JAX package's
    ``cast_params_bf16`` makes bf16 (>= 2-D weights except the scan's
    ``A_logs`` / ``dt_projs_*``); ``random_init_`` materializes a module
    built on the meta device, reproducibly from its seed."""
    from actalker_tpu.io.init import cast_params_bf16
    from actalker_tpu_torch.io.init import cast_params_bf16_, random_init_

    rng = np.random.default_rng(6)
    args = (_rand(rng, 2, 16, 64), _rand(rng, 2, 1, 48), _rand(rng, 2, 32, 48),
            _rand(rng, 2, 1, 48), None, None)
    jm = jssm.SS2DCondV10(d_model=64, d_cond=48)
    p = cast_params_bf16(_init(jm, *(None if a is None else jnp.asarray(a)
                                     for a in args)))
    sd = W.export_state_dict(lambda s: W._mamba_v10({}, "m", s, "m"),
                             {"m": p["params"]})
    want = {k[len("m."):]: str(np.asarray(v).dtype) == "bfloat16"
            for k, v in sd.items()}

    with torch.device("meta"):
        tm = ssm.SS2DCondV10(64, d_cond=48)
    a = random_init_(tm, seed=3, device="cpu")
    got = {k: v.dtype == torch.bfloat16
           for k, v in cast_params_bf16_(a).state_dict().items()}
    assert got == want and any(got.values()) and not all(got.values())

    with torch.device("meta"):
        tm2 = ssm.SS2DCondV10(64, d_cond=48)
    b = cast_params_bf16_(random_init_(tm2, seed=3, device="cpu"))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.in_proj1.weight.float()
    assert abs(w.std().item() - 0.02) < 0.002
