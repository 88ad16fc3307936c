"""PyTorch port, one clip's windows split over ranks on the CPU: gloo
process groups of spawned ranks (``tests/torch_dist_workers.py``).

* ``sample_video(..., group=)`` / ``generate_latents(..., group=)``: each
  denoise step's 8 windows (6 frames, windows of 2 overlapping by 1) over
  2 ranks, with the churn on and off and with 0 and 2 windows a UNet
  call, equal to the single process on the float64 micro pipeline (atol
  1e-6 of the latents' range, the rank-split serving test's tolerance: a
  UNet call of fewer windows rounds its fp32 norm statistics and scan
  otherwise); the single process against the JAX ``sample_video`` on
  stand-in UNets (fp32, 1e-5); the churn draw independent of the
  chunking.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actalker_tpu.pipeline import sampler as jsampler
from actalker_tpu_torch.pipeline import sampler as tsampler
from tests import torch_dist_workers as DW
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)

WINDOW_CASES = ((False, 0), (True, 0), (True, 2))


def _ranks(tmp_path, fn, world, *args):
    os.makedirs(tmp_path, exist_ok=True)
    out = str(tmp_path)
    DW.run_ranks(fn, world, out, *args)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))


# --------------------------------------------------------- windows split

def test_windows_split_over_ranks_equal_one_process(tmp_path):
    pipe = DW.serve_pipeline()
    plan = tsampler.make_plan(DW.window_config(False, 0), DW.WINDOW_FRAMES)
    assert plan.window_idx.shape[1:] == (8, 2)
    want = {case: DW.sample_windows(pipe, DW.window_config(*case)) for case in WINDOW_CASES}
    res = _ranks(tmp_path, DW.window_rank, 2, WINDOW_CASES)
    for case in WINDOW_CASES:
        for r in res:                  # every rank returns the whole clip
            for got, ref in zip(r[case], want[case]):
                assert got.shape == ref.shape and torch.isfinite(got).all()
                _close(got, ref)
    # the churn is on where asked, and the chunking does not change it
    top_off, top_on, top_chunked = (want[c][0] for c in WINDOW_CASES)
    assert (top_on - top_off).abs().max() > 1e-3 * top_off.abs().max()
    _close(top_chunked, top_on)


def test_single_process_windows_match_jax():
    """The port's sampler, 3 windows a call, against the JAX
    ``sample_video`` (all windows in one vmap) on stand-in UNets and the
    same initial noise."""
    fpb, h, w, nf = 2, 4, 4, 6
    kw = dict(num_inference_steps=3, frames_per_batch=fpb, overlap=1, shift_offset=1,
              gate=(1, 0))
    jcfg = jsampler.SamplerConfig(**kw)
    tcfg = tsampler.SamplerConfig(windows_per_call=3, **kw)
    plan = tsampler.make_plan(tcfg, nf)
    rng = np.random.default_rng(12)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    buf = plan.buffer_len
    arrays = dict(id_tokens=r(buf, 1, 8), audio_tokens=r(buf, 32, 8),
                  audio_tokens_u=r(buf, 32, 8), vasa_tokens=r(buf, 1, 8),
                  vasa_tokens_u=r(buf, 1, 8), image_latents=r(buf, h, w, 4),
                  pose_fea=r(buf, h, w, 4))
    ref_latent, init = r(h, w, 4), r(buf, h, w, 4)
    ones = np.ones((1, 1, 8 * h, 8 * w), np.float32)

    def j_unet(params, sample, t, cond, tids, pose):
        b, f = sample.shape[:2]
        a = cond.audio_tokens.reshape(b, f, -1).mean(-1)[:, :, None, None, None]
        return 0.3 * sample[..., :4] - 0.2 * sample[..., 4:8] + 0.05 * a + 0.1 * pose

    def t_unet(sample, t, cond, tids, pose):
        b, f = sample.shape[:2]
        a = cond.audio_tokens.reshape(b, f, -1).mean(-1)[:, :, None, None, None]
        return 0.3 * sample[..., :4] - 0.2 * sample[..., 4:8] + 0.05 * a + 0.1 * pose

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
    assert plan.window_idx.shape[1] == 8
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("per_call", [0, 3])
def test_churn_draw_is_the_steps_whole_block(per_call):
    """With churn on, a step draws its noise for every window at once from
    the generator: the chunking (windows a UNet call) leaves the result as
    it is, on a stand-in UNet."""
    cfg = tsampler.SamplerConfig(num_inference_steps=2, frames_per_batch=2, overlap=1,
                                 shift_offset=1, s_churn=2.0, windows_per_call=per_call)
    plan = tsampler.make_plan(cfg, 5)
    buf = plan.buffer_len
    bufs = tsampler.CondBuffers(
        id_tokens=torch.zeros(buf, 1, 8), audio_tokens=torch.zeros(buf, 32, 8),
        audio_tokens_u=torch.zeros(buf, 32, 8), vasa_tokens=torch.zeros(buf, 1, 8),
        vasa_tokens_u=torch.zeros(buf, 1, 8), image_latents=torch.zeros(buf, 2, 2, 4),
        pose_fea=torch.zeros(buf, 2, 2, 8), audio_mask=None, exp_mask=None)

    def run(c):
        return tsampler.sample_video(lambda inp, t, cond, tids, pose: 0.1 * inp[..., :4],
                                     c, plan, bufs, torch.zeros(2, 2, 4),
                                     torch.Generator().manual_seed(5), torch.float32)

    whole = run(dataclasses.replace(cfg, windows_per_call=0))
    torch.testing.assert_close(run(cfg), whole, rtol=0, atol=0)
