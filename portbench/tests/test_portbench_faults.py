"""A run whose timed path is broken underneath must come out ``correct``
false: the harness driven at micro size on the CPU (the look for a card
skipped), once for each fault a cell can have. One card, so no exchange
between chips to leave out. And the control, the reference computed in
fp8 in the program's place, fails the limits of each cell."""
from __future__ import annotations

import contextlib
import io
import json
import os

import pytest
import torch

from portbench import harness
from portbench.drivers import sampler, trainer
from portbench.reference import ops as ref_ops

ROOT = harness.ROOT
torch.set_num_threads(2)


def _config(name, **over):
    with open(os.path.join(ROOT, "portbench", "configs", name)) as f:
        cfg = json.load(f)
    cfg["unet"].update(block_out_channels=[32, 64], num_attention_heads=[2, 4],
                       layers_per_block=1, cross_attn_levels=1)
    # the limits are the cells' own, read at full width in bf16 on the
    # card; at micro width on the CPU a sound run computes in fp32
    cfg["precision"]["unet"] = "float32"
    for k, v in over.items():
        cfg[k].update(v)
    return cfg


def infer_cell():
    cfg = _config("actalker-svdxt-576.json",
                  sampler={"image_size": 144, "n_sample_frames": 4, "num_inference_steps": 3})
    with open(os.path.join(ROOT, "portbench", "traffic", "mode0-facebox.json")) as f:
        tr = json.load(f)
    tr.update(clip_frames=8, warmup_calls=1)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    return harness.Cell({"name": "infer576.mode0-facebox", "chips": 1}, cfg, tr, b)


def train_cell():
    cfg = _config("actalker-svdxt-train512.json",
                  training={"image_size": 64, "n_sample_frames": 4})
    with open(os.path.join(ROOT, "portbench", "traffic", "synthetic.json")) as f:
        tr = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    return harness.Cell({"name": "train512.synthetic", "chips": 1}, cfg, tr, b)


def result_of(cell, driver, seed=7):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.measure(cell, driver, torch.device("cpu"), seed, 0.01, False)
    assert rc == 0, err.getvalue()[-2000:]
    return json.loads(out.getvalue().splitlines()[-1])


def test_sound_runs_are_correct():
    assert result_of(infer_cell(), sampler)["correct"] is True
    assert result_of(train_cell(), trainer)["correct"] is True


# ------------------------------------------------------------ inference

@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_broken_sampler_is_not_correct(fault, monkeypatch):
    from actalker_tpu_torch.pipeline import pipeline as port_pipeline

    real = port_pipeline.sample_video_batch

    def broken(unet, cfg, plan, buffers, refs, generators=None, dtype=torch.bfloat16,
               init_noise=None, window_group=None):
        if fault == "unchanged":      # the step returns its state
            return refs.float()[:, None] + float(plan.sigmas[0]) * init_noise
        out = real(unet, cfg, plan, buffers, refs, generators, dtype, init_noise,
                   window_group)
        if fault == "half_batch":     # half the frames left out, the rest kept
            n = out.shape[1] // 2
            out[:, n:] = out[:, :n].mean(dim=1, keepdim=True)
        else:                         # one frame's answer altered
            out[:, 1] += 0.05 * out[:, 1].std()
        return out

    monkeypatch.setattr(port_pipeline, "sample_video_batch", broken)
    res = result_of(infer_cell(), sampler)
    assert res["correct"] is False, res["compared"]


# ------------------------------------------------------------- training

@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_broken_trainer_is_not_correct(fault, monkeypatch):
    from actalker_tpu_torch.training import trainer as port_trainer

    if fault == "unchanged":          # the commit leaves the state as it was
        monkeypatch.setattr(port_trainer.Optimizer, "step",
                            lambda self: (setattr(self, "mini_step", (self.mini_step + 1) % self.k)
                                          or (self.mini_step == 0, None)))
    elif fault == "half_batch":       # the loss's mean over half the frames
        real = port_trainer.diffusion_loss

        def half(modules, batch, cfg, draws=None, generator=None, dtype=torch.bfloat16):
            f = batch.latents.shape[1] // 2
            cut = batch._replace(**{k: getattr(batch, k)[:, :f] for k in (
                "latents", "audio_feats", "vasa_expr", "vasa_rot")})
            d = draws._replace(noise=draws.noise[:, :f])
            return real(modules, cut, cfg, d, generator, dtype)

        monkeypatch.setattr(port_trainer, "diffusion_loss", half)
    else:                             # one parameter's update altered
        real_step = port_trainer.Optimizer.step

        def altered(self):
            committed, norm = real_step(self)
            if committed:
                with torch.no_grad():
                    self.params[len(self.params) // 2].mul_(1.01)
            return committed, norm

        monkeypatch.setattr(port_trainer.Optimizer, "step", altered)
    res = result_of(train_cell(), trainer)
    assert res["correct"] is False, res["compared"]


# -------------------------------------------------------------- control

def test_fp8_control_fails_the_sampler_limit():
    cell = infer_cell()
    st = sampler.setup(cell, 7, torch.device("cpu"))
    sampler.release(st)
    ref, start, sigma, nxt = sampler.reference_output(st, 1)
    ref_ops.set_precision("fp8")
    try:
        ctl = sampler.reference_output(st, 1)[0]
    finally:
        ref_ops.set_precision("fp32")
    assert sampler.v_error(ctl, ref, start, sigma, nxt) > sampler.LIMIT["guided_v_err"]


def test_fp8_control_fails_a_training_limit():
    cell = train_cell()
    n = cell.traffic["follow_commits"] * 4
    ref = trainer.reference_run(cell.config, 7, torch.device("cpu"), n)
    ref_ops.set_precision("fp8")
    try:
        ctl = trainer.reference_run(cell.config, 7, torch.device("cpu"), n)
    finally:
        ref_ops.set_precision("fp32")
    errs = dict(zip(("loss_err", "grad_err", "change_err"), trainer.compare(*ctl, *ref)))
    assert any(errs[k] > lim for k, lim in trainer.LIMIT.items()), errs


@pytest.mark.parametrize("kind", ["infer", "train"])
def test_traced_run_at_micro_size(kind):
    """The ``--trace 1`` path (the unprofiled window, then the traced one)
    runs through to a correct result whose metrics are the cell's
    per-layer ones; on the CPU nothing is traced, so only the host-clock
    readers find something."""
    cell, driver = (infer_cell(), sampler) if kind == "infer" else (train_cell(), trainer)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.measure(cell, driver, torch.device("cpu"), 5, 0.01, True)
    assert rc == 0, err.getvalue()[-2000:]
    result = json.loads(out.getvalue().splitlines()[-1])
    assert result["correct"] is True
    names = {m["name"] for m in cell.metrics("per_layer")}
    assert set(result["metrics"]) <= names
    assert f"mfu.{kind}" in result["metrics"]
    assert "profiler:" in err.getvalue()
