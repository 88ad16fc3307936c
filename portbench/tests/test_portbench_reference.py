"""The plain reference held to the port at micro widths on the CPU, on the
same seeded weights and inputs: the UNet (every mask path of the SSM
control blocks), one denoise step of the sampler, the training loss and
gradients, and the clipped AdamW commit. The test imports the port; the
reference does not."""
from __future__ import annotations

import copy
import json
import os

import pytest
import torch

from portbench import harness, weights
from portbench.drivers import sampler, trainer
from portbench.reference import train as ref_train
from portbench.reference.unet import Cond, UNet

ROOT = harness.ROOT
torch.set_num_threads(2)


def micro(config_name: str, **over) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", config_name)) as f:
        cfg = json.load(f)
    cfg["unet"].update(block_out_channels=[32, 64], num_attention_heads=[2, 4],
                       layers_per_block=1, cross_attn_levels=1)
    cfg["precision"]["unet"] = "float32"
    for k, v in over.items():
        cfg[k].update(v)
    return cfg


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def _unet_inputs(seed, b=2, f=3, hw=18):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    box = torch.zeros(1, 1, hw * 8, hw * 8)
    box[..., 16:96, 32:112] = 1.0
    return (rn(b, f, hw, hw, 8), torch.tensor(1.3), rn(b * f, 1, 1024),
            rn(b * f, 32, 1024), rn(b * f, 1, 1024), rn(b, 3), rn(b, f, hw, hw, 32) * 0.1,
            box)


@pytest.mark.parametrize("masks", ["box_mode0", "box_both", "none", "ones"])
def test_unet_matches_the_port(masks):
    from actalker_tpu_torch.models.conditioning import Conditioning

    cfg = micro("actalker-svdxt-576.json")
    sizes = sampler.sizes_of(cfg)
    port = sampler.port_unet(sizes, cfg, 17, torch.device("cpu")).eval()
    ref = sampler.reference_unet(sizes, 17, torch.device("cpu"))
    x, t, idt, au, va, tids, pose, box = _unet_inputs(3)
    am, em = {"box_mode0": (box, torch.zeros_like(box)), "box_both": (box, box),
              "none": (None, None), "ones": (torch.ones_like(box),) * 2}[masks]
    if masks.startswith("box"):
        # the gather path under the pipeline's budget for these masks
        from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline, PipelineModules
        from actalker_tpu_torch.pipeline.sampler import SamplerConfig

        pipe = ACTalkerPipeline(PipelineModules(port, *([None] * 6)), torch.float32)
        gate = (1, 0) if masks == "box_mode0" else (1, 1)
        caps = pipe._capacity_fracs(SamplerConfig(gate=gate), am, em, (18, 18))
        assert caps is not None
        port.set_mask_capacity(caps)
    with torch.no_grad():
        got = port(x, t, Conditioning(idt, au, va, am, em), tids, pose)
        want = ref(x, t, Cond(idt, au, va, am, em), tids, pose)
    assert rel(got, want) < 1e-5


def _micro_infer_cell():
    cfg = micro("actalker-svdxt-576.json", sampler={"image_size": 144, "n_sample_frames": 4,
                                                    "num_inference_steps": 3})
    with open(os.path.join(ROOT, "portbench", "traffic", "mode0-facebox.json")) as f:
        tr = json.load(f)
    tr.update(clip_frames=8, warmup_calls=1)
    return harness.Cell({"name": "infer576.mode0-facebox", "chips": 1}, cfg, tr, {})


@pytest.mark.parametrize("call", [0, 2])
def test_denoise_step_matches_the_port(call):
    """A timed call of the sampler cell (one denoise step over 3 windows,
    4-way guidance, Euler, the overlap average) against the reference."""
    cell = _micro_infer_cell()
    st = sampler.setup(cell, 99, torch.device("cpu"))
    st.calls = call
    sampler.call(st)
    sampler.release(st)
    ref, start, sigma, nxt = sampler.reference_output(st, call)
    assert sampler.v_error(st.outputs[-1], ref, start, sigma, nxt) < 1e-4


def test_face_box_selects_the_same_tokens_on_every_seed():
    from portbench.reference.unet import selected_tokens

    box = json.load(open(os.path.join(ROOT, "portbench/traffic/mode0-facebox.json")))["box"]
    counts = {int(selected_tokens(sampler.face_box(576, box, s), 1, l, "cpu").sum())
              for s in range(12) for l in (5184,)}
    assert len(counts) == 1


def _micro_train_cfg():
    return micro("actalker-svdxt-train512.json",
                 training={"image_size": 64, "n_sample_frames": 3})


def test_training_loss_and_gradients_match_the_port():
    from actalker_tpu_torch.training.trainer import TrainConfig, diffusion_loss

    cfg = _micro_train_cfg()
    dev = torch.device("cpu")
    port = trainer._port_modules(cfg, 21, dev)
    ref = trainer.reference_modules(cfg)
    for n, sd in trainer.seeded(ref, 21, dev).items():
        ref[n].load_state_dict(sd, assign=True)
    batch, draws = trainer._port_batch(cfg, 21, 0, dev)
    t = cfg["training"]
    tcfg = TrainConfig(noise_offset=t["noise_offset"],
                       cond_dropout_prob=t["conditioning_dropout_prob"])
    loss_p, _ = diffusion_loss(port, batch, tcfg, draws, dtype=torch.float32)
    loss_p.backward()
    b, d = trainer.batch_of(cfg, 21, 0, dev)
    loss_r = ref_train.loss_of(ref, b, d, t)
    loss_r.backward()
    assert abs(float(loss_p.detach()) - float(loss_r.detach())) <= 1e-5 * abs(float(loss_r.detach()))
    gp = {k: p.grad for k, p in trainer._named(port).items()}
    gr = {k: p.grad for k, p in trainer._named(ref).items()}
    total = torch.sqrt(sum((g.double() ** 2).sum() for g in gr.values() if g is not None))
    for k, g in gr.items():
        # a parameter the port never reads (the q / k of a one-token
        # context: softmax over one key is 1) has no gradient there and
        # none to rounding here
        g = torch.zeros_like(gp[k]) if g is None and gp[k] is not None else g
        p = torch.zeros_like(g) if gp[k] is None and g is not None else gp[k]
        if g is None:
            continue
        assert float((p - g).norm()) <= 1e-4 * float(total) + 1e-4 * float(g.norm()), k


def test_adamw_commit_matches_the_port():
    from actalker_tpu_torch.training.trainer import Optimizer, TrainConfig

    cfg = _micro_train_cfg()
    g = torch.Generator().manual_seed(4)
    ps = [torch.randn(7, 5, generator=g), torch.randn(11, generator=g)]
    pp = [p.clone().requires_grad_(True) for p in ps]
    pr = [p.clone() for p in ps]
    t = cfg["training"]
    opt_p = Optimizer(pp, TrainConfig(max_grad_norm=t["max_grad_norm"]))
    opt_r = ref_train.AdamW(pr, t)
    for step in range(8):
        grads = [torch.randn(p.shape, generator=g) * (0.1 + step) for p in ps]
        for p, q, gr in zip(pp, pr, grads):
            p.grad = gr.clone() if p.grad is None else p.grad + gr
            q.grad = gr.clone() if q.grad is None else q.grad + gr
        opt_p.step()
        opt_r.step()
    for p, q in zip(pp, pr):
        assert torch.allclose(p.detach(), q, rtol=1e-6, atol=1e-8)


def test_seeded_state_is_a_function_of_the_seed():
    cfg = micro("actalker-svdxt-576.json")
    with torch.device("meta"):
        m = UNet(sampler.sizes_of(cfg))
    a = weights.seeded_state(m, 2 ** 40 + 5, "cpu")
    b = weights.seeded_state(m, 2 ** 40 + 5, "cpu")
    c = weights.seeded_state(m, 2 ** 40 + 6, "cpu")
    k = "down_blocks.0.attentions.0.mamba_blocks.0.audio_unit.A_logs"
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["conv_in.weight"], c["conv_in.weight"])
    assert float(a[k][0, 15]) == pytest.approx(float(torch.log(torch.tensor(16.0))), abs=0.3)
    assert copy.deepcopy(list(a)) == [n for n, _ in m.named_parameters()]
