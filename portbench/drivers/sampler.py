"""Driver of the clip-making traffic: denoise steps of a clip through the
port's ``ACTalkerPipeline.generate_latents_batch``, the CLI's path.

Set-up builds the bf16 UNet from the configuration with seeded weights,
makes one identity's inputs from the seed (the conditioning ring buffers
that ``prepare_sampling`` would build: tokens, image latents, pose
features, a face-box region mask), and warms up. A timed call is one
denoise step of the clip: a plan holding one row of the clip's schedule
(call i takes step i mod steps), from the reference latent noised to that
step's sigma with noise drawn from the seed for that call, as a schedule
entered part-way starts. Its unit is the window-step (one UNet call of 4
guidance branches x the window's frames).

The check picks one completed call from the seed and runs the plain fp32
reference (``reference/``) over the same inputs and weights made again
from the seed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List

import numpy as np
import torch

from portbench import roofline, weights
from portbench.reference import ops as ref_ops
from portbench.reference import sampler as ref_sampler
from portbench.reference.unet import UNet, UNetSizes, selected_tokens

# worst frame's relative L2 gap of the guided v-prediction implied by the
# output latents, against the reference's; set from the readings in PERF.md
LIMIT = {"guided_v_err": 0.15}
VAE_SCALING = 0.18215


def sizes_of(config: dict) -> UNetSizes:
    u = config["unet"]
    return UNetSizes(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]),
        num_attention_heads=tuple(u["num_attention_heads"]),
        layers_per_block=u["layers_per_block"],
        cross_attention_dim=u["cross_attention_dim"],
        addition_time_embed_dim=u["addition_time_embed_dim"],
        projection_class_embeddings_input_dim=u["projection_class_embeddings_input_dim"],
        d_state=config["ssm"]["d_state"], ssm_expand=config["ssm"]["expand"],
        cross_attn_levels=u["cross_attn_levels"],
        gradient_checkpointing=bool(config.get("training", {}).get(
            "gradient_checkpointing", False)))


def port_unet_config(sizes: UNetSizes):
    from actalker_tpu_torch.models.unet import UNetConfig

    n = len(sizes.block_out_channels)
    k = sizes.cross_attn_levels
    return UNetConfig(
        in_channels=sizes.in_channels, out_channels=sizes.out_channels,
        block_out_channels=sizes.block_out_channels,
        down_block_types=tuple("CrossAttnDownBlockSpatioTemporal" if i < k
                               else "DownBlockSpatioTemporal" for i in range(n)),
        up_block_types=tuple("UpBlockSpatioTemporal" if i < n - k
                             else "CrossAttnUpBlockSpatioTemporal" for i in range(n)),
        num_attention_heads=sizes.num_attention_heads,
        layers_per_block=sizes.layers_per_block,
        cross_attention_dim=sizes.cross_attention_dim,
        addition_time_embed_dim=sizes.addition_time_embed_dim,
        projection_class_embeddings_input_dim=sizes.projection_class_embeddings_input_dim,
        gradient_checkpointing=sizes.gradient_checkpointing)


def dtype_of(config: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[config["precision"]["unet"]]


def build_kernels(dev, names) -> None:
    """Load (and on a fresh checkout, build) the port's kernels the traffic
    runs, all at once."""
    if dev.type != "cuda":
        return
    from actalker_tpu_torch.ops import _build
    _build.build_all(kernel_objects(names).values())


def kernel_objects(names):
    from actalker_tpu_torch.ops import mha, mlp, selective_scan as ss

    every = {"ssm_scan_grouped": ss.KERNEL, "ssm_scan_bwd": ss.BWD_KERNEL,
             "mha": mha.MHA_KERNEL, "mha_bwd": mha.MHA_BWD_KERNEL,
             "frame_attention": mha.FRAME_KERNEL, "geglu_mlp": mlp.KERNEL}
    return {n: every[n] for n in names}


def port_unet(sizes: UNetSizes, config: dict, seed: int, dev):
    """The port's UNet with the seeded weights, in the type it is served
    in (``io.init.cast_params_bf16_``'s rule)."""
    from actalker_tpu_torch.io.init import cast_params_bf16_
    from actalker_tpu_torch.models.unet import UNetSpatioTemporalCondition

    dt = dtype_of(config)
    with torch.device("meta"):
        ref = UNet(sizes)
        unet = UNetSpatioTemporalCondition(port_unet_config(sizes), dtype=dt)
    _log("module trees built")
    if dt == torch.bfloat16:
        cast_params_bf16_(unet)
    unet.to_empty(device=dev)
    state = weights.seeded_state(ref, seed, dev)
    _sync(dev)
    _log("weights drawn")
    unet.load_state_dict(state, strict=True)
    return unet


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reference_unet(sizes: UNetSizes, seed: int, dev) -> UNet:
    with torch.device("meta"):
        ref = UNet(sizes)
    ref.load_state_dict(weights.seeded_state(ref, seed, dev), strict=True, assign=True)
    return ref


def face_box(px: int, box: dict, seed: int) -> torch.Tensor:
    """(1, 1, px, px) mask: a square of ``side / grid`` of the frame at one
    of ``at`` x ``at`` grid-aligned places drawn from the seed, so every seed
    selects the same number of tokens."""
    cell = px // box["grid"]
    rng = np.random.default_rng(weights.seed64(seed, 11))
    y, x = (int(rng.choice(box["at"])) * cell for _ in range(2))
    m = torch.zeros(1, 1, px, px)
    m[..., y:y + box["side"] * cell, x:x + box["side"] * cell] = 1.0
    return m


def make_inputs(config: dict, traffic: dict, seed: int, dev) -> dict:
    """One identity's conditioning buffers, in the layout the sampler reads
    (ring buffers of frames + window rows, unconditional tokens past the
    clip), made from the seed on the device."""
    s = config["sampler"]
    u = config["unet"]
    px = s["image_size"]
    hw, frames, win = px // 8, traffic["clip_frames"], s["n_sample_frames"]
    buf, d = frames + win, u["cross_attention_dim"]
    gen = weights.generator(seed, 1, dev)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    ref_latent = rn(hw, hw, 4)
    id_tok = rn(1, 1, d)
    audio, audio_u = rn(frames, 32, d), rn(1, 32, d)
    pose = rn(frames, hw, hw, u["block_out_channels"][0]) * 0.1
    gate = tuple(traffic["gate"])
    vasa = torch.zeros(buf, 1, d, device=dev)
    mask = face_box(px, traffic["box"], seed).to(dev)
    pad = audio_u.expand(buf - frames, 32, d)
    return {
        "ref_latent": ref_latent,
        "id_tokens": id_tok.expand(buf, 1, d),
        "audio": torch.cat([audio, pad]), "audio_u": audio_u.expand(buf, 32, d),
        "vasa": vasa, "vasa_u": vasa,
        "image_latents": (ref_latent / VAE_SCALING).expand(buf, hw, hw, 4),
        "pose_fea": pose[torch.arange(buf, device=dev) % frames],
        "audio_mask": mask, "exp_mask": mask, "gate": gate,
    }


def call_noise(seed: int, call: int, shape, dev) -> torch.Tensor:
    return torch.randn(shape, generator=weights.generator(seed, 1000 + call, dev),
                       device=dev)


@dataclasses.dataclass
class State:
    config: dict
    traffic: dict
    seed: int
    dev: torch.device
    sizes: UNetSizes
    inputs: dict
    pipe: object = None
    unet: object = None
    scfg: object = None
    plan: object = None
    buffers: object = None
    calls: int = 0
    outputs: List[torch.Tensor] = dataclasses.field(default_factory=list)
    windows: int = 0


def _sampler_config(config: dict, traffic: dict):
    from actalker_tpu_torch.pipeline.sampler import SamplerConfig

    s = config["sampler"]
    return SamplerConfig(
        num_inference_steps=s["num_inference_steps"],
        frames_per_batch=s["n_sample_frames"], overlap=s["overlap"],
        shift_offset=s["shift_offset"], fps=s["fps"],
        motion_bucket_id=s["motion_bucket_id"],
        motion_bucket_id_exp=s["motion_bucket_id_exp"],
        min_guidance1=s["min_appearance_guidance_scale"],
        max_guidance1=s["max_appearance_guidance_scale"],
        guidance2=s["audio_guidance_scale"], guidance3=s["vasa_guidance_scale"],
        i2i_noise_strength=s["i2i_noise_strength"], gate=tuple(traffic["gate"]),
        windows_per_call=s["windows_per_call"])


def setup(cell, seed: int, dev) -> State:
    from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline, PipelineModules
    from actalker_tpu_torch.pipeline.sampler import CondBuffers, make_plan

    config, traffic = cell.config, cell.traffic
    build_kernels(dev, ("ssm_scan_grouped", "mha", "frame_attention", "geglu_mlp"))
    sizes = sizes_of(config)
    st = State(config, traffic, seed, dev, sizes, make_inputs(config, traffic, seed, dev))
    _log("kernels loaded")
    st.unet = port_unet(sizes, config, seed, dev).eval()
    _log("weights made")
    st.pipe = ACTalkerPipeline(PipelineModules(st.unet, *([None] * 6)),
                               dtype=dtype_of(config), gather=True)
    st.scfg = _sampler_config(config, traffic)
    st.plan = make_plan(st.scfg, traffic["clip_frames"])
    st.windows = st.plan.window_idx.shape[1]
    i = st.inputs
    st.buffers = CondBuffers(
        id_tokens=i["id_tokens"], audio_tokens=i["audio"], audio_tokens_u=i["audio_u"],
        vasa_tokens=i["vasa"], vasa_tokens_u=i["vasa_u"],
        image_latents=i["image_latents"], pose_fea=i["pose_fea"],
        audio_mask=i["audio_mask"], exp_mask=i["exp_mask"],
        ip_scales=(config["sampler"]["ip_audio_scale"],) * 2)
    for w in range(traffic["warmup_calls"]):
        _generate(st, w % st.plan.sigmas.shape[0], call_noise(seed, -1 - w, _noise_shape(st), dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        _log(f"warm-up call {w}")
    return st


def _log(msg: str) -> None:
    from portbench.harness import _log as log
    log(msg)


def _noise_shape(st: State):
    hw = st.config["sampler"]["image_size"] // 8
    return (1, st.plan.buffer_len, hw, hw, 4)


def _plan_row(plan, i: int):
    """The clip's plan cut to its denoise step ``i``."""
    return dataclasses.replace(
        plan, sigmas=plan.sigmas[i:i + 2], timesteps=plan.timesteps[i:i + 1],
        guidance1=plan.guidance1[i:i + 1], guidance2=plan.guidance2[i:i + 1],
        guidance3=plan.guidance3[i:i + 1], gammas=plan.gammas[i:i + 1],
        window_idx=plan.window_idx[i:i + 1])


def _generate(st: State, step: int, noise: torch.Tensor) -> torch.Tensor:
    row = _plan_row(st.plan, step % len(st.plan.timesteps))
    prepared = [(row, st.buffers, st.inputs["ref_latent"], None)]
    return st.pipe.generate_latents_batch(prepared, st.scfg, init_noise=noise)


def call(st: State) -> int:
    c = st.calls
    out = _generate(st, c, call_noise(st.seed, c, _noise_shape(st), st.dev))
    st.outputs.append(out[0])
    st.calls += 1
    return st.windows


@contextlib.contextmanager
def instrument(st: State, readings):
    """The benchmark's spans around each UNet call (CUDA events at both
    ends) and the port's launch counters over the traced window."""
    kernels = kernel_objects(("ssm_scan_grouped", "mha", "frame_attention", "geglu_mlp"))
    before = {n: k.launches for n, k in kernels.items()}
    events = []
    cuda = st.dev.type == "cuda"

    def pre(mod, args):
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events.append([e, None])

    def post(mod, args, out):
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[-1][1] = e

    hooks = [st.unet.register_forward_pre_hook(pre), st.unet.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        if cuda:
            torch.cuda.synchronize()
            readings.unet_span_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
        readings.launches = {n: k.launches - before[n] for n, k in kernels.items()}


def outcome(st: State):
    bad = sum(1 for o in st.outputs if not bool(torch.isfinite(o).all()))
    return st.calls * st.windows, bad * st.windows


def _selected_rows(st: State) -> dict:
    """Each SSM level's scanned rows per branch: the selected tokens (the
    most of any row) plus the branch's tail."""
    hw = st.config["sampler"]["image_size"] // 8
    ga, gv = st.inputs["gate"]
    out = {}
    for s, _, _, ssm in roofline.levels(st.sizes, hw):
        if not ssm:
            continue
        n = [int(selected_tokens(st.inputs[m] if on else torch.zeros_like(
            st.inputs[m]), 1, s, st.dev).sum()) for m, on in
             (("audio_mask", ga), ("exp_mask", gv))]
        out[s] = [n[0] + 33, n[1] + 2]
    return out


def yardsticks(st: State, readings) -> None:
    hw = st.config["sampler"]["image_size"] // 8
    readings.bounds = roofline.forward_bounds(
        st.sizes, 4, st.config["sampler"]["n_sample_frames"], hw, _selected_rows(st))


def end_to_end(st: State, window_s: float, units: int) -> dict:
    return {"window_step_s": window_s / units}


def release(st: State) -> None:
    st.pipe = st.unet = st.buffers = None
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()


def implied_v(out: torch.Tensor, start: torch.Tensor, sigma: float,
              nxt: float) -> torch.Tensor:
    """The guided v-prediction an Euler step from ``start`` to ``out``
    implies (float64): x0 = x - s (out - x) / (s' - s), v = (x / (s^2 + 1)
    - x0) sqrt(s^2 + 1) / s. Linear in ``out``, so the model's part of the
    step is judged at every sigma, not drowned in the noise it carries."""
    x, o = start.double(), out.double()
    x0 = x - sigma * (o - x) / (nxt - sigma)
    return (x / (sigma ** 2 + 1.0) - x0) * (sigma ** 2 + 1.0) ** 0.5 / sigma


def v_error(out, ref, start, sigma: float, nxt: float) -> float:
    """Worst frame's ||v(out) - v(ref)|| / ||v(ref)||."""
    vp, vr = implied_v(out, start, sigma, nxt), implied_v(ref, start, sigma, nxt)
    num = (vp - vr).flatten(1).norm(dim=1)
    return float((num / vr.flatten(1).norm(dim=1).clamp_min(1e-30)).max())


def reference_output(st: State, call_index: int, flops=None):
    """The reference's answer to timed call ``call_index``: (latents, start
    latents, sigma, next sigma)."""
    ref_ops.fp32_matmul()
    unet = reference_unet(st.sizes, st.seed, st.dev)
    s = st.config["sampler"]
    step = call_index % s["num_inference_steps"]
    sched = ref_sampler.Schedule(steps=s["num_inference_steps"])
    noise = call_noise(st.seed, call_index, _noise_shape(st), st.dev)[0]
    x = st.inputs["ref_latent"] + float(sched.sigmas()[step]) * noise
    ctx = flops if flops is not None else contextlib.nullcontext()
    with ctx:
        out = ref_sampler.denoise_step(unet, st.inputs, x, step, s, sched,
                                       st.inputs["gate"], st.traffic["clip_frames"])
    del unet
    return out, x[:st.traffic["clip_frames"]], float(sched.sigmas()[step]), \
        float(sched.sigmas()[step + 1])


def check(st: State, trace: bool, readings) -> list:
    rng = np.random.default_rng(weights.seed64(st.seed, 5))
    c = int(rng.integers(st.calls))
    counter = None
    if trace:
        from torch.utils.flop_counter import FlopCounterMode

        counter = FlopCounterMode(display=False)
    ref, start, sigma, nxt = reference_output(st, c, counter)
    if counter is not None:
        readings.flops_per_unit = counter.get_total_flops() / st.windows
    err = v_error(st.outputs[c], ref, start, sigma, nxt)
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
    return [("guided_v_err", err if math.isfinite(err) else float("inf"),
             LIMIT["guided_v_err"])]
