#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``actalker_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 (Hopper):

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. card: name and power limit (nvidia-smi), torch / CUDA versions; no GPU
     -> exit 1 without a result;
  2. build: nvcc-compiles the four hand-written kernels (K1-K4) from
     ``actalker_tpu_torch/csrc`` into ``actalker_tpu_torch/_build``;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the flagship path gives it, same bf16 inputs, fp32
     accumulation in the plain version, with CUDA-event times (median);
  4. UNet: one full-width bf16 forward (UNetConfig(), seeded weights) on a
     small latent through the kernels and through the plain versions;
  5. main path: the 512 px / 14-frame clip (full-width UNet, bf16 UNet and
     VAE, seeded weights, mode 2) through ``generate_latents`` and
     ``decode_latents``, run twice; the second run is timed, and the kernel
     launch counts of that run must match the UNet calls it made.
Then one JSON line with the kernels, the card line, and the last line
``{"ok": true, "device": {...}}``.

Matrix products in the plain versions run in full fp32 (TF32 off for both
cuBLAS and cuDNN).
"""
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS, FRAMES, PX = 3, 14, 512

# (plain-version check) relative L2 tolerances and their reasons
TOL = {
    # fp32 state in both; the output is rounded to bf16
    "ssm_scan_grouped": 1e-3,
    # the kernel rounds the softmax probabilities to bf16 before P @ V
    # (as the TPU kernel does); the plain version keeps them fp32
    "mha": 1e-2,
    # fp32 throughout in both; output rounded to bf16
    "frame_attention": 1e-3,
    # h is rounded to bf16 in both, so an fp32 accumulation-order
    # difference can flip the rounding of single h entries
    "geglu_mlp": 5e-3,
}
# a full-width bf16 UNet: kernels and plain versions round activations at
# different places through ~100 layers
UNET_TOL = 5e-2


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "nvidia-smi: no output"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def timed(torch, fn, reps):
    """Median of ``reps`` CUDA-event timings of ``fn`` (ms), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def errors(a, b):
    a, b = a.float(), b.float()
    d = a - b
    return (d.abs().max().item(),
            (d.norm() / b.norm().clamp_min(1e-30)).item())


@contextlib.contextmanager
def plain_ops():
    """Route the UNet's four kernel call sites to the plain versions."""
    from actalker_tpu_torch.models import attention_blocks as ab, ssm
    from actalker_tpu_torch.ops import mha, mlp, selective_scan as ss

    saved = (ab.mha_tokens, ab.frame_attention_tokens, ab.geglu_mlp,
             ssm.ssm_scan_grouped)
    ab.mha_tokens, ab.frame_attention_tokens = (mha.mha_tokens_ref,
                                                mha.frame_attention_tokens_ref)
    ab.geglu_mlp, ssm.ssm_scan_grouped = mlp.geglu_mlp_ref, ss.ssm_scan_grouped_ref
    try:
        yield
    finally:
        (ab.mha_tokens, ab.frame_attention_tokens, ab.geglu_mlp,
         ssm.ssm_scan_grouped) = saved


def kernel_cases(torch, dev, gen):
    """Yield (kernel name, label, kernel fn, plain fn) at flagship shapes."""
    from actalker_tpu_torch.ops import mha, mlp, selective_scan as ss

    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def k1(dp, hw):
        # one SS2D block at d_inner = dp: rank = ceil(d_model / 16), L = h*w
        # tokens + 33 tail tokens (1 id + 32 audio), Bp = 4 CFG x 14 frames
        g, n_tok, bp, rank = 4, hw * hw + 33, 56, -(-dp // 2 // 16)
        u = rnd(n_tok, bp, 2 * dp)
        slab = torch.zeros(n_tok, bp, g * 128, device=dev)
        for gi in range(g):
            slab[:, :, gi * 128:gi * 128 + rank + 32] = torch.randn(
                n_tok, bp, rank + 32, generator=gen, device=dev) * 0.5
            # ~30% inactive rows (mask-deselected tokens)
            slab[:, :, gi * 128 + ss.MASK_LANE] = (torch.rand(
                n_tok, bp, generator=gen, device=dev) < 0.3).float()
        slab = slab.to(bf)
        dtw = torch.zeros(g, 128, dp, device=dev)
        dtw[:, :rank] = torch.randn(g, rank, dp, generator=gen, device=dev) * 0.2
        dtw[:, ss.MASK_LANE] = -1e9
        a = -torch.exp(torch.randn(g, dp, 16, generator=gen, device=dev) * 0.5)
        d = torch.randn(g, dp, generator=gen, device=dev)
        bias = torch.randn(g, dp, generator=gen, device=dev) * 0.5
        args = (u, slab, dtw, a, d, bias, rank)
        return (lambda: ss.ssm_scan_grouped(*args),
                lambda: ss.ssm_scan_grouped_ref(*args))

    yield ("ssm_scan_grouped", "Dp=640 L=4096+33 Bp=56 (res-64)", *k1(640, 64))
    yield ("ssm_scan_grouped", "Dp=2560 L=256+33 Bp=56 (res-16)", *k1(2560, 16))
    for b, s, c, h in ((56, 4096, 320, 5), (56, 1024, 640, 10),
                       (56, 5184, 320, 5)):
        q, k, v = rnd(b, s, c), rnd(b, s, c), rnd(b, s, c)
        yield ("mha", f"B={b} S={s} C={c} H={h}",
               lambda q=q, k=k, v=v, h=h: mha.mha_tokens(q, k, v, h),
               lambda q=q, k=k, v=v, h=h: mha.mha_tokens_ref(q, k, v, h))
    for f in (14, 25):
        q, k, v = (rnd(4 * f, 4096, 320) for _ in range(3))
        yield ("frame_attention", f"B*F={4 * f} F={f} S=4096 C=320 H=5",
               lambda q=q, k=k, v=v, f=f: mha.frame_attention_tokens(q, k, v, f, 5),
               lambda q=q, k=k, v=v, f=f: mha.frame_attention_tokens_ref(q, k, v, f, 5))
    for c in (320, 1280):
        m = 56 * 4096
        x = rnd(m, c)
        w1, b1 = rnd(8 * c, c, scale=c ** -0.5), rnd(8 * c, dtype=torch.float32, scale=0.1)
        w2, b2 = rnd(c, 4 * c, scale=(4 * c) ** -0.5), rnd(c, dtype=torch.float32, scale=0.1)
        yield ("geglu_mlp", f"M={m} C={c}",
               lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: mlp.geglu_mlp(x, w1, b1, w2, b2),
               lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: mlp.geglu_mlp_ref(x, w1, b1, w2, b2))


def seeded_modules(torch, dev, unet_config=None):
    from actalker_tpu_torch.io.init import cast_params_bf16_, random_init_
    from actalker_tpu_torch.pipeline.pipeline import PipelineModules

    with torch.device("meta"):
        mods = PipelineModules.create(unet_config=unet_config,
                                      dtype=torch.bfloat16,
                                      vae_dtype=torch.bfloat16)
    for i, mod in enumerate(mods.named().values()):
        cast_params_bf16_(random_init_(mod, seed=i, device=dev)).eval()
    return mods


def main() -> int:
    import torch

    card = card_line()
    print(f"[1 card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | cuda available {torch.cuda.is_available()}",
          flush=True)
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; this script measures the card only")
        return 1
    sys.path.insert(0, ROOT)
    from actalker_tpu_torch.ops import mha, mlp, selective_scan as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {k.name: k for k in (ss.KERNEL, mha.MHA_KERNEL,
                                   mha.FRAME_KERNEL, mlp.KERNEL)}

    t0 = time.perf_counter()
    for k in kernels.values():
        k.build()
    print(f"[2 build] {', '.join(f'{n} {k.build_seconds:.1f}s' for n, k in kernels.items())}"
          f" | total {time.perf_counter() - t0:.1f}s", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, label, kern, plain in kernel_cases(torch, dev, gen):
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        mx, rel = errors(out, ref)
        ok = bool(torch.isfinite(out.float()).all()) and rel <= TOL[name]
        ms = timed(torch, kern, 10)
        plain_ms = timed(torch, plain, 3)
        print(f"[3 kernel] {name} {label}: max_abs {mx:.4g} rel_l2 {rel:.3g} "
              f"(tol {TOL[name]}) | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"| {card}", flush=True)
        if not ok:
            raise RuntimeError(f"{name} {label} disagrees with its plain version")
        r = results.setdefault(name, {"max_abs_err": 0.0, "ms": ms,
                                      "plain_ms": plain_ms})
        r["max_abs_err"] = max(r["max_abs_err"], mx)
        del out, ref
    torch.cuda.empty_cache()

    # ---- 4: full-width UNet, kernels vs plain versions ----
    from actalker_tpu_torch.models.conditioning import Conditioning
    from actalker_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporalCondition
    from actalker_tpu_torch.io.init import cast_params_bf16_, random_init_

    with torch.device("meta"):
        unet = UNetSpatioTemporalCondition(UNetConfig(), dtype=torch.bfloat16)
    cast_params_bf16_(random_init_(unet, seed=0, device=dev)).eval()
    b, f, hw = 4, 4, 32
    g2 = torch.Generator(device=dev).manual_seed(1)
    rn = lambda *s: torch.randn(*s, generator=g2, device=dev)  # noqa: E731
    cond = Conditioning(rn(b * f, 1, 1024).bfloat16(), rn(b * f, 32, 1024).bfloat16(),
                        rn(b * f, 1, 1024).bfloat16(),
                        torch.ones(1, 1, hw * 8, hw * 8, device=dev),
                        torch.ones(1, 1, hw * 8, hw * 8, device=dev))
    args = (rn(b, f, hw, hw, 8).bfloat16(), torch.tensor(0.5, device=dev), cond,
            rn(b, 3).bfloat16(), (rn(b, f, hw, hw, 320) * 0.1).bfloat16())
    with torch.no_grad():
        y_k = unet(*args)
        with plain_ops():
            y_p = unet(*args)
    torch.cuda.synchronize()
    mx, rel = errors(y_k, y_p)
    print(f"[4 unet] UNetConfig() bf16 (4, 4, 32, 32, 8): kernels vs plain "
          f"max_abs {mx:.4g} rel_l2 {rel:.3g} (tol {UNET_TOL}) | {card}",
          flush=True)
    if not (torch.isfinite(y_k.float()).all() and rel <= UNET_TOL):
        raise RuntimeError("UNet through the kernels disagrees with the plain path")
    del unet, y_k, y_p, args, cond
    torch.cuda.empty_cache()

    # ---- 5: the main path, 512 px / 14 frames, bench.py::main_clip setup ----
    import numpy as np

    from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline
    from actalker_tpu_torch.pipeline.sampler import SamplerConfig, make_plan

    t0 = time.perf_counter()
    mods = seeded_modules(torch, dev)
    pipe = ACTalkerPipeline(mods, dtype=torch.bfloat16)
    init_s = time.perf_counter() - t0
    scfg = SamplerConfig(num_inference_steps=STEPS, frames_per_batch=FRAMES,
                         windows_per_call=1, gate=(1, 1))
    n_win = make_plan(scfg, FRAMES).window_idx.shape[1]
    unet_calls = STEPS * n_win
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((PX, PX, 3)).astype(np.float32) * 0.2
    id_embed = rng.standard_normal(512).astype(np.float32)
    audio = rng.standard_normal((FRAMES, 32, 1024)).astype(np.float32)
    vasa = rng.standard_normal((FRAMES, 1, 1024)).astype(np.float32)
    pose = rng.random((FRAMES, PX, PX, 3)).astype(np.float32)

    def clip():
        t_a = time.perf_counter()
        lat = pipe.generate_latents(ref, id_embed, audio, np.zeros_like(audio),
                                    vasa, np.zeros_like(vasa), pose, scfg,
                                    seed=0)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        frames = pipe.decode_latents(lat, decode_chunk_size=FRAMES)
        return frames, t_b - t_a, time.perf_counter() - t_a

    clip()                                   # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    frames, gen_s, clip_s = clip()
    counts = {n: k.launches for n, k in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # launches per UNet forward: 15 SS2D blocks, 16 spatial self-attentions,
    # 16 temporal blocks, 48 feed-forwards of two launches each
    per_forward = {"ssm_scan_grouped": 15, "mha": 16, "frame_attention": 16,
                   "geglu_mlp": 96}
    print(f"[5 main] {STEPS} steps x {n_win} windows of (4 CFG x {FRAMES} f x "
          f"{PX // 8}x{PX // 8}) = {unet_calls} UNet calls | launches {counts} "
          f"| init {init_s:.1f}s | {card}", flush=True)
    print(f"[5 main] seconds per window-step {gen_s / unet_calls:.4f} s | "
          f"generate_latents {gen_s:.3f} s | clip (generate + decode) "
          f"{clip_s:.3f} s | peak max_memory_allocated {peak_gib:.2f} GiB | "
          f"{card}", flush=True)
    if frames.shape != (FRAMES, PX, PX, 3) or not np.isfinite(frames).all():
        raise RuntimeError(f"clip output {frames.shape} not finite / wrong shape")
    for n, per in per_forward.items():
        if counts[n] != per * unet_calls:
            raise RuntimeError(f"{n}: {counts[n]} launches, expected "
                               f"{per} x {unet_calls} UNet calls")

    print(json.dumps({"kernels": [{
        "name": n, "route": "cuda",
        "source": os.path.relpath(k.source, ROOT),
        "replaces": k.replaces, "launches": counts[n],
        "max_abs_err": results[n]["max_abs_err"], "ms": results[n]["ms"],
        "plain_ms": results[n]["plain_ms"]} for n, k in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
