#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``actalker_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 (Hopper):

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. card: name and power limit (nvidia-smi), torch / CUDA versions; no GPU
     -> exit 1 without a result;
  2. build: nvcc-compiles the six hand-written kernels (K1-K4, the scan
     adjoint K6 and the attention backward K2-bwd) from
     ``actalker_tpu_torch/csrc`` into ``actalker_tpu_torch/_build``, one
     nvcc process per source, all started together;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the clip and training paths give it, same inputs, fp32
     accumulation in the plain version, with CUDA-event times (median), the
     time of one PyTorch library call computing the same function where
     there is one, and the data-sheet bound;
  4. UNet: one full-width bf16 forward (UNetConfig(), seeded weights) on a
     small latent through the kernels and through the plain versions;
  5. clip path: the 512 px / 14-frame clip (full-width UNet, bf16 UNet and
     VAE, seeded weights, mode 2) through ``generate_latents`` and
     ``decode_latents``, run twice; the second run is timed, and the kernel
     launch counts of that run must match the UNet calls it made;
  6. gradients: a full-width UNet with block checkpointing (fp32 master
     weights, bf16 compute) on a small latent, loss and every parameter
     gradient through the kernels and through the plain versions;
  7. training path: ``training.train.main`` at the ``configs/train.yaml``
     operating point (512 px, 25 frames, batch 1, 4-step accumulation,
     block checkpointing, seeded weights) for 8 micro-steps: finite losses,
     launches per micro-step equal to the counts derived from the model,
     parameters still before the first commit and moved after it, the
     checkpoint reloads, six reference files exported.
Then one JSON line with the kernels, the card line, and the last line
``{"ok": true, "device": {...}}``.

Matrix products in the plain versions run in full fp32 (TF32 off for both
cuBLAS and cuDNN).
"""
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS, FRAMES, PX = 3, 14, 512
TRAIN_MICRO_STEPS = 8
# git-ignored scratch for the training phase's checkpoint and exports
OUT = os.path.join(ROOT, "chip_smoke_out")
# data-sheet peaks of one H100 SXM (dense): bf16 tensor cores, fp32 outside
# them, HBM bandwidth
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12

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
    # fp32 state and sums in both; the kernel rounds du to bf16 and sums
    # channels / tokens in another order
    "ssm_scan_bwd": 1e-3,
    # the kernel rounds P and dS to bf16 before their products; the plain
    # version (autograd through the fp32 reference) does not
    "mha_bwd": 1e-2,
}
# a full-width bf16 UNet: kernels and plain versions round activations at
# different places through ~100 layers
UNET_TOL = 5e-2
# its gradients: the same rounding differences forward, then back through
# the same layers, plus K2-bwd's bf16 P / dS. Held over all parameters and
# over each of GRAD_GROUPS; a control run with K2-bwd's dq set to zero
# must fail the check (it does not move the all-parameter reading: at
# random init the attention gradients are a sliver of the whole).
UNET_GRAD_TOL = 1e-2
# (pattern, tolerance) of the parameter families whose gradient one
# kernel's backward gives directly (spatial self-attention: K2-bwd; the
# SS2D scan units: K6). At random init the self-attention is near uniform
# and q / k share a large mean over tokens, which the exact dq and dk
# cancel; bf16 P and dS leave ~15% of them on an H100, in K2-bwd and
# in SDPA's backward alike (phase 6 reads both), so those two are held to
# 0.3. The rest read 0.5-1.7e-2 there, from roundings upstream.
GRAD_GROUPS = {
    "K2-bwd dq": (r"\.transformer_blocks\.\d+\.attn1\.to_q\.", 0.3),
    "K2-bwd dk": (r"\.transformer_blocks\.\d+\.attn1\.to_k\.", 0.3),
    "K2-bwd dv": (r"\.transformer_blocks\.\d+\.attn1\.to_v\.", 3e-2),
    "K6 dslab": (r"_unit\.x_proj_weight$", 3e-2),
    "K6 ddtw": (r"_unit\.dt_projs_weight$", 3e-2),
    "K6 dA": (r"_unit\.A_logs$", 3e-2),
    "K6 dD": (r"_unit\.Ds$", 3e-2),
    "K6 dbias": (r"_unit\.dt_projs_bias$", 3e-2),
}


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
    """(max abs error, relative L2 error) of a against b. Tuples of tensors
    are compared output by output: the largest of each, so every output is
    held to the tolerance on its own."""
    if isinstance(a, (tuple, list)):
        per = [errors(x, y) for x, y in zip(a, b, strict=True)]
        return max(m for m, _ in per), max(r for _, r in per)
    a, b = a.float(), b.float()
    d = a - b
    return (d.abs().max().item(),
            (d.norm() / b.norm().clamp_min(1e-30)).item())


def bound(nbytes, ops, peak):
    """Least time (ms) for the work: the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_adjoint():
    """Route ``SsmScanGroupedFn``'s backward to the plain adjoint (K6's
    plain version)."""
    from actalker_tpu_torch.ops import selective_scan as ss

    saved = ss.ssm_scan_arranged_grad
    ss.ssm_scan_arranged_grad = ss.ssm_scan_arranged_grad_ref
    try:
        yield
    finally:
        ss.ssm_scan_arranged_grad = saved


@contextlib.contextmanager
def attention_bwd(kind):
    """Swap what ``MhaTokensFn.backward`` runs in K2-bwd's place: "zero dq"
    (K2-bwd with its dq replaced by zeros, a control the gradient check
    must fail) or "library" (``F.scaled_dot_product_attention``'s bf16
    backward, a yardstick for the rounding of P and dS)."""
    import torch
    import torch.nn.functional as F

    from actalker_tpu_torch.ops import mha

    saved = mha.mha_tokens_bwd

    def zero_dq(*args, **kw):
        dq, dk, dv = saved(*args, **kw)
        return dq.new_zeros(dq.shape), dk, dv

    def library(q, k, v, o, lse, do, heads, scale=None):
        b, s, c = q.shape

        def split(x):
            return x.view(b, s, heads, c // heads).transpose(1, 2)

        with torch.enable_grad():
            ins = [split(x).detach().requires_grad_(True) for x in (q, k, v)]
            out = F.scaled_dot_product_attention(*ins, scale=scale)
            grads = torch.autograd.grad(out, ins, split(do))
        return tuple(g.transpose(1, 2).reshape(b, s, c).contiguous()
                     for g in grads)

    mha.mha_tokens_bwd = {"zero dq": zero_dq, "library": library}[kind]
    try:
        yield
    finally:
        mha.mha_tokens_bwd = saved


@contextlib.contextmanager
def plain_ops():
    """Route the UNet's four kernel call sites to the plain versions (their
    gradients then come from autograd through the plain versions)."""
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
    """Yield (kernel name, label, kernel fn, plain fn, library fn or None,
    (bound ms, bound by)) at the shapes the clip and training paths use;
    the first case of each kernel is its main-path shape."""
    import torch.nn.functional as F

    from actalker_tpu_torch.ops import mha, mlp, selective_scan as ss

    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def grouped(dp, hw, bp):
        # one SS2D block at d_inner = dp: rank = ceil(d_model / 16), L = h*w
        # tokens + 33 tail tokens (1 id + 32 audio)
        g, n_tok, rank = 4, hw * hw + 33, -(-dp // 2 // 16)
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
        return (u, slab, dtw, a, d, bias, rank)

    def k1(dp, hw):
        args = grouped(dp, hw, 56)       # Bp = 4 CFG x 14 frames
        l, bp, r = args[0].shape[0], 56, args[6]
        # per (token, row, group, channel): the rank + 1 lane projection,
        # softplus, and per state exp + mul + 2 FMA (y and h)
        ops = l * bp * 4 * dp * (2 * (r + 1) + 10 + 16 * 6)
        nbytes = 2 * l * bp * (2 * dp + 4 * 128 + 4 * dp) + 4 * 4 * dp * (128 + 19)
        return (lambda: ss.ssm_scan_grouped(*args),
                lambda: ss.ssm_scan_grouped_ref(*args), None,
                bound(nbytes, ops, PEAK_FP32))

    yield ("ssm_scan_grouped", "Dp=640 L=4096+33 Bp=56 (res-64)", *k1(640, 64))
    yield ("ssm_scan_grouped", "Dp=2560 L=256+33 Bp=56 (res-16)", *k1(2560, 16))

    def k6(dp, hw):
        # training: Bp = 25 frames; gradients through SsmScanGroupedFn.backward
        # (K6 once per group) against the same backward with the plain
        # adjoint; the slab's mask lane (its gradient is the -1e9 row times
        # ddt) is left out of the comparison
        u, slab, dtw, a, d, bias, rank = grouped(dp, hw, 25)
        ins = [t.requires_grad_(True) for t in (u, slab, dtw, a, d, bias)]
        gy = rnd(u.shape[0], 25, 4 * dp)
        keep = [j for j in range(4 * 128) if j % 128 != ss.MASK_LANE]

        def grads():
            y = ss.ssm_scan_grouped(*ins, rank)
            g = torch.autograd.grad(y, ins, gy)
            return (g[0], g[1][..., keep], *g[2:])

        def plain_grads():
            with plain_adjoint():
                return grads()

        # timing: one K6 call (group 1, right to left) and its plain version
        l = u.shape[0]
        one = (u[:, :, :dp].detach().contiguous(),
               slab[:, :, 128:256].detach().float() @ dtw[1].detach(),
               slab[:, :, 128 + rank:128 + rank + 32].detach().contiguous(),
               a[1].detach(), d[1].detach(), bias[1].detach(),
               gy[:, :, dp:2 * dp].contiguous(), True)
        # per (token, row, channel): the forward replay (exp, mul, FMA per
        # state) and the adjoint (~16 ops per state), softplus / sigmoid
        ops = l * 25 * dp * (16 * (4 + 16) + 10)
        nbytes = l * 25 * (dp * (2 + 4 + 2 + 2 + 4) + 2 * 32 * 2)
        return (grads, plain_grads, (lambda: ss.ssm_scan_arranged_grad(*one),
                                     lambda: ss.ssm_scan_arranged_grad_ref(*one)),
                None, bound(nbytes, ops, PEAK_FP32))

    for dp, hw in ((640, 64), (2560, 16)):
        grads, plain_grads, timing, lib, bnd = k6(dp, hw)
        yield ("ssm_scan_bwd", f"Dp={dp} L={hw * hw}+33 Bp=25 G=4 (train)",
               grads, plain_grads, lib, bnd, timing)

    def heads_view(x, h):
        """(B, S, H*d) -> (B, H, S, d) copy, SDPA's layout (made outside
        the timed library call)."""
        b, s, c = x.shape
        return x.view(b, s, h, c // h).transpose(1, 2).contiguous()

    for b, s, c, h in ((56, 4096, 320, 5), (56, 1024, 640, 10),
                       (56, 5184, 320, 5)):
        q, k, v = rnd(b, s, c), rnd(b, s, c), rnd(b, s, c)
        qh, kh, vh = (heads_view(x, h) for x in (q, k, v))
        ops = 4 * b * h * s * s * (c // h)
        yield ("mha", f"B={b} S={s} C={c} H={h}",
               lambda q=q, k=k, v=v, h=h: mha.mha_tokens(q, k, v, h),
               lambda q=q, k=k, v=v, h=h: mha.mha_tokens_ref(q, k, v, h),
               lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh),
               bound(4 * b * s * c * 2, ops, PEAK_BF16))
    for b, s, c, h in ((25, 4096, 320, 5), (25, 1024, 640, 10),
                       (25, 5184, 320, 5)):
        q, k, v, do = (rnd(b, s, c) for _ in range(4))
        o, lse = mha._mha_fwd(q, k, v, h, with_lse=True)
        qh, kh, vh = (heads_view(x, h).detach().requires_grad_(True)
                      for x in (q, k, v))
        oh, doh = F.scaled_dot_product_attention(qh, kh, vh), heads_view(do, h)
        # the five products of the backward: S = QK^T, dP = dO V^T,
        # dV = P^T dO, dQ = dS K, dK = dS^T Q
        ops = 5 * 2 * b * h * s * s * (c // h)
        yield ("mha_bwd", f"B={b} S={s} C={c} H={h} (train)",
               lambda q=q, k=k, v=v, o=o, lse=lse, do=do, h=h:
                   mha.mha_tokens_bwd(q, k, v, o, lse, do, h),
               lambda q=q, k=k, v=v, do=do, h=h: mha.mha_tokens_bwd_ref(q, k, v, do, h),
               lambda oh=oh, ins=(qh, kh, vh), doh=doh:
                   torch.autograd.grad(oh, ins, doh, retain_graph=True),
               bound(8 * b * s * c * 2 + b * h * s * 4, ops, PEAK_BF16))
    for f in (14, 25):
        q, k, v = (rnd(4 * f, 4096, 320) for _ in range(3))
        # SDPA over the frame axis: (B*S, H, F, d), laid out beforehand
        qf, kf, vf = (x.view(4, f, 4096, 5, 64).permute(0, 2, 3, 1, 4)
                      .reshape(4 * 4096, 5, f, 64) for x in (q, k, v))
        ops = 4 * 4 * 4096 * 5 * f * f * 64
        yield ("frame_attention", f"B*F={4 * f} F={f} S=4096 C=320 H=5",
               lambda q=q, k=k, v=v, f=f: mha.frame_attention_tokens(q, k, v, f, 5),
               lambda q=q, k=k, v=v, f=f: mha.frame_attention_tokens_ref(q, k, v, f, 5),
               lambda qf=qf, kf=kf, vf=vf: F.scaled_dot_product_attention(qf, kf, vf),
               bound(4 * 4 * f * 4096 * 320 * 2, ops, PEAK_BF16))
    for c in (320, 1280):
        m = 56 * 4096
        x = rnd(m, c)
        w1, b1 = rnd(8 * c, c, scale=c ** -0.5), rnd(8 * c, dtype=torch.float32, scale=0.1)
        w2, b2 = rnd(c, 4 * c, scale=(4 * c) ** -0.5), rnd(c, dtype=torch.float32, scale=0.1)
        yield ("geglu_mlp", f"M={m} C={c}",
               lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: mlp.geglu_mlp(x, w1, b1, w2, b2),
               lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: mlp.geglu_mlp_ref(x, w1, b1, w2, b2),
               None, bound(2 * (2 * m * c + 12 * c * c), 24 * m * c * c, PEAK_BF16))


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
    from actalker_tpu_torch.ops import _build, mha, mlp, selective_scan as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {k.name: k for k in (ss.KERNEL, mha.MHA_KERNEL,
                                   mha.FRAME_KERNEL, mlp.KERNEL,
                                   ss.BWD_KERNEL, mha.MHA_BWD_KERNEL)}

    t0 = time.perf_counter()
    _build.build_all(kernels.values())
    print(f"[2 build] {', '.join(f'{n} {k.build_seconds:.1f}s' for n, k in kernels.items())}"
          f" | total {time.perf_counter() - t0:.1f}s (in parallel)", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, label, kern, plain, lib, (bound_ms, bound_by), *timing in \
            kernel_cases(torch, dev, gen):
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        mx, rel = errors(out, ref)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        ok = all(bool(torch.isfinite(x.float()).all()) for x in outs) \
            and rel <= TOL[name]
        kern_t, plain_t = timing[0] if timing else (kern, plain)
        ms = timed(torch, kern_t, 10)
        plain_ms = timed(torch, plain_t, 3)
        lib_ms = timed(torch, lib, 10) if lib is not None else None
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        print(f"[3 kernel] {name} {label}: max_abs {mx:.4g} rel_l2 {rel:.3g} "
              f"(tol {TOL[name]}) | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"library {lib_txt} bound {bound_ms:.4f} ms ({bound_by}) "
              f"| {card}", flush=True)
        if not ok:
            raise RuntimeError(f"{name} {label} disagrees with its plain version")
        r = results.setdefault(name, {
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
        r["max_abs_err"] = max(r["max_abs_err"], mx)
        del out, ref, outs
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

    # ---- 5: the clip path, 512 px / 14 frames, bench.py::main_clip setup ----
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
    for n in kernels:
        if counts[n] != per_forward.get(n, 0) * unet_calls:
            raise RuntimeError(f"{n}: {counts[n]} launches, expected "
                               f"{per_forward.get(n, 0)} x {unet_calls} UNet calls")
    clip_counts = counts
    del mods, pipe, frames
    torch.cuda.empty_cache()

    # ---- 6: full-width gradients, kernels vs plain versions ----
    with torch.device("meta"):
        unet = UNetSpatioTemporalCondition(
            UNetConfig(gradient_checkpointing=True), dtype=torch.bfloat16)
    random_init_(unet, seed=0, device=dev)        # fp32 masters, as in training
    b, f, hw = 1, 4, 32
    g3 = torch.Generator(device=dev).manual_seed(2)
    rn = lambda *s: torch.randn(*s, generator=g3, device=dev)  # noqa: E731
    face = torch.zeros(1, 1, hw * 8, hw * 8, device=dev)
    face[..., hw * 2:hw * 6, hw * 2:hw * 6] = 1.0      # a face box: 25% of tokens
    cond = Conditioning(rn(b * f, 1, 1024).bfloat16(), rn(b * f, 32, 1024).bfloat16(),
                        rn(b * f, 1, 1024).bfloat16(), face,
                        torch.ones(1, 1, hw * 8, hw * 8, device=dev))
    args = (rn(b, f, hw, hw, 8).bfloat16(), torch.full((b,), 0.5, device=dev), cond,
            rn(b, 3).bfloat16(), (rn(b, f, hw, hw, 320) * 0.1).bfloat16())
    cot = rn(b, f, hw, hw, 4)
    named = list(unet.named_parameters())
    groups = {g: [i for i, (n, _) in enumerate(named) if re.search(pat, n)]
              for g, (pat, _) in GRAD_GROUPS.items()}

    def unet_grads():
        """Loss, the flat gradient of every parameter, and the flat gradient
        of each of GRAD_GROUPS."""
        unet.zero_grad(set_to_none=True)
        loss = (unet(*args).float() * cot).sum()
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for _, p in named]
        flat = torch.cat([x.flatten() for x in grads])
        by_group = {g: torch.cat([grads[i].flatten() for i in idx])
                    for g, idx in groups.items()}
        unet.zero_grad(set_to_none=True)
        return loss.item(), flat, by_group

    def group_errors(got, want):
        return {g: errors(got[g], want[g])[1] for g in GRAD_GROUPS}

    for k in kernels.values():
        k.launches = 0
    loss_k, g_k, gg_k = unet_grads()
    grad_counts = {n: k.launches for n, k in kernels.items()}
    with plain_ops():
        loss_p, g_p, gg_p = unet_grads()
    torch.cuda.synchronize()
    mx, rel = errors(g_k, g_p)
    rel_g = group_errors(gg_k, gg_p)
    print(f"[6 grad] UNetConfig(gradient_checkpointing=True) bf16 / fp32 masters "
          f"(1, 4, 32, 32, 8), face-box mask: loss kernels {loss_k:.6g} plain "
          f"{loss_p:.6g} | {g_k.numel()} gradient entries: max_abs {mx:.4g} "
          f"rel_l2 {rel:.3g} (tol {UNET_GRAD_TOL}) | by group (tol) "
          f"{ {g: f'{r:.3g} ({GRAD_GROUPS[g][1]})' for g, r in rel_g.items()} } "
          f"| launches {grad_counts} | {card}", flush=True)
    if not (torch.isfinite(g_k).all() and rel <= UNET_GRAD_TOL
            and all(rel_g[g] <= GRAD_GROUPS[g][1] for g in GRAD_GROUPS)
            and abs(loss_k - loss_p) <= UNET_TOL * abs(loss_p)):
        raise RuntimeError("UNet gradients through the kernels disagree with "
                           "the plain path")
    if any(grad_counts[n] == 0 for n in kernels):
        raise RuntimeError(f"a kernel did not run in the gradient: {grad_counts}")
    del g_k
    with attention_bwd("library"):
        _, g_l, gg_l = unet_grads()
    rel_gl = group_errors(gg_l, gg_p)
    del g_l, gg_l
    with attention_bwd("zero dq"):
        _, g_c, gg_c = unet_grads()
    rel_gc = group_errors(gg_c, gg_p)
    for what, r in (("library attention backward (SDPA) in K2-bwd's place",
                     rel_gl), ("control, K2-bwd's dq set to zero", rel_gc)):
        print(f"[6 grad] {what}: vs plain by group "
              f"{ {g: f'{x:.3g}' for g, x in r.items()} } | {card}", flush=True)
    if all(rel_gc[g] <= GRAD_GROUPS[g][1] for g in GRAD_GROUPS):
        raise RuntimeError("the gradient check cannot tell a zero dq apart")
    del unet, named, unet_grads, g_c, gg_c, g_p, gg_p, gg_k, args, cond
    torch.cuda.empty_cache()

    # ---- 7: the training path at the configs/train.yaml operating point ----
    from actalker_tpu_torch.io import checkpoint as ckpt
    from actalker_tpu_torch.training import train

    shutil.rmtree(OUT, ignore_errors=True)
    out_dir, ref_dir = os.path.join(OUT, "train"), os.path.join(OUT, "reference")
    os.makedirs(OUT)
    free_gib = shutil.disk_usage(OUT).free / 2 ** 30
    seen = {"counts": [], "moved": []}

    def watched(trainer):
        mods = trainer.modules
        return {"unet.conv_in": mods["unet"].conv_in.weight,
                "unet.up_attn": mods["unet"].up_blocks[3].attentions[0].proj_in.weight,
                "audio_proj": mods["audio_proj"].proj1.weight,
                "pose_guider": mods["pose_guider"].conv_in.weight}

    def observe(trainer, rec):
        if rec is None:             # just before the first micro-step
            for k in kernels.values():
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
            seen["before"] = {n: p.detach().clone()
                              for n, p in watched(trainer).items()}
        else:
            seen["moved"].append({n: not torch.equal(p, seen["before"][n])
                                  for n, p in watched(trainer).items()})
        seen["counts"].append({n: k.launches for n, k in kernels.items()})

    t0 = time.perf_counter()
    res = train.main(["--config", os.path.join(ROOT, "configs", "train.yaml"),
                      "--synthetic", str(TRAIN_MICRO_STEPS), "--steps",
                      str(TRAIN_MICRO_STEPS), "--output", out_dir,
                      "--export-reference", ref_dir], observe=observe)
    main_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    recs = res["records"]
    per_step = [{n: c1[n] - c0[n] for n in kernels}
                for c0, c1 in zip(seen["counts"], seen["counts"][1:])]
    train_counts = {n: seen["counts"][-1][n] for n in kernels}
    secs = sorted(r["seconds"] for r in recs[-4:])
    sec_step = (secs[1] + secs[2]) / 2
    # per micro-step with one checkpoint scope per block: every forward
    # kernel runs twice (forward, recompute); the backward runs K6 once per
    # (SS2D block, group) and K2-bwd once per spatial self-attention
    expect = {"ssm_scan_grouped": 2 * 15, "mha": 2 * 16, "frame_attention": 2 * 16,
              "geglu_mlp": 2 * 96, "ssm_scan_bwd": 15 * 4, "mha_bwd": 16}
    print(f"[7 train] {TRAIN_MICRO_STEPS} micro-steps at 512 px x 25 frames, "
          f"batch 1, accumulation 4, block checkpointing, bf16 / fp32 masters: "
          f"seconds per micro-step {sec_step:.4f} s (median of the last 4) | "
          f"peak max_memory_allocated {peak_gib:.2f} GiB | main() {main_s:.1f} s "
          f"| disk free before {free_gib:.0f} GiB | {card}", flush=True)
    print(f"[7 train] losses {[round(r['loss'], 6) for r in recs]} | commits "
          f"{[r['commit'] for r in recs]} | grad_norm "
          f"{[r['grad_norm'] for r in recs]} | seconds "
          f"{[round(r['seconds'], 4) for r in recs]} | {card}", flush=True)
    print(f"[7 train] launches per micro-step {per_step[-1]} (expected {expect})"
          f" | moved after each micro-step "
          f"{[any(m.values()) for m in seen['moved']]}", flush=True)
    import math

    if len(recs) != TRAIN_MICRO_STEPS or not all(math.isfinite(r["loss"])
                                                 for r in recs):
        raise RuntimeError("training losses missing or not finite")
    if any(c != expect for c in per_step):
        raise RuntimeError(f"launches per micro-step {per_step} != {expect}")
    moved = [all(m.values()) for m in seen["moved"]]
    still = [not any(m.values()) for m in seen["moved"]]
    if [r["commit"] for r in recs] != [i % 4 == 3 for i in range(TRAIN_MICRO_STEPS)] \
            or not (all(still[:3]) and moved[3]):
        raise RuntimeError("parameters moved before the first commit or not "
                           "after it")
    state = ckpt.restore_checkpoint(out_dir)
    for name, m in res["modules"].items():
        for k, v in m.state_dict().items():
            if not torch.equal(state["params"][name][k], v.cpu()):
                raise RuntimeError(f"checkpoint {name}.{k} does not reload")
    if len(res["exported"]) != 6 or not all(os.path.getsize(p) > 0
                                            for p in res["exported"]):
        raise RuntimeError(f"expected six exported files: {res['exported']}")
    print(f"[7 train] checkpoint-{ckpt.latest_checkpoint(out_dir)} reloads equal; "
          f"exported {sorted(os.path.basename(p) for p in res['exported'])}",
          flush=True)
    del res, state
    shutil.rmtree(OUT, ignore_errors=True)

    launches = {n: (train_counts[n] if n in ("ssm_scan_bwd", "mha_bwd")
                    else clip_counts[n]) for n in kernels}
    print(json.dumps({"kernels": [{
        "name": n, "route": "cuda",
        "source": os.path.relpath(k.source, ROOT),
        "replaces": k.replaces, "launches": launches[n],
        "launches_by_path": {"clip": clip_counts[n], "train": train_counts[n]},
        "max_abs_err": results[n]["max_abs_err"], "ms": results[n]["ms"],
        "plain_ms": results[n]["plain_ms"], "bound_ms": results[n]["bound_ms"],
        "bound_by": results[n]["bound_by"],
        "library_ms": results[n]["library_ms"]} for n, k in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
