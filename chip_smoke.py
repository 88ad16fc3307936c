#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``actalker_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 (Hopper):

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. card: name and power limit (nvidia-smi), torch / CUDA versions; no GPU
     -> exit 1 without a result;
  2. build: nvcc-compiles the ten hand-written kernels (K1-K4, the
     single-direction scan K5, the scan adjoint K6, the attention backward
     K2-bwd, LayerNorm K7-LN, GroupNorm K7-GN and the fused GroupNorm + SiLU
     + 3x3 conv K8) from ``actalker_tpu_torch/csrc`` into
     ``actalker_tpu_torch/_build``, one nvcc process per source, all started
     together;
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the clip, training, lineage and CLI paths give it (K1 also
     at the gather's compacted lengths, K7-LN at the audio encoder's
     (1500, 384) fp32), same inputs,
     fp32 accumulation in the plain version, with CUDA-event times
     (median), the time of one PyTorch library call computing the same
     function where there is one, and the data-sheet bound (K1, K5 and K6
     also their special-function floor; K7-GN also K8's statistics alone,
     bound by one read of x; K4 and K8 also a chain of library calls
     computing their function, timed only; K7-LN and K8 also their launch
     alone, without the wrapper's other work); then K8's five
     bisect variants (``tools/resconv_bisect.py``) against their plain
     versions at a small shape, and timed at (56, 64, 64, 320 -> 320);
  4. UNet: one full-width bf16 forward (UNetConfig(), seeded weights) on a
     small latent through the kernels and through the plain versions;
     4b. the same under the fused-norm configuration (ACTALKER_NORM=fused,
     ACTALKER_RESCONV=pallas: K7-LN, K7-GN and K8 on the path);
  5. clip path: the 512 px / 14-frame clip (full-width UNet, bf16 UNet and
     VAE, seeded weights, mode 2) through ``generate_latents`` and
     ``decode_latents``, run twice; the second run is timed, and the kernel
     launch counts of that run must match the UNet calls it made, and
     K7-LN / K7-GN / K8 must not launch;
     5b. the same clip under the fused-norm configuration, timed the same
     way; the launches of all seven forward kernels must equal the counts
     derived from the model (UNet calls, VAE encodes and decodes, heads);
  6. gradients: a full-width UNet with block checkpointing (fp32 master
     weights, bf16 compute) on a small latent, loss and every parameter
     gradient through the kernels and through the plain versions;
  7. training path: ``training.train.main`` at the ``configs/train.yaml``
     operating point (512 px, 25 frames, batch 1, 4-step accumulation,
     block checkpointing, seeded weights) for 8 micro-steps: finite losses,
     launches per micro-step equal to the counts derived from the model,
     parameters still before the first commit and moved after it, the
     checkpoint reloads, six reference files exported;
  8. lineage: SS2DCondV9 / V5 / V6 at the UNet's res-64 control-block shape
     (bf16, d_model 320, the clip's 33-token tail, V9 with face-box masks)
     and MambaUPNet at its published defaults on (8, 8, 8, 512) fp32,
     seeded with the JAX package's initializers, through K5 and through the
     plain versions; launch counts derived from the modules; one V9 loss
     backward through K5 / K6 against the plain path, by parameter group;
  9. the inference CLI (``cli.generate_frames``, then ``write_outputs``
     where the machine has a video encoder) at full width, 512 px, 14
     frames, 3 steps, seeded weights, on a written WAV and portrait: mode 0
     with a fixed face box (the SSM gather: K1's rows must be the derived
     budgets) and mode 2, each run once to warm up and once counted, stage
     times printed; then C9, the mode-0 window-step with the gather and
     with the masked-dense scan (``gather=False``), and C7, the 576 px /
     25-frame window-step in both configurations with its peak memory,
     each beside one UNet forward through the kernels and the plain
     versions; launch counts derived from the model;
 10. the CLI's full path: the six networks of the face stack and the
     post-passes (yolov5m-face, SCRFD-10G-bnkps, RTMPose-m face6, GPEN-512,
     the teeth net, IFNet c = 90) seeded at their published widths and
     saved as the reference's files; ``cli.generate_frames`` in mode 2 at
     full width, 512 px, 14 frames, 3 steps with every pass on (the learned
     detector, landmarks, reference-image BFR, teeth, frame BFR, RIFE: 27
     frames), once to warm up and once counted, stage times printed, K1-K4
     launches derived from the model; SCRFD alone; each network on the card
     (fp32, loaded from its file) against the same module on the CPU.
Then a JSON line with the bisect variants, one with the kernels, the card
line, and the last line ``{"ok": true, "device": {...}}``.

Matrix products in the plain versions run in full fp32 (TF32 off for both
cuBLAS and cuDNN).
"""
import contextlib
import json
import math
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
    "ssm_scan": 1e-3,
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
    # fp32 statistics and affine in both, one rounding of the output to
    # the input dtype in both: only the order of the fp32 sums differs
    "layer_norm": 1e-3,
    "group_norm": 1e-3,
    # the activation is rounded to bf16 in both before the product (the
    # kernel's exp-based SiLU and the plain sigmoid can flip single
    # roundings); fp32 accumulation in another order
    "gn_silu_conv3x3": 5e-3,
}
# the kernels of the default clip and training paths (phases 5-7), and the
# three the fused-norm configuration adds (phases 4b, 5b)
DEFAULT_KERNELS = ("ssm_scan_grouped", "mha", "frame_attention", "geglu_mlp",
                   "ssm_scan_bwd", "mha_bwd")
FUSED_KERNELS = ("layer_norm", "group_norm", "gn_silu_conv3x3")
# the lineage modules, kernels vs plain (phase 8), by activation dtype: in
# bf16 the scans' outputs round to bf16 in both and a single flip travels
# through the later units (the CPU tests' bf16 tolerance); in fp32 only the
# kernel's exp / log1p differ, through 16 blocks
LINEAGE_TOL = {"bfloat16": 2e-2, "float32": 1e-3}
# (pattern, tolerance) of the lineage's scan parameters, whose gradients
# K6 gives directly (the tolerance of phase 6's K6 groups)
LINEAGE_GRAD_GROUPS = {
    "K6 dx_proj": (r"_unit\.x_proj_weight$", 3e-2),
    "K6 ddt_projs": (r"_unit\.dt_projs_(weight|bias)$", 3e-2),
    "K6 dA": (r"_unit\.A_logs$", 3e-2),
    "K6 dD": (r"_unit\.Ds$", 3e-2),
}
# phase 9: the CLI's mode-0 face box (a detector's box whose area-expanded
# pose mask, x 1.2 in configs/inference.yaml, covers 31.2% of the 512 px
# portrait), the SSM budget _capacity_fracs gives it (its res-16 selection
# is 33% of the tokens; checked in phase 9), and the 576 px / 25-frame
# window of C7
CLI_BOX = (136.0, 136.0, 375.0, 375.0)
C9_CAPACITY = 0.375
C7_PX, C7_FRAMES = 576, 25
# phase 10: the face stack's and the post-passes' networks, the card against
# the CPU on the same weights and inputs. fp32 on both (TF32 off); cuDNN
# and the CPU sum each conv in another order, through up to ~60 layers
FACE_NET_TOL = 1e-4
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


def sfu_floor_ms(n_special):
    """Least time (ms) for ``n_special`` exp2 / log2 on the card's
    special-function units: 16 per SM per clock at the card's largest SM
    clock (nvidia-smi's clocks.max.sm), on every SM."""
    import torch

    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mhz = float(out.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_special / (16 * sms * mhz * 1e6) * 1e3


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
    """Route the models' kernel call sites (K1-K4; K7-LN, K7-GN and K8 of
    the fused-norm configuration) to the plain versions (their gradients
    then come from autograd through the plain versions), and K5's forward
    (inside ``SsmScanArrangedFn`` too) to its plain version; a backward
    through K5's function takes the plain adjoint under ``plain_adjoint``."""
    from actalker_tpu_torch.models import (
        attention_blocks as ab, common, resnet, ssm)
    from actalker_tpu_torch.ops import mha, mlp, norms, resconv, selective_scan as ss

    saved = (ab.mha_tokens, ab.frame_attention_tokens, ab.geglu_mlp,
             ssm.ssm_scan_grouped, common.layer_norm, common.group_norm,
             resnet.gn_silu_conv3x3, ss._arranged_fwd)
    ab.mha_tokens, ab.frame_attention_tokens = (mha.mha_tokens_ref,
                                                mha.frame_attention_tokens_ref)
    ab.geglu_mlp, ssm.ssm_scan_grouped = mlp.geglu_mlp_ref, ss.ssm_scan_grouped_ref
    common.layer_norm, common.group_norm = norms.layer_norm_ref, norms.group_norm_ref
    resnet.gn_silu_conv3x3 = resconv.gn_silu_conv3x3_ref
    ss._arranged_fwd = ss.ssm_scan_arranged_ref
    try:
        yield
    finally:
        (ab.mha_tokens, ab.frame_attention_tokens, ab.geglu_mlp,
         ssm.ssm_scan_grouped, common.layer_norm, common.group_norm,
         resnet.gn_silu_conv3x3, ss._arranged_fwd) = saved


@contextlib.contextmanager
def fused_norm_config():
    """ACTALKER_NORM=fused and ACTALKER_RESCONV=pallas, both switches
    restored afterwards."""
    from actalker_tpu_torch.models import common, resnet

    saved = common.norm_impl(), resnet.resconv_impl()
    common.set_norm_impl("fused")
    resnet.set_resconv_impl("pallas")
    try:
        yield
    finally:
        common.set_norm_impl(saved[0])
        resnet.set_resconv_impl(saved[1])


def lineage_launches(module):
    """K5 launches of one forward of a lineage module: one per direction of
    every scan unit (``SS2DUnit``, and ``SS2DSpatial``'s scan parameters,
    a subclass of it)."""
    from actalker_tpu_torch.models.ssm import SS2DUnit

    return sum(m.num_direction for m in module.modules()
               if isinstance(m, SS2DUnit))


def fused_launches(*modules):
    """Launches of K7-LN, K7-GN and K8 that one forward of each module makes
    under ACTALKER_NORM=fused and ACTALKER_RESCONV=pallas: one K7-LN per
    LayerNormF32, one K7-GN per GroupNorm32 (the statistics of a resnet
    pair included), one K8 per GroupNorm / SiLU / conv pair of a
    ResnetBlock2D (two each)."""
    from actalker_tpu_torch.models.common import GroupNorm32, LayerNormF32
    from actalker_tpu_torch.models.resnet import ResnetBlock2D

    kinds = {"layer_norm": LayerNormF32, "group_norm": GroupNorm32,
             "gn_silu_conv3x3": ResnetBlock2D}
    return {name: sum((2 if kind is ResnetBlock2D else 1)
                      for m in modules for sub in m.modules()
                      if isinstance(sub, kind))
            for name, kind in kinds.items()}


def gathered_rows(l, frac):
    """K1's token slots for one branch of ``l`` tokens under the capacity
    fraction ``frac`` (``SS2DCondV10._capacities``)."""
    k = math.ceil(min(max(frac, 0.0), 1.0) * l)
    return min(l, -(-k // 8) * 8) if k else 0


def kernel_cases(torch, dev, gen):
    """Yield (kernel name, label, kernel fn, plain fn, library fn or None,
    (bound ms, bound by), extras) at the shapes the clip and training paths
    use; the first case of each kernel is its main-path shape. extras may
    hold "timing" (the (kernel, plain) pair to time in place of the two
    compared), "chain" (a second library yardstick) and "alone" (the
    kernel's launch without its wrapper's other work)."""
    import torch.nn.functional as F

    from actalker_tpu_torch.ops import mha, mlp, norms, resconv, selective_scan as ss

    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def grouped(dp, hw, bp, rows=None):
        # one SS2D block at d_inner = dp: rank = ceil(d_model / 16), L = h*w
        # tokens (or the gather's ``rows`` slots) + 33 tail tokens (1 id +
        # 32 audio)
        g, n_tok, rank = 4, (rows or hw * hw) + 33, -(-dp // 2 // 16)
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

    def k1(dp, hw, rows=None):
        args = grouped(dp, hw, 56, rows)  # Bp = 4 CFG x 14 frames
        l, bp, r = args[0].shape[0], 56, args[6]
        # per (token, row, group, channel): the rank + 1 lane projection,
        # softplus, and per state exp + mul + 2 FMA (y and h)
        ops = l * bp * 4 * dp * (2 * (r + 1) + 10 + 16 * 6)
        nbytes = 2 * l * bp * (2 * dp + 4 * 128 + 4 * dp) + 4 * 4 * dp * (128 + 19)
        # the special-function floor: 16 exps and a softplus (exp, log) per
        # (token, row, group, channel), not part of the bound
        floor = sfu_floor_ms(l * bp * 4 * dp * 18)
        return (lambda: ss.ssm_scan_grouped(*args),
                lambda: ss.ssm_scan_grouped_ref(*args), None,
                bound(nbytes, ops, PEAK_FP32), {"floor": floor})

    # the window-step's three SS2D resolutions: res-64 (rank 20), res-32
    # (rank 40), res-16 (rank 80)
    yield ("ssm_scan_grouped", "Dp=640 L=4096+33 Bp=56 (res-64)", *k1(640, 64))
    yield ("ssm_scan_grouped", "Dp=1280 L=1024+33 Bp=56 (res-32)", *k1(1280, 32))
    yield ("ssm_scan_grouped", "Dp=2560 L=256+33 Bp=56 (res-16)", *k1(2560, 16))
    # the gather of modes 0 / 1 (phase 9): a 6/16 budget of each resolution's
    # tokens (the ~31% face box of C9) + the 33-token tail
    for dp, hw in ((640, 64), (1280, 32), (2560, 16)):
        k = gathered_rows(hw * hw, C9_CAPACITY)
        yield ("ssm_scan_grouped", f"Dp={dp} L={k}+33 Bp=56 (gathered res-{hw})",
               *k1(dp, hw, k))

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
        # the special-function floor: two rounds of 16 exps (the forward
        # states, the adjoint's decays), a softplus twice and a sigmoid per
        # (token, row, channel): 38 exp2 / log2 / rcp, not part of the bound
        floor = sfu_floor_ms(l * 25 * dp * 38)
        return (grads, plain_grads, (lambda: ss.ssm_scan_arranged_grad(*one),
                                     lambda: ss.ssm_scan_arranged_grad_ref(*one)),
                None, bound(nbytes, ops, PEAK_FP32), floor)

    # the training groups at res-64, res-32 and res-16
    for dp, hw in ((640, 64), (1280, 32), (2560, 16)):
        grads, plain_grads, timing, lib, bnd, floor = k6(dp, hw)
        yield ("ssm_scan_bwd", f"Dp={dp} L={hw * hw}+33 Bp=25 G=4 (train)",
               grads, plain_grads, lib, bnd, {"timing": timing, "floor": floor})

    def k5(lp, bp, dp, dtype):
        # one direction of a lineage scan unit: the 2N = 32 B|C lanes of
        # 128, ~30% masked rows (delta -1e9, exact identity steps)
        dt = torch.randn(lp, bp, dp, generator=gen, device=dev) * 0.5
        dt[torch.rand(lp, bp, generator=gen, device=dev) < 0.3] = -1e9
        bc = torch.zeros(lp, bp, 128, device=dev)
        bc[..., :32] = torch.randn(lp, bp, 32, generator=gen, device=dev) * 0.5
        args = (rnd(lp, bp, dp, dtype=dtype), dt.to(dtype), bc.to(dtype),
                -torch.exp(torch.randn(dp, 16, generator=gen, device=dev) * 0.5),
                torch.randn(dp, generator=gen, device=dev),
                torch.randn(dp, generator=gen, device=dev) * 0.5)
        item = args[0].element_size()
        # per (token, row, channel): softplus, delta * u, D * u (~10) and per
        # state exp + mul + 2 FMA (h and y); bytes: u, dt, y and the 32 B|C
        # lanes once, A / D / bias
        ops = lp * bp * dp * (10 + 16 * 6)
        nbytes = lp * bp * (3 * dp + 32) * item + 4 * dp * 18
        return args, nbytes, ops

    # the lineage's res-64 blocks, then MambaUPNet's four stages (8 images
    # at its published dims: d_inner 2 x dim, L = (H / 2^s)^2)
    for lp, bp, dp, dtype, what in ((4096 + 33, 56, 640, bf, "V5/V6/V9 res-64"),
                                    (4096, 8, 128, torch.float32,
                                     "MambaUPNet last stage"),
                                    (64, 8, 1024, torch.float32,
                                     "MambaUPNet stage 1"),
                                    (256, 8, 512, torch.float32,
                                     "MambaUPNet stage 2"),
                                    (1024, 8, 256, torch.float32,
                                     "MambaUPNet stage 3")):
        args, nbytes, ops = k5(lp, bp, dp, dtype)
        bnd = bound(nbytes, ops, PEAK_FP32)
        # the special-function floor: 16 exps and a softplus (exp, log) per
        # (token, row, channel), not part of the bound
        floor = sfu_floor_ms(lp * bp * dp * 18)
        for rev in (False, True):
            yield ("ssm_scan", f"L={lp} Bp={bp} Dp={dp} {str(dtype)[6:]} "
                   f"{'reverse' if rev else 'forward'} ({what})",
                   lambda args=args, rev=rev: ss.ssm_scan_arranged(*args, reverse=rev),
                   lambda args=args, rev=rev: ss.ssm_scan_arranged_ref(*args, rev),
                   None, bnd, {"floor": floor})
        if dtype is bf:
            # K5 -> K6: gradients through SsmScanArrangedFn against the same
            # function with the plain adjoint (K6's rows keep its training
            # shape's numbers; this case adds its error)
            ins = [t.requires_grad_(True) for t in args]
            gy = rnd(lp, bp, dp)

            def k5_grads(ins=ins, gy=gy):
                return torch.autograd.grad(ss.ssm_scan_arranged(*ins), ins, gy)

            def k5_plain_grads(ins=ins, gy=gy):
                with plain_adjoint():
                    return torch.autograd.grad(ss.ssm_scan_arranged(*ins), ins, gy)

            # K5's bound plus K6's (as its training case counts it)
            ops6 = lp * bp * dp * (16 * (4 + 16) + 10)
            bytes6 = lp * bp * (dp * (2 + 4 + 2 + 2 + 4) + 2 * 32 * 2)
            yield ("ssm_scan_bwd", f"K5 -> K6 L={lp} Bp={bp} Dp={dp} bf16 ({what})",
                   k5_grads, k5_plain_grads, None,
                   bound(nbytes + bytes6, ops + ops6, PEAK_FP32))

    def heads_view(x, h):
        """(B, S, H*d) -> (B, H, S, d) copy, SDPA's layout (made outside
        the timed library call)."""
        b, s, c = x.shape
        return x.view(b, s, h, c // h).transpose(1, 2).contiguous()

    # the window-step's four resolutions (res-64, -32, -16, the res-8 mid
    # block) and the 576 px latent (S = 5184, no multiple of the tiles);
    # the training backward at the same S and C
    for b, s, c, h in ((56, 4096, 320, 5), (56, 1024, 640, 10),
                       (56, 5184, 320, 5), (56, 256, 1280, 20),
                       (56, 64, 1280, 20)):
        q, k, v = rnd(b, s, c), rnd(b, s, c), rnd(b, s, c)
        qh, kh, vh = (heads_view(x, h) for x in (q, k, v))
        ops = 4 * b * h * s * s * (c // h)
        yield ("mha", f"B={b} S={s} C={c} H={h}",
               lambda q=q, k=k, v=v, h=h: mha.mha_tokens(q, k, v, h),
               lambda q=q, k=k, v=v, h=h: mha.mha_tokens_ref(q, k, v, h),
               lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh),
               bound(4 * b * s * c * 2, ops, PEAK_BF16))
    for b, s, c, h in ((25, 4096, 320, 5), (25, 1024, 640, 10),
                       (25, 5184, 320, 5), (25, 256, 1280, 20),
                       (25, 64, 1280, 20)):
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
    # K3: the 14-frame window-step at res-64 / -32 / -16 / -8 (4 CFG x 14
    # frames), 4 CFG x 25 frames at res-64, training's 25 frames, and the
    # reference's default 576 px window (4 CFG x 25 frames, S = 72^2)
    for b, f, s, h in ((4, 14, 4096, 5), (4, 25, 4096, 5), (4, 14, 1024, 10),
                       (4, 14, 256, 20), (4, 14, 64, 20), (1, 25, 4096, 5),
                       (4, 25, 5184, 5)):
        c = 64 * h
        q, k, v = (rnd(b * f, s, c) for _ in range(3))
        # SDPA over the frame axis: (B*S, H, F, d), laid out beforehand
        qf, kf, vf = (x.view(b, f, s, h, 64).permute(0, 2, 3, 1, 4)
                      .reshape(b * s, h, f, 64) for x in (q, k, v))
        ops = 4 * b * s * h * f * f * 64
        yield ("frame_attention", f"B*F={b * f} F={f} S={s} C={c} H={h}",
               lambda q=q, k=k, v=v, f=f, h=h: mha.frame_attention_tokens(q, k, v, f, h),
               lambda q=q, k=k, v=v, f=f, h=h: mha.frame_attention_tokens_ref(q, k, v, f, h),
               lambda qf=qf, kf=kf, vf=vf: F.scaled_dot_product_attention(qf, kf, vf),
               bound(4 * b * f * s * c * 2, ops, PEAK_BF16))
    def geglu_chain(x, w1, b1, w2, b2):
        # the library chain: F.linear -> fp32 gate -> F.linear, bf16 products
        inner = w2.shape[1]
        h2 = F.linear(x, w1, b1)
        g = h2[:, inner:].float()
        h = (h2[:, :inner].float() * 0.5 * g * (1.0 + torch.erf(g * 2 ** -0.5))).to(bf)
        return F.linear(h, w2, b2)

    # the window-step's feed-forwards (res-64, -32, -16 and the res-8 mid
    # block), and C = 1280 at res-64's M (off the path)
    for m, c, what in ((56 * 4096, 320, "res-64"), (56 * 1024, 640, "res-32"),
                       (56 * 256, 1280, "res-16"), (56 * 64, 1280, "res-8"),
                       (56 * 4096, 1280, "off the path")):
        x = rnd(m, c)
        w1, b1 = rnd(8 * c, c, scale=c ** -0.5), rnd(8 * c, dtype=torch.float32, scale=0.1)
        w2, b2 = rnd(c, 4 * c, scale=(4 * c) ** -0.5), rnd(c, dtype=torch.float32, scale=0.1)
        yield ("geglu_mlp", f"M={m} C={c} ({what})",
               lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: mlp.geglu_mlp(x, w1, b1, w2, b2),
               lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: mlp.geglu_mlp_ref(x, w1, b1, w2, b2),
               None, bound(2 * (2 * m * c + 12 * c * c), 24 * m * c * c, PEAK_BF16),
               {"chain": lambda x=x, w1=w1, b1=b1.to(bf), w2=w2, b2=b2.to(bf):
                    geglu_chain(x, w1, b1, w2, b2)})

    # the fused-norm configuration: K7-LN at the transformers' (B*F*HW, C)
    # (res-64, res-32, res-16), the res-16 SSM out_norm and the fp32
    # projection heads; K7-GN at the transformers' and temporal resnets'
    # (N, M, C) and the VAE's 512 px images; K8 at the UNet's spatial
    # resnets (res-64, res-32, res-16, res-8) and the VAE's 512 px convs.
    # Bounds: bytes once in and once out; K8 by its 2 * M * 9C * Co
    # tensor-core operations.
    # (and the audio encoder's fp32 LayerNorms over one 30 s window, the
    # CLI's whisper under the fused-norm configuration)
    for m, c, dtype in ((56 * 4096, 320, bf), (56 * 1024, 640, bf),
                        (56 * 256, 1280, bf), (56 * 256, 2560, bf),
                        (56 * 32, 1024, torch.float32),
                        (1500, 384, torch.float32)):
        x = rnd(m, c, dtype=dtype, scale=2.0) + 0.5
        g, b = rnd(c, dtype=torch.float32), rnd(c, dtype=torch.float32)
        item = x.element_size()
        yield ("layer_norm", f"({m}, {c}) {str(dtype)[6:]}",
               lambda x=x, g=g, b=b: norms.layer_norm(x, g, b),
               lambda x=x, g=g, b=b: norms.layer_norm_ref(x, g, b),
               lambda x=x, g=g.to(dtype), b=b.to(dtype), c=c:
                   F.layer_norm(x, (c,), g, b, 1e-5),
               bound(2 * m * c * item + 8 * c, 8 * m * c, PEAK_FP32),
               # K7-LN's launch alone, into an output made beforehand
               {"alone": lambda x=x, g=g, b=b, y=torch.empty_like(x):
                    norms.layer_norm_launch(x, g, b, y, 1e-5)})
    # K7-GN: the transformers' norms at res-64 / -32 / -16 / -8, the
    # temporal resnets' at res-64, the VAE's 512 px frames; then K8's
    # statistics alone (one read of x) at res-64 and at res-16's widest
    # resnet input
    for n, m, c, eps in ((56, 4096, 320, 1e-6), (4, 14 * 4096, 320, 1e-5),
                         (14, 512 * 512, 128, 1e-6), (56, 1024, 640, 1e-6),
                         (56, 256, 1280, 1e-6), (56, 64, 1280, 1e-6)):
        x = rnd(n, m, c, scale=2.0) - 0.5
        g, b = rnd(c, dtype=torch.float32), rnd(c, dtype=torch.float32)
        # F.group_norm on the channels-last NCHW view (N, C, M, 1)
        xv = x.view(n, m, 1, c).permute(0, 3, 1, 2)
        yield ("group_norm", f"(N, M, C) = ({n}, {m}, {c})",
               lambda x=x, g=g, b=b, eps=eps: norms.group_norm(x, g, b, 32, eps),
               lambda x=x, g=g, b=b, eps=eps: norms.group_norm_ref(x, g, b, 32, eps),
               lambda xv=xv, g=g.to(bf), b=b.to(bf), eps=eps:
                   F.group_norm(xv, 32, g, b, eps),
               bound(2 * n * m * c * 2 + 8 * c, 10 * n * m * c, PEAK_FP32))
    for n, m, c in ((56, 4096, 320), (56, 256, 2560)):
        x = rnd(n, m, c, scale=2.0) - 0.5
        g, b = rnd(c, dtype=torch.float32), rnd(c, dtype=torch.float32)
        yield ("group_norm", f"statistics alone (K8's), (N, M, C) = ({n}, {m}, {c})",
               lambda x=x, g=g, b=b: norms.group_norm_affine(x, g, b, 32, 1e-5),
               lambda x=x, g=g, b=b: norms.gn_affine(x, g, b, 32, 1e-5), None,
               bound(n * m * c * 2 + 8 * c + 8 * n * c, 3 * n * m * c, PEAK_FP32))
    for n, hw, c, co in ((56, 64, 320, 320), (56, 32, 640, 640),
                         (56, 16, 2560, 1280), (56, 8, 1280, 1280),
                         (14, 512, 128, 128)):
        x = rnd(n, hw, hw, c, scale=1.5) + 0.3
        g = 1.0 + rnd(c, dtype=torch.float32, scale=0.1)
        b = rnd(c, dtype=torch.float32, scale=0.5)
        w = rnd(co, c, 3, 3, scale=(9 * c) ** -0.5)
        cb = rnd(co, dtype=torch.float32, scale=0.1)
        # the library yardsticks take NCHW views with channels-last strides
        xv = x.permute(0, 3, 1, 2)
        with torch.no_grad():
            act = F.silu(F.group_norm(xv, 32, g.to(bf), b.to(bf), 1e-5))
        # K8's launch alone, on operands its wrapper prepares
        ops8 = resconv.conv_operands(x, g, b, 32, 1e-5, w, cb)
        m = n * hw * hw
        yield ("gn_silu_conv3x3", f"({n}, {hw}, {hw}, {c} -> {co})",
               lambda x=x, g=g, b=b, w=w, cb=cb:
                   resconv.gn_silu_conv3x3(x, g, b, 32, 1e-5, w, cb),
               lambda x=x, g=g, b=b, w=w, cb=cb:
                   resconv.gn_silu_conv3x3_ref(x, g, b, 32, 1e-5, w, cb),
               lambda act=act, w=w, cb=cb: F.conv2d(act, w, cb.to(bf), padding=1),
               bound(2 * (m * c + m * co + 9 * c * co), 2 * m * 9 * c * co,
                     PEAK_BF16),
               {"chain": lambda xv=xv, g=g.to(bf), b=b.to(bf), w=w, cb=cb.to(bf):
                    F.conv2d(F.silu(F.group_norm(xv, 32, g, b, 1e-5)), w, cb,
                             padding=1),
                "alone": lambda ops8=ops8: resconv.conv_launch(*ops8)})


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


def unet_calls(scfg, num_frames):
    """UNet calls of one ``generate_latents``: per denoise step, the
    windows in groups of ``windows_per_call``."""
    from actalker_tpu_torch.pipeline.sampler import make_plan

    plan = make_plan(scfg, num_frames)
    n_win = plan.window_idx.shape[1]
    return len(plan.timesteps) * -(-n_win // (scfg.windows_per_call or n_win))


def forward_launches(unet):
    """Launches of K1-K4 in one UNet forward, derived from the model: one K1
    per SS2DCondV10, one K2 per spatial block's self-attention, one K3 per
    temporal self-attention, two K4 per GEGLU feed-forward."""
    from actalker_tpu_torch.models import attention_blocks as ab
    from actalker_tpu_torch.models.ssm import SS2DCondV10

    mods = list(unet.modules())

    def n(kind):
        return sum(isinstance(m, kind) for m in mods)

    return {"ssm_scan_grouped": n(SS2DCondV10), "mha": n(ab.BasicTransformerBlock),
            "frame_attention": n(ab._FrameSelfAttention),
            "geglu_mlp": 2 * n(ab.FeedForward)}


@contextlib.contextmanager
def k1_rows():
    """Record the rows (L) of every K1 call the SSM blocks make."""
    from actalker_tpu_torch.models import ssm

    seen, real = [], ssm.ssm_scan_grouped

    def spy(u_g, *args):
        seen.append(u_g.shape[0])
        return real(u_g, *args)

    ssm.ssm_scan_grouped = spy
    try:
        yield seen
    finally:
        ssm.ssm_scan_grouped = real


def write_cli_inputs(out):
    """The CLI's inputs under ``out``: 1.2 s of 16 kHz speech-band tones
    (stdlib wave, read by load_audio's scipy branch where libav is absent)
    and a seeded 512 px portrait. Returns (wav, png) paths."""
    import wave

    import numpy as np
    from PIL import Image

    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(9)
    t = np.arange(int(1.2 * 16000)) / 16000
    tone = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.3, 180), (0.2, 720), (0.1, 2400)))
    wav = os.path.join(out, "speech.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((tone * 32767 * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)))
                      .astype(np.int16).tobytes())
    ref = os.path.join(out, "portrait.png")
    Image.fromarray((rng.random((PX, PX, 3)) * 255).astype(np.uint8)).save(ref)
    return wav, ref


def phase9(torch, dev, kernels, card):
    """The inference CLI at full width (modes 0 and 2), C9 (the mode-0
    window-step with the SSM gather and masked-dense) and C7 (the 576 px /
    25-frame window-step, default and fused-norm). Returns the CLI runs'
    launch counts."""
    import argparse
    import dataclasses

    import numpy as np

    from actalker_tpu_torch import cli
    from actalker_tpu_torch.frontend import video as V
    from actalker_tpu_torch.models.conditioning import Conditioning
    from actalker_tpu_torch.pipeline.sampler import SamplerConfig

    out = os.path.join(OUT, "cli")
    wav, ref = write_cli_inputs(out)
    cfg = dataclasses.replace(
        cli.load_config(os.path.join(ROOT, "configs", "inference.yaml")),
        image_size=PX, n_sample_frames=FRAMES, num_inference_steps=STEPS,
        decode_chunk_size=FRAMES, seed=0, output_dir=out, exp_name="cli",
        arcface_checkpoint_path="")
    pipes = {}

    def run_cli(mode):
        args = argparse.Namespace(config="configs/inference.yaml", ref=ref,
                                  audio=wav, video=None, mode=mode, batch=False,
                                  random_weights=True, frame_limit=2 * FRAMES,
                                  device="cuda")
        gate = cli.MODE_GATES[mode]
        cli.generate_frames(cfg, args, gate, pipes, detector=lambda im: CLI_BOX)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        with k1_rows() as rows:
            res = cli.generate_frames(cfg, args, gate, pipes,
                                      detector=lambda im: CLI_BOX)
        counts = {n: k.launches for n, k in kernels.items()}
        return args, res, counts, sorted(set(rows))

    cli_counts = {n: 0 for n in kernels}
    mode0 = None
    for mode in (0, 2):
        args, res, counts, rows = run_cli(mode)
        pipe = res["pipe"]
        calls = unet_calls(cfg.sampler_config(cli.MODE_GATES[mode]), res["num_frames"])
        per = forward_launches(pipe.m.unet)
        want = {n: per.get(n, 0) * calls for n in kernels}
        caps = pipe._capacity_fracs(cfg.sampler_config(cli.MODE_GATES[mode]),
                                    res["masks"]["audio_mask"], res["masks"]["exp_mask"],
                                    (PX // 8, PX // 8))
        # K1's rows: the gather's max(K + 33 tail, 2-row tail of the gated-off
        # branch) at res-64 / -32 / -16; masked-dense L + 33
        want_rows = sorted(
            max(gathered_rows(l, caps[0]) + 33, gathered_rows(l, caps[1]) + 2)
            if caps else l + 33
            for l in ((PX // 8 // st) ** 2 for st in pipe.ssm_strides()))
        frames = res["frames01"]
        sec = {k: round(v, 4) for k, v in res["seconds"].items()}
        if V.have_encoder():
            path = cli.write_outputs(cfg, args, res)
            sec["write"] = round(res["seconds"]["write"], 4)
            wrote = f"wrote {os.path.relpath(path, ROOT)}"
        else:
            wrote = "no mp4 written"
        print(f"[9 cli] mode {mode}, full width, {PX} px, {res['num_frames']} frames, "
              f"{STEPS} steps, random weights: stages (s) {sec} | "
              f"capacity {caps} | K1 rows {rows} (derived {want_rows}) | launches "
              f"{counts} (derived {want}: {calls} UNet calls) | {wrote} | {card}",
              flush=True)
        if not V.have_encoder():
            print("[9 cli] no video encoder on this machine: "
                  "runtime/libactalker_media.so does not load (its libav "
                  "libraries are absent) and there is no ffmpeg binary, so the "
                  "CLI stops at the decoded frames; the write stage is not "
                  "measured here", flush=True)
        if frames.shape != (res["num_frames"], PX, PX, 3) or not np.isfinite(frames).all():
            raise RuntimeError(f"CLI mode {mode} frames {frames.shape} not finite / "
                               "wrong shape")
        if counts != want:
            raise RuntimeError(f"CLI mode {mode} launches {counts} != derived {want}")
        if rows != want_rows or (mode == 0) != (caps is not None):
            raise RuntimeError(f"CLI mode {mode}: K1 rows {rows} != {want_rows} "
                               f"(capacity {caps})")
        if mode == 0 and caps != (C9_CAPACITY, 0.0):
            raise RuntimeError(f"C9 box gives capacity {caps}, not {C9_CAPACITY}")
        for n in kernels:
            cli_counts[n] += counts[n]
        if mode == 0:
            mode0 = res
    pipe = mode0["pipe"]

    # ---- C9: the mode-0 window-step, gather vs masked-dense ----
    scfg = SamplerConfig(num_inference_steps=STEPS, frames_per_batch=FRAMES,
                         windows_per_call=1, gate=(1, 0))
    calls = unet_calls(scfg, FRAMES)
    mask = mode0["masks"]["audio_mask"]
    gen_args = (mode0["pre"].ref_img, mode0["id_embed"], *mode0["tokens"],
                mode0["pose_imgs"], scfg)

    def window_steps(gather):
        pipe.gather = gather
        try:
            pipe.generate_latents(*gen_args, seed=0, audio_mask=mask)  # warm-up
            torch.cuda.synchronize()
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            lat = pipe.generate_latents(*gen_args, seed=0, audio_mask=mask)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / calls, lat, \
                kernels["ssm_scan_grouped"].launches
        finally:
            pipe.gather = True

    unet = pipe.m.unet
    g9 = torch.Generator(device=dev).manual_seed(9)

    def rn(*shape):
        return torch.randn(*shape, generator=g9, device=dev)

    def forward_inputs(b, f, hw, audio_mask, exp_mask, gate_v):
        """One window-step's UNet inputs (b = 4 CFG, f frames), seeded;
        ``gate_v`` 0 zeroes the expression tokens (mode 0)."""
        cond = Conditioning(rn(b * f, 1, 1024).bfloat16(), rn(b * f, 32, 1024).bfloat16(),
                            (rn(b * f, 1, 1024) * gate_v).bfloat16(), audio_mask, exp_mask)
        return (rn(b, f, hw, hw, 8).bfloat16(), torch.tensor(0.5, device=dev), cond,
                rn(b, 3).bfloat16(),
                (rn(b, f, hw, hw, unet.config.block_out_channels[0]) * 0.1).bfloat16())

    def forward_check(args, caps):
        """The UNet forward on ``args`` with the SSM capacity ``caps``,
        through the kernels and the plain versions: (output, rel L2)."""
        saved = unet.config.mask_capacity
        unet.set_mask_capacity(caps)
        try:
            with torch.no_grad():
                y_k = unet(*args)
                with plain_ops():
                    y_p = unet(*args)
        finally:
            unet.set_mask_capacity(saved)
        torch.cuda.synchronize()
        return y_k, errors(y_k, y_p)[1]

    c9 = {}
    fwd9 = forward_inputs(4, FRAMES, PX // 8, torch.from_numpy(mask).to(dev),
                          torch.zeros(1, 1, PX, PX, device=dev), 0.0)
    for name, gather in (("gather", True), ("masked-dense", False)):
        sec, lat, k1 = window_steps(gather)
        y, rel = forward_check(fwd9, (C9_CAPACITY, 0.0) if gather else None)
        c9[name] = (sec, lat, k1, y, rel)
        print(f"[9 C9] mode 0, face box 31.2% of the image, {name}: seconds per "
              f"window-step {sec:.4f} s ({calls} UNet calls of 4 CFG x {FRAMES} f x "
              f"{PX // 8}x{PX // 8}) | K1 launches {k1} (derived "
              f"{forward_launches(unet)['ssm_scan_grouped'] * calls}) | one forward, "
              f"kernels vs plain rel_l2 {rel:.3g} (tol {UNET_TOL}) | {card}", flush=True)
        if k1 != forward_launches(unet)["ssm_scan_grouped"] * calls \
                or rel > UNET_TOL or not torch.isfinite(lat).all():
            raise RuntimeError(f"C9 {name}: K1 launches {k1}, rel_l2 {rel}")
    rel_lat = errors(c9["gather"][1], c9["masked-dense"][1])[1]
    rel_fwd = errors(c9["gather"][3], c9["masked-dense"][3])[1]
    print(f"[9 C9] gather vs masked-dense: window-step {c9['gather'][0]:.4f} s vs "
          f"{c9['masked-dense'][0]:.4f} s ({c9['masked-dense'][0] / c9['gather'][0]:.3f}x) "
          f"| latents rel_l2 {rel_lat:.3g}, one forward rel_l2 {rel_fwd:.3g} "
          f"(tol {UNET_TOL}) | {card}", flush=True)
    if rel_fwd > UNET_TOL or rel_lat > UNET_TOL:
        raise RuntimeError("the gather disagrees with the masked-dense scan")
    del c9, gen_args, mode0, fwd9
    torch.cuda.empty_cache()

    # ---- C7: the 576 px / 25-frame window-step (S = 5184) ----
    scfg7 = SamplerConfig(num_inference_steps=STEPS, frames_per_batch=C7_FRAMES,
                          windows_per_call=1, gate=(1, 1))
    calls7 = unet_calls(scfg7, C7_FRAMES)
    r7 = np.random.default_rng(7)
    ins7 = (r7.standard_normal((C7_PX, C7_PX, 3)).astype(np.float32) * 0.2,
            r7.standard_normal(512).astype(np.float32),
            r7.standard_normal((C7_FRAMES, 32, 1024)).astype(np.float32),
            np.zeros((C7_FRAMES, 32, 1024), np.float32),
            r7.standard_normal((C7_FRAMES, 1, 1024)).astype(np.float32),
            np.zeros((C7_FRAMES, 1, 1024), np.float32),
            r7.random((C7_FRAMES, C7_PX, C7_PX, 3)).astype(np.float32), scfg7)
    ones7 = torch.ones(1, 1, C7_PX, C7_PX, device=dev)
    hw7 = C7_PX // 8
    fwd7 = forward_inputs(4, C7_FRAMES, hw7, ones7, ones7, 1.0)
    for label, ctx in (("default", contextlib.nullcontext), ("fused-norm", fused_norm_config)):
        with ctx():
            pipe.generate_latents(*ins7, seed=0)                     # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            lat = pipe.generate_latents(*ins7, seed=0)
            torch.cuda.synchronize()
            sec = (time.perf_counter() - t0) / calls7
            counts = {n: k.launches for n, k in kernels.items()}
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            _, rel = forward_check(fwd7, None)
        per = forward_launches(unet)
        want = {n: per.get(n, 0) * calls7 for n in kernels}
        if label != "default":
            parts = ((calls7, fused_launches(unet)), (2, fused_launches(pipe.m.vae.encoder)),
                     (1, fused_launches(pipe.m.id_proj, pipe.m.pose_guider)))
            for n in FUSED_KERNELS:
                want[n] = sum(c * p[n] for c, p in parts)
        print(f"[9 C7] {C7_PX} px / {C7_FRAMES} frames, {label}: seconds per "
              f"window-step {sec:.4f} s ({calls7} UNet calls of 4 CFG x {C7_FRAMES} f x "
              f"{hw7}x{hw7}, S = {hw7 * hw7}) | peak max_memory_allocated "
              f"{peak:.2f} GiB | latents finite {bool(torch.isfinite(lat).all())} | one "
              f"forward, kernels vs plain rel_l2 {rel:.3g} (tol {UNET_TOL}) | launches "
              f"{counts} (derived {want}) | {card}", flush=True)
        if not torch.isfinite(lat).all() or rel > UNET_TOL:
            raise RuntimeError(f"C7 {label}: latents not finite or rel_l2 {rel}")
        if counts != want:
            raise RuntimeError(f"C7 {label}: launches {counts} != derived {want}")
    del pipe, pipes, unet, lat, fwd7
    torch.cuda.empty_cache()
    shutil.rmtree(OUT, ignore_errors=True)
    return cli_counts


def face_networks():
    """The CLI's six networks at their published widths: name -> (config
    key of its checkpoint, the module's constructor, its loader, seeded
    inputs at its published size)."""
    import numpy as np

    from actalker_tpu_torch.frontend.landmarks import face6_config
    from actalker_tpu_torch.io import init as I
    from actalker_tpu_torch.models import rife, rtmpose, scrfd, stylegan2, teeth, yoloface

    r = np.random.default_rng(10)

    def img(side, lo=0.0, hi=1.0):
        return r.uniform(lo, hi, (1, side, side, 3)).astype(np.float32)

    return {
        "yolov5m-face": ("det_checkpoint_path", yoloface.YoloFaceNet,
                         I.load_yoloface, (img(416),)),
        "scrfd-10g-bnkps": ("scrfd_checkpoint_path", scrfd.ScrfdNet,
                            I.load_scrfd, (img(640, -1.0),)),
        "rtmpose-m-face6": ("face_landmark_checkpoint_path",
                            lambda: rtmpose.RTMPoseNet(face6_config()),
                            I.load_face_landmarker,
                            (r.standard_normal((1, 256, 256, 3)).astype(np.float32),)),
        "gpen-512": ("bfr_checkpoint_path", stylegan2.GPENGenerator, I.load_bfr,
                     (img(512, -1.0),)),
        "teeth": ("teeth_checkpoint_path", teeth.TeethEnhancer, I.load_teeth,
                  (img(512, -1.0),)),
        "ifnet-c90": ("rife_checkpoint_path", rife.IFNet, I.load_rife,
                      (img(512), img(512))),
    }


def flat_output(torch, y):
    """A network's output(s) as one fp32 CPU vector."""
    if isinstance(y, (tuple, list)):
        return torch.cat([flat_output(torch, t) for t in y])
    return y.detach().float().cpu().flatten()


def phase10(torch, dev, kernels, card):
    """The CLI's full path: the six networks seeded at their published
    widths and saved as the reference's files, then ``generate_frames`` in
    mode 2 at full UNet width with every pass on (learned detector,
    landmarks, reference-image BFR, teeth, frame BFR, RIFE), once to warm
    up and once counted; SCRFD alone; each network on the card against the
    CPU. Returns the counted run's launches."""
    import argparse
    import dataclasses

    import numpy as np

    from actalker_tpu_torch import cli
    from actalker_tpu_torch.frontend.preprocess import read_image

    out = os.path.join(OUT, "face")
    wav, ref = write_cli_inputs(out)
    nets = face_networks()
    paths, cpu_nets = {}, {}
    for i, (name, (key, build, _, _)) in enumerate(nets.items()):
        torch.manual_seed(100 + i)
        cpu_nets[name] = build().eval()
        paths[key] = os.path.join(out, f"{name}.pth")
        torch.save(cpu_nets[name].state_dict(), paths[key])
    base = cli.load_config(os.path.join(ROOT, "configs", "inference.yaml"))
    cfg = dataclasses.replace(
        base, image_size=PX, n_sample_frames=FRAMES, num_inference_steps=STEPS,
        decode_chunk_size=FRAMES, seed=0, output_dir=out, exp_name="cli",
        arcface_checkpoint_path="", use_bfr=True, use_teeth_enhance=True,
        use_interframe=True, extras={**base.extras, "use_bfr_frames": True}, **paths)
    args = argparse.Namespace(config="configs/inference.yaml", ref=ref, audio=wav,
                              video=None, mode=2, batch=False, random_weights=True,
                              frame_limit=2 * FRAMES, device="cuda")
    gate, pipes = cli.MODE_GATES[2], {}
    cli.generate_frames(cfg, args, gate, pipes)                       # warm-up
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    res = cli.generate_frames(cfg, args, gate, pipes)
    counts = {n: k.launches for n, k in kernels.items()}
    calls = unet_calls(cfg.sampler_config(gate), res["num_frames"])
    per = forward_launches(res["pipe"].m.unet)
    want = {n: per.get(n, 0) * calls for n in kernels}
    frames = res["frames01"]
    sec = {k: round(v, 4) for k, v in res["seconds"].items()}
    print(f"[10 cli] mode 2, every pass on (yolov5m-face, RTMPose-m face6, GPEN-512 "
          f"on the reference and the frames, teeth, RIFE c = 90), full width, {PX} px, "
          f"{res['num_frames']} frames -> {frames.shape[0]}, {STEPS} steps, random "
          f"weights: stages (s) {sec} | total {sum(res['seconds'].values()):.4f} s | "
          f"launches {counts} (derived {want}: {calls} UNet calls) | {card}", flush=True)
    n_out = 2 * res["num_frames"] - 1
    if frames.shape != (n_out, PX, PX, 3) or not np.isfinite(frames).all() \
            or frames.min() < 0 or frames.max() > 1:
        raise RuntimeError(f"CLI with every pass: frames {frames.shape} not "
                           f"({n_out}, {PX}, {PX}, 3), finite, in [0, 1]")
    missing = {"detect", "landmarks", "bfr_ref", "teeth", "bfr_frames", "rife"} - set(sec)
    if missing or counts != want:
        raise RuntimeError(f"CLI with every pass: stages {missing} missing or "
                           f"launches {counts} != derived {want}")
    del res, pipes
    torch.cuda.empty_cache()

    # SCRFD alone (the CLI takes yolov5-face first)
    det = cli.resolve_face_detector("", paths["scrfd_checkpoint_path"], dev)
    portrait = read_image(ref)
    det.detect(portrait[..., ::-1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bboxes, kpss, scores = det.detect(portrait[..., ::-1])
    print(f"[10 scrfd] SCRFD-10G-bnkps alone on the {PX} px portrait (640 x 640 "
          f"letterbox): {len(bboxes)} faces, kps {kpss.shape}, "
          f"{time.perf_counter() - t0:.4f} s | {card}", flush=True)
    if bboxes.shape[1:] != (4,) or kpss.shape[1:] != (5, 2) or scores.shape != bboxes.shape[:1]:
        raise RuntimeError("SCRFD's detect gave malformed arrays")

    # each network: the card (loaded from its file) against the CPU module
    for name, (key, _, loader, inputs) in nets.items():
        card_net = loader(paths[key], dev)
        with torch.no_grad():
            y_card = flat_output(torch, card_net(*(torch.from_numpy(x).to(dev) for x in inputs)))
            y_cpu = flat_output(torch, cpu_nets[name](*(torch.from_numpy(x) for x in inputs)))
        rel = float((y_card - y_cpu).norm() / y_cpu.norm())
        print(f"[10 net] {name}: card vs CPU rel_l2 {rel:.3g} (tol {FACE_NET_TOL}) "
              f"over {y_cpu.numel()} outputs | {card}", flush=True)
        if not (rel <= FACE_NET_TOL and torch.isfinite(y_card).all()):
            raise RuntimeError(f"{name}: card vs CPU rel_l2 {rel}")
        del card_net
    del cpu_nets
    torch.cuda.empty_cache()
    shutil.rmtree(OUT, ignore_errors=True)
    return counts


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
    from actalker_tpu_torch.ops import (
        _build, mha, mlp, norms, resconv, selective_scan as ss)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {k.name: k for k in (ss.KERNEL, ss.ARRANGED_KERNEL,
                                   mha.MHA_KERNEL, mha.FRAME_KERNEL, mlp.KERNEL,
                                   ss.BWD_KERNEL, mha.MHA_BWD_KERNEL,
                                   norms.LN_KERNEL, norms.GN_KERNEL,
                                   resconv.KERNEL)}

    t0 = time.perf_counter()
    _build.build_all(kernels.values())
    print(f"[2 build] {', '.join(f'{n} {k.build_seconds:.1f}s' for n, k in kernels.items())}"
          f" | total {time.perf_counter() - t0:.1f}s (in parallel)", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for name, label, kern, plain, lib, (bound_ms, bound_by), *rest in \
            kernel_cases(torch, dev, gen):
        extras = rest[0] if rest else {}
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        mx, rel = errors(out, ref)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        ok = all(bool(torch.isfinite(x.float()).all()) for x in outs) \
            and rel <= TOL[name]
        kern_t, plain_t = extras.get("timing", (kern, plain))
        ms = timed(torch, kern_t, 10)
        plain_ms = timed(torch, plain_t, 3)
        lib_ms = timed(torch, lib, 10) if lib is not None else None
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        more = "".join(f" {what} {timed(torch, extras[key], 10):.4f} ms"
                       for key, what in (("alone", "launch alone"),
                                         ("chain", "library chain"))
                       if key in extras)
        if "floor" in extras:
            more += f" exp floor {extras['floor']:.4f} ms"
        print(f"[3 kernel] {name} {label}: max_abs {mx:.4g} rel_l2 {rel:.3g} "
              f"(tol {TOL[name]}) | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"library {lib_txt}{more} bound {bound_ms:.4f} ms ({bound_by}) "
              f"| {card}", flush=True)
        if not ok:
            raise RuntimeError(f"{name} {label} disagrees with its plain version")
        r = results.setdefault(name, {
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
        r["max_abs_err"] = max(r["max_abs_err"], mx)
        del out, ref, outs
    # the last case's closures hold its inputs (the VAE-sized K8 case: ~2
    # GiB), which would otherwise count in the later phases' peaks
    del kern, plain, lib, rest, extras, kern_t, plain_t
    torch.cuda.empty_cache()

    # K8's stage knock-outs (the bisect tool's check and timing)
    from actalker_tpu_torch.tools import resconv_bisect

    bisect = resconv_bisect.check_variants(gen)
    bisect_ms = resconv_bisect.time_variants(gen)
    for r in bisect:
        r.update(bisect_ms[r["variant"]])
        print(f"[3 bisect] {r['variant']} {resconv_bisect.CHECK_SHAPE}: max_abs "
              f"{r['max_abs_err']:.4g} rel_l2 {r['rel_l2']:.3g} (tol "
              f"{resconv_bisect.TOL}) | {r['ms']:.4f} ms plain "
              f"{r['plain_ms']:.4f} ms at {resconv_bisect.TIME_SHAPE} | {card}",
              flush=True)
    if not all(r["ok"] for r in bisect):
        raise RuntimeError("a bisect variant of K8 disagrees with its plain version")
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

    # ---- 4b: the same forward under the fused-norm configuration ----
    with torch.no_grad(), fused_norm_config():
        for k in kernels.values():
            k.launches = 0
        y_fk = unet(*args)
        fwd_counts = {n: kernels[n].launches for n in FUSED_KERNELS}
        with plain_ops():
            y_fp = unet(*args)
    torch.cuda.synchronize()
    mx, rel = errors(y_fk, y_fp)
    want = fused_launches(unet)
    print(f"[4b unet] ACTALKER_NORM=fused ACTALKER_RESCONV=pallas, same forward: "
          f"kernels vs plain max_abs {mx:.4g} rel_l2 {rel:.3g} (tol {UNET_TOL}) "
          f"| vs the default configuration rel_l2 {errors(y_fk, y_k)[1]:.3g} | "
          f"launches {fwd_counts} (derived {want}) | {card}", flush=True)
    if not (torch.isfinite(y_fk.float()).all() and rel <= UNET_TOL):
        raise RuntimeError("UNet through K7 / K8 disagrees with the plain path")
    if fwd_counts != want:
        raise RuntimeError(f"fused forward launches {fwd_counts} != {want}")
    del unet, y_k, y_p, y_fk, y_fp, args, cond
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
    per_forward = forward_launches(mods.unet)
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

    # ---- 5b: the same clip under the fused-norm configuration ----
    with fused_norm_config():
        clip()                               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        frames_f, gen_s, clip_s = clip()
        counts = {n: k.launches for n, k in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # derived from the model: per UNet call, per VAE encode (the reference
    # image and its noise-augmented copy), per decode chunk, and the heads
    # generate_latents runs once (id_proj, pose_guider)
    encodes, decodes = 2, -(-FRAMES // FRAMES)
    parts = ((unet_calls, fused_launches(mods.unet)),
             (encodes, fused_launches(mods.vae.encoder)),
             (decodes, fused_launches(mods.vae.decoder)),
             (1, fused_launches(mods.id_proj, mods.pose_guider)))
    want = {n: per_forward.get(n, 0) * unet_calls for n in kernels}
    for n in FUSED_KERNELS:
        want[n] = sum(calls * per[n] for calls, per in parts)
    print(f"[5b fused] ACTALKER_NORM=fused ACTALKER_RESCONV=pallas: launches "
          f"{counts} (derived {want}: per UNet call "
          f"{ {n: parts[0][1][n] for n in FUSED_KERNELS} }, per encode "
          f"{parts[1][1]}, per decode {parts[2][1]}, heads {parts[3][1]}) | "
          f"{card}", flush=True)
    print(f"[5b fused] seconds per window-step {gen_s / unet_calls:.4f} s | "
          f"generate_latents {gen_s:.3f} s | clip (generate + decode) "
          f"{clip_s:.3f} s | peak max_memory_allocated {peak_gib:.2f} GiB | "
          f"frames vs the default configuration rel_l2 "
          f"{errors(torch.from_numpy(frames_f), torch.from_numpy(frames))[1]:.3g}"
          f" | {card}", flush=True)
    if frames_f.shape != (FRAMES, PX, PX, 3) or not np.isfinite(frames_f).all():
        raise RuntimeError(f"fused clip output {frames_f.shape} not finite / "
                           "wrong shape")
    if counts != want:
        raise RuntimeError(f"fused clip launches {counts} != derived {want}")
    fused_counts = counts
    del mods, pipe, frames, frames_f
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
    if any(grad_counts[n] == 0 for n in DEFAULT_KERNELS):
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
              "geglu_mlp": 2 * 96, "ssm_scan_bwd": 15 * 4, "mha_bwd": 16,
              "ssm_scan": 0, **{n: 0 for n in FUSED_KERNELS}}
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

    # ---- 8: the SS2D lineage, kernels (K5, K6) vs plain versions ----
    from actalker_tpu_torch.io.init import lineage_init_
    from actalker_tpu_torch.models import ssm_spatial as sp

    def lineage_module(make, seed, bf16):
        with torch.device("meta"):
            m = make()
        m = lineage_init_(m, seed=seed, device=dev)
        return (cast_params_bf16_(m) if bf16 else m).eval()

    g8 = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=g8, device=dev)  # noqa: E731
    # the UNet's res-64 control block (d_model 320) at the clip's 4 CFG x 14
    # frames; its tail as v10's: one identity token, 32 audio tokens, one
    # expression token; the face box as phase 6's (25% of the tokens)
    x = rn(56, 4096, 320).bfloat16()
    id_emb, audio, expr = (rn(56, s, 1024).bfloat16() for s in (1, 32, 1))
    face = torch.zeros(1, 1, 512, 512, device=dev)
    face[..., 128:384, 128:384] = 1.0
    v9_args = (x, id_emb, audio, expr, face, face)
    cond = torch.cat([id_emb, audio], dim=1)       # V5 / V6: L = 4096 + 33
    cases = (
        ("SS2DCondV9(320) bf16 (56, 4096, 320), face-box masks",
         lambda: sp.SS2DCondV9(320), True, v9_args),
        ("SS2DCondV5(320) bf16 (56, 4096, 320) + 33 cond tokens",
         lambda: sp.SS2DCondV5(320), True, (x, cond)),
        ("SS2DCondV6(320) bf16 (56, 4096, 320) + 33 cond tokens",
         lambda: sp.SS2DCondV6(320), True, (x, cond)),
        ("MambaUPNet() dims (512, 256, 128, 64) depths (3, 4, 6, 3) fp32 "
         "(8, 8, 8, 512)", sp.MambaUPNet, False, (rn(8, 8, 8, 512),)),
    )
    lineage_counts = {n: 0 for n in kernels}
    for seed, (label, make, bf16, args) in enumerate(cases):
        mod = lineage_module(make, seed, bf16)
        with torch.no_grad():
            for k in kernels.values():
                k.launches = 0
            y_k = mod(*args)
            counts = {n: k.launches for n, k in kernels.items()}
            with plain_ops():
                y_p = mod(*args)
            ms = timed(torch, lambda: mod(*args), 3)
        torch.cuda.synchronize()
        mx, rel = errors(y_k, y_p)
        tol = LINEAGE_TOL["bfloat16" if bf16 else "float32"]
        want = {n: 0 for n in kernels}
        want["ssm_scan"] = lineage_launches(mod)
        outs = y_k if isinstance(y_k, list) else [y_k]
        print(f"[8 lineage] {label}: kernels vs plain max_abs {mx:.4g} rel_l2 "
              f"{rel:.3g} (tol {tol}) | {ms:.4f} ms per forward | outputs "
              f"{[tuple(o.shape) for o in outs]} | launches {counts['ssm_scan']} "
              f"K5 (derived {want['ssm_scan']}) | {card}", flush=True)
        if not (all(torch.isfinite(o.float()).all() for o in outs) and rel <= tol):
            raise RuntimeError(f"{label} through K5 disagrees with the plain path")
        if counts != want:
            raise RuntimeError(f"{label}: launches {counts} != derived {want}")
        for n in kernels:
            lineage_counts[n] += counts[n]
        del mod, y_k, y_p, outs
    torch.cuda.empty_cache()

    # one V9 loss backward (fp32 masters, bf16 compute, as in training)
    v9 = lineage_module(cases[0][1], 0, False)
    named = list(v9.named_parameters())
    cot = rn(56, 4096, 320)

    def v9_grads():
        v9.zero_grad(set_to_none=True)
        loss = (v9(*v9_args).float() * cot).sum()
        loss.backward()
        by_group = {g: torch.cat([p.grad.flatten() for n, p in named
                                  if re.search(pat, n)])
                    for g, (pat, _) in LINEAGE_GRAD_GROUPS.items()}
        v9.zero_grad(set_to_none=True)
        return loss.item(), by_group

    for k in kernels.values():
        k.launches = 0
    loss_k, gg_k = v9_grads()
    counts = {n: k.launches for n, k in kernels.items()}
    with plain_ops(), plain_adjoint():
        loss_p, gg_p = v9_grads()
    torch.cuda.synchronize()
    rel_g = {g: errors(gg_k[g], gg_p[g])[1] for g in LINEAGE_GRAD_GROUPS}
    want = {n: 0 for n in kernels}
    want["ssm_scan"] = want["ssm_scan_bwd"] = lineage_launches(v9)
    print(f"[8 lineage] SS2DCondV9 loss backward, fp32 masters: loss kernels "
          f"{loss_k:.6g} plain {loss_p:.6g} | by group (tol) "
          f"{ {g: f'{r:.3g} ({LINEAGE_GRAD_GROUPS[g][1]})' for g, r in rel_g.items()} }"
          f" | launches K5 {counts['ssm_scan']} K6 {counts['ssm_scan_bwd']} "
          f"(derived {want['ssm_scan']} each) | {card}", flush=True)
    if not (all(torch.isfinite(gg_k[g]).all() and rel_g[g] <= LINEAGE_GRAD_GROUPS[g][1]
                for g in LINEAGE_GRAD_GROUPS)
            and abs(loss_k - loss_p) <= LINEAGE_TOL["bfloat16"] * abs(loss_p)):
        raise RuntimeError("V9 gradients through K5 / K6 disagree with the plain path")
    if counts != want:
        raise RuntimeError(f"V9 backward launches {counts} != derived {want}")
    for n in kernels:
        lineage_counts[n] += counts[n]
    del v9, named, gg_k, gg_p, x, cond, v9_args, cot

    # ---- 9: the inference CLI, C9 and C7 ----
    cli_counts = phase9(torch, dev, kernels, card)

    # ---- 10: the CLI's full path (face stack and post-passes) ----
    full_counts = phase10(torch, dev, kernels, card)

    launches = {n: (train_counts[n] if n in ("ssm_scan_bwd", "mha_bwd")
                    else lineage_counts[n] if n == "ssm_scan"
                    else fused_counts[n] if n in FUSED_KERNELS
                    else clip_counts[n]) for n in kernels}
    # every variant runs K8's GEMM at K8's first phase-3 shape (the tool's):
    # K8's bound and library conv there stand for each
    k8 = results["gn_silu_conv3x3"]
    print(json.dumps({"bisect": [{
        "name": f"gn_silu_conv3x3 {r['variant']}", "route": "cuda",
        "source": os.path.relpath(resconv.KERNEL.source, ROOT),
        "replaces": "tools/micro_resconv_bisect.py:79", "launches": 0,
        "shape": list(resconv_bisect.TIME_SHAPE), "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": k8["bound_ms"],
        "bound_by": k8["bound_by"], "library_ms": k8["library_ms"],
        "check_shape": list(resconv_bisect.CHECK_SHAPE),
        "max_abs_err": r["max_abs_err"], "rel_l2": r["rel_l2"]} for r in bisect]}))
    print(json.dumps({"kernels": [{
        "name": n, "route": "cuda",
        "source": os.path.relpath(k.source, ROOT),
        "replaces": k.replaces, "launches": launches[n],
        "launches_by_path": {"clip": clip_counts[n],
                             "clip_fused": fused_counts[n],
                             "train": train_counts[n],
                             "lineage": lineage_counts[n],
                             "cli": cli_counts[n],
                             "cli_full": full_counts[n]},
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
