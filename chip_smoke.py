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
     at the gather's compacted lengths, K4 at the 576 px cell's four
     feed-forwards, K7-LN at the audio encoder's
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
     launch counts of that run must match the UNet calls it made, K8 must
     not launch, and K7-LN / K7-GN (the default lowering's variant) must
     launch once per LayerNormF32 / GroupNorm32 of each module run whose
     width K7 takes, the others running plain ("norm.plain"); every later
     phase that counts launches derives these too (``norm_launches``: a
     training micro-step's checkpointed blocks twice, the batch builder's
     encoders and the heads once);
     5b. the same clip under the fused-norm configuration, timed the same
     way; the launches of all seven forward kernels must equal the counts
     derived from the model (UNet calls, VAE encodes and decodes, heads);
  6. gradients: a full-width UNet with block checkpointing (fp32 master
     weights, bf16 compute) on a small latent, loss and every parameter
     gradient through the kernels and through the plain versions, K7's
     launches in forward and recompute as derived;
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
     frames, 3 steps, seeded weights, on a written WAV and portrait and a
     written 28-frame driving mp4 (decoded by ``frontend/video.read_frames``:
     OpenCV where the libav runtime does not load): mode 0 with a fixed
     face box (the SSM gather of the audio branch: K1's rows must be the
     derived budgets), mode 1 driven by the video (the gather of the
     expression branch, budget (0, 0.375)) and mode 2 driven by it, each
     run once to warm up and once counted, stage times printed; in modes 1
     and 2 the expression tokens non-zero and finite, and the VASA towers
     on the video's crops on the card against the same towers in fp32 on
     the CPU; then C9, the mode-0 and mode-1 window-steps with the gather
     and with the masked-dense scan (``gather=False``), and C7, the 576 px /
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
     (fp32, loaded from its file) against the same module on the CPU;
 11. batched serving and training on real data: C4, four identities (each
     its own tokens, face-box masks and generator; mode 2, 512 px, 14
     frames, 3 steps, windows one a call, full width, bf16) through
     ``ACTalkerPipeline.generate_latents_batch`` (one
     ``pipeline/serving.sample_video_batch`` loop under one SSM budget)
     against the same four through it one at a time, each under its own
     budget (seconds, peak memory, K1-K4 launches and K1's gathered rows
     derived from the model, identity 2 of the batch against itself
     alone); then a seeded corpus (four clips of 64 frames at 512 px as
     ``.npy`` stacks, a WAV each, boxes and 68-point landmarks, a seeded
     ArcFace file); C8, the loader's samples/s at 0 and 2 worker
     processes on a still scene (one
     pass of the dataset a sample), the dataset alone and with the batch
     builder, no worker initializing CUDA, then in process on a drifting
     scene with its resamples a sample; C2, ``training.train.main --metadata`` at the configs/train.yaml
     operating point with 2 workers for 4 micro-steps: seconds, loader wait
     and encoder time per micro-step, launches per micro-step derived from
     the model, the first batch's loss through the kernels against the
     plain versions; then one micro-step on the first clip written as an
     mp4 and read by the default ``VideoFrameReader`` (decode seconds);
 12. data parallelism over NCCL at world 1 (torchrun's environment set by
     the script): ``training.train.main --synthetic 4 --dp 1`` through
     ``parallel.distributed.init_distributed`` at phase 7's operating
     point, so the ZeRO-2 optimizer takes the first commit: losses and
     parameters after it against phase 7's (the non-distributed trainer on
     the same seeds and batches), launches per micro-step derived from the
     model, seconds and peak memory beside phase 7's, ``per_rank_bytes``
     at world 1 / 4 / 8; then two identities through the rank-split
     ``generate_latents_batch`` (one step, the phase-5 cut) against the
     same call without a group;
 13. evaluation: the six networks (SyncNet, S3FD, FID InceptionV3, I3D,
     SENet-50, LPIPS-Alex) seeded at their published widths and saved as
     the reference's files, each loaded on the card and on the CPU and run
     on the same inputs (rel L2, ms a call); ``run_eval.main --npy --device
     cuda`` over two generated / reference pairs of 27 frames at 512 px as
     ``.npy`` stacks with WAVs, twice; ``run_eval.run`` over one pair as
     mp4s through the default ``VideoClipReader`` (decode seconds); each
     metric's seconds on one clip;
     ``SyncEvaluator.evaluate_tube`` on a seeded 30-frame tube, card
     against CPU;
 14. DWPose, the data tools, pre-encoded batches, windows over ranks and
     tensor parallelism: YOLOX-L and RTMPose-l (133 keypoints) seeded at
     their published widths, saved as the reference's files, loaded on the
     card and the CPU (rel L2, ms a call); ``Wholebody`` on a 512 px and a
     1280 x 720 frame (seconds a frame, boxes and keypoints card vs CPU);
     ``tools/curate_data --yoloface`` on two of phase 11's ``.npy`` clips,
     card against CPU; one pre-encoded micro-step (the UNet alone) at
     phase 7's point, launches derived from the model, its loss through
     the kernels against the plain versions; ``generate_latents(group=)``
     (the windows split) at world 1 over NCCL against no group; K1, K6, K2,
     K2-bwd, K3, K4 and K8 at one tp = 2 rank's shapes against their plain
     versions; the bytes a rank holds at flagship widths; a tp = 2 step
     (full widths, one layer a block) as two processes on the card over
     gloo, against the same two micro-steps in one process.
Then a JSON line with the bisect variants, one with the kernels, the card
line, and the last line ``{"ok": true, "device": {...}}``.

Matrix products in the plain versions run in full fp32 (TF32 off for both
cuBLAS and cuDNN).
"""
import contextlib
import gc
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
    # the SSM gather's delta add: the plain version rounds the difference
    # to the tokens' dtype before the add, the kernel adds in fp32 and
    # rounds once, so in bf16 an updated token differs by at most one
    # rounding (2^-8 relative); in fp32 both round alike and the fp32 case
    # is held bit for bit ("exact")
    "gather_delta_add": 2 ** -8,
}
# the kernels of the default clip and training paths (phases 5-7), and the
# three the fused-norm configuration adds (phases 4b, 5b)
DEFAULT_KERNELS = ("ssm_scan_grouped", "mha", "frame_attention", "geglu_mlp",
                   "ssm_scan_bwd", "mha_bwd")
FUSED_KERNELS = ("layer_norm", "group_norm", "gn_silu_conv3x3")
# K7-LN / K7-GN also run under the default lowering (its variant of them:
# one launch per LayerNormF32 / GroupNorm32 call on the card that K7 takes);
# the calls it does not take run the plain code and count "norm.plain",
# kept beside the kernels' launch counters (``count_plain_norms``), so that
# every phase derives and compares both
PLAIN = "norm.plain"
NORM_ENTRIES = (*FUSED_KERNELS, PLAIN)
# the trainable heads a raw-head micro-step runs once each, in its forward
HEADS = ("audio_proj", "id_proj", "vasa_proj", "pose_guider")
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
# the budget (audio, expression) of each mode the box gates: mode 0 gathers
# the audio branch, mode 1 the expression branch
C9_BUDGET = {0: (C9_CAPACITY, 0.0), 1: (0.0, C9_CAPACITY)}
C7_PX, C7_FRAMES = 576, 25
# phase 10: the face stack's and the post-passes' networks, the card against
# the CPU on the same weights and inputs. fp32 on both (TF32 off); cuDNN
# and the CPU sum each conv in another order, through up to ~60 layers
FACE_NET_TOL = 1e-4
# phase 9: the VASA towers on the driving video's crops, the card against
# the CPU. The CLI casts their weights to bf16, the same values on both
# sides; both compute in fp32 (the convs cast the weights to the input's
# dtype; TF32 off), so only the order of each conv's sums differs, through
# ~50 layers (ResNet-50-GN) and ~20 (ResNet-18-GN): the face networks' case
VASA_TOL = FACE_NET_TOL
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


# phase 11: C4, batched serving (identities per sampler call), and the
# real-data training path (C8 loader samples/s, C2 micro-steps)
SERVE_IDS = 4
# C8 / C2: the seeded corpus (clips of CORPUS_FRAMES frames at PX), the
# loader's worker count, the samples timed per worker count, the micro-steps
CORPUS_CLIPS, CORPUS_FRAMES = 4, 64
LOADER_WORKERS = 2
LOADER_SAMPLES = {0: 2, LOADER_WORKERS: 4}
MOVING_DRIFT = (0.25, 0.5)   # sub-pixel head drift, (dy, dx) px a frame at 512 px
REAL_MICRO_STEPS = 4
# phase 12: ZeRO-2 at world 1 takes phase 7's first commit; it computes the
# same AdamW step on the same fp32 gradients, only the global norm sums in
# another order: losses and parameters after the commit within fp32
# rounding. The rank-split serving call at world 1 runs the same kernels on
# the same inputs as the call without a group
SHARDED_MICRO_STEPS = 4
SHARDED_TOL = 1e-5
SPLIT_IDS = 2
SPLIT_TOL = 1e-6
# phase 13: the evaluation clips' length (>= 16 for FVD), and SyncNet's
# scores on the card against the CPU (the towers agree to FACE_NET_TOL)
EVAL_FRAMES = 27
SYNC_TOL = 1e-3



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
    """Route the models' kernel call sites (K1-K4, the SSM gather's delta
    add; K7-LN, K7-GN and K8) to the plain versions (their gradients
    then come from autograd through the plain versions), and K5's forward
    (inside ``SsmScanArrangedFn`` too) to its plain version; a backward
    through K5's function takes the plain adjoint under ``plain_adjoint``."""
    from actalker_tpu_torch.models import (
        attention_blocks as ab, common, resnet, ssm)
    from actalker_tpu_torch.ops import mha, mlp, norms, resconv, selective_scan as ss

    saved = (ab.mha_tokens, ab.frame_attention_tokens, ab.geglu_mlp,
             ssm.ssm_scan_grouped, ssm.gather_delta_add, common.layer_norm,
             common.group_norm, resnet.gn_silu_conv3x3, ss._arranged_fwd)
    ab.mha_tokens, ab.frame_attention_tokens = (mha.mha_tokens_ref,
                                                mha.frame_attention_tokens_ref)
    ab.geglu_mlp, ssm.ssm_scan_grouped = mlp.geglu_mlp_ref, ss.ssm_scan_grouped_ref
    ssm.gather_delta_add = ss.gather_delta_add_ref
    common.layer_norm, common.group_norm = norms.layer_norm_ref, norms.group_norm_ref
    resnet.gn_silu_conv3x3 = resconv.gn_silu_conv3x3_ref
    ss._arranged_fwd = ss.ssm_scan_arranged_ref
    try:
        yield
    finally:
        (ab.mha_tokens, ab.frame_attention_tokens, ab.geglu_mlp,
         ssm.ssm_scan_grouped, ssm.gather_delta_add, common.layer_norm,
         common.group_norm, resnet.gn_silu_conv3x3, ss._arranged_fwd) = saved


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


def count_plain_norms(kernels):
    """Add ``PLAIN`` to ``kernels``: a counter (``.launches``, reset and
    read with the kernels') of the norm calls that ran the plain code, kept
    by a spy on ``models/common.count`` whether or not tracing is on."""
    import types

    from actalker_tpu_torch.models import common

    plain, real = types.SimpleNamespace(name=PLAIN, launches=0), common.count

    def spy(name, n):
        if name == PLAIN:
            plain.launches += n
        return real(name, n)

    common.count = spy
    kernels[PLAIN] = plain


def norm_launches(*modules):
    """Launches of K7-LN, K7-GN and K8, and plain norm calls (``PLAIN``),
    that one forward of each module makes under the default lowerings on
    the card: a LayerNormF32 / GroupNorm32 whose width K7 takes (C % 8 ==
    0, whole groups: ``ops/norms.kernel_takes``) launches K7-LN / K7-GN
    once (the resnets' norms are GroupNorm32 calls there), any other runs
    plain; no K8."""
    from actalker_tpu_torch.models.common import GroupNorm32, LayerNormF32

    out = dict.fromkeys(NORM_ENTRIES, 0)
    for m in modules:
        for sub in m.modules():
            if isinstance(sub, (LayerNormF32, GroupNorm32)):
                gn, c = isinstance(sub, GroupNorm32), sub.weight.shape[0]
                takes = c % 8 == 0 and (not gn or c % sub.groups == 0)
                out[PLAIN if not takes else "group_norm" if gn else "layer_norm"] += 1
    return out


def norm_sum(parts):
    """The norm entries (``NORM_ENTRIES``) of (calls, per-forward counts)
    pairs, summed."""
    return {n: sum(c * p.get(n, 0) for c, p in parts) for n in NORM_ENTRIES}


def step_norm_launches(unet, heads=(), builder=()):
    """``norm_sum`` of one training micro-step with one checkpoint scope per
    UNet block: the norms of the UNet's down, mid and up blocks twice
    (forward, recompute), its others once; the ``heads`` once (the forward;
    a backward differentiates the plain twin and launches nothing);
    ``builder``: (calls, module) pairs of the batch builder's encoders."""
    blocks = (*unet.down_blocks, unet.mid_block, *unet.up_blocks)
    return norm_sum(((1, norm_launches(unet)), (1, norm_launches(*blocks)),
                     (1, norm_launches(*heads)),
                     *((c, norm_launches(m)) for c, m in builder)))


def frozen_encoders(torch):
    """The training batch builder's frozen encoders as structure alone (on
    the meta device): the VAE's encoder and whisper."""
    from actalker_tpu_torch.models.vae import AutoencoderKLTemporalDecoder, VAEConfig
    from actalker_tpu_torch.models.whisper import WhisperEncoder

    with torch.device("meta"):
        return AutoencoderKLTemporalDecoder(VAEConfig()).encoder, WhisperEncoder()


def cli_norm_launches(m, calls, num_frames, decode_chunk, vasa):
    """``norm_sum`` of one ``cli.generate_frames`` run on the modules ``m``:
    per UNet call; two VAE encodes (the reference and its noise-augmented
    copy); a decode per chunk; whisper once (the CLI inputs' 1.2 s of audio
    are one 3000-frame mel window); audio_proj twice (the audio tokens and
    the unconditional ones); vasa_proj twice where a driving video gives
    VASA tokens (``vasa``); the heads generate_latents runs once."""
    return norm_sum(((calls, norm_launches(m.unet)), (2, norm_launches(m.vae.encoder)),
                     (-(-num_frames // decode_chunk), norm_launches(m.vae.decoder)),
                     (1, norm_launches(m.whisper)), (2, norm_launches(m.audio_proj)),
                     (2 if vasa else 0, norm_launches(m.vasa_proj)),
                     (1, norm_launches(m.id_proj, m.pose_guider))))


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


def kernel_cases(torch, dev, gen, tp=1):
    """Yield (kernel name, label, kernel fn, plain fn, library fn or None,
    (bound ms, bound by), extras) at the shapes the clip and training paths
    use; the first case of each kernel is its main-path shape. extras may
    hold "timing" (the (kernel, plain) pair to time in place of the two
    compared), "chain" (a second library yardstick) and "alone" (the
    kernel's launch without its wrapper's other work). With ``tp`` > 1,
    the shapes one rank of tensor parallelism gives the kernels it
    changes (``parallel/tensor.py``): K1 / K6 on d_inner / tp, K2 / K2-bwd /
    K3 on heads / tp (the 5-head res-64 attention stays whole), K4 on H /
    tp, K8 on C_out / tp."""
    import torch.nn.functional as F

    from actalker_tpu_torch.ops import mha, mlp, norms, resconv, selective_scan as ss

    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def grouped(dp, hw, bp, rows=None, tail=33):
        # one SS2D block at d_inner = dp (its tp slice: dp / tp): rank =
        # ceil(d_model / 16), L = h*w tokens (or the gather's ``rows``
        # slots) + the tail (1 id + 32 audio tokens; mode 1's gather walks
        # the expression branch's 1 id + 1 VASA token)
        g, n_tok, rank = 4, (rows or hw * hw) + tail, -(-dp // 2 // 16)
        dp //= tp
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

    def k1(dp, hw, rows=None, tail=33):
        args = grouped(dp, hw, 56, rows, tail)  # Bp = 4 CFG x 14 frames
        dp //= tp
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
    per = f" (tp {tp} rank)" if tp > 1 else ""
    yield ("ssm_scan_grouped", f"Dp={640 // tp} L=4096+33 Bp=56 (res-64){per}", *k1(640, 64))
    yield ("ssm_scan_grouped", f"Dp={1280 // tp} L=1024+33 Bp=56 (res-32){per}",
           *k1(1280, 32))
    yield ("ssm_scan_grouped", f"Dp={2560 // tp} L=256+33 Bp=56 (res-16){per}",
           *k1(2560, 16))
    # the gather of modes 0 / 1 (phase 9): a 6/16 budget of each resolution's
    # tokens (the ~31% face box of C9) + the tail of the gathered branch:
    # mode 0's audio (33), mode 1's expression (2)
    for mode, tail in ((0, 33), (1, 2)) if tp == 1 else ():
        for dp, hw in ((640, 64), (1280, 32), (2560, 16)):
            k = gathered_rows(hw * hw, C9_CAPACITY)
            yield ("ssm_scan_grouped",
                   f"Dp={dp} L={k}+{tail} Bp=56 (gathered res-{hw}, mode {mode})",
                   *k1(dp, hw, k, tail))

    def delta_add(di, hw, k, sel, dtype):
        # one branch of the 576 px mode-0 call's gather (4 CFG x 25 frames):
        # y the block's (B * L, D) tokens; s the audio branch's two
        # directions, a column slice of K1's output (two branches); u its
        # columns of K1's input; each column's ``sel`` box tokens in token
        # order in the first slots, the rest empty (their column's last
        # token, as ``_compact_rows`` gives them)
        b, l = 100, hw * hw
        di //= tp
        y = rnd(b * l, di, dtype=dtype)
        s = rnd(k, b, 4 * di, dtype=dtype)[:, :, :2 * di]
        u = rnd(k, b, 2 * di, dtype=dtype)[:, :, :di]
        pick = torch.rand(b, l, generator=gen, device=dev).argsort(1)[:, :sel].sort(1).values
        tok = torch.full((b, k), l - 1, dtype=torch.long, device=dev)
        tok[:, :sel] = pick
        tok = (tok + torch.arange(b, device=dev)[:, None] * l).t().contiguous()
        act = (torch.arange(k, device=dev) < sel)[:, None].expand(k, b).contiguous()
        yt = y.clone()

        def run(fn):
            out = y.clone()
            fn(out, s, u, tok, act)
            return out

        # per active slot: 2 D of s, D of u and D of y read, D of y written,
        # its token and flag; 2 adds and a subtract an element
        nbytes = sel * b * (5 * di * y.element_size() + 9)
        return (lambda: run(ss.gather_delta_add), lambda: run(ss.gather_delta_add_ref),
                None, bound(nbytes, 3 * sel * b * di, PEAK_FP32),
                {"timing": (lambda: ss.gather_delta_add(yt, s, u, tok, act),
                            lambda: ss.gather_delta_add_ref(yt, s, u, tok, act)),
                 "exact": dtype == torch.float32})

    # the gather's delta add at the 576 px mode-0 call's three SS2D
    # resolutions (a 5/16 budget: 1624 / 408 / 104 slots, the box's 1600 /
    # 400 / 100 tokens active), in bf16 (the main path) and fp32
    for di, hw, k, sel, dtype in ((640, 72, 1624, 1600, bf), (1280, 36, 408, 400, bf),
                                  (2560, 18, 104, 100, bf),
                                  (640, 72, 1624, 1600, torch.float32)):
        yield ("gather_delta_add",
               f"(B * L, D) = ({100 * hw * hw}, {di // tp}), {k} x 100 slots, {sel} x 100 "
               f"active (res-{hw}, mode 0) {str(dtype)[6:]}{per}",
               *delta_add(di, hw, k, sel, dtype))

    def k6(dp, hw):
        # training: Bp = 25 frames; gradients through SsmScanGroupedFn.backward
        # (K6 once per group) against the same backward with the plain
        # adjoint; the slab's mask lane (its gradient is the -1e9 row times
        # ddt) is left out of the comparison
        u, slab, dtw, a, d, bias, rank = grouped(dp, hw, 25)
        dp //= tp
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
        yield ("ssm_scan_bwd", f"Dp={dp // tp} L={hw * hw}+33 Bp=25 G=4 (train){per}",
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
                                     "MambaUPNet stage 3")) if tp == 1 else ():
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

    def per_rank(shapes):
        """(..., C, H) attention shapes -> one tp rank's (C / tp, H / tp),
        leaving out those whose heads do not divide (they stay whole)."""
        if tp == 1:
            return shapes
        return [(*x[:-2], x[-2] // tp, x[-1] // tp) for x in shapes if x[-1] % tp == 0]

    # the window-step's four resolutions (res-64, -32, -16, the res-8 mid
    # block) and the 576 px latent (S = 5184, no multiple of the tiles);
    # the training backward at the same S and C
    for b, s, c, h in per_rank(((56, 4096, 320, 5), (56, 1024, 640, 10),
                                (56, 5184, 320, 5), (56, 256, 1280, 20),
                                (56, 64, 1280, 20))):
        q, k, v = rnd(b, s, c), rnd(b, s, c), rnd(b, s, c)
        qh, kh, vh = (heads_view(x, h) for x in (q, k, v))
        ops = 4 * b * h * s * s * (c // h)
        yield ("mha", f"B={b} S={s} C={c} H={h}{per}",
               lambda q=q, k=k, v=v, h=h: mha.mha_tokens(q, k, v, h),
               lambda q=q, k=k, v=v, h=h: mha.mha_tokens_ref(q, k, v, h),
               lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh),
               bound(4 * b * s * c * 2, ops, PEAK_BF16))
    for b, s, c, h in per_rank(((25, 4096, 320, 5), (25, 1024, 640, 10),
                                (25, 5184, 320, 5), (25, 256, 1280, 20),
                                (25, 64, 1280, 20))):
        q, k, v, do = (rnd(b, s, c) for _ in range(4))
        o, lse = mha._mha_fwd(q, k, v, h, with_lse=True)
        qh, kh, vh = (heads_view(x, h).detach().requires_grad_(True)
                      for x in (q, k, v))
        oh, doh = F.scaled_dot_product_attention(qh, kh, vh), heads_view(do, h)
        # the five products of the backward: S = QK^T, dP = dO V^T,
        # dV = P^T dO, dQ = dS K, dK = dS^T Q
        ops = 5 * 2 * b * h * s * s * (c // h)
        yield ("mha_bwd", f"B={b} S={s} C={c} H={h} (train){per}",
               lambda q=q, k=k, v=v, o=o, lse=lse, do=do, h=h:
                   mha.mha_tokens_bwd(q, k, v, o, lse, do, h),
               lambda q=q, k=k, v=v, do=do, h=h: mha.mha_tokens_bwd_ref(q, k, v, do, h),
               lambda oh=oh, ins=(qh, kh, vh), doh=doh:
                   torch.autograd.grad(oh, ins, doh, retain_graph=True),
               bound(8 * b * s * c * 2 + b * h * s * 4, ops, PEAK_BF16))
    # K3: the 14-frame window-step at res-64 / -32 / -16 / -8 (4 CFG x 14
    # frames), 4 CFG x 25 frames at res-64, training's 25 frames, and the
    # reference's default 576 px window (4 CFG x 25 frames, S = 72^2)
    for b, f, s, c, h in per_rank([(b, f, s, 64 * h, h) for b, f, s, h in (
            (4, 14, 4096, 5), (4, 25, 4096, 5), (4, 14, 1024, 10), (4, 14, 256, 20),
            (4, 14, 64, 20), (1, 25, 4096, 5), (4, 25, 5184, 5))]):
        q, k, v = (rnd(b * f, s, c) for _ in range(3))
        # SDPA over the frame axis: (B*S, H, F, d), laid out beforehand
        qf, kf, vf = (x.view(b, f, s, h, 64).permute(0, 2, 3, 1, 4)
                      .reshape(b * s, h, f, 64) for x in (q, k, v))
        ops = 4 * b * s * h * f * f * 64
        yield ("frame_attention", f"B*F={b * f} F={f} S={s} C={c} H={h}{per}",
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
    # block), C = 1280 at res-64's M (off the path), and the 576 px cell's
    # (4 CFG x 25 frames at res-72, -36, -18 and the res-9 mid block); a tp
    # rank holds H / tp of the 4C hidden units (its partial output, bias
    # zero)
    for m, c, what in ((56 * 4096, 320, "res-64"), (56 * 1024, 640, "res-32"),
                       (56 * 256, 1280, "res-16"), (56 * 64, 1280, "res-8"),
                       (56 * 4096, 1280, "off the path"),
                       (100 * 5184, 320, "576 px res-72"), (100 * 1296, 640, "576 px res-36"),
                       (100 * 324, 1280, "576 px res-18"), (100 * 81, 1280, "576 px res-9"),
                       )[:9 if tp == 1 else 4]:
        x, hid = rnd(m, c), 4 * c // tp
        w1, b1 = rnd(2 * hid, c, scale=c ** -0.5), rnd(2 * hid, dtype=torch.float32, scale=0.1)
        w2 = rnd(c, hid, scale=(4 * c) ** -0.5)
        b2 = rnd(c, dtype=torch.float32, scale=0.1) if tp == 1 else \
            torch.zeros(c, device=dev)
        yield ("geglu_mlp", f"M={m} C={c} H={hid} ({what}){per}",
               lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: mlp.geglu_mlp(x, w1, b1, w2, b2),
               lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: mlp.geglu_mlp_ref(x, w1, b1, w2, b2),
               None, bound(2 * (2 * m * c + 3 * hid * c), 6 * m * c * hid, PEAK_BF16),
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
                        (1500, 384, torch.float32)) if tp == 1 else ():
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
                         (56, 256, 1280, 1e-6), (56, 64, 1280, 1e-6)) if tp == 1 else ():
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
    for n, m, c in ((56, 4096, 320), (56, 256, 2560)) if tp == 1 else ():
        x = rnd(n, m, c, scale=2.0) - 0.5
        g, b = rnd(c, dtype=torch.float32), rnd(c, dtype=torch.float32)
        yield ("group_norm", f"statistics alone (K8's), (N, M, C) = ({n}, {m}, {c})",
               lambda x=x, g=g, b=b: norms.group_norm_affine(x, g, b, 32, 1e-5),
               lambda x=x, g=g, b=b: norms.gn_affine(x, g, b, 32, 1e-5), None,
               bound(n * m * c * 2 + 8 * c + 8 * n * c, 3 * n * m * c, PEAK_FP32))
    # the default lowering's variant (``io_affine``: the affine rounded in
    # the activation dtype, as the plain default branch rounds it) at the
    # 576 px cell's shapes (4 CFG x 25 frames, 72 x 72 latents): plain is
    # that branch, "fp32-affine K7" the fused lowering's launch on the same
    # input. K7-LN at res-72 and at the SSM out-norm, which takes the block's
    # (B, L) bf16 tokens as they are, and in fp32 at that width; K7-GN on the
    # two-pass path (res-72, and the temporal resnets' (4, 25 * 72 * 72, C))
    # and the cluster path (res-36)
    for label, m, c, dtype in (("res-72", (100 * 5184,), 320, bf),
                               ("SSM out-norm, res-72", (100, 5184), 640, bf),
                               ("fp32", (100 * 5184,), 640, torch.float32)
                               ) if tp == 1 else ():
        x = rnd(*m, c, dtype=dtype, scale=2.0) + 0.5
        m = x.numel() // c
        g, b = 1.0 + rnd(c, dtype=torch.float32, scale=0.3), rnd(c, dtype=torch.float32)
        yield ("layer_norm", f"default variant, {label}: {tuple(x.shape)} "
                             f"{str(dtype)[6:]}",
               lambda x=x, g=g, b=b: norms.layer_norm(x, g, b, io_affine=True),
               lambda x=x, g=g, b=b: norms.layer_norm_ref(x, g, b, io_affine=True),
               None, bound(2 * m * c * x.element_size() + 8 * c, 10 * m * c, PEAK_FP32),
               {"fused": lambda x=x, g=g, b=b: norms.layer_norm(x, g, b)})
    for label, n, m, c, eps in (("res-72, two-pass", 100, 5184, 320, 1e-6),
                                ("temporal resnets, two-pass", 4, 25 * 5184, 320, 1e-5),
                                ("res-36, cluster", 100, 1296, 640, 1e-6)
                                ) if tp == 1 else ():
        x = rnd(n, m, c, scale=2.0) - 0.5
        g, b = 1.0 + rnd(c, dtype=torch.float32, scale=0.3), rnd(c, dtype=torch.float32)
        yield ("group_norm", f"default variant, {label}: (N, M, C) = ({n}, {m}, {c})",
               lambda x=x, g=g, b=b, eps=eps:
                   norms.group_norm(x, g, b, 32, eps, io_affine=True),
               lambda x=x, g=g, b=b, eps=eps:
                   norms.group_norm_ref(x, g, b, 32, eps, io_affine=True),
               None, bound(2 * n * m * c * 2 + 8 * c, 10 * n * m * c, PEAK_FP32),
               {"fused": lambda x=x, g=g, b=b, eps=eps: norms.group_norm(x, g, b, 32, eps)})
    # a tp rank: C_out / tp (the VAE is whole)
    for n, hw, c, co in ((56, 64, 320, 320 // tp), (56, 32, 640, 640 // tp),
                         (56, 16, 2560, 1280 // tp), (56, 8, 1280, 1280 // tp),
                         (14, 512, 128, 128))[:5 if tp == 1 else 4]:
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
        yield ("gn_silu_conv3x3", f"({n}, {hw}, {hw}, {c} -> {co}){per}",
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


def forward_launches(unet, caps=None):
    """Launches of K1-K4 in one UNet forward, derived from the model: one K1
    per SS2DCondV10, one K2 per spatial block's self-attention, one K3 per
    temporal self-attention, two K4 per GEGLU feed-forward (the keys
    ``portbench/roofline.py`` derives); under the SSM budget ``caps``
    (audio, expression) with both masks given, also the SSM gather's delta
    adds, one per (SS2DCondV10 on the gather path, branch with slots)."""
    from actalker_tpu_torch.models import attention_blocks as ab
    from actalker_tpu_torch.models.ssm import SS2DCondV10

    mods = list(unet.modules())

    def n(kind):
        return sum(isinstance(m, kind) for m in mods)

    per = {"ssm_scan_grouped": n(SS2DCondV10), "mha": n(ab.BasicTransformerBlock),
           "frame_attention": n(ab._FrameSelfAttention),
           "geglu_mlp": 2 * n(ab.FeedForward)}
    if caps is not None:
        per["gather_delta_add"] = sum(delta_launches(m, caps) for m in mods
                                      if isinstance(m, SS2DCondV10))
    return per


def delta_launches(block, caps):
    """The delta adds of one SS2DCondV10 call under the budget ``caps``
    (masks given): none on the masked-dense path (no budget, or every
    built branch's at 1), else one per built branch whose budget is above
    0."""
    if caps is None or block.no_scan:
        return 0
    fracs = [f for f, on in zip(caps, (block.use_audio, block.use_exp)) if on]
    return sum(f > 0 for f in fracs) if any(f < 1 for f in fracs) else 0


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


def write_mp4(path, frames, fps=25.0):
    """(F, H, W, 3) uint8 RGB frames -> ``path`` with OpenCV's MPEG-4 part 2
    encoder (``mp4v``), which the card's OpenCV writes and reads back
    through its FFmpeg backend (the libav runtime does not load there)."""
    import cv2
    import numpy as np

    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"OpenCV {cv2.__version__} cannot write {path}")
    for f in frames:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))
    writer.release()


def write_driving_clip(out):
    """The CLI's driving video under ``out``: 2 * FRAMES frames at 25 fps and
    PX px of a seeded smooth texture moving 3 px a frame (so the VASA crops
    differ from frame to frame). Returns the path."""
    import cv2
    import numpy as np

    n, shift = 2 * FRAMES, 3
    width = PX + shift * n
    rng = np.random.default_rng(10)
    tex = cv2.resize((rng.random((PX // 16, width // 16, 3)) * 255).astype(np.uint8),
                     (width, PX), interpolation=cv2.INTER_CUBIC)
    path = os.path.join(out, "drive.mp4")
    write_mp4(path, np.stack([tex[:, shift * i:shift * i + PX] for i in range(n)]))
    return path


def vasa_on_cpu(torch, pipe, crops):
    """The pipeline's VASA towers copied to the CPU in fp32 on ``crops``:
    (expr, rot) as ``encode_vasa_video`` computes them."""
    import copy

    x = torch.from_numpy(crops)
    with torch.no_grad():
        expr = copy.deepcopy(pipe.m.vasa_expression).cpu().float()(x)
        rot = copy.deepcopy(pipe.m.vasa_pose).cpu().float()(x * 2.0 - 1.0)["rotation"]
    return expr, rot


def phase9(torch, dev, kernels, card):
    """The inference CLI at full width (mode 0, then modes 1 and 2 driven by
    a video), C9 (the mode-0 and mode-1 window-steps with the SSM gather
    and masked-dense) and C7 (the 576 px / 25-frame window-step, default
    and fused-norm). Returns the CLI runs' launch counts."""
    import argparse
    import dataclasses

    import cv2
    import numpy as np

    from actalker_tpu_torch import cli
    from actalker_tpu_torch.frontend import media_native
    from actalker_tpu_torch.frontend import video as V
    from actalker_tpu_torch.models.conditioning import Conditioning
    from actalker_tpu_torch.pipeline.sampler import SamplerConfig

    out = os.path.join(OUT, "cli")
    wav, ref = write_cli_inputs(out)
    clip = write_driving_clip(out)
    t0 = time.perf_counter()
    drive = V.read_frames(clip)
    decoder = ("the libav runtime" if media_native.lib() is not None
               else f"OpenCV {cv2.__version__} (the libav runtime does not load)")
    print(f"[9 cli] driving video {os.path.relpath(clip, ROOT)}: {drive.shape} "
          f"decoded by {decoder} in {time.perf_counter() - t0:.4f} s", flush=True)
    if drive.shape != (2 * FRAMES, PX, PX, 3):
        raise RuntimeError(f"the driving video decodes to {drive.shape}")
    cfg = dataclasses.replace(
        cli.load_config(os.path.join(ROOT, "configs", "inference.yaml")),
        image_size=PX, n_sample_frames=FRAMES, num_inference_steps=STEPS,
        decode_chunk_size=FRAMES, seed=0, output_dir=out, exp_name="cli",
        arcface_checkpoint_path="")
    pipes = {}

    def run_cli(mode):
        args = argparse.Namespace(config="configs/inference.yaml", ref=ref,
                                  audio=wav, video=clip if mode else None,
                                  mode=mode, batch=False,
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
    runs = {}
    for mode in (0, 1, 2):
        args, res, counts, rows = run_cli(mode)
        pipe = res["pipe"]
        calls = unet_calls(cfg.sampler_config(cli.MODE_GATES[mode]), res["num_frames"])
        caps = pipe._capacity_fracs(cfg.sampler_config(cli.MODE_GATES[mode]),
                                    res["masks"]["audio_mask"], res["masks"]["exp_mask"],
                                    (PX // 8, PX // 8))
        per = forward_launches(pipe.m.unet, caps)
        want = {n: per.get(n, 0) * calls for n in kernels}
        want.update(cli_norm_launches(pipe.m, calls, res["num_frames"],
                                      cfg.decode_chunk_size, vasa=mode != 0
                                      and pipe.m.vasa_expression is not None))
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
        if rows != want_rows or (mode in (0, 1)) != (caps is not None):
            raise RuntimeError(f"CLI mode {mode}: K1 rows {rows} != {want_rows} "
                               f"(capacity {caps})")
        if mode in (0, 1) and caps != C9_BUDGET[mode]:
            raise RuntimeError(f"C9 box gives mode {mode} the capacity {caps}, "
                               f"not {C9_BUDGET[mode]}")
        if mode == 1 and (res["masks"]["exp_mask"] is None
                          or res["masks"]["audio_mask"] is not None):
            raise RuntimeError("CLI mode 1 must gate the expression branch alone")
        if mode:
            # the driving video's expression tokens, and the VASA towers on
            # its crops: the card (the CLI's bf16 weights, fp32 compute)
            # against the same weights in fp32 on the CPU
            tok, crops = res["tokens"][2], res["vasa_crops"]
            if crops is None or not torch.isfinite(tok).all() or tok.abs().max() == 0:
                raise RuntimeError(f"CLI mode {mode}: the driving video gave no "
                                   "expression tokens")
            expr, rot = pipe.encode_vasa_video(crops, crops)
            want_e, want_r = vasa_on_cpu(torch, pipe, crops)
            rel_e = errors(torch.from_numpy(expr), want_e)[1]
            rel_r = errors(torch.from_numpy(rot), want_r)[1]
            print(f"[9 cli] mode {mode}: expression tokens {tuple(tok.shape)} max "
                  f"|tok| {tok.abs().max().item():.4g} | VASA towers on "
                  f"{crops.shape[0]} crops, card vs CPU fp32 rel_l2 expression "
                  f"{rel_e:.3g} rotation {rel_r:.3g} (tol {VASA_TOL}) | {card}",
                  flush=True)
            if max(rel_e, rel_r) > VASA_TOL:
                raise RuntimeError(f"CLI mode {mode}: the VASA towers on the card "
                                   "disagree with the CPU")
        for n in kernels:
            cli_counts[n] += counts[n]
        runs[mode] = res
    pipe = runs[0]["pipe"]
    unet = pipe.m.unet
    g9 = torch.Generator(device=dev).manual_seed(9)

    def rn(*shape):
        return torch.randn(*shape, generator=g9, device=dev)

    def forward_inputs(b, f, hw, audio_mask, exp_mask, gate_a, gate_v):
        """One window-step's UNet inputs (b = 4 CFG, f frames), seeded;
        ``gate_a`` / ``gate_v`` 0 zero the audio / expression tokens (modes
        1 / 0)."""
        cond = Conditioning(rn(b * f, 1, 1024).bfloat16(),
                            (rn(b * f, 32, 1024) * gate_a).bfloat16(),
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

    # ---- C9: the mode-0 and mode-1 window-steps, gather vs masked-dense ----
    for mode in (0, 1):
        c9_window_step(torch, dev, kernels, card, pipe, runs[mode], mode,
                       forward_inputs, forward_check)
    del runs
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
    fwd7 = forward_inputs(4, C7_FRAMES, hw7, ones7, ones7, 1.0, 1.0)
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
        per_norm = norm_launches if label == "default" else fused_launches
        want.update(norm_sum(((calls7, per_norm(unet)), (2, per_norm(pipe.m.vae.encoder)),
                              (1, per_norm(pipe.m.id_proj, pipe.m.pose_guider)))))
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


def c9_window_step(torch, dev, kernels, card, pipe, run, mode, forward_inputs,
                   forward_check):
    """C9 of ``mode`` (0: audio, 1: expression), the CLI run ``run``'s
    window-step with the SSM gather and with the masked-dense scan: seconds,
    K1's launches, the latents and one seeded UNet forward (kernels vs
    plain) of each, then the two against each other."""
    from actalker_tpu_torch.pipeline.sampler import SamplerConfig

    gate = ((1, 0), (0, 1))[mode]
    branch = ("audio_mask", "exp_mask")[mode]
    scfg = SamplerConfig(num_inference_steps=STEPS, frames_per_batch=FRAMES,
                         windows_per_call=1, gate=gate)
    calls = unet_calls(scfg, FRAMES)
    mask = run["masks"][branch]
    gen_args = (run["pre"].ref_img, run["id_embed"], *run["tokens"],
                run["pose_imgs"], scfg)
    unet = pipe.m.unet
    k1_want = forward_launches(unet)["ssm_scan_grouped"] * calls
    delta_want = {True: forward_launches(unet, C9_BUDGET[mode])["gather_delta_add"] * calls,
                  False: 0}

    def window_steps(gather):
        pipe.gather = gather
        try:
            pipe.generate_latents(*gen_args, seed=0, **{branch: mask})  # warm-up
            torch.cuda.synchronize()
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            lat = pipe.generate_latents(*gen_args, seed=0, **{branch: mask})
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / calls, lat, \
                (kernels["ssm_scan_grouped"].launches, kernels["gather_delta_add"].launches)
        finally:
            pipe.gather = True

    face = torch.from_numpy(mask).to(dev)
    empty = torch.zeros(1, 1, PX, PX, device=dev)
    fwd = forward_inputs(4, FRAMES, PX // 8, *((face, empty) if mode == 0 else (empty, face)),
                         *gate)
    c9 = {}
    for name, gather in (("gather", True), ("masked-dense", False)):
        sec, lat, (k1, delta) = window_steps(gather)
        y, rel = forward_check(fwd, C9_BUDGET[mode] if gather else None)
        c9[name] = (sec, lat, y)
        print(f"[9 C9] mode {mode}, face box 31.2% of the image, {name}: seconds per "
              f"window-step {sec:.4f} s ({calls} UNet calls of 4 CFG x {FRAMES} f x "
              f"{PX // 8}x{PX // 8}) | K1 launches {k1} (derived {k1_want}), delta "
              f"adds {delta} (derived {delta_want[gather]}) | one forward, kernels vs "
              f"plain rel_l2 {rel:.3g} (tol {UNET_TOL}) | {card}", flush=True)
        if k1 != k1_want or delta != delta_want[gather] or rel > UNET_TOL \
                or not torch.isfinite(lat).all():
            raise RuntimeError(f"C9 mode {mode} {name}: K1 launches {k1}, delta adds "
                               f"{delta}, rel_l2 {rel}")
    rel_lat = errors(c9["gather"][1], c9["masked-dense"][1])[1]
    rel_fwd = errors(c9["gather"][2], c9["masked-dense"][2])[1]
    print(f"[9 C9] mode {mode}, gather vs masked-dense: window-step "
          f"{c9['gather'][0]:.4f} s vs {c9['masked-dense'][0]:.4f} s "
          f"({c9['masked-dense'][0] / c9['gather'][0]:.3f}x) | latents rel_l2 "
          f"{rel_lat:.3g}, one forward rel_l2 {rel_fwd:.3g} (tol {UNET_TOL}) | {card}",
          flush=True)
    if rel_fwd > UNET_TOL or rel_lat > UNET_TOL:
        raise RuntimeError(f"mode {mode}: the gather disagrees with the masked-dense scan")


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
    # no driving video: zero VASA tokens, no vasa_proj
    want.update(cli_norm_launches(res["pipe"].m, calls, res["num_frames"],
                                  cfg.decode_chunk_size, vasa=False))
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


class CudaProbe:
    """A dataset wrapper that records in each sample whether the process
    that built it had initialized CUDA (the loader's workers must not)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    @property
    def rng(self):
        return self.ds.rng

    @rng.setter
    def rng(self, value):
        self.ds.rng = value

    def __getitem__(self, k):
        import torch

        sample = self.ds[k]
        sample["cuda_initialized"] = torch.cuda.is_initialized()
        return sample


def micro_step_launches():
    """Launches per training micro-step with one checkpoint scope per block:
    every forward kernel runs twice (forward, recompute); the backward runs
    K6 once per (SS2D block, group) and K2-bwd once per spatial
    self-attention; the batch builder's encoders (default configuration) none; K8
    none (K7's launches and the plain norm calls: ``step_norm_launches``)."""
    return {"ssm_scan_grouped": 2 * 15, "mha": 2 * 16, "frame_attention": 2 * 16,
            "geglu_mlp": 2 * 96, "ssm_scan_bwd": 15 * 4, "mha_bwd": 16,
            "ssm_scan": 0, "gn_silu_conv3x3": 0, "gather_delta_add": 0}


def drifted(scene, t, drift):
    """``scene`` moved by ``t * drift`` (dy, dx) pixels, bilinear, wrapping
    at the borders."""
    import numpy as np

    out = scene.astype(np.float32)
    for axis, d in enumerate(drift):
        k, a = divmod(t * d, 1.0)
        out = (1 - a) * np.roll(out, int(k), axis) + a * np.roll(out, int(k) + 1, axis)
    return out


def write_corpus(out, drift=(0.0, 0.0)):
    """The seeded training corpus under ``out``: CORPUS_CLIPS clips of
    CORPUS_FRAMES frames at PX x PX as ``.npy`` stacks (a scene of 8-pixel
    blocks with per-pixel grain, still by default, else moving ``drift``
    (dy, dx) pixels a frame), a 16 kHz WAV each, per-frame boxes and
    68-point landmarks in ``clips.json``, and a seeded iresnet50 as the
    ArcFace file. Returns (metadata path, ArcFace path). On the still scene
    no sample crosses the dataset's flow gate, so each costs one pass of
    its work: the loader's floor. The crop augmentation zooms the face box
    by up to ~50x, so a drift can push a draw past the gate, which
    resamples it."""
    import wave

    import numpy as np
    import torch

    from actalker_tpu_torch.models.arcface import iresnet50

    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(11)
    clips = []
    for c in range(CORPUS_CLIPS):
        scene = rng.integers(16, 240, (PX // 8, PX // 8, 3)).repeat(8, 0).repeat(8, 1)
        scene = scene + rng.integers(-16, 16, (PX, PX, 3))        # per-pixel grain
        frames = np.stack([np.clip(drifted(scene, t, drift), 0, 255).round()
                           for t in range(CORPUS_FRAMES)]).astype(np.uint8)
        video = os.path.join(out, f"clip{c}.npy")
        np.save(video, frames)
        audio = os.path.join(out, f"clip{c}.wav")
        t = np.arange(int((CORPUS_FRAMES / 25 + 0.5) * 16000)) / 16000
        with wave.open(audio, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((0.3 * np.sin(2 * np.pi * (180 + 40 * c) * t) * 32767)
                          .astype(np.int16).tobytes())
        box = np.array([0.3, 0.25, 0.7, 0.75]) * PX
        boxes = box + rng.uniform(-2, 2, (CORPUS_FRAMES, 4))
        lmks = np.stack([rng.uniform(box[0], box[2], (CORPUS_FRAMES, 68)),
                         rng.uniform(box[1], box[3], (CORPUS_FRAMES, 68))], -1)
        clips.append(dict(video_path=video, audio_path=audio, frames=CORPUS_FRAMES,
                          fps=25.0, bboxes=boxes.tolist(), landmarks=lmks.tolist()))
    meta = os.path.join(out, "clips.json")
    with open(meta, "w") as f:
        json.dump(clips, f)
    torch.manual_seed(12)
    arcface = os.path.join(out, "arcface.pth")
    torch.save(iresnet50().state_dict(), arcface)
    return meta, arcface


def serve_inputs(pipe, scfg, torch, n=SERVE_IDS):
    """``n`` identities' sampler inputs (``prepare_sampling``): each its
    own seeded reference, tokens and pose images, its own face box (19-35%
    of the image; the audio mask its lower half) and its own generator.
    Returns (plan, per-identity buffers, ref latents, generator states)."""
    import numpy as np

    plans, bufs, refs, states = [], [], [], []
    for i in range(n):
        r = np.random.default_rng(20 + i)
        side = int(PX * (0.44 + 0.05 * i))
        y0, x0 = (PX - side) // 2, (PX - side) // 3
        face = np.zeros((1, 1, PX, PX), np.float32)
        face[..., y0:y0 + side, x0:x0 + side] = 1.0
        mouth = np.zeros_like(face)
        mouth[..., y0 + side // 2:y0 + side, x0:x0 + side] = 1.0
        plan, b, ref, gen = pipe.prepare_sampling(
            r.standard_normal((PX, PX, 3)).astype(np.float32) * 0.2,
            r.standard_normal(512).astype(np.float32),
            r.standard_normal((FRAMES, 32, 1024)).astype(np.float32),
            np.zeros((FRAMES, 32, 1024), np.float32),
            r.standard_normal((FRAMES, 1, 1024)).astype(np.float32),
            np.zeros((FRAMES, 1, 1024), np.float32),
            r.random((FRAMES, PX, PX, 3)).astype(np.float32), scfg, seed=i,
            audio_mask=mouth, exp_mask=face)
        plans.append(plan)
        bufs.append(b)
        refs.append(ref)
        states.append(gen.get_state())
    return plans[0], bufs, torch.stack(refs), states


def phase11_serving(torch, dev, kernels, card, pipe):
    """C4: SERVE_IDS identities through ``generate_latents_batch`` (one
    ``sample_video_batch`` loop, each UNet call stacking them, one SSM
    budget covering every identity's masks) against the same clips through
    it one identity at a time (each under its own budget, as
    ``generate_latents`` runs a clip). Returns the batched run's
    launches."""
    from actalker_tpu_torch.pipeline import sampler, serving
    from actalker_tpu_torch.pipeline.sampler import SamplerConfig

    unet = pipe.m.unet
    scfg = SamplerConfig(num_inference_steps=STEPS, frames_per_batch=FRAMES,
                         windows_per_call=1, gate=(1, 1))
    plan, bufs, refs, states = serve_inputs(pipe, scfg, torch)
    stacked = serving.stack_buffers(bufs)

    def budget(b):     # what the entry sets, to derive K1's rows from
        return pipe._capacity_fracs(scfg, b.audio_mask[:, 0], b.exp_mask[:, 0],
                                    (PX // 8, PX // 8))

    caps = budget(stacked)
    own_caps = [budget(serving.stack_buffers([b])) for b in bufs]
    calls = unet_calls(scfg, FRAMES)

    def gens():
        out = []
        for s in states:
            g = torch.Generator(device=dev)
            g.set_state(s)
            out.append(g)
        return out

    def prepared(p):
        return [(p, b, refs[i], g) for i, (b, g) in enumerate(zip(bufs, gens()))]

    def batched(cfg=scfg, p=plan):
        return pipe.generate_latents_batch(prepared(p), cfg)

    def one_by_one(cfg=scfg, p=plan):
        return [pipe.generate_latents_batch([one], cfg)[0] for one in prepared(p)]

    warm = SamplerConfig(num_inference_steps=1, frames_per_batch=FRAMES,
                         windows_per_call=1, gate=(1, 1))
    runs = {}
    for name, fn in (("batched", batched), ("sequential", one_by_one)):
        fn(warm, sampler.make_plan(warm, FRAMES))      # warm-up, same shapes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        with k1_rows() as rows:
            t0 = time.perf_counter()
            lat = fn()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        runs[name] = dict(lat=lat, sec=sec, rows=sorted(set(rows)),
                          peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                          counts={n: k.launches for n, k in kernels.items()})
    if unet.config.mask_capacity is not None:
        raise RuntimeError("C4: the serving entry left its SSM budget set")

    def k1_rows_of(cs):
        return sorted({
            max(gathered_rows(l, c[0]) + 33, gathered_rows(l, c[1]) + 2)
            if c else l + 33
            for c in cs for l in ((PX // 8 // st) ** 2 for st in pipe.ssm_strides())})

    b, s = runs["batched"], runs["sequential"]
    rel = errors(b["lat"][2], s["lat"][2])[1]
    finite = bool(torch.isfinite(b["lat"]).all())
    for name, r, ncalls, cs in (("batched", b, calls, [caps]),
                                ("sequential", s, SERVE_IDS * calls, own_caps)):
        # each identity alone under its own budget, or all under one
        want = {n: sum(forward_launches(unet, c).get(n, 0) for c in cs) * calls
                for n in kernels}
        want.update(norm_sum(((ncalls, norm_launches(unet)),)))
        want_rows = k1_rows_of(cs)
        print(f"[11 C4] {name}: {SERVE_IDS} identities x {FRAMES} frames, {PX} px, "
              f"{STEPS} steps, mode 2, own masks / tokens / generator each: "
              f"{r['sec']:.4f} s ({r['sec'] / SERVE_IDS:.4f} s an identity, "
              f"{r['sec'] / (SERVE_IDS * calls):.4f} s an identity-window-step; "
              f"{ncalls} UNet calls of {SERVE_IDS * 4 if name == 'batched' else 4} "
              f"x {FRAMES} f) | peak max_memory_allocated {r['peak']:.2f} GiB | "
              f"capacity {cs}, K1 rows {r['rows']} (derived {want_rows}) | "
              f"launches {r['counts']} (derived {want}) | {card}", flush=True)
        if r["counts"] != want or r["rows"] != want_rows:
            raise RuntimeError(f"C4 {name}: launches {r['counts']} != {want} or "
                               f"K1 rows {r['rows']} != {want_rows}")
    print(f"[11 C4] batched vs sequential: {s['sec'] / b['sec']:.3f}x | identity 2 "
          f"of the batch vs alone rel_l2 {rel:.3g} (tol {UNET_TOL}) | latents "
          f"{tuple(b['lat'].shape)} finite {finite} | {card}", flush=True)
    if not finite or b["lat"].shape != (SERVE_IDS, FRAMES, PX // 8, PX // 8, 4) \
            or rel > UNET_TOL:
        raise RuntimeError(f"C4: batched latents not finite / wrong shape, or "
                           f"identity 2 differs from itself alone (rel_l2 {rel})")
    return b["counts"]


def loader_rate(prefetch, ds, collate, workers, n):
    """(seconds to the first batch, samples per second over the rest) of
    ``n`` batches of one sample through ``prefetch_batches``."""
    t0 = time.perf_counter()
    stamps = []
    gen = prefetch(ds, 1, collate, num_workers=workers, num_batches=n)
    try:
        for _ in gen:
            stamps.append(time.perf_counter())
    finally:
        gen.close()
    first = stamps[0] - t0
    return first, (n - 1) / (stamps[-1] - stamps[0]), stamps[-1] - t0


def phase11_loader(torch, dev, card, pipe, meta, arcface_path):
    """C8: the loader's samples/s at 0 and LOADER_WORKERS workers on the
    still corpus (one pass of the dataset's work a sample, the floor), the
    dataset alone, then with the builder (the frozen encoders on the card)
    as ``collate``; then the dataset alone in process on a corpus drifting
    MOVING_DRIFT pixels a frame, with its resamples a sample."""
    from actalker_tpu_torch.training import data as D
    from actalker_tpu_torch.training.batch_builder import BatchBuilder
    from actalker_tpu_torch.training.loader import prefetch_batches
    from actalker_tpu_torch.io.init import load_arcface

    builder = BatchBuilder(pipe, arcface=load_arcface(arcface_path, dev))
    cfg = D.DataConfig(n_sample_frames=25, image_size=PX)
    for what, collate in (("dataset alone", list), ("with the builder", builder)):
        for workers, n in LOADER_SAMPLES.items():
            ds = CudaProbe(D.PortraitAudioDataset(
                D.load_metadata([meta]), cfg, D.NpyFrameReader(),
                audio_feature_reader=D.AudioWindowReader()))
            seen = []

            def probe(samples, collate=collate):
                seen.extend(s.pop("cuda_initialized") for s in samples)
                return collate(samples)

            first, rate, total = loader_rate(prefetch_batches, ds, probe, workers, n)
            print(f"[11 C8] loader, {what}: {workers} workers, {n} samples of 25 "
                  f"frames at {PX} px (batch 1, {CORPUS_CLIPS} clips of {CORPUS_FRAMES} "
                  f"frames, .npy): first sample {first:.3f} s, then {rate:.4f} "
                  f"samples/s ({total:.3f} s in all) | a worker initialized CUDA: "
                  f"{any(seen) if workers else 'n/a (in-process)'} | os.cpu_count() "
                  f"{os.cpu_count()} | {card}", flush=True)
            if workers and any(seen):
                raise RuntimeError("a loader worker initialized CUDA")
    del builder
    moving, _ = write_corpus(os.path.join(OUT, "corpus_moving"), MOVING_DRIFT)
    ds = D.PortraitAudioDataset(D.load_metadata([moving]), cfg, D.NpyFrameReader(),
                                audio_feature_reader=D.AudioWindowReader())
    n = LOADER_SAMPLES[0] + 1
    first, rate, total = loader_rate(prefetch_batches, ds, list, 0, n)
    print(f"[11 C8] loader, dataset alone, moving corpus ({MOVING_DRIFT} px a frame, "
          f"dy, dx): 0 workers, {n} samples: first sample {first:.3f} s, then "
          f"{rate:.4f} samples/s ({total:.3f} s in all) | resampled {ds.resampled} "
          f"draws, {ds.resampled / n:.3f} a sample | {card}", flush=True)


def phase11_train(torch, dev, kernels, card, meta, arcface_path):
    """C2: ``training.train.main --metadata`` at the configs/train.yaml
    operating point on the corpus, LOADER_WORKERS workers, the ``.npy``
    reader; each micro-step's seconds and its wait on the loader; the
    launches per micro-step; one captured batch's loss through the kernels
    and through the plain versions; then one micro-step on the first clip
    as an mp4 through the default reader. Returns the launches of the
    ``.npy`` run."""
    import numpy as np

    from actalker_tpu_torch.training import data as D
    from actalker_tpu_torch.training import train
    from actalker_tpu_torch.training.trainer import diffusion_loss, sample_draws

    with open(os.path.join(ROOT, "configs", "train.yaml")) as f:
        text = f.read()
    cfg_path = os.path.join(OUT, "train_real.yaml")
    with open(cfg_path, "w") as f:
        f.write(re.sub(r"num_workers: *\d+.*", f"num_workers: {LOADER_WORKERS}", text)
                + f"\narcface_checkpoint_path: '{arcface_path}'\n")
    seen = {"counts": []}

    def observe(trainer, rec):
        if rec is None:
            step = trainer.step

            def keep_first(batch, **kw):
                seen.setdefault("batch", batch)
                return step(batch, **kw)

            trainer.step = keep_first
            for k in kernels.values():
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
        seen["counts"].append({n: k.launches for n, k in kernels.items()})

    t0 = time.perf_counter()
    res = train.main(["--config", cfg_path, "--metadata", meta, "--steps",
                      str(REAL_MICRO_STEPS), "--output", os.path.join(OUT, "train_real")],
                     observe=observe, frame_reader=D.NpyFrameReader())
    main_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    recs = res["records"]
    per_step = [{n: c1[n] - c0[n] for n in kernels}
                for c0, c1 in zip(seen["counts"], seen["counts"][1:])]
    mods = res["modules"]
    # the batch builder's frozen encoders, a micro-step: the sample's 25
    # frames in VAE calls of 16 (``BatchBuilder``'s encode_chunk) and the
    # reference frame's, and whisper on the clip's one 3000-frame mel window
    vae_enc, whisper = frozen_encoders(torch)
    expect = {**micro_step_launches(),
              **step_norm_launches(mods["unet"], [mods[h] for h in HEADS],
                                   ((-(-25 // 16) + 1, vae_enc), (1, whisper)))}
    tcfg = train.TrainConfig()
    batch = seen["batch"]
    draws = sample_draws(batch, tcfg, torch.Generator(device=dev).manual_seed(5))
    with torch.no_grad():
        loss_k = diffusion_loss(mods, batch, tcfg, draws, dtype=torch.bfloat16)[0].item()
        with plain_ops():
            loss_p = diffusion_loss(mods, batch, tcfg, draws, dtype=torch.bfloat16)[0].item()
    print(f"[11 C2] {REAL_MICRO_STEPS} micro-steps on real batches (train.main "
          f"--metadata, {PX} px x 25 frames, batch 1, accumulation 4, block "
          f"checkpointing, {LOADER_WORKERS} loader workers, .npy frames, seeded "
          f"ArcFace / VAE / whisper / VASA): micro-step seconds "
          f"{[round(r['seconds'], 4) for r in recs]} | loader wait "
          f"{[round(r['load_seconds'], 4) for r in recs]} | encoders "
          f"{[round(r['encode_seconds'], 4) for r in recs]} | main() {main_s:.1f} s | "
          f"peak max_memory_allocated {peak:.2f} GiB | os.cpu_count() {os.cpu_count()} "
          f"| {card}", flush=True)
    print(f"[11 C2] losses {[round(r['loss'], 6) for r in recs]} | commits "
          f"{[r['commit'] for r in recs]} | launches per micro-step {per_step} "
          f"(expected {expect}) | first batch's loss through the kernels {loss_k:.6g}, "
          f"plain {loss_p:.6g} (tol {UNET_TOL} relative) | {card}", flush=True)
    if len(recs) != REAL_MICRO_STEPS or not all(np.isfinite(r["loss"]) for r in recs):
        raise RuntimeError("real-data training losses missing or not finite")
    if any(c != expect for c in per_step):
        raise RuntimeError(f"launches per micro-step {per_step} != {expect}")
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= UNET_TOL * abs(loss_p)):
        raise RuntimeError(f"real batch: loss through the kernels {loss_k} vs plain {loss_p}")
    counts = {n: seen["counts"][-1][n] for n in kernels}
    del res, mods, batch, draws, seen
    torch.cuda.empty_cache()

    # the corpus's first clip as an mp4, through the default reader
    # (frontend/video.read_frames in the loader's workers): one micro-step
    from actalker_tpu_torch.frontend import video as V

    with open(meta) as f:
        clip0 = json.load(f)[0]
    frames = np.load(clip0["video_path"])
    mp4 = os.path.splitext(clip0["video_path"])[0] + ".mp4"
    write_mp4(mp4, frames)
    t0 = time.perf_counter()
    decoded = V.read_frames(mp4)
    decode_s = time.perf_counter() - t0
    meta_mp4 = os.path.join(os.path.dirname(meta), "clips_mp4.json")
    with open(meta_mp4, "w") as f:
        json.dump([dict(clip0, video_path=mp4)], f)
    t0 = time.perf_counter()
    recs = train.main(["--config", cfg_path, "--metadata", meta_mp4, "--steps", "1",
                       "--output", os.path.join(OUT, "train_mp4")])["records"]
    main_s = time.perf_counter() - t0
    print(f"[11 C2] mp4: {os.path.basename(mp4)} {decoded.shape} decoded by "
          f"read_frames in {decode_s:.4f} s, mean |mp4 - npy| "
          f"{np.abs(decoded.astype(np.float32) - frames).mean():.3f} | train.main "
          f"--metadata with the default VideoFrameReader in {LOADER_WORKERS} workers, "
          f"1 micro-step: {recs[0]['seconds']:.4f} s, loader wait "
          f"{recs[0]['load_seconds']:.4f} s, loss {recs[0]['loss']:.6g} | main() "
          f"{main_s:.1f} s | {card}", flush=True)
    if decoded.shape != frames.shape or len(recs) != 1 or not np.isfinite(recs[0]["loss"]):
        raise RuntimeError("training on the mp4 clip: frames or loss wrong")
    return counts


def phase11(torch, dev, kernels, card):
    """C4 (batched serving), C8 (the loader), C2 (training on real data).
    Returns the launches of C4's batched run and of C2."""
    shutil.rmtree(OUT, ignore_errors=True)
    meta, arcface_path = write_corpus(os.path.join(OUT, "corpus"))
    from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline

    pipe = ACTalkerPipeline(seeded_modules(torch, dev), dtype=torch.bfloat16)
    serve = phase11_serving(torch, dev, kernels, card, pipe)
    phase11_loader(torch, dev, card, pipe, meta, arcface_path)
    del pipe
    torch.cuda.empty_cache()
    real = phase11_train(torch, dev, kernels, card, meta, arcface_path)
    torch.cuda.empty_cache()
    shutil.rmtree(OUT, ignore_errors=True)
    return serve, real


def commit_snapshot(modules):
    """Every trainable parameter, copied to the host (phase 7 after its
    first commit: phase 12's reference)."""
    return {name: {k: p.detach().to("cpu", copy=True) for k, p in m.named_parameters()}
            for name, m in modules.items()}


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase12(torch, dev, kernels, card, phase7):
    """``training.train.main --synthetic 4 --dp 1`` under ``init_distributed``
    (torchrun's environment set here: one rank, NCCL) at phase 7's operating
    point, so ZeRO-2 (``ShardedOptimizer``) takes the one commit: losses and
    parameters after the commit against phase 7's first four micro-steps
    (the non-distributed ``Optimizer``, same seeds and batches), launches per
    micro-step derived from the model, seconds and peak memory beside phase
    7's, the per-rank bytes at world 1 / 4 / 8; then SPLIT_IDS identities
    through the rank-split ``generate_latents_batch`` against the same call
    without a group. Returns the launches of the training run and of the
    split call."""
    import torch.distributed as dist

    from actalker_tpu_torch.parallel import distributed as P
    from actalker_tpu_torch.parallel.mesh import per_rank_bytes
    from actalker_tpu_torch.training import train
    from actalker_tpu_torch.training.trainer import ShardedOptimizer

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    if not P.init_distributed("cuda") or dist.get_backend() != "nccl":
        raise RuntimeError("phase 12: no NCCL process group from the environment")
    try:
        shutil.rmtree(OUT, ignore_errors=True)
        seen = {"counts": []}

        def observe(trainer, rec):
            if rec is None:
                if not isinstance(trainer.optimizer, ShardedOptimizer):
                    raise RuntimeError("train.main under a process group did not "
                                       "take the ZeRO-2 optimizer")
                seen["opt"] = trainer.optimizer
                for k in kernels.values():
                    k.launches = 0
                torch.cuda.reset_peak_memory_stats()
            seen["counts"].append({n: k.launches for n, k in kernels.items()})

        t0 = time.perf_counter()
        res = train.main(["--config", os.path.join(ROOT, "configs", "train.yaml"),
                          "--synthetic", str(SHARDED_MICRO_STEPS), "--steps",
                          str(SHARDED_MICRO_STEPS), "--dp", "1", "--output",
                          os.path.join(OUT, "train_sharded")], observe=observe)
        main_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        recs, opt = res["records"], seen.pop("opt")
        per_step = [{n: c1[n] - c0[n] for n in kernels}
                    for c0, c1 in zip(seen["counts"], seen["counts"][1:])]
        secs = sorted(r["seconds"] for r in recs)
        sec_step = (secs[1] + secs[2]) / 2
        loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                    for a, b in zip(recs, phase7["records"])]
        param_rel = {}
        for name, m in res["modules"].items():
            ref = phase7["committed"][name]
            num = den = 0.0
            for k, p in m.named_parameters():
                r = ref[k].to(dev)
                num += float((p.detach() - r).double().square().sum())
                den += float(r.double().square().sum())
            param_rel[name] = math.sqrt(num / den)
        n_params = opt.layout.numel
        held = {"masters": opt.flat.numel() * 4, "moments": 2 * opt.exp_avg.numel() * 4,
                "grads": opt.grad.numel() * 4}
        expect = {**micro_step_launches(),
                  **step_norm_launches(res["modules"]["unet"],
                                       [res["modules"][h] for h in HEADS])}
        print(f"[12 zero2] train.main --synthetic {SHARDED_MICRO_STEPS} --dp 1 under "
              f"init_distributed ({dist.get_backend()}, world {dist.get_world_size()}), "
              f"ShardedOptimizer over {n_params} parameters in {len(opt.layout.buckets)} "
              f"buckets: seconds per micro-step {sec_step:.4f} (median of the middle two "
              f"of {SHARDED_MICRO_STEPS}; phase 7 {phase7['sec_step']:.4f}) {[round(r['seconds'], 4) for r in recs]} | "
              f"peak max_memory_allocated {peak:.2f} GiB (phase 7 "
              f"{phase7['peak_gib']:.2f}) | main() {main_s:.1f} s | {card}", flush=True)
        print(f"[12 zero2] losses {[round(r['loss'], 6) for r in recs]} vs phase 7 "
              f"{[round(r['loss'], 6) for r in phase7['records']]} (rel "
              f"{[f'{x:.3g}' for x in loss_rel]}) | parameters after the commit vs "
              f"phase 7's, rel_l2 { {n: f'{x:.3g}' for n, x in param_rel.items()} } "
              f"(tol {SHARDED_TOL}) | commits {[r['commit'] for r in recs]} | grad_norm "
              f"{recs[-1]['grad_norm']} (phase 7 {phase7['records'][-1]['grad_norm']}) "
              f"| {card}", flush=True)
        gb = {w: {k: round(v / 1e9, 3) for k, v in per_rank_bytes(n_params, w).items()}
              for w in (1, 4, 8)}
        print(f"[12 zero2] per_rank_bytes (GB) {gb} | held by this rank (GB) "
              f"{ {k: round(v / 1e9, 3) for k, v in held.items()} } | launches per "
              f"micro-step {per_step[-1]} (expected {expect})", flush=True)
        if len(recs) != SHARDED_MICRO_STEPS or [r["commit"] for r in recs] != \
                [i == SHARDED_MICRO_STEPS - 1 for i in range(SHARDED_MICRO_STEPS)]:
            raise RuntimeError("ZeRO-2 run: records or commits wrong")
        if any(c != expect for c in per_step):
            raise RuntimeError(f"ZeRO-2 launches per micro-step {per_step} != {expect}")
        if max(loss_rel) > SHARDED_TOL or max(param_rel.values()) > SHARDED_TOL:
            raise RuntimeError("ZeRO-2 at world 1 differs from the non-distributed "
                               "trainer")
        if {k: v for k, v in held.items()} != {k: per_rank_bytes(n_params, 1)[k]
                                              for k in held}:
            raise RuntimeError(f"the rank holds {held}, not per_rank_bytes")
        train_counts = {n: seen["counts"][-1][n] for n in kernels}
        del res, opt, seen
        torch.cuda.empty_cache()
        split_counts = phase12_serving(torch, dev, kernels, card, dist.group.WORLD)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(OUT, ignore_errors=True)
    return train_counts, split_counts


def phase12_serving(torch, dev, kernels, card, group):
    """SPLIT_IDS identities (the phase-5 cut, one step) through
    ``generate_latents_batch`` over ``group`` (world 1: the MAX of the
    budgets and the gather to rank 0 over NCCL) against the same call
    without it. Returns the split call's launches."""
    from actalker_tpu_torch.pipeline import serving
    from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline
    from actalker_tpu_torch.pipeline.sampler import SamplerConfig

    pipe = ACTalkerPipeline(seeded_modules(torch, dev), dtype=torch.bfloat16)
    scfg = SamplerConfig(num_inference_steps=1, frames_per_batch=FRAMES,
                         windows_per_call=1, gate=(1, 1))
    plan, bufs, refs, states = serve_inputs(pipe, scfg, torch, SPLIT_IDS)

    def prepared():
        out = []
        for i, (b, s) in enumerate(zip(bufs, states)):
            g = torch.Generator(device=dev)
            g.set_state(s)
            out.append((plan, b, refs[i], g))
        return out

    runs = {}
    for name, kw in (("alone", {}), ("split", {"group": group})):
        pipe.generate_latents_batch(prepared(), scfg, **kw)          # warm-up
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        lat = pipe.generate_latents_batch(prepared(), scfg, **kw)
        torch.cuda.synchronize()
        runs[name] = (lat, time.perf_counter() - t0,
                      {n: k.launches for n, k in kernels.items()})
    (a, sec_a, _), (b, sec_b, counts) = runs["alone"], runs["split"]
    # the split call's budget covers every identity's masks (world 1: its
    # MAX is theirs)
    stacked = serving.stack_buffers(bufs)
    caps = pipe._capacity_fracs(scfg, stacked.audio_mask[:, 0], stacked.exp_mask[:, 0],
                                (PX // 8, PX // 8))
    per = forward_launches(pipe.m.unet, caps)
    want = {n: per.get(n, 0) * unet_calls(scfg, FRAMES) for n in kernels}
    want.update(norm_sum(((unet_calls(scfg, FRAMES), norm_launches(pipe.m.unet)),)))
    rel = errors(b, a)[1]
    print(f"[12 serve] {SPLIT_IDS} identities, {PX} px x {FRAMES} frames, 1 step, "
          f"mode 2 with face-box masks: rank-split generate_latents_batch (NCCL, world "
          f"1) {sec_b:.4f} s vs without a group {sec_a:.4f} s | latents "
          f"{tuple(b.shape)} rel_l2 {rel:.3g} (tol {SPLIT_TOL}) | launches {counts} "
          f"(derived {want}) | {card}", flush=True)
    if b.shape != a.shape or not torch.isfinite(b).all() or rel > SPLIT_TOL:
        raise RuntimeError(f"rank-split serving differs from the call without a group "
                           f"(rel_l2 {rel})")
    if counts != want:
        raise RuntimeError(f"rank-split serving launches {counts} != derived {want}")
    del pipe, runs, a, b
    torch.cuda.empty_cache()
    return counts


def eval_cases(torch):
    """The six evaluation networks' seeded inputs at the path's sizes and
    how each is called: key -> (inputs, call(net, *inputs))."""
    import numpy as np

    r = np.random.default_rng(13)

    def u(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(r.uniform(lo, hi, shape).astype(np.float32))

    return {
        "syncnet": ((u(20, 1, 13, 20, lo=-20, hi=20), u(4, 3, 5, 224, 224, hi=255)),
                    lambda n, a, l: (n.forward_aud(a), n.forward_lip(l))),
        "s3fd": ((u(1, 3, 128, 128, lo=-120, hi=130),), lambda n, x: n(x)),
        "fid_inception": ((u(4, 3, 299, 299),), lambda n, x: n(x)),
        "i3d": ((u(2, 3, 16, 224, 224),), lambda n, x: n(x)),
        "senet50": ((u(4, 3, 224, 224, lo=-120, hi=140),), lambda n, x: n(x)),
        "lpips": ((u(4, 3, 256, 256, lo=-1), u(4, 3, 256, 256, lo=-1)),
                  lambda n, x, y: n(x, y)),
    }


def write_eval_clips(out):
    """Two generated / reference pairs of EVAL_FRAMES frames at PX px as
    ``.npy`` stacks (a seeded block scene drifting a pixel a frame; the
    reference shifted in value), a 16 kHz tone as each clip's WAV beside
    it, and a reference image each. Returns the three directories."""
    import wave

    import numpy as np
    from PIL import Image

    dirs = {k: os.path.join(out, k) for k in ("gen", "ref", "img")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    r = np.random.default_rng(14)
    for i in range(2):
        scene = r.integers(16, 240, (PX // 8, PX // 8, 3)).repeat(8, 0).repeat(8, 1)
        for kind, shift in (("gen", 0), ("ref", 9)):
            frames = np.stack([np.clip(np.roll(scene, t, 1) + shift, 0, 255)
                               for t in range(EVAL_FRAMES)]).astype(np.uint8)
            np.save(os.path.join(dirs[kind], f"clip{i}.npy"), frames)
            t = np.arange(int(EVAL_FRAMES / 25 * 16000)) / 16000
            with wave.open(os.path.join(dirs[kind], f"clip{i}.wav"), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(16000)
                w.writeframes((0.3 * np.sin(2 * np.pi * (200 + 60 * i) * t) * 32767)
                              .astype(np.int16).tobytes())
        Image.fromarray(scene[::2, ::2].astype(np.uint8)).save(
            os.path.join(dirs["img"], f"clip{i}.png"))
    return dirs


def phase13(torch, dev, card):
    """The evaluation entry point: the six networks seeded at their
    published widths and saved as the reference's files
    (``tools/eval_weights.py``), each loaded on the card and on the CPU and
    run on the same inputs (rel L2, ms on the card); ``run_eval.main --npy
    --device cuda`` over two generated / reference clip pairs of
    EVAL_FRAMES frames; the seconds of each metric's work on one clip; and
    ``SyncEvaluator.evaluate_tube`` on a seeded 30-frame tube, card
    against CPU."""
    import numpy as np

    from actalker_tpu_torch.evaluation import run_eval as R
    from actalker_tpu_torch.evaluation.lpips import lpips_distance
    from actalker_tpu_torch.evaluation.sync_eval import SyncEvaluator, evaluate_sync
    from actalker_tpu_torch.io import init as I
    from actalker_tpu_torch.tools.eval_weights import EVAL_FILES, write_seeded_weights

    out = os.path.join(OUT, "eval")
    shutil.rmtree(out, ignore_errors=True)
    weights = os.path.join(out, "weights")
    paths = write_seeded_weights(weights, seed=0)
    loaders = {"syncnet": I.load_syncnet, "s3fd": I.load_s3fd,
               "fid_inception": I.load_fid_inception, "i3d": I.load_i3d,
               "senet50": I.load_senet50, "lpips": I.load_lpips}
    for key, (inputs, call) in eval_cases(torch).items():
        card_net, cpu_net = loaders[key](paths[key], dev), loaders[key](paths[key], "cpu")
        on_card = [x.to(dev) for x in inputs]
        with torch.no_grad():
            y_card = flat_output(torch, call(card_net, *on_card))
            y_cpu = flat_output(torch, call(cpu_net, *inputs))
            ms = timed(torch, lambda: call(card_net, *on_card), 5)
        rel = float((y_card - y_cpu).norm() / y_cpu.norm())
        n_params = sum(p.numel() for p in card_net.parameters())
        print(f"[13 net] {key} ({EVAL_FILES[key][0]}, {n_params} parameters, "
              f"strict=True): card vs CPU rel_l2 {rel:.3g} (tol {FACE_NET_TOL}) over "
              f"{y_cpu.numel()} outputs | {ms:.4f} ms a call on inputs "
              f"{[tuple(x.shape) for x in inputs]} | {card}", flush=True)
        if not (rel <= FACE_NET_TOL and torch.isfinite(y_card).all()):
            raise RuntimeError(f"{key}: card vs CPU rel_l2 {rel}")
        del card_net, cpu_net, on_card
    torch.cuda.empty_cache()

    dirs = write_eval_clips(out)
    argv = ["--video_dir", dirs["gen"], "--ref_video_dir", dirs["ref"], "--image_dir",
            dirs["img"], "--weights_dir", weights, "--out", os.path.join(out, "r.jsonl"),
            "--device", dev.type, "--npy"]
    t0 = time.perf_counter()
    recs = R.main(argv)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs2 = R.main(argv)
    again = time.perf_counter() - t0
    summary = recs[-1]

    def same(a, b):
        return a.keys() == b.keys() and all(
            math.isclose(v, b[k], rel_tol=1e-3, abs_tol=1e-4)
            if isinstance(v, float) else v == b[k] for k, v in a.items())

    print(f"[13 run_eval] run_eval.main --npy --device {dev.type} over 2 clip pairs of "
          f"{EVAL_FRAMES} frames at {PX} px, seeded weights: {first:.3f} s (loads "
          f"included), again {again:.3f} s | summary {summary} | clip records "
          f"{recs[:-1]} | {card}", flush=True)
    scores = ("id_cosine", "psnr", "l1", "lpips", "fid", "fvd")
    if len(recs) != 3 or not all(same(a, b) for a, b in zip(recs, recs2)) or not all(
            summary[k] is not None and math.isfinite(summary[k]) for k in scores) \
            or any(r.get("sync_note") != "no face track" for r in recs[:-1]):
        raise RuntimeError(f"run_eval: records malformed or not repeatable: {recs}")

    # one pair as mp4s, read by the default VideoClipReader; the audio from
    # the WAV beside it (the mp4 holds none, and the card's machine has no
    # decoder for an mp4's audio track)
    mp4_dirs = {k: os.path.join(out, f"{k}_mp4") for k in ("gen", "ref")}
    for k, d in mp4_dirs.items():
        os.makedirs(d, exist_ok=True)
        write_mp4(os.path.join(d, "clip0.mp4"), np.load(os.path.join(dirs[k], "clip0.npy")))
        shutil.copy(os.path.join(dirs[k], "clip0.wav"), d)
    t0 = time.perf_counter()
    decoded = R.VideoClipReader().frames(os.path.join(mp4_dirs["gen"], "clip0.mp4"))
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs_mp4 = R.run(mp4_dirs["gen"], mp4_dirs["ref"], dirs["img"], weights,
                     os.path.join(out, "r_mp4.jsonl"), device=dev.type,
                     audio_reader=R.wav_beside)
    mp4_s = time.perf_counter() - t0
    print(f"[13 run_eval] mp4: clip0.mp4 {decoded.shape} decoded by the default "
          f"VideoClipReader in {decode_s:.4f} s | run_eval.run over 1 mp4 pair, the "
          f"WAV beside it: {mp4_s:.3f} s | clip record {recs_mp4[0]} (the .npy "
          f"run's: {recs[0]}) | {card}", flush=True)
    rec = recs_mp4[0]
    if len(recs_mp4) != 2 or rec["frames"] != EVAL_FRAMES or not all(
            rec[k] is not None and math.isfinite(rec[k])
            for k in ("id_cosine", "psnr", "l1", "lpips")):
        raise RuntimeError(f"run_eval on the mp4 pair: record malformed: {recs_mp4}")

    # each metric's work on one clip pair, warm
    models = R.EvalModels(weights, dev)
    reader = R.NpyClipReader()
    gen0, ref0 = (os.path.join(dirs[k], "clip0.npy") for k in ("gen", "ref"))
    f, g = reader.frames(gen0), reader.frames(ref0)
    f01, g01 = f.astype(np.float32) / 255.0, g.astype(np.float32) / 255.0
    syncnet, s3fd = models.sync()
    x, y = (torch.from_numpy(v * 2 - 1).to(dev) for v in (f01, g01))
    work = {
        "sync (S3FD on every frame, scenes, tracks)": lambda: evaluate_sync(
            gen0, syncnet, s3fd, reader, R.wav_beside),
        "id_cosine (SENet-50)": lambda: models.face_embed()(f),
        "lpips": lambda: lpips_distance(models.lpips(), x, y),
        "fid features (InceptionV3)": lambda: models.inception()(
            R.resize_frames01(f01, 299, dev)),
        "fvd features (I3D, 16 frames)": lambda: models.i3d()(
            R.resize_frames01(f01[:16], 224, dev)[None]),
    }
    secs = {}
    for name, fn in work.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t0, 4)
    print(f"[13 metrics] seconds on one {EVAL_FRAMES}-frame {PX} px clip, warm: {secs} "
          f"| {card}", flush=True)

    # SyncNet scoring on a seeded tube, card against CPU
    r = np.random.default_rng(15)
    tube = r.integers(0, 255, (30, 224, 224, 3), dtype=np.uint8)
    audio = (r.standard_normal(int(30 / 25 * 16000)) * 3000).astype(np.int16)
    t0 = time.perf_counter()
    on_card = SyncEvaluator(syncnet=syncnet).evaluate_tube(tube, audio)
    tube_s = time.perf_counter() - t0
    on_cpu = SyncEvaluator(syncnet=I.load_syncnet(paths["syncnet"], "cpu")).evaluate_tube(
        tube, audio)
    rel = max(abs(a - b) / abs(b) for a, b in zip(on_card[1:], on_cpu[1:]))
    print(f"[13 sync] evaluate_tube, 30 frames: card {on_card} in {tube_s:.4f} s, CPU "
          f"{on_cpu} (offset equal, confidence / distance rel {rel:.3g}, tol "
          f"{SYNC_TOL}) | {card}", flush=True)
    if on_card[0] != on_cpu[0] or rel > SYNC_TOL:
        raise RuntimeError(f"evaluate_tube on the card {on_card} vs CPU {on_cpu}")
    del models, syncnet, s3fd, x, y
    torch.cuda.empty_cache()
    shutil.rmtree(OUT, ignore_errors=True)


# phase 14: DWPose, the data tools, pre-encoded batches, windows split over
# ranks, tensor parallelism (per-rank kernel shapes, a two-process tp = 2
# step on the one card over gloo)
DWPOSE_TOL = 1e-4          # card vs CPU rel L2 of YOLOX-L / RTMPose-l (fp32)
CURATE_CLIPS, CURATE_FRAMES = 2, 8
# the tp = 2 step: full widths, one layer a block (the JAX package's
# flagship TP test), 256 px, 4 frames, batch 1, block checkpointing, bf16
TP_HW, TP_FRAMES = 32, 4
# bf16 compute: a tp rank sums its partial products in another order
TP_LOSS_TOL, TP_UPDATE_TOL = 2e-2, 5e-2


def tp_unet_config():
    import dataclasses

    from actalker_tpu_torch.models.unet import UNetConfig

    return dataclasses.replace(UNetConfig(), layers_per_block=1,
                               gradient_checkpointing=True)


def micro_step_launches_of(unet, heads=()):
    """Launches per training micro-step with one checkpoint scope per block,
    derived from ``unet`` and the ``heads`` the step runs: every forward
    kernel twice (forward, recompute), K6 once per (SS2D block, group),
    K2-bwd once per spatial self-attention, K7 and the plain norm calls as
    ``step_norm_launches`` counts them, K8 and the SSM gather's delta add
    none (training takes the masked-dense path)."""
    f = forward_launches(unet)
    return {**{n: 2 * c for n, c in f.items()},
            "ssm_scan_bwd": 4 * f["ssm_scan_grouped"], "mha_bwd": f["mha"],
            "ssm_scan": 0, "gather_delta_add": 0, **step_norm_launches(unet, heads)}


def tp_step_rank(rank, world, port, out):
    """One rank of the tp = 2 step on the card (gloo takes CUDA tensors;
    NCCL refuses two ranks on one device). Rank 0 first runs the two
    micro-steps (a commit each) of the seeded tp_unet_config() model and
    heads unsliced, alone, keeping its parameters on the host; then both
    ranks run the same two steps sliced over the two ranks, the second
    counted and timed, and rank 0 compares the gathered update with its
    own."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from actalker_tpu_torch.ops import mha, mlp, norms, resconv, selective_scan as ss
    from actalker_tpu_torch.parallel import distributed as P
    from actalker_tpu_torch.parallel.tensor import TPGroup, shard_modules_
    from actalker_tpu_torch.training import train
    from actalker_tpu_torch.training.trainer import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    kernels = {k.name: k for k in (ss.KERNEL, ss.ARRANGED_KERNEL, mha.MHA_KERNEL,
                                   mha.FRAME_KERNEL, mlp.KERNEL, ss.BWD_KERNEL,
                                   mha.MHA_BWD_KERNEL, norms.LN_KERNEL,
                                   norms.GN_KERNEL, resconv.KERNEL,
                                   ss.DELTA_KERNEL)}
    count_plain_norms(kernels)
    tcfg = TrainConfig(grad_accum_steps=1, learning_rate=1e-4, adam_eps=1.0,
                       max_grad_norm=1e6)

    def run(mods, trainer):
        batch = next(train.synthetic_batches(1, TP_FRAMES, TP_HW, seed=0, device=dev))
        gen = torch.Generator(device=dev).manual_seed(7)
        rec = []
        for step in range(2):
            torch.cuda.synchronize()
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            m = trainer.step(batch, generator=gen)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            rec.append({"loss": loss, "seconds": time.perf_counter() - t0,
                        "grad_norm": float(m["grad_norm"]),
                        "counts": {n: k.launches for n, k in kernels.items()}})
        return rec

    def host(mods, params=None):
        return {n: {k: p.detach().float().cpu() for k, p in
                    (params[n] if params else m.named_parameters())}
                for n, m in mods.items()}

    try:
        dp_group, tp_group, _, i_tp = P.mesh_groups(1, world)
        res = {}
        if rank == 0:
            single = train.build_modules(tp_unet_config(), dev, torch.bfloat16)
            p0 = host(single)
            res["single"] = run(single, Trainer(single, tcfg, torch.bfloat16))
            after = host(single)
            del single
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        mods = train.build_modules(tp_unet_config(), dev, torch.bfloat16)
        plan = shard_modules_(mods, TPGroup(tp_group, world, i_tp))
        res["n_sliced_local"] = sum(p.numel() for p in plan.sharded_params(mods))
        res["launches_derived"] = micro_step_launches_of(mods["unet"],
                                                         [mods[h] for h in HEADS])
        torch.cuda.reset_peak_memory_stats()
        res["records"] = run(mods, Trainer(mods, tcfg, torch.bfloat16, sharded=True,
                                           group=dp_group, tp_plan=plan))
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        whole = host(mods, {n: plan.gather(n, dict(m.named_parameters())).items()
                            for n, m in mods.items()})
        if rank == 0:
            res["update_rel"] = {}
            for n, ref in after.items():
                num = den = 0.0
                for k, b in ref.items():
                    a = whole[n][k].double() - p0[n][k].double()
                    b = b.double() - p0[n][k].double()
                    num += float((a - b).square().sum())
                    den += float(b.square().sum())
                res["update_rel"][n] = math.sqrt(num / max(den, 1e-300))
        torch.save(res, os.path.join(out, f"tp_rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def sharpen_(torch, convs, rows, probe, shift_to, k):
    """A seeded detector's objectness is near one value at every anchor
    (every score a tie, or every anchor a candidate). Rescale rows ``rows``
    of its 1x1 prediction ``convs`` so that, on ``probe()`` (the convs'
    outputs on a frame, those rows), the logits have mean 0 and std 1 and
    the k-th largest sits at ``shift_to``: a few anchors pass the score
    gates, each with its own score, as with a trained detector."""
    with torch.no_grad():
        logits = probe()
        mu, sd = float(logits.mean()), float(logits.std())
        top = float(logits.sort(descending=True).values[k - 1])
        shift = shift_to - (top - mu) / sd
        for conv in convs:
            conv.weight[rows] /= sd
            conv.bias[rows] = (conv.bias[rows] - mu) / sd + shift


def head_outputs(torch, convs, run):
    """Each of ``convs``' outputs while ``run()`` goes, flattened per
    channel: (channels, positions over all convs)."""
    outs = []
    hooks = [c.register_forward_hook(lambda m, i, o: outs.append(
        o.detach().float().transpose(0, 1).flatten(1))) for c in convs]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return torch.cat(outs, 1).cpu()


def phase14(torch, dev, kernels, card, results):
    """DWPose, the data tools, pre-encoded batches, windows split over
    ranks and tensor parallelism on the card. Returns the launches of the
    pre-encoded micro-step, of the window-split clip and of rank 0's tp
    micro-step."""
    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from actalker_tpu_torch.frontend.pose_draw import Wholebody, draw_pose
    from actalker_tpu_torch.io import init as I
    from actalker_tpu_torch.models import rtmpose, yolox
    from actalker_tpu_torch.tools import curate_data, eval_weights

    shutil.rmtree(OUT, ignore_errors=True)
    out = os.path.join(OUT, "phase14")
    counts = {}
    print(f"[14 start] this process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
          "GiB of the card", flush=True)

    # ---- DWPose: YOLOX-L and RTMPose-l seeded, saved, loaded on both sides
    paths = eval_weights.write_seeded_dwpose(out)
    r = np.random.default_rng(14)
    ins = {"yolox": r.uniform(0, 255, (1, 640, 640, 3)).astype(np.float32),
           "dwpose": r.standard_normal((1, 384, 288, 3)).astype(np.float32)}
    nets = {}
    for key, load in (("yolox", I.load_yolox), ("dwpose", I.load_dwpose)):
        on_card, on_cpu = load(paths[key], dev), load(paths[key], "cpu")
        x = torch.from_numpy(ins[key])
        with torch.no_grad():
            y_c = flat_output(torch, on_card(x.to(dev)))
            y_p = flat_output(torch, on_cpu(x))
            ms = timed(torch, lambda: on_card(x.to(dev)), 5)
        rel = errors(y_c, y_p)[1]
        print(f"[14 dwpose] {os.path.basename(paths[key])} "
              f"({sum(p.numel() for p in on_card.parameters())} parameters, "
              f"input {tuple(x.shape)}): card vs CPU rel_l2 {rel:.3g} (tol "
              f"{DWPOSE_TOL}) | {ms:.4f} ms a call | {card}", flush=True)
        if not (torch.isfinite(y_c).all() and rel <= DWPOSE_TOL):
            raise RuntimeError(f"{key} on the card differs from the CPU")
        nets[key] = (on_card, on_cpu)
    # the seeded head made detector-like (``sharpen_``): person class only,
    # boxes of e^2 strides, the 4th strongest anchor of a 512 px frame at
    # score 0.3
    frames = {(h, w): r.integers(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in ((512, 512), (720, 1280))}
    with torch.no_grad():
        for net in nets["yolox"]:
            for i in range(3):
                net.head.cls_preds[i].weight.zero_()
                net.head.cls_preds[i].bias.fill_(-10.0)
                net.head.cls_preds[i].bias[0] = 3.0
                net.head.reg_preds[i].bias[2:4] += 2.0
    card_net = nets["yolox"][0]
    padded = torch.from_numpy(yolox.letterbox(frames[(512, 512)], (640, 640))[0])[None]
    obj = [card_net.head.obj_preds[i] for i in range(3)]
    logits = head_outputs(torch, obj, lambda: card_net(padded.to(dev)))[0]
    for net in nets["yolox"]:
        sharpen_(torch, [net.head.obj_preds[i] for i in range(3)], [0],
                 lambda: logits, -0.78, 4)
    det_c, det_p = (yolox.YoloXPersonDetector(n) for n in nets["yolox"])
    pose_c, pose_p = (rtmpose.RTMPoseWholebody(n) for n in nets["dwpose"])
    wholebody = Wholebody(det_c, pose_c)
    for (h, w), img in frames.items():
        wholebody(img)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kp, sc = wholebody(img)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        boxes_c, boxes_p = det_c(img), det_p(img)
        box_err = (float(np.abs(boxes_c - boxes_p).max()) if boxes_c.shape == boxes_p.shape
                   and len(boxes_c) else None)
        mine = boxes_c[:2]
        (kc, scc), (kq, scq) = pose_c(img, mine), pose_p(img, mine)
        kerr, serr = float(np.abs(kc - kq).max()), float(np.abs(scc - scq).max())
        # the seeded pose head's SimCC maxima are no probabilities: clipped
        # to [0, 1] for the renderer's colour scale
        canvas = draw_pose({"bodies": {"candidate": kp[0, :18] / [w, h],
                                       "subset": np.arange(18)[None].astype(float),
                                       "score": np.clip(sc[:1, :18], 0.0, 1.0)}}, h, w)
        print(f"[14 dwpose] Wholebody {w}x{h}: {sec:.4f} s a frame, {len(kp)} "
              f"person(s) (boxes card {len(boxes_c)}, CPU {len(boxes_p)}, max abs "
              f"{box_err} px) | the first {max(len(mine), 1)} box(es)' keypoints card "
              f"vs CPU max abs {kerr:.3g} px, scores {serr:.3g} | canvas "
              f"{canvas.shape} | {card}", flush=True)
        if len(boxes_c) != len(boxes_p) or (box_err or 0.0) > 1e-2 or kerr > 1e-2 \
                or serr > 1e-3 or not np.isfinite(kp).all():
            raise RuntimeError("Wholebody on the card differs from the CPU")
    del nets, det_c, det_p, pose_c, pose_p, wholebody
    torch.cuda.empty_cache()

    # ---- curate_data on phase 11's .npy corpus with a yolov5-face file
    from actalker_tpu_torch.models.yoloface import YoloFaceNet

    meta, _ = write_corpus(os.path.join(out, "corpus"))
    from actalker_tpu_torch.models.yoloface import YoloFaceDetector

    face = eval_weights.seeded(YoloFaceNet, 3)
    with open(meta) as f:
        first = np.load(json.load(f)[0]["video_path"], mmap_mode="r")[0]
    detect = face.model[23].m
    with torch.no_grad():        # the face class certain; objectness sharpened
        for conv in detect:      # so that ~20 anchors of a frame pass 0.5
            conv.weight.view(3, 16, -1)[:, 15] = 0.0
            conv.bias.view(3, 16)[:, 15] = 6.0
    obj_rows = [a * 16 + 4 for a in range(3)]
    probe = YoloFaceDetector(face).letterbox(np.ascontiguousarray(first[..., ::-1]))
    logits = head_outputs(torch, detect, lambda: face(probe))[obj_rows].flatten()
    sharpen_(torch, detect, obj_rows, lambda: logits, 0.0, 20)
    face_path = os.path.join(out, "yolov5m-face.pth")
    torch.save(face.state_dict(), face_path)
    with open(meta) as f:
        clips = [c["video_path"] for c in json.load(f)][:CURATE_CLIPS]
    recs = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res = curate_data.main([os.path.join(out, f"{where}.json"), *clips,
                                "--max-frames", str(CURATE_FRAMES), "--yoloface",
                                face_path, "--device", where])
        recs[where] = (res, time.perf_counter() - t0)
    (a, sec_a), (b, sec_b) = recs["cuda"], recs["cpu"]
    same = len(a["clips"]) == len(b["clips"]) == CURATE_CLIPS and all(
        x[k] == y[k] for x, y in zip(a["clips"], b["clips"])
        for k in ("video_path", "audio_path", "frames", "fps", "motion_bucket"))
    geo = max((float(np.abs(np.asarray(x[k]) - np.asarray(y[k])).max())
               for x, y in zip(a["clips"], b["clips"]) for k in ("bboxes", "landmarks")),
              default=float("nan"))
    qual = max((abs(x["quality"] - y["quality"]) / max(abs(y["quality"]), 1e-9)
                for x, y in zip(a["clips"], b["clips"])), default=float("nan"))
    print(f"[14 curate] curate_data --yoloface on {CURATE_CLIPS} .npy clips x "
          f"{CURATE_FRAMES} frames at {PX} px: card {sec_a / CURATE_CLIPS:.4f} s a clip "
          f"({a['detector'].passes} network passes), CPU {sec_b / CURATE_CLIPS:.4f} s "
          f"a clip | records card vs CPU: fields equal {same}, boxes / landmarks max "
          f"abs {geo:.3g} px, quality rel {qual:.3g} | {card}", flush=True)
    if not (same and geo <= 1e-2 and qual <= 1e-4
            and a["detector"].passes == CURATE_CLIPS * CURATE_FRAMES):
        raise RuntimeError("curate_data on the card differs from the CPU run")

    # ---- one pre-encoded micro-step at phase 7's point: the UNet alone
    from actalker_tpu_torch.models.unet import UNetConfig
    from actalker_tpu_torch.training import train
    from actalker_tpu_torch.training.trainer import (
        Trainer, TrainConfig, diffusion_loss, sample_draws)

    unet = train.build_modules(UNetConfig(gradient_checkpointing=True), dev,
                               torch.bfloat16)["unet"]
    tcfg = TrainConfig(grad_accum_steps=4)
    trainer = Trainer({"unet": unet}, tcfg, torch.bfloat16)
    batch = next(train.synthetic_batches(1, 25, PX // 8, seed=0, device=dev,
                                         raw_heads=False, c0=320))
    gen = torch.Generator(device=dev).manual_seed(0)
    trainer.step(batch, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    m = trainer.step(batch, generator=gen)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts["train_pre_encoded"] = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = micro_step_launches_of(unet)
    draws = sample_draws(batch, tcfg, torch.Generator(device=dev).manual_seed(5))
    with torch.no_grad():
        loss_k = diffusion_loss({"unet": unet}, batch, tcfg, draws, dtype=torch.bfloat16)[0].item()
        with plain_ops():
            loss_p = diffusion_loss({"unet": unet}, batch, tcfg, draws,
                                    dtype=torch.bfloat16)[0].item()
    print(f"[14 pre-encoded] Trainer({{'unet'}}) on a raw_heads=False batch ({PX} px x "
          f"25 frames, batch 1, accumulation 4, block checkpointing): micro-step "
          f"{sec:.4f} s, loss {loss:.6g} | peak max_memory_allocated {peak:.2f} GiB | "
          f"launches {counts['train_pre_encoded']} (derived {want}) | loss through the "
          f"kernels {loss_k:.6g}, plain {loss_p:.6g} (tol {UNET_TOL} relative) | {card}",
          flush=True)
    if counts["train_pre_encoded"] != want:
        raise RuntimeError(f"pre-encoded micro-step launches != {want}")
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= UNET_TOL * abs(loss_p)):
        raise RuntimeError(f"pre-encoded loss through the kernels {loss_k} vs plain {loss_p}")
    del unet, trainer, batch
    torch.cuda.empty_cache()

    # ---- windows split over ranks: sample_video(group=) at world 1 (NCCL)
    from actalker_tpu_torch.parallel import distributed as P
    from actalker_tpu_torch.pipeline.pipeline import ACTalkerPipeline
    from actalker_tpu_torch.pipeline.sampler import SamplerConfig

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    if not P.init_distributed("cuda") or dist.get_backend() != "nccl":
        raise RuntimeError("phase 14: no NCCL process group from the environment")
    try:
        pipe = ACTalkerPipeline(seeded_modules(torch, dev), dtype=torch.bfloat16)
        scfg = SamplerConfig(num_inference_steps=1, frames_per_batch=FRAMES,
                             windows_per_call=1, gate=(1, 1))
        rng = np.random.default_rng(0)
        args = (rng.standard_normal((PX, PX, 3)).astype(np.float32) * 0.2,
                rng.standard_normal(512).astype(np.float32),
                rng.standard_normal((FRAMES, 32, 1024)).astype(np.float32),
                np.zeros((FRAMES, 32, 1024), np.float32),
                rng.standard_normal((FRAMES, 1, 1024)).astype(np.float32),
                np.zeros((FRAMES, 1, 1024), np.float32),
                rng.random((FRAMES, PX, PX, 3)).astype(np.float32))
        runs = {}
        for name, kw in (("alone", {}), ("split", {"group": dist.group.WORLD})):
            pipe.generate_latents(*args, scfg, seed=3, **kw)        # warm-up
            torch.cuda.synchronize()
            for k in kernels.values():
                k.launches = 0
            t0 = time.perf_counter()
            lat = pipe.generate_latents(*args, scfg, seed=3, **kw)
            torch.cuda.synchronize()
            runs[name] = (lat, time.perf_counter() - t0,
                          {n: k.launches for n, k in kernels.items()})
        (la, sa, _), (lb, sb, cb) = runs["alone"], runs["split"]
        per = forward_launches(pipe.m.unet)
        want = {n: per.get(n, 0) * unet_calls(scfg, FRAMES) for n in kernels}
        # per UNet call, the two VAE encodes and the heads, as phase 5
        want.update(norm_sum(((unet_calls(scfg, FRAMES), norm_launches(pipe.m.unet)),
                              (2, norm_launches(pipe.m.vae.encoder)),
                              (1, norm_launches(pipe.m.id_proj, pipe.m.pose_guider)))))
        rel = errors(lb, la)[1]
        counts["sample_split_windows"] = cb
        print(f"[14 windows] generate_latents(group=) ({PX} px x {FRAMES} frames, 1 "
              f"step, mode 2; NCCL, world 1: the rank's block is every window, one "
              f"all-reduce a step) {sb:.4f} s vs without a group {sa:.4f} s | rel_l2 "
              f"{rel:.3g} (tol {SPLIT_TOL}) | launches {cb} (derived {want}) | {card}",
              flush=True)
        if rel > SPLIT_TOL or not torch.isfinite(lb).all() or cb != want:
            raise RuntimeError("sample_video(group=) differs from the call without one")
        del pipe, runs, la, lb
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # ---- tensor parallelism: the kernels at one tp = 2 rank's shapes
    per_rank = {}
    check_kernels(torch, kernel_cases(torch, dev, torch.Generator(device=dev).manual_seed(2),
                                      tp=2), per_rank, card, "14 tp kernel")
    for n, rr in per_rank.items():
        results[n]["max_abs_err"] = max(results[n]["max_abs_err"], rr["max_abs_err"])
        results[n]["tp2_rank"] = rr
    # the bytes a rank holds at flagship widths (meta tensors: shapes only)
    from actalker_tpu_torch.parallel.mesh import per_rank_bytes_tp
    from actalker_tpu_torch.parallel.tensor import TPGroup, shard_modules_

    from actalker_tpu_torch.models.unet import UNetSpatioTemporalCondition

    with torch.device("meta"):
        flag = UNetSpatioTemporalCondition(UNetConfig())
    n_all = sum(p.numel() for p in flag.parameters())
    plan = shard_modules_({"unet": flag}, TPGroup(None, 2, 0))
    n_half = sum(p.numel() for p in plan.sharded_params({"unet": flag}))
    n_sl = 2 * n_half
    gb = {f"dp{dp} x tp{tp}": round(per_rank_bytes_tp(n_sl if tp > 1 else 0,
                                                      n_all - n_sl if tp > 1 else n_all,
                                                      dp, tp)["total"] / 1e9, 3)
          for dp, tp in ((1, 1), (1, 2), (4, 2), (8, 1))}
    print(f"[14 tp] UNetConfig(): {n_all} parameters, {n_sl} of them in tp slices "
          f"({sum(map(len, plan.layouts.values()))} tensors) | per_rank_bytes_tp "
          f"(GB) {gb}", flush=True)
    del flag, plan

    # ---- a two-process tp = 2 step on the card (gloo); this process's
    # cached blocks go back first: the two ranks and the one-process
    # reference share the card with it
    gc.collect()
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_allocated() / 2 ** 30, torch.cuda.memory_reserved() / 2 ** 30)
    t0 = time.perf_counter()
    mp.start_processes(tp_step_rank, args=(2, free_port(), out), nprocs=2, join=True,
                       start_method="spawn")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"tp_rank{i}.pt"), weights_only=False)
             for i in range(2)]
    r0 = ranks[0]
    single = r0["single"]
    loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(r0["records"], single)]
    want = r0["launches_derived"]
    counts["train_tp2"] = r0["records"][1]["counts"]
    print(f"[14 tp] tp = 2 on the card, two processes over gloo, "
          f"layers_per_block 1 at full widths, {TP_HW * 8} px x {TP_FRAMES} frames, "
          f"batch 1, block checkpointing, bf16: micro-step seconds tp "
          f"{[round(x['seconds'], 4) for x in r0['records']]} vs one process "
          f"{[round(x['seconds'], 4) for x in single]} | peak max_memory_allocated a "
          f"rank {[round(x['peak_gib'], 2) for x in ranks]} GiB | losses "
          f"{[round(x['loss'], 6) for x in r0['records']]} vs "
          f"{[round(x['loss'], 6) for x in single]} (rel "
          f"{[f'{x:.3g}' for x in loss_rel]}, tol {TP_LOSS_TOL}) | update after two "
          f"commits vs one process, rel_l2 "
          f"{ {n: f'{x:.3g}' for n, x in r0['update_rel'].items()} } (tol "
          f"{TP_UPDATE_TOL}) | launches a rank {[x['records'][1]['counts'] for x in ranks]} "
          f"(derived {want}) | {wall:.1f} s in all, this process holding "
          f"{held[0]:.2f} GiB ({held[1]:.2f} reserved) | {card}", flush=True)
    if max(loss_rel) > TP_LOSS_TOL or max(r0["update_rel"].values()) > TP_UPDATE_TOL:
        raise RuntimeError("the tp = 2 step differs from the one-process step")
    if any(x["records"][1]["counts"] != want for x in ranks) or single[1]["counts"] != want:
        raise RuntimeError(f"tp = 2 launches a rank != derived {want}")
    shutil.rmtree(OUT, ignore_errors=True)
    return counts


def check_kernels(torch, cases, results, card, tag):
    """Each case of ``kernel_cases``: the kernel against its plain version
    (within ``TOL``), CUDA-event times of both, of the library call and of
    the extras, one line each; ``results`` keeps each kernel's first case's
    numbers and the largest error over all its cases."""
    for name, label, kern, plain, lib, (bound_ms, bound_by), *rest in cases:
        extras = rest[0] if rest else {}
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        mx, rel = errors(out, ref)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        ok = all(bool(torch.isfinite(x.float()).all()) for x in outs) \
            and rel <= TOL[name] and (mx == 0 or not extras.get("exact"))
        kern_t, plain_t = extras.get("timing", (kern, plain))
        ms = timed(torch, kern_t, 10)
        plain_ms = timed(torch, plain_t, 3)
        lib_ms = timed(torch, lib, 10) if lib is not None else None
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        more = "".join(f" {what} {timed(torch, extras[key], 10):.4f} ms"
                       for key, what in (("alone", "launch alone"),
                                         ("chain", "library chain"),
                                         ("fused", "fp32-affine K7"))
                       if key in extras)
        if "floor" in extras:
            more += f" exp floor {extras['floor']:.4f} ms"
        print(f"[{tag}] {name} {label}: max_abs {mx:.4g} rel_l2 {rel:.3g} "
              f"(tol {'0, bit for bit' if extras.get('exact') else TOL[name]}) | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
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


def main() -> int:
    import torch

    start = time.perf_counter()
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
                                   resconv.KERNEL, ss.DELTA_KERNEL)}

    t0 = time.perf_counter()
    _build.build_all(kernels.values())
    print(f"[2 build] {', '.join(f'{n} {k.build_seconds:.1f}s' for n, k in kernels.items())}"
          f" | total {time.perf_counter() - t0:.1f}s (in parallel)", flush=True)
    count_plain_norms(kernels)

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    check_kernels(torch, kernel_cases(torch, dev, gen), results, card, "3 kernel")
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
        for k in kernels.values():
            k.launches = 0
        y_k = unet(*args)
        norm_counts = {n: kernels[n].launches for n in NORM_ENTRIES}
        with plain_ops():
            y_p = unet(*args)
    torch.cuda.synchronize()
    mx, rel = errors(y_k, y_p)
    want = norm_launches(unet)
    print(f"[4 unet] UNetConfig() bf16 (4, 4, 32, 32, 8): kernels vs plain "
          f"max_abs {mx:.4g} rel_l2 {rel:.3g} (tol {UNET_TOL}) | K7 / K8 launches, plain norms "
          f"{norm_counts} (derived {want}) | {card}", flush=True)
    if not (torch.isfinite(y_k.float()).all() and rel <= UNET_TOL):
        raise RuntimeError("UNet through the kernels disagrees with the plain path")
    if norm_counts != want:
        raise RuntimeError(f"default forward K7 / K8 launches {norm_counts} != {want}")

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
    # K7 (the default lowering's variant): per UNet call, per VAE encode,
    # per decode chunk and the heads, as 5b derives the fused lowering's
    encodes, decodes = 2, -(-FRAMES // FRAMES)
    want = {n: per_forward.get(n, 0) * unet_calls for n in kernels}
    want.update(norm_sum(((unet_calls, norm_launches(mods.unet)),
                          (encodes, norm_launches(mods.vae.encoder)),
                          (decodes, norm_launches(mods.vae.decoder)),
                          (1, norm_launches(mods.id_proj, mods.pose_guider)))))
    if counts != want:
        raise RuntimeError(f"clip launches {counts} != derived {want}")
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
    want = step_norm_launches(unet)
    if {n: grad_counts[n] for n in NORM_ENTRIES} != want:
        raise RuntimeError(f"gradient K7 / K8 launches, plain norms {grad_counts} != {want}")
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
            if rec["step"] == SHARDED_MICRO_STEPS - 1:  # phase 12's reference
                seen["committed"] = commit_snapshot(trainer.modules)
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
    expect = {**micro_step_launches(),
              **step_norm_launches(res["modules"]["unet"],
                                   [res["modules"][h] for h in HEADS])}
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
    phase7 = {"records": recs[:SHARDED_MICRO_STEPS], "sec_step": sec_step,
              "peak_gib": peak_gib, "committed": seen.pop("committed")}
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
        want.update(norm_launches(mod))
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
    want.update(norm_launches(v9))      # the forward's; the backward's are plain
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

    # ---- 11: batched serving (C4), the loader (C8), real-data training (C2) ----
    serve_counts, real_counts = phase11(torch, dev, kernels, card)

    # ---- 12: ZeRO-2 training and rank-split serving under NCCL, world 1 ----
    sharded_counts, split_counts = phase12(torch, dev, kernels, card, phase7)
    del phase7

    # ---- 13: the evaluation networks and run_eval on the card ----
    phase13(torch, dev, card)

    # ---- 14: DWPose, data tools, pre-encoded batches, windows split, tp ----
    p14 = phase14(torch, dev, kernels, card, results)

    launches = {n: (train_counts[n] if n in ("ssm_scan_bwd", "mha_bwd")
                    else lineage_counts[n] if n == "ssm_scan"
                    else fused_counts[n] if n in FUSED_KERNELS
                    else cli_counts[n] if n == "gather_delta_add"
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
                             "cli_full": full_counts[n],
                             "serve_batched": serve_counts[n],
                             "train_real": real_counts[n],
                             "train_sharded": sharded_counts[n],
                             "serve_split": split_counts[n],
                             "train_pre_encoded": p14["train_pre_encoded"][n],
                             "sample_split_windows": p14["sample_split_windows"][n],
                             "train_tp2_rank0": p14["train_tp2"][n]},
        **({"tp2_rank": results[n]["tp2_rank"]} if "tp2_rank" in results[n] else {}),
        "max_abs_err": results[n]["max_abs_err"], "ms": results[n]["ms"],
        "plain_ms": results[n]["plain_ms"], "bound_ms": results[n]["bound_ms"],
        "bound_by": results[n]["bound_by"],
        "library_ms": results[n]["library_ms"]} for n, k in kernels.items()
        if n != PLAIN]}))
    print(f"[total] {time.perf_counter() - start:.1f} s, the build included | {card}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
