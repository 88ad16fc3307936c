"""Where the device time goes: ``torch.profiler`` over a window of the
port's work on the card, summed by kernel group.

    python -m actalker_tpu_torch.tools.profile_step --what train
    python -m actalker_tpu_torch.tools.profile_step --what forward
    python -m actalker_tpu_torch.tools.profile_step --what forward \
        --norm fused --resconv pallas

``train``: ``training.train.main`` at the ``configs/train.yaml`` operating
point (512 px, 25 frames, batch 1, 4-step accumulation, block
checkpointing, seeded weights) for 8 micro-steps; micro-steps 5-8 (one
accumulation cycle, its commit included) are profiled. ``forward``: one
full-width bf16 UNet forward at the clip path's window-step shape (4 CFG x
14 frames, 64 x 64 latents, seeded weights), after a warm-up forward.
``--norm`` / ``--resconv`` set the model's two lowering switches
(``models.common.set_norm_impl``, ``models.resnet.set_resconv_impl``);
``--norm fused --resconv pallas`` is the fused-norm configuration (K7-LN,
K7-GN, K8).
Prints the card line, the wall time of the window, the device busy time
and idle share, and the device time per group of kernels; one JSON line
at the end. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time

import torch

# (group, name substrings), first match wins: the port's own kernels first
GROUPS = (
    ("K1 grouped scan", ("ssm_grouped_kernel",)),
    ("K5 scan", ("ssm_scan_kernel",)),
    ("K6 scan adjoint", ("ssm_bwd_",)),
    ("K2 attention", ("mha_fwd_kernel",)),
    ("K2-bwd attention backward", ("dkdv_kernel", "dq_kernel", "row_dot")),
    ("K3 frame attention", ("frame_attn_",)),
    ("K4 GEGLU", ("gemm_tn_kernel",)),
    ("K7-LN layer norm", ("layer_norm_",)),
    ("K7-GN group norm", ("gn_stats_kernel", "gn_finalize_kernel",
                          "gn_apply_kernel")),
    ("K8 GN + SiLU + conv3x3", ("gn_silu_conv3x3_kernel",)),
    ("optimizer (multi-tensor)", ("multi_tensor_apply",)),
    ("cuDNN convs", ("conv", "cudnn", "implicit", "wgrad", "dgrad", "fprop")),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "xmma", "cublas", "splitk")),
    ("reductions", ("reduce", "norm_kernel", "softmax")),
    ("memcpy / memset", ("memcpy", "memset")),
    ("elementwise and copies", ("elementwise", "vectorized", "unrolled",
                                "copy", "cat", "index", "fill")),
)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def device_times(trace_path: str):
    """(busy ms, {group: ms}) from a chrome trace: the sum of kernel,
    memcpy and memset durations."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    groups = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset"):
            g = group_of(e["name"]) if e["cat"] == "kernel" else "memcpy / memset"
            groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3
    return sum(groups.values()), groups


class Window:
    """A profiled window: ``start()`` / ``stop()`` on a synchronized card."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def start(self):
        torch.cuda.synchronize()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)


def profile_train(tmp: str) -> Window:
    from actalker_tpu_torch.training import train

    win = Window()

    def observe(trainer, rec):
        if rec is not None and rec["step"] == 3:
            win.start()
        elif rec is not None and rec["step"] == 7:
            win.stop()

    train.main(["--config", os.path.join(ROOT, "configs", "train.yaml"),
                "--synthetic", "8", "--steps", "8",
                "--output", os.path.join(tmp, "train")], observe=observe)
    return win


def profile_forward() -> Window:
    from actalker_tpu_torch.io.init import cast_params_bf16_, random_init_
    from actalker_tpu_torch.models.conditioning import Conditioning
    from actalker_tpu_torch.models.unet import UNetConfig, UNetSpatioTemporalCondition

    dev = torch.device("cuda")
    with torch.device("meta"):
        unet = UNetSpatioTemporalCondition(UNetConfig(), dtype=torch.bfloat16)
    cast_params_bf16_(random_init_(unet, seed=0, device=dev)).eval()
    b, f, hw = 4, 14, 64
    g = torch.Generator(device=dev).manual_seed(1)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    ones = torch.ones(1, 1, hw * 8, hw * 8, device=dev)
    cond = Conditioning(rn(b * f, 1, 1024).bfloat16(), rn(b * f, 32, 1024).bfloat16(),
                        rn(b * f, 1, 1024).bfloat16(), ones, ones)
    args = (rn(b, f, hw, hw, 8).bfloat16(), torch.tensor(0.5, device=dev), cond,
            rn(b, 3).bfloat16(), (rn(b, f, hw, hw, 320) * 0.1).bfloat16())
    win = Window()
    with torch.no_grad():
        unet(*args)
        win.start()
        unet(*args)
        win.stop()
    return win


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--what", choices=("train", "forward"), default="train")
    p.add_argument("--norm", choices=("xla", "fused"), default="xla")
    p.add_argument("--resconv", choices=("xla", "pallas"), default="xla")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from actalker_tpu_torch.models import common, resnet

    common.set_norm_impl(args.norm)
    resnet.set_resconv_impl(args.resconv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    # the trace and the run's checkpoint go to the git-ignored build tree
    scratch = os.path.join(ROOT, "actalker_tpu_torch", "_build")
    os.makedirs(scratch, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="profile-", dir=scratch)
    try:
        win = profile_train(tmp) if args.what == "train" else profile_forward()
        trace = os.path.join(tmp, "trace.json")
        win.prof.export_chrome_trace(trace)
        busy, groups = device_times(trace)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall_ms = win.wall * 1e3
    print(f"[profile {args.what} norm={args.norm} resconv={args.resconv}] "
          f"{card} | wall {wall_ms:.2f} ms | device busy "
          f"{busy:.2f} ms | idle {100 * max(0.0, 1 - busy / wall_ms):.1f}%")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:32s} {ms:10.2f} ms {100 * ms / busy:6.1f}%")
    print(json.dumps({"what": args.what, "norm": args.norm,
                      "resconv": args.resconv, "card": card, "wall_ms": wall_ms,
                      "busy_ms": busy, "groups_ms": groups}))


if __name__ == "__main__":
    main()
