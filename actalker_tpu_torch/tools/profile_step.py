"""Where the device time goes: ``torch.profiler`` over a window of the
port's work on the card, summed by kernel group.

    python -m actalker_tpu_torch.tools.profile_step --what train
    python -m actalker_tpu_torch.tools.profile_step --what forward
    python -m actalker_tpu_torch.tools.profile_step --what forward \
        --norm fused --resconv pallas
    python -m actalker_tpu_torch.tools.profile_step --what lineage

``train``: ``training.train.main`` at the ``configs/train.yaml`` operating
point (512 px, 25 frames, batch 1, 4-step accumulation, block
checkpointing, seeded weights) for 8 micro-steps; micro-steps 5-8 (one
accumulation cycle, its commit included) are profiled. ``forward``: one
full-width bf16 UNet forward at the clip path's window-step shape (4 CFG x
14 frames, 64 x 64 latents, seeded weights), after a warm-up forward.
``--norm`` / ``--resconv`` set the model's two lowering switches
(``models.common.set_norm_impl``, ``models.resnet.set_resconv_impl``);
``--norm fused --resconv pallas`` is the fused-norm configuration (K7-LN,
K7-GN, K8). ``lineage``: the SS2D lineage as ``chip_smoke.py`` phase 8
builds it, one forward each after a warm-up: SS2DCondV9(320) at the UNet's
res-64 control-block shape (56 x 4096 tokens, bf16, face-box masks) and
MambaUPNet at its published dims on (8, 8, 8, 512) fp32; one window, and
one report, per module.
Prints the card line, the wall time of the window, the device busy time
and idle share, and the device time per group of kernels, under each of
the port's kernels its device time per launch by launch grid; then the
program's spans (``utils/observability``): per span name its count, its
device ms from start event to end event (``span_table``), and the device
ms of the kernels, memcpys and memsets it launched, by innermost span and
by every span open at the launch; then the program's counters (e.g.
``norm.kernel`` / ``norm.plain``: norm calls through K7 / the plain code);
a JSON line for each window. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import shutil
import subprocess
import tempfile
import time

import torch

from actalker_tpu_torch.utils import observability

# (group, name substrings), first match wins: the port's own kernels first
GROUPS = (
    ("K1 grouped scan", ("ssm_grouped_kernel",)),
    ("K5 scan", ("ssm_scan_",)),
    ("K6 scan adjoint", ("ssm_bwd_",)),
    ("K2 attention", ("mha_fwd_kernel",)),
    ("K2-bwd attention backward", ("dkdv_kernel", "dq_kernel", "row_dot")),
    ("K3 frame attention", ("frame_attn_",)),
    ("K4 GEGLU", ("gemm_tn_kernel",)),
    ("K7-LN layer norm", ("layer_norm_",)),
    ("K7-GN group norm", ("gn_stats_kernel", "gn_finalize_kernel",
                          "gn_apply_kernel", "gn_cluster_kernel")),
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


def short_name(name: str) -> str:
    """A kernel's demangled name without its return type, namespace and
    parameter list (its template arguments kept)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0]


# a program span's name (``unet.norm``), not torch's own ranges
# (``Optimizer.step#AdamW.step``)
PROGRAM_SPAN = re.compile(r"^[a-z_]+(\.[a-z_]+)+$")


def span_kernel_times(events):
    """{span: [ms as the innermost span, ms inside it]} of the device's
    kernels, memcpys and memsets; "(no span)" takes what no span holds. A
    device event's ``args.correlation`` leads to its ``cuda_runtime``
    launch, and the program spans open on the launch's thread take it; on
    a thread with none open (autograd's device thread in a backward) the
    spans open on the thread whose innermost span began last."""
    launch = {}
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat == "cuda_runtime":
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = (float(e["ts"]), e.get("tid"))
        elif cat == "user_annotation" and PROGRAM_SPAN.match(e["name"]):
            t0 = float(e["ts"])
            spans.append((t0, t0 + float(e.get("dur", 0.0)), e.get("tid"), e["name"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((e.get("args", {}).get("correlation"), e["dur"] / 1e3))
    at = sorted((launch[c] + (ms,)) for c, ms in dev if c in launch)
    spans.sort()
    starts = [s[0] for s in spans]
    stacks, out, i = {}, {}, 0
    for ts, tid, ms in at:
        j = bisect.bisect_right(starts, ts)
        for t0, t1, stid, name in spans[i:j]:
            st = stacks.setdefault(stid, [])
            while st and st[-1][1] <= t0:
                st.pop()
            st.append((t0, t1, name))
        i = j
        for st in stacks.values():
            while st and st[-1][1] <= ts:
                st.pop()
        chain = stacks.get(tid) or max(
            (st for st in stacks.values() if st), key=lambda st: st[-1][0],
            default=[(0.0, 0.0, "(no span)")])
        out.setdefault(chain[-1][2], [0.0, 0.0])[0] += ms
        for name in {s[2] for s in chain}:
            out.setdefault(name, [0.0, 0.0])[1] += ms
    return out


def device_times(trace_path: str):
    """(busy ms, {group: ms}, launches) from a chrome trace: the sum of
    kernel, memcpy and memset durations; ``launches`` maps each of the
    port's own kernels (groups "K...") by (group, name, grid) to its
    [count, ms], so each launch shape's device time reads on its own."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    groups, launches = {}, {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset"):
            g = group_of(e["name"]) if e["cat"] == "kernel" else "memcpy / memset"
            groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3
            if g.startswith("K"):
                key = (g, short_name(e["name"]),
                       tuple(e.get("args", {}).get("grid", ())))
                hit = launches.setdefault(key, [0, 0.0])
                hit[0] += 1
                hit[1] += e["dur"] / 1e3
    return sum(groups.values()), groups, launches


class Window:
    """A profiled window: ``start()`` / ``stop()`` on a synchronized card,
    through ``utils.observability.device_trace`` into ``tmp``. ``stop()``
    reads the window's device time at once (``busy``, ``groups``) from the
    chrome trace: a later profiler session in the process leaves an
    earlier one's kernels without device timestamps."""

    def __init__(self, tmp: str):
        self.tmp = tmp

    def start(self):
        observability.reset()
        self.trace = observability.device_trace(self.tmp, torch.device("cuda"))
        self.prof = self.trace.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.trace.__exit__(None, None, None)
        self.busy, self.groups, self.launches = device_times(self.prof.trace_path)
        with open(self.prof.trace_path) as f:
            self.by_span = span_kernel_times(json.load(f)["traceEvents"])
        self.spans = observability.span_table()


def span_lines(table, by_span):
    """The span table's lines: per span name its count, device ms start
    event to end event, and its kernels' ms by innermost span and inside
    it (``by_span``, from ``span_kernel_times``); then each counter of
    ``table`` (``observability.span_table``), such as ``norm.kernel`` /
    ``norm.plain``, the norm calls that launched K7 / ran the plain code."""
    rows = table["spans"]
    lines = [f"  {'span':24s} {'n':>6s} {'events ms':>11s} {'innermost ms':>13s} "
             f"{'inside ms':>11s}"]
    for name in sorted(set(rows) | set(by_span)):
        n, ev = (rows[name]["n"], rows[name]["device_ms"]) if name in rows else (0, 0.0)
        inner, inside = by_span.get(name, (0.0, 0.0))
        lines.append(f"  {name:24s} {n:6d} {ev:11.2f} {inner:13.2f} {inside:11.2f}")
    lines += [f"  counter {name:24s} {n:12d}"
              for name, n in sorted(table["counters"].items())]
    return lines


def profile_train(tmp: str) -> Window:
    from actalker_tpu_torch.training import train

    win = Window(tmp)

    def observe(trainer, rec):
        if rec is not None and rec["step"] == 3:
            win.start()
        elif rec is not None and rec["step"] == 7:
            win.stop()

    train.main(["--config", os.path.join(ROOT, "configs", "train.yaml"),
                "--synthetic", "8", "--steps", "8",
                "--output", os.path.join(tmp, "train")], observe=observe)
    return win


def profile_forward(tmp: str) -> Window:
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
    win = Window(tmp)
    with torch.no_grad():
        unet(*args)
        win.start()
        unet(*args)
        win.stop()
    return win


def profile_lineage(tmp: str):
    """[(label, Window)]: one V9 and one MambaUPNet forward, built and fed
    as ``chip_smoke.py`` phase 8 builds them (the same seeds and draws)."""
    from actalker_tpu_torch.io.init import cast_params_bf16_, lineage_init_
    from actalker_tpu_torch.models import ssm_spatial as sp

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    x = rn(56, 4096, 320).bfloat16()
    id_emb, audio, expr = (rn(56, s, 1024).bfloat16() for s in (1, 32, 1))
    face = torch.zeros(1, 1, 512, 512, device=dev)
    face[..., 128:384, 128:384] = 1.0
    cases = (("SS2DCondV9(320) bf16 (56, 4096, 320)", lambda: sp.SS2DCondV9(320),
              0, True, (x, id_emb, audio, expr, face, face)),
             ("MambaUPNet() fp32 (8, 8, 8, 512)", sp.MambaUPNet, 3, False,
              (rn(8, 8, 8, 512),)))
    windows = []
    for label, make, seed, bf16, args in cases:
        with torch.device("meta"):
            mod = make()
        mod = lineage_init_(mod, seed=seed, device=dev)
        mod = (cast_params_bf16_(mod) if bf16 else mod).eval()
        win = Window(tmp)
        with torch.no_grad():
            mod(*args)
            win.start()
            mod(*args)
            win.stop()
        windows.append((label, win))
        del mod
    return windows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--what", choices=("train", "forward", "lineage"),
                   default="train")
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
        if args.what == "train":
            windows = [("", profile_train(tmp))]
        elif args.what == "forward":
            windows = [("", profile_forward(tmp))]
        else:
            windows = profile_lineage(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for label, win in windows:
        wall_ms, busy, groups = win.wall * 1e3, win.busy, win.groups
        print(f"[profile {args.what}{' ' + label if label else ''} norm={args.norm} "
              f"resconv={args.resconv}] {card} | wall {wall_ms:.2f} ms | device "
              f"busy {busy:.2f} ms | idle {100 * max(0.0, 1 - busy / wall_ms):.1f}%")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  {g:32s} {ms:10.2f} ms {100 * ms / busy:6.1f}%")
            for (kg, name, grid), (k, kms) in sorted(win.launches.items()):
                if kg == g:
                    print(f"    {name} grid {grid}: {k} launches, "
                          f"{kms / k:.4f} ms each")
        for line in span_lines(win.spans, win.by_span):
            print(line)
        print(json.dumps({"what": args.what, "module": label or None,
                          "norm": args.norm, "resconv": args.resconv,
                          "card": card, "wall_ms": wall_ms, "busy_ms": busy,
                          "groups_ms": groups, "spans": win.spans,
                          "spans_kernel_ms": win.by_span}))


if __name__ == "__main__":
    main()
