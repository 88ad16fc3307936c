"""Stage bisect of K8 (fused GroupNorm affine + SiLU + 3x3 conv) on the card:
what each stage of the kernel costs.

The port of ``tools/micro_resconv_bisect.py``. Its five variants are
compile-time variants of K8's kernel (``csrc/gn_silu_conv3x3.cu``), one C
entry each, launched through ``ops.resconv.conv_launch``:

    full      K8 itself: y = conv3x3(silu(x * a + b)) + cb
    noshift   only the dx = 0 taps (the dx = +-1 columns of the kernel zero)
    noaffine  y = conv3x3(silu(x)) + cb
    nosilu    y = conv3x3(x * a + b) + cb
    mmonly    the halo is written as zeros and no input is read: y = cb

Each variant is first held against a plain PyTorch version of its function
at a small ragged shape, then timed (CUDA events, median of 10; the plain
version median of 3) at the TPU tool's shape (56, 64, 64, 320 -> 320),
beside the card's name and power limit. Needs a CUDA card:

    python -m actalker_tpu_torch.tools.resconv_bisect
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from actalker_tpu_torch.ops import resconv

CHECK_SHAPE = (2, 9, 7, 40, 24)     # (N, H, W, C, Co): ragged against the tiles
TIME_SHAPE = (56, 64, 64, 320, 320)
# as K8's: the activation is rounded to bf16 in both (the kernel's exp-based
# SiLU and the plain sigmoid can flip single roundings); fp32 sums in
# another order
TOL = 5e-3


def variant_ref(variant: str, x, a, b, w, cb) -> torch.Tensor:
    """Plain version of one variant: x (N, H, W, C) bf16; a, b (N, C) fp32
    affine; w (Co, C, 3, 3); cb (Co,). The activation is rounded to x's
    dtype before an fp32 conv, as in K8."""
    y = x.float()
    if variant in ("full", "noshift", "nosilu"):
        y = y * a[:, None, None, :] + b[:, None, None, :]
    if variant != "nosilu":
        y = y * torch.sigmoid(y)
    y = y.to(x.dtype).float()
    if variant == "mmonly":
        y = torch.zeros_like(y)
    w = w.to(x.dtype).float()
    if variant == "noshift":
        w = w * torch.tensor([0.0, 1.0, 0.0], device=w.device)
    out = F.conv2d(y.permute(0, 3, 1, 2), w, padding=1) + cb.float()[:, None, None]
    return out.permute(0, 2, 3, 1).to(x.dtype)


def operands(shape, gen):
    """Seeded (x, a, b, w, wt, cb) on the generator's device: w in torch's
    (Co, C, 3, 3) layout, wt K8's (Co, 9 * C) re-layout of it."""
    n, h, wd, c, co = shape
    dev = gen.device

    def rn(*s):
        return torch.randn(*s, generator=gen, device=dev)

    x = (rn(n, h, wd, c) * 1.5 + 0.3).bfloat16()
    a, b = 1 + 0.1 * rn(n, c), 0.5 * rn(n, c)
    w = (rn(co, c, 3, 3) * (9 * c) ** -0.5).bfloat16()
    wt = w.permute(0, 2, 3, 1).reshape(co, 9 * c).contiguous()
    return x, a, b, w, wt, 0.1 * rn(co)


def check_variants(gen, shape=CHECK_SHAPE) -> list:
    """Each variant's launch against its plain version: one dict per
    variant with its max abs error, relative L2 error and verdict."""
    x, a, b, w, wt, cb = operands(shape, gen)
    rows = []
    for v in resconv.VARIANTS:
        got = resconv.conv_launch(x, a, b, wt, cb, v)
        want = variant_ref(v, x, a, b, w, cb)
        d = (got.float() - want.float())
        rel = (d.norm() / want.float().norm().clamp_min(1e-30)).item()
        rows.append({"variant": v, "max_abs_err": d.abs().max().item(),
                     "rel_l2": rel, "ok": bool(torch.isfinite(got.float()).all())
                     and rel <= TOL})
    return rows


def _median_ms(fn, reps: int) -> float:
    """CUDA-event median (ms) of ``fn`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[reps // 2]


def time_variants(gen, shape=TIME_SHAPE, reps: int = 10) -> dict:
    """Per variant at ``shape``: the CUDA-event median (ms) of its launch
    (of ``reps``) and of its plain version (of 3)."""
    x, a, b, w, wt, cb = operands(shape, gen)
    return {v: {"ms": _median_ms(lambda: resconv.conv_launch(x, a, b, wt, cb, v),
                                 reps),
                "plain_ms": _median_ms(lambda: variant_ref(v, x, a, b, w, cb), 3)}
            for v in resconv.VARIANTS}


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 1
    # the plain versions' products in full fp32, as chip_smoke.py times them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = check_variants(gen)
    for r in rows:
        print(f"[check {CHECK_SHAPE}] {r['variant']:8s} max_abs "
              f"{r['max_abs_err']:.4g} rel_l2 {r['rel_l2']:.3g} (tol {TOL}) "
              f"{'ok' if r['ok'] else 'FAIL'}", flush=True)
    if not all(r["ok"] for r in rows):
        return 1
    ms = time_variants(gen)
    for v, t in ms.items():
        print(f"[time {TIME_SHAPE}] {v:8s} {t['ms']:.4f} ms (plain "
              f"{t['plain_ms']:.4f} ms) | {card}", flush=True)
    print(json.dumps({"shape": TIME_SHAPE, "ms": ms, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
