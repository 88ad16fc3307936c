"""Stage bisect of K4 (the GEGLU feed-forward's two GEMM launches) on the
card: what the mainloop, the stores and the gate each cost.

The variants are compile-time variants of K4's kernel
(``csrc/geglu_mlp.cu``, ``-DK4_VARIANT``), built by this tool into
libraries of their own and on no other path:

    full      K4 itself
    nogate    bias and bf16 stores, no erff: the GEGLU launch stores h * g
    mmonly    the mainloop alone, nothing stored (the products kept live
              by a store no input takes, so that ptxas keeps them)

Each launch is timed alone, under the plan the wrapper takes at its
shapes (``ops.mlp.plans``): the GEGLU launch h = x W1 -> gate, and the
output projection y = h W2^T + b2 (which has no gate: its ``nogate`` is its
``full``). Each variant is first held against a plain PyTorch version of
its function at a small ragged shape, then timed (CUDA events, median of
10) at the 576 px cell's four feed-forward shapes (M = 100 frames x the
level's tokens), beside each launch's bound and the card's name and power
limit. Needs a CUDA card:

    python -m actalker_tpu_torch.tools.geglu_bisect
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

from actalker_tpu_torch.ops import mlp
from actalker_tpu_torch.ops._build import Kernel, ptr, stream_of

VARIANTS = ("full", "nogate", "mmonly")
# (level, M, C, I, Cout): infer576.mode0-facebox's feed-forwards
SHAPES = (("res-72", 518400, 320, 1280, 320), ("res-36", 129600, 640, 2560, 640),
          ("res-18", 32400, 1280, 5120, 1280), ("mid res-9", 8100, 1280, 5120, 1280))
# (M, C, I, Cout): ragged against the tiles, and past the resident plan's
# row floor, so that the plan the res-72 rows time is the one checked
CHECK_SHAPE = (mlp.RESIDENT_MIN_M + 75, 72, 200, 56)
TOL = 5e-3                            # as K4's card tests
PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12


def kernels() -> dict:
    """One library per variant (``full`` is built with the flag too, so
    the tool times exactly what it built)."""
    return {v: Kernel("geglu_mlp", replaces=mlp.KERNEL.replaces,
                      flags=(f"-DK4_VARIANT={i}",))
            for i, v in enumerate(VARIANTS)}


def launch_in(kernel, x, w1, b1, h, cout):
    """The GEGLU launch under the plan the wrapper takes at these shapes."""
    (m, c), i = x.shape, h.shape[1]
    plan = mlp.PLANS[mlp.plans(m, c, i, cout)[0]]
    kernel.launch("geglu_in_bf16", "ppppiiiip", ptr(x), ptr(w1), ptr(b1), ptr(h),
                  m, c, i, plan, stream_of(x))


def launch_out(kernel, h, w2, b2, y, c):
    """The output projection under the wrapper's plan (x was (M, c))."""
    (m, i), cout = h.shape, y.shape[1]
    plan = mlp.PLANS[mlp.plans(m, c, i, cout)[1]]
    kernel.launch("linear_bias_bf16", "ppppiiiip", ptr(h), ptr(w2), ptr(b2), ptr(y),
                  m, i, cout, plan, stream_of(h))


def operands(m, c, i, cout, gen):
    dev = gen.device

    def rn(*s):
        return torch.randn(*s, generator=gen, device=dev)

    return (rn(m, c).bfloat16(), (rn(2 * i, c) * c ** -0.5).bfloat16(),
            0.1 * rn(2 * i), (rn(cout, i) * i ** -0.5).bfloat16(), 0.1 * rn(cout))


def in_ref(variant, x, w1, b1):
    """Plain version of the GEGLU launch's variant (fp32 products)."""
    i = w1.shape[0] // 2
    h2 = x.float() @ w1.float().t() + b1
    g = h2[:, i:]
    gate = g if variant == "nogate" else 0.5 * g * (1.0 + torch.erf(g * 2 ** -0.5))
    return (h2[:, :i] * gate).to(x.dtype)


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def check_variants(ks, gen) -> list:
    """Each variant that stores against its plain version: one dict per
    (variant, launch) with its relative L2 error and verdict."""
    m, c, i, cout = CHECK_SHAPE
    x, w1, b1, w2, b2 = operands(m, c, i, cout, gen)
    rows = []
    for v in ("full", "nogate"):
        h = torch.empty(m, i, dtype=x.dtype, device=x.device)
        launch_in(ks[v], x, w1, b1, h, cout)
        rows.append({"variant": v, "launch": "in", "rel_l2": _rel(h, in_ref(v, x, w1, b1))})
    h = in_ref("full", x, w1, b1)
    y = torch.empty(m, cout, dtype=x.dtype, device=x.device)
    launch_out(ks["full"], h, w2, b2, y, c)
    want = (h.float() @ w2.float().t() + b2).to(x.dtype)
    rows.append({"variant": "full", "launch": "out", "rel_l2": _rel(y, want)})
    for r in rows:
        r["ok"] = r["rel_l2"] <= TOL
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


def bounds_ms(m, c, i, cout) -> dict:
    """Least time of each launch: operations at the bf16 peak or bytes
    (inputs read once, output written once) at the memory's, the larger."""
    b_in = max(2 * m * c * 2 * i / PEAK_BF16, 2 * (m * c + 2 * i * c + m * i) / PEAK_BYTES)
    b_out = max(2 * m * i * cout / PEAK_BF16, 2 * (m * i + cout * i + m * cout) / PEAK_BYTES)
    return {"in": b_in * 1e3, "out": b_out * 1e3}


def time_variants(ks, gen, reps: int = 10) -> list:
    """Per shape: each variant's GEGLU launch and output projection alone,
    the production wrapper's whole feed-forward, and the bounds."""
    rows = []
    for level, m, c, i, cout in SHAPES:
        x, w1, b1, w2, b2 = operands(m, c, i, cout, gen)
        h = torch.empty(m, i, dtype=x.dtype, device=x.device)
        y = torch.empty(m, cout, dtype=x.dtype, device=x.device)
        row = {"level": level, "M": m, "C": c, "I": i, "Cout": cout,
               "bound_ms": bounds_ms(m, c, i, cout)}
        for v in VARIANTS:
            row[v] = {"in": _median_ms(lambda k=ks[v]: launch_in(k, x, w1, b1, h, cout),
                                       reps)}
            if v != "nogate":
                row[v]["out"] = _median_ms(lambda k=ks[v]: launch_out(k, h, w2, b2, y, c),
                                           reps)
        row["ff_ms"] = _median_ms(lambda: mlp.geglu_mlp(x, w1, b1, w2, b2), reps)
        rows.append(row)
        del x, h, y
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    ks = kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = check_variants(ks, gen)
    for r in checks:
        print(f"[check {CHECK_SHAPE}] {r['variant']:7s} {r['launch']:3s} rel_l2 "
              f"{r['rel_l2']:.3g} (tol {TOL}) {'ok' if r['ok'] else 'FAIL'}", flush=True)
    if not all(r["ok"] for r in checks):
        return 1
    rows = time_variants(ks, gen)
    for r in rows:
        b = r["bound_ms"]
        print(f"[time {r['level']} M={r['M']} C={r['C']} I={r['I']} Cout={r['Cout']}] "
              f"in: full {r['full']['in']:.4f} nogate {r['nogate']['in']:.4f} "
              f"mmonly {r['mmonly']['in']:.4f} (bound {b['in']:.4f}); out: full "
              f"{r['full']['out']:.4f} mmonly {r['mmonly']['out']:.4f} (bound "
              f"{b['out']:.4f}); wrapper {r['ff_ms']:.4f} ms | {card}", flush=True)
    print(json.dumps({"checks": checks, "rows": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
