"""The yardstick of the port's kernels: the H100's data-sheet peaks, the
least time of a launch from its operations and bytes, and the operations
and bytes of each kernel at a call's shapes.

The formulas are copies of ``chip_smoke.py``'s phase 3 (``bound`` and the
cases of ``kernel_cases``), taken per call at the shapes a cell's UNet
call gives; K1's rows are counted per branch (its selected slots plus its
tail), the work these inputs need.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

# NVIDIA H100 SXM data sheet, dense: bf16 989 TFLOP/s, fp32 outside the
# tensor cores 67 TFLOP/s, HBM3 3.35 TB/s
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    """Least seconds for the work: bytes over the memory rate or the
    operations over the peak of their type, whichever is larger."""
    return max(nbytes / PEAK_BYTES, ops / peak)


def k1_call(rows: List[int], bp: int, dp: int, rank: int) -> float:
    """One K1 launch: ``rows`` holds each branch's scanned rows (its slots
    plus its tail); two directions a branch, d_inner ``dp``."""
    ops = sum(2 * r * bp * dp * (2 * (rank + 1) + 10 + 16 * 6) for r in rows)
    nbytes = sum(2 * r * bp * (dp + 2 * 128 + 2 * dp) for r in rows) \
        + 4 * 2 * len(rows) * dp * (128 + 19)
    return bound_s(nbytes, ops, PEAK_FP32)


def k6_call(l: int, bp: int, dp: int) -> float:
    """One (branch, direction) group of K6 over ``l`` rows."""
    ops = l * bp * dp * (16 * (4 + 16) + 10)
    nbytes = l * bp * (dp * (2 + 4 + 2 + 2 + 4) + 2 * 32 * 2)
    return bound_s(nbytes, ops, PEAK_FP32)


def k2_call(b: int, s: int, c: int, heads: int) -> float:
    return bound_s(4 * b * s * c * 2, 4 * b * heads * s * s * (c // heads), PEAK_BF16)


def k2_bwd_call(b: int, s: int, c: int, heads: int) -> float:
    return bound_s(8 * b * s * c * 2 + b * heads * s * 4,
                   5 * 2 * b * heads * s * s * (c // heads), PEAK_BF16)


def k3_call(b: int, f: int, s: int, c: int, heads: int) -> float:
    return bound_s(4 * b * f * s * c * 2, 4 * b * s * heads * f * f * (c // heads),
                   PEAK_BF16)


def k4_call(m: int, c: int) -> float:
    """One GEGLU feed-forward (its two launches): hidden 4C."""
    hid = 4 * c
    return bound_s(2 * (2 * m * c + 3 * hid * c), 6 * m * c * hid, PEAK_BF16)


def levels(sizes, hw: int) -> List[Tuple[int, int, int, bool]]:
    """(tokens, channels, heads, has SSM) of each level's transformers,
    the mid block's last (no SSM)."""
    out = []
    for i, (c, h) in enumerate(zip(sizes.block_out_channels, sizes.num_attention_heads)):
        side = hw // 2 ** i
        if i < sizes.cross_attn_levels:
            out.append((side * side, c, h, True))
    n = len(sizes.block_out_channels) - 1
    side = hw // 2 ** n
    out.append((side * side, sizes.block_out_channels[-1],
                sizes.num_attention_heads[-1], False))
    return out


def transformers_per_level(sizes) -> int:
    """Cross-attention transformers of one level: its down block's and its
    up block's (one more, as the up block takes one more skip)."""
    return 2 * sizes.layers_per_block + 1


def forward_bounds(sizes, batch: int, frames: int, hw: int,
                   k1_rows: Dict[int, List[int]]) -> Dict[str, Tuple[int, float]]:
    """kernel -> (launches, summed least seconds) of one UNet forward over
    ``batch`` videos of ``frames`` frames at ``hw`` x ``hw`` latents.
    ``k1_rows`` maps a level's token count to each branch's scanned rows.
    Launches count ``Kernel.launch`` calls: K4 makes two a feed-forward."""
    bf = batch * frames
    out = {"ssm_scan_grouped": [0, 0.0], "mha": [0, 0.0],
           "frame_attention": [0, 0.0], "geglu_mlp": [0, 0.0]}

    def add(name, n, secs):
        out[name][0] += n
        out[name][1] += n * secs

    for s, c, h, ssm in levels(sizes, hw):
        n = transformers_per_level(sizes) if ssm else 1
        if ssm:
            add("ssm_scan_grouped", n, k1_call(k1_rows[s], bf, 2 * c, math.ceil(c / 16)))
        add("mha", n, k2_call(bf, s, c, h))
        add("frame_attention", n, k3_call(batch, frames, s, c, h))
        # three feed-forwards a transformer (spatial ff; temporal ff_in, ff)
        out["geglu_mlp"][0] += 2 * 3 * n
        out["geglu_mlp"][1] += 3 * n * k4_call(bf * s, c)
    return {k: (v[0], v[1]) for k, v in out.items()}


def micro_step_bounds(sizes, frames: int, hw: int, tails=(33, 2)
                      ) -> Dict[str, Tuple[int, float]]:
    """kernel -> (launches, least seconds) of one training micro-step with
    one checkpoint scope a block: every forward launch twice (forward,
    recompute), K6 once per (SS2D block, group), K2-bwd once per spatial
    self-attention. Every token is scanned (all-ones masks), then each
    branch's tail: the audio branch's identity and 32 audio tokens, the
    expression branch's identity and VASA token."""
    rows = {s: [s + t for t in tails] for s, _, _, ssm in levels(sizes, hw) if ssm}
    fwd = forward_bounds(sizes, 1, frames, hw, rows)
    out = {k: (2 * n, 2 * secs) for k, (n, secs) in fwd.items()}
    n6, s6, n2, s2 = 0, 0.0, 0, 0.0
    for s, c, h, ssm in levels(sizes, hw):
        n = transformers_per_level(sizes) if ssm else 1
        if ssm:
            n6 += 4 * n
            s6 += 2 * n * sum(k6_call(s + t, frames, 2 * c) for t in tails)
        n2 += n
        s2 += n * k2_bwd_call(frames, s, c, h)
    out["ssm_scan_bwd"] = (n6, s6)
    out["mha_bwd"] = (n2, s2)
    return out
